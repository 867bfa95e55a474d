#!/usr/bin/env python3
"""How to tile the float32 flash-attention backward
(`src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_3xbf16.cu`)
for each head dim, timed on one GPU.

    python3 scripts/flash_bwd_f32_sweep.py [--hd 32 64 128]
                                           [--out build/flash_bwd_f32_sweep.jsonl]

The library takes its tiling from one `Config<hd>` line per head dim: the
q rows of a streamed tile (BQT) and the stages of the dK/dV kernel's ring
(KV_STAGES), the keys of a streamed tile (BK) and the stages of the dQ
kernel's ring (Q_STAGES). For every variant in VARIANTS the source is built
with that head dim's line replaced (the build's own flags, all variants at
once) into `build/repro_torch_kernels/`; each variant is loaded in the
library's place under the wrapper (`ops.flash_attention_bwd`), held to the
plain backward within `BWD_RTOL["float32"]` at ragged, full and causal
shapes of its head dim, its dK/dV and dQ kernels' registers and spills are
read from the compiler's output, and it is timed as chip_smoke.py times the
backward: the whole call (`_device_ms`) and each of its three kernels from
a torch.profiler trace (`_bwd_kernel_ms`), at TIMED[hd] (the shipped tiling
first and last, so its spread shows). The two ring kernels are separate
launches, so the best dK/dV tiling and the best dQ tiling of a head dim can
be read apart. Prints one JSON line per variant and exits non-zero without
a CUDA device or on any disagreement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

STEM = "flash_attention_bwd_3xbf16"
#: (BQT, KV_STAGES, BK, Q_STAGES) tilings built and timed, by head dim, the
#: shipped one first; each fits the 227 KB of a block (the source asserts it)
VARIANTS = {
    32: ((64, 2, 64, 2), (64, 4, 64, 4), (32, 2, 32, 2), (64, 3, 128, 2)),
    64: ((64, 2, 64, 2), (64, 3, 64, 3), (32, 3, 32, 3), (64, 2, 128, 2)),
    128: ((32, 2, 32, 3), (32, 2, 32, 2), (32, 3, 32, 3), (64, 1, 64, 1), (32, 2, 64, 1)),
}
#: (B, nq, nkv, Sq, Sk, causal) timed at each head dim: the float32
#: BWD_CASES (the float32 path's shape at hd 32, qwen3-0.6b's at hd 128) and
#: qwen3-0.6b's heads at hd 64
TIMED = {
    32: ((26, 4, 2, 512, 512, True),),
    64: ((2, 16, 8, 2048, 2048, True),),
    128: ((2, 16, 8, 2048, 2048, True),),
}
#: (B, nq, nkv, Sq, Sk, causal, scale) held to the plain backward at each
#: head dim beside the timed ones: a ragged causal S with a GQA group of 4,
#: full attention with Sq != Sk and a scale, a short causal S
CHECKED = ((3, 8, 2, 1000, 1000, True, None), (1, 8, 2, 130, 161, False, 0.2),
           (1, 4, 4, 100, 100, True, None))
LINE = re.compile(r"struct Config<(\d+)> \{ static constexpr int BQT = \d+, KV_STAGES = \d+, "
                  r"BK = \d+, Q_STAGES = \d+; \};")


def config_line(hd: int, bqt: int, kv_stages: int, bk: int, q_stages: int) -> str:
    return (f"struct Config<{hd}> {{ static constexpr int BQT = {bqt}, KV_STAGES = {kv_stages}, "
            f"BK = {bk}, Q_STAGES = {q_stages}; }};")


def build(variants) -> dict:
    """One library a (hd, variant), all built together; returns
    {(hd, variant): (CDLL, the ptxas lines of its dK/dV and dQ instances at
    hd)}."""
    from repro_torch.kernels import _build

    src_path = _build.sources()[STEM]
    src = src_path.read_text()
    lines = {int(m.group(1)): m.group(0) for m in LINE.finditer(src)}
    if sorted(lines) != sorted(VARIANTS):
        raise RuntimeError(f"{STEM}.cu no longer sets its tiling as {LINE.pattern!r}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for hd, variant in variants:
        tag = f"hd{hd}_" + "_".join(map(str, variant))
        cu = _build.BUILD_DIR / f"{STEM}_{tag}.cu"
        cu.write_text(src.replace(lines[hd], config_line(hd, *variant)))
        so = cu.with_suffix(".so")
        # -I: the source's own directory, for its `#include "wgmma_tma.cuh"`
        procs[(hd, variant)] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.flags(STEM), "-I", str(src_path.parent), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc exited {proc.returncode}\n{out}")
        libs[key] = (ctypes.CDLL(str(so)), ptxas(out, key[0]))
    return libs


def ptxas(log: str, hd: int) -> dict:
    """The registers and spills ptxas reports for the dK/dV and dQ
    instances at head dim `hd` (their mangled names hold `ILi<hd>E`)."""
    found, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = next((k for k in ("dkdv_3xbf16_kernel", "dq_3xbf16_kernel")
                            if k in line and f"ILi{hd}E" in line), None)
        elif current and ("spill" in line or "registers" in line):
            found[current] = " | ".join(filter(None, (found.get(current), line.split(
                "ptxas info    :")[-1].strip())))
    return found


def install(lib) -> None:
    """Load `lib` in the library's place under the wrapper."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    _build._loaded[STEM] = lib
    ops._fns.pop(STEM, None)
    ops._fns.pop(f"{STEM}_scratch", None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hd", type=int, nargs="+", choices=tuple(VARIANTS), default=list(VARIANTS))
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "flash_bwd_f32_sweep.jsonl")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_f32_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
    from repro_torch.kernels.flash_attention import testing as T

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    order = [(hd, v) for hd in args.hd for v in VARIANTS[hd]]
    libs = build(order)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("")
    # the shipped tiling (each head dim's first variant) once more at the end
    for hd, variant in order + [(hd, VARIANTS[hd][0]) for hd in args.hd]:
        lib, regs = libs[(hd, variant)]
        install(lib)
        errs = {}
        for i, (*shape, causal, scale) in enumerate(CHECKED + tuple(
                (*t, None) for t in TIMED[hd])):
            zoo = T.ZooCase((*shape, hd, causal, "float32"), scale)
            q, k, v, do = T.bwd_inputs(zoo, "cuda", seed=20 + i)
            name = T.case_name(zoo.case)
            rep = T.check_bwd(q, k, v, do, causal, scale, f"{variant} {name}")
            errs[name] = max(rep[g]["rel"] for g in ("dq", "dk", "dv"))
            del q, k, v, do
        times = {}
        for *shape, causal in TIMED[hd]:
            zoo = T.ZooCase((*shape, hd, causal, "float32"))
            q, k, v, do = T.bwd_inputs(zoo, "cuda", seed=0)
            o, lse = ops._forward(q, k, v, causal, None, want_lse=True)
            call = lambda: flash_attention_bwd(q, k, v, o, lse, do,  # noqa: E731
                                               causal=causal)
            ms = chip_smoke._device_ms(torch, call, 20)
            kernel_ms, _ = chip_smoke._bwd_kernel_ms(torch, call, STEM, 20)
            times[T.case_name(zoo.case)] = {"ms": ms, "kernel_ms": kernel_ms}
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
        line = json.dumps({"hd": hd, **dict(zip(("BQT", "KV_STAGES", "BK", "Q_STAGES"), variant)),
                           "shipped": variant == VARIANTS[hd][0], "ptxas": regs, "times": times,
                           "max_rel_err": errs, "card": smi})
        print(line, flush=True)
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
