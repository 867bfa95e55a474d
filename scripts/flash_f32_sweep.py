#!/usr/bin/env python3
"""How to tile the float32 flash-attention kernel
(`src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`) for
each head dim, timed on one GPU.

    python3 scripts/flash_f32_sweep.py [--out build/flash_f32_sweep.jsonl]

The kernel takes its tiling from one `Config<hd>` line per head dim: NW
warps of 16 q rows a block, KV tiles of BK keys, q's 3xTF32 split in
registers (QREG) or in shared memory, and the blocks an SM its launch
bounds ask for (MINB). For every variant in VARIANTS the source is built
with that head dim's line replaced (the build's own flags, all variants at
once) into `build/repro_torch_kernels/`; each variant is held to the plain
version within the float32 bound at ragged and causal shapes of its head
dim, its registers and spills are read from the compiler's output, and it
is timed as chip_smoke.py times a kernel at that head dim's timed shapes
(the shipped tiling first and last, so its spread shows). Prints one JSON
line per variant and exits non-zero without a CUDA device or on any
disagreement.
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
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

#: (NW, BK, QREG, MINB) tilings built and timed, by head dim, the shipped
#: one first; each fits the SM's 227 KB of shared memory
VARIANTS = {
    32: ((4, 64, False, 3), (4, 64, False, 1), (4, 64, True, 2), (4, 32, False, 4),
         (8, 64, False, 1)),
    64: ((4, 64, False, 1), (4, 32, False, 1), (4, 32, True, 2), (8, 32, False, 1)),
    128: ((8, 32, True, 1), (4, 32, True, 2), (8, 16, False, 1), (4, 32, False, 1)),
}
#: (B, nq, nkv, Sq, Sk, causal) timed at each head dim (float32)
TIMED = {
    32: ((26, 4, 2, 512, 512, True), (2, 4, 2, 128, 128, True)),
    64: ((2, 4, 2, 256, 256, True), (2, 8, 2, 256, 256, False), (1, 2, 1, 512, 512, True)),
    128: ((2, 16, 8, 2048, 2048, True), (1, 4, 4, 128, 128, True)),
}
#: (B, nq, nkv, Sq, Sk, causal) held to the plain version at each head dim,
#: beside the timed ones: ragged, full with Sq != Sk, bf16 through the same body
CHECKED = ((1, 4, 2, 100, 100, True), (1, 4, 1, 96, 200, False), (2, 4, 2, 130, 130, True))
LINE = re.compile(r"struct Config<(\d+)> \{ static constexpr int NW = \d+, BK = \d+, "
                  r"MINB = \d+; static constexpr bool QREG = (?:true|false); \};")


def config_line(hd: int, nw: int, bk: int, qreg: bool, minb: int) -> str:
    return (f"struct Config<{hd}> {{ static constexpr int NW = {nw}, BK = {bk}, MINB = {minb}; "
            f"static constexpr bool QREG = {str(qreg).lower()}; }};")


def build(variants) -> dict:
    """One library a (hd, variant), all built together; returns
    {(hd, variant): (CDLL, registers and spills of the float32 instance)}."""
    from repro_torch.kernels import _build

    src = _build.sources()["flash_attention"].read_text()
    lines = {int(m.group(1)): m.group(0) for m in LINE.finditer(src)}
    if sorted(lines) != sorted(VARIANTS):
        raise RuntimeError(f"flash_attention.cu no longer sets its tiling as {LINE.pattern!r}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for hd, variant in variants:
        nw, bk, qreg, minb = variant
        tag = f"hd{hd}_nw{nw}_bk{bk}_{'qreg' if qreg else 'qsmem'}_minb{minb}"
        cu = _build.BUILD_DIR / f"flash_attention_{tag}.cu"
        cu.write_text(src.replace(lines[hd], config_line(hd, *variant)))
        so = cu.with_suffix(".so")
        procs[(hd, variant)] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.flags("flash_attention"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc exited {proc.returncode}\n{out}")
        libs[key] = (ctypes.CDLL(str(so)), ptxas(out, key[0]))
    return libs


def ptxas(log: str, hd: int) -> str:
    """The registers and spills ptxas reports for the float32 instance at
    head dim `hd` (its mangled name holds `Li<hd>E`)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "flash_attention_kernel" in line \
                and f"IfLi{hd}E" in line:
            return " | ".join(x.split("ptxas info    :")[-1].strip() for x in lines[i + 1:i + 4])
    return "not found"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "flash_f32_sweep.jsonl")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from kernel_ab import bind_flash
    from repro_torch.kernels.flash_attention import testing as T

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    order = [(hd, v) for hd, vs in VARIANTS.items() for v in vs]
    libs = build(order)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    # the shipped tiling (each head dim's first variant) once more at the end
    for hd, variant in order + [(hd, vs[0]) for hd, vs in VARIANTS.items()]:
        lib, regs = libs[(hd, variant)]
        launch = bind_flash(lib)
        errs = {}
        for i, shape in enumerate(CHECKED + TIMED[hd]):
            for dt in ("float32", "bfloat16") if i == 0 else ("float32",):
                case = (*shape[:5], hd, shape[5], dt)
                q, k, v = T.case_inputs(case, "cuda", seed=i)
                o = torch.empty_like(q)
                launch(q, k, v, o, case[6])
                torch.cuda.synchronize()
                name = T.case_name(case)
                errs[name] = T.assert_close(o, T.plain(q, k, v, case[6]), f"{variant} {name}")[
                    "max_abs_err"]
        times = {}
        for shape in TIMED[hd]:
            case = (*shape[:5], hd, shape[5], "float32")
            q, k, v = T.case_inputs(case, "cuda", seed=0)
            o = torch.empty_like(q)
            work = chip_smoke.flash_work(*shape[:5], hd, shape[5], 4)
            times[T.case_name(case)] = chip_smoke._device_ms(
                torch, lambda: launch(q, k, v, o, case[6]), 10 if work["flops"] > 1e10 else 50)
        line = json.dumps({"hd": hd, **dict(zip(("NW", "BK", "QREG", "MINB"), variant)),
                           "shipped": variant == VARIANTS[hd][0],
                           "ptxas": regs, "ms": times, "max_abs_err": errs, "card": smi})
        print(line, flush=True)
        lines.append(line)
    args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
