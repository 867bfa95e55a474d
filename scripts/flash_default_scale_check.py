#!/usr/bin/env python3
"""This checkout's flash-attention kernels at their default scale against
another checkout's, bit for bit, on one GPU.

    python3 scripts/flash_default_scale_check.py --parent DIR [--out FILE]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with `git archive`). Its `flash_attention.cu` and
`flash_attention_wgmma.cu` are built with this checkout's nvcc flags into
`build/repro_torch_kernels/` (`kernel_ab.build_parent`) and bound as
`ops.launch` binds this checkout's, with or without the `double scale`
argument and the log-sum-exp pointer (passed null) as the parent's entry
points declare them. This checkout's wrapper passes a null log-sum-exp
pointer too, so the check also holds the forward kernels' outputs with no
log-sum-exp written to the parent's, bit for bit. Every case of
`kernels/flash_attention/testing.py` (`CASES`, the bf16 ones at the model
layout as the paths hand them over)
runs through this checkout's wrapper at the default scale and through the
parent's kernel of the same dtype; the outputs must be equal bit for bit,
and both within the bound of the plain version. The float32 kernel also
runs every bf16 case, as chip_smoke.py runs it. Prints one JSON line per
case (and writes them to --out); exits non-zero without a CUDA device or on
any difference.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

STEMS = ("flash_attention", "flash_attention_wgmma")


def bind(stem: str, lib):
    """`launch(q, k, v, o, causal)` through the parent's entry point at
    1/sqrt(hd), passed where the entry point takes a scale."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    fn = getattr(lib, f"{stem}_fwd")
    scaled = "double scale" in lib.source
    lse = [None] if "void* lse" in lib.source else []  # a null log-sum-exp pointer
    n_ints = 7 if stem == "flash_attention" else 6  # B .. hd, and the dtype code
    fn.argtypes = [ctypes.c_void_p] * (4 + len(lse)) + [ctypes.c_int] * n_ints + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        *([ctypes.c_double] if scaled else []), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(q, k, v, o, causal):
        B, nq, Sq, hd = q.shape
        strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, o) for s in ops._strides(t)])
        dtype = [ops._CODES[q.dtype]] if stem == "flash_attention" else []
        scale = [1.0 / math.sqrt(hd)] if scaled else []
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *lse, B, nq, k.shape[1],
                 Sq,
                 k.shape[2], hd, *dtype, strides, int(causal), *scale,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent {stem}: error {err}")

    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "flash_default_scale.jsonl")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_default_scale_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.kernels.flash_attention import testing as T

    from kernel_ab import build_parent

    libs = build_parent(args.parent, tuple((stem, "flash_attention") for stem in STEMS))
    parent = {stem: bind(stem, lib) for stem, lib in libs.items()}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    lines, bad = [], 0
    for i, case in enumerate(T.CASES):
        causal, name = case[6], T.case_name(case)
        q, k, v = T.case_inputs(case, "cuda", seed=i)
        if case in T.MODEL_CASES:
            q, k, v = chip_smoke._model_layout(q, k, v)
        want = T.plain(q, k, v, causal)
        runs = [(ops.KERNEL_OF[q.dtype], flash_attention(q, k, v, causal=causal))]
        if q.dtype == torch.bfloat16:  # the float32 kernel's bf16 instance too
            o = torch.empty_like(q)
            ops.launch("flash_attention", q, k, v, o, causal)
            runs.append(("flash_attention", o))
        for stem, mine in runs:
            theirs = torch.empty_like(q)
            parent[stem](q, k, v, theirs, causal)
            torch.cuda.synchronize()
            same = bool(torch.equal(mine, theirs))
            line = {"case": name, "kernel": stem, "bit_for_bit": same,
                    "max_abs_diff": float((mine.float() - theirs.float()).abs().max()),
                    **T.assert_close(mine, want, f"{stem} {name}")}
            bad += not same
            lines.append(line)
            print(json.dumps(line), flush=True)
        del q, k, v, want, runs
        torch.cuda.empty_cache()
    args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(json.dumps({"cases": len(lines), "differ": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
