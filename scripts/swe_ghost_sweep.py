#!/usr/bin/env python3
"""How often a cluster's blocks should exchange edge cells in the SWE solve
kernel: its ghost-cell width k (`kGhost` in
`src/repro_torch/kernels/swe/csrc/swe_solve.cu`), timed on one GPU; with
`--adjoint`, the same for the solve's adjoint (`kGhost` in
`swe_solve_vjp.cu`).

    python3 scripts/swe_ghost_sweep.py [--adjoint] [--out build/swe_ghost_sweep.json]

Builds the solve kernel's source once per k in GHOSTS, with `kGhost` set to
k and the build's own flags, into `build/repro_torch_kernels/`. A block
exchanges edge cells with its neighbours every k steps: k = 1 exchanges one
cell a side every step, and the shipped kernel takes k = 32. At each narrow
wave (512 and 2,048 cells x 16 and 64 lanes) and each cluster size above 1,
every k is held against the plain loop bit for bit, then timed as
chip_smoke.py's `solve_times` times a solve; the shipped kernel's one block
a lane is timed beside them. The adjoint: a block reloads its ghost states
every k recomputed steps and its ghost cotangents every k - 1 reverse
steps (and at each checkpoint segment's start), so k >= ceil(sqrt(n)) + 1
leaves only the segments' own two cluster barriers, at the cost of more
cells computed. At each 16- and 64-lane wave and each cluster size above
1, every width of VJP_GHOSTS is held bit for bit to the shipped adjoint
and timed as chip_smoke.py's `swe_vjp_vs_plain` times it. Prints one JSON
line per wave, writes them all to --out, and exits non-zero without a
CUDA device or on any mismatch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: ghost-cell widths built and timed
GHOSTS = (1, 16, 32, 64)
#: the adjoint's ghost-cell widths built and timed
VJP_GHOSTS = (16, 32, 49, 64)
#: the line of the source that sets the width
SHIPPED = "constexpr int kGhost = 32;"
#: [cells, lanes] of the waves timed: those the plan splits over clusters
SHAPES = tuple((C, N) for C in (512, 2048) for N in (16, 64))
CLUSTERS = (2, 4, 8)


def build(ghosts, stem: str = "swe_solve") -> dict[int, ctypes.CDLL]:
    """One library of the kernel `stem` a ghost width, all built together."""
    from repro_torch.kernels import _build

    source = _build.sources()[stem]
    src = source.read_text()
    if src.count(SHIPPED) != 1:
        raise RuntimeError(f"{stem}.cu no longer sets the ghost width as {SHIPPED!r}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in ghosts:
        cu = _build.BUILD_DIR / f"{stem}_ghost{k}.cu"
        cu.write_text(src.replace(SHIPPED, f"constexpr int kGhost = {k};"))
        so = cu.with_suffix(".so")
        procs[k] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.flags(stem), "-I", str(source.parent), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for k, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ghost width {k}: nvcc exited {proc.returncode}\n{out}")
        libs[k] = ctypes.CDLL(str(so))
    return libs


def adjoint_sweep(torch, chip_smoke) -> list:
    """Every adjoint ghost width of VJP_GHOSTS at each 16- and 64-lane wave
    and cluster size above 1, held bit for bit to the shipped adjoint."""
    from repro_torch.kernels.swe import ops, swe_solve_vjp
    from repro_torch.kernels.swe.ref import checkpoint_every
    from repro_torch.kernels.swe.testing import vjp_case_inputs

    smi = chip_smoke.nvidia_smi()
    shipped = ops._vjp_kernel()
    variants = {}
    for k, lib in build(VJP_GHOSTS, "swe_solve_vjp").items():
        fn = lib.swe_solve_vjp_f32
        fn.argtypes, fn.restype = shipped.argtypes, shipped.restype
        variants[k] = fn
    waves = []
    for C, N in SHAPES:
        kw = vjp_case_inputs(f"wave_{C}x{N}", "cuda")
        h, hu, b, cot = kw.pop("h"), kw.pop("hu"), kw.pop("b"), kw.pop("cot_mx")
        _, _, ck, ck_mx = ops._solve(h, hu, b, kw["dt_dx"], kw["n_steps"], kw["rows"],
                                     kw["h0_rows"], None, keep=True)
        want = swe_solve_vjp(b, ck, ck_mx, cot, **kw)
        calls = 1 if C * N > 16 * 512 else 3
        ms = {"one block a lane": chip_smoke._device_ms(
            torch, lambda: swe_solve_vjp(b, ck, ck_mx, cot, **kw, cluster=1), calls=calls)}
        for k, fn in variants.items():
            ops._vjp_fn = fn
            for cs in CLUSTERS:
                got = swe_solve_vjp(b, ck, ck_mx, cot, **kw, cluster=cs)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"adjoint ghost width {k}, {C}x{N}, cluster {cs}: "
                                         "differs from the shipped adjoint")
                ms[f"ghost {k}, cluster {cs}"] = chip_smoke._device_ms(
                    torch, lambda: swe_solve_vjp(b, ck, ck_mx, cot, **kw, cluster=cs),
                    calls=calls)
        ops._vjp_fn = shipped
        wave = {"adjoint": True, "shape": [C, N], "n_steps": kw["n_steps"],
                "checkpoint_every": checkpoint_every(kw["n_steps"]), "ms": ms,
                "held_bit_for_bit": True, "card": smi}
        print(json.dumps(wave), flush=True)
        waves.append(wave)
        del ck, ck_mx
    return waves


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--adjoint", action="store_true",
                    help="sweep the adjoint's ghost width instead of the solve's")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "swe_ghost_sweep.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("swe_ghost_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    if args.adjoint:
        waves = adjoint_sweep(torch, chip_smoke)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "timer": "one CUDA event pair around back-to-back adjoints (3 at 16 lanes, 1 "
                     "above), per launch, median of 5 windows (chip_smoke.py's _device_ms)",
            "waves": waves}, indent=1))
        return 0
    from repro_torch.kernels.swe import ops, swe_solve, swe_solve_ref
    from repro_torch.kernels.swe.testing import assert_solve_equal, wave_inputs

    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi()
    shipped = ops._solve_kernel()
    variants = {}
    for k, lib in build(GHOSTS).items():
        fn = lib.swe_solve_f32
        fn.argtypes, fn.restype = shipped.argtypes, shipped.restype
        variants[k] = fn
    waves = []
    for C, N in SHAPES:
        kw = wave_inputs(C, N, dev)
        h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
        want = swe_solve_ref(h, hu, b, **kw)
        ms = {"one block a lane": chip_smoke._device_ms(
            torch, lambda: swe_solve(h, hu, b, **kw, cluster=1), calls=5)}
        for k, fn in variants.items():
            ops._solve_fn = fn
            for cs in CLUSTERS:
                got = swe_solve(h, hu, b, **kw, cluster=cs)
                torch.cuda.synchronize()
                assert_solve_equal(got, want, f"ghost width {k}, {C}x{N}, cluster {cs}")
                ms[f"ghost {k}, cluster {cs}"] = chip_smoke._device_ms(
                    torch, lambda: swe_solve(h, hu, b, **kw, cluster=cs), calls=5)
        ops._solve_fn = shipped
        wave = {"shape": [C, N], "n_steps": kw["n_steps"], "ms": ms,
                "held_bit_for_bit": True, "card": smi}
        print(json.dumps(wave), flush=True)
        waves.append(wave)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({
        "timer": "one CUDA event pair around 5 back-to-back solves, per solve, "
                 "median of 5 windows (chip_smoke.py's _device_ms)",
        "waves": waves}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
