#!/usr/bin/env python3
"""Where the SWE adjoint kernel's time goes: a split of its reverse mode into
the parts between its barriers, read from clock64() stamps on one GPU.

    python3 scripts/swe_vjp_phases.py [--out FILE]

Builds `src/repro_torch/kernels/swe/csrc/swe_solve_vjp.cu` with its own
flags and `-DSWE_VJP_PHASES` into `build/swe_vjp_phases/`.
That variant has block 0's thread 0 add up the cycles of each part of the
wave (each part up to and including the barrier after it; the names come
from the library, `swe_solve_vjp_phase_parts`) and of the whole kernel.
At each of chip_smoke.py's timed shapes (`VJP_TIMED`) it runs the shipped
kernel, then the stamped one in its place under the same wrapper
(`ops.swe_solve_vjp`), holds the two bit for bit, times the stamped launch
with CUDA events and reads the cycles back. A part's time a step is its
share of block 0's cycles times the launch's time, over the wave's steps:
block 0 stands for every block (all run the same steps, and a cluster's
blocks wait for each other at its barriers).

The first launch of each library is watched: if it has not finished within
WATCHDOG_S, the script prints what it knows and leaves with os._exit (a
hung kernel never returns from a synchronise). Prints one JSON line a
shape, writes them to --out, and exits non-zero without a CUDA device or
if the variant and the shipped kernel differ.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: seconds the first launch of a library may take before the script gives up
WATCHDOG_S = 120.0
OUT_DIR = ROOT / "build" / "swe_vjp_phases"


def build(source: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / "libswe_solve_vjp_phases.so"
    cmd = [_build.nvcc(), *_build.flags("swe_solve_vjp"), "-DSWE_VJP_PHASES", "-I",
           str(_build.sources()["swe_solve_vjp"].parent), "-o", str(so), str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exited {proc.returncode}\n{proc.stdout}")
    (OUT_DIR / "build.log").write_text(proc.stdout)
    return ctypes.CDLL(str(so))


def watched(torch, fn, what: str):
    """`fn()` whose launches must finish within WATCHDOG_S (polled, never
    synchronised on)."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + WATCHDOG_S
    while not done.query():
        if time.monotonic() > deadline:
            print(json.dumps({"hung": what, "after_s": WATCHDOG_S}), flush=True)
            os._exit(3)
        time.sleep(0.01)
    return out


def device_ms(torch, fn, calls: int, windows: int = 5) -> float:
    """chip_smoke.py's `_device_ms`: the median over windows of one CUDA
    event pair around `calls` back-to-back calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT_DIR / "phases.jsonl")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("swe_vjp_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import VJP_TIMED
    from repro_torch.kernels import _build
    from repro_torch.kernels.swe import ops
    from repro_torch.kernels.swe.ref import checkpoint_every
    from repro_torch.kernels.swe.testing import vjp_case_inputs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    stamped = build(_build.sources()["swe_solve_vjp"])
    stamped.swe_solve_vjp_phase_parts.restype = ctypes.c_char_p
    parts = stamped.swe_solve_vjp_phase_parts().decode().split(",")
    read = stamped.swe_solve_vjp_phase_cycles
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    dev = torch.device("cuda")
    lines = []
    for case in VJP_TIMED:
        kw = vjp_case_inputs(case, dev)
        h, hu, b, cot = kw.pop("h"), kw.pop("hu"), kw.pop("b"), kw.pop("cot_mx")
        C, N = h.shape
        _, _, ck, ck_mx = ops._solve(h, hu, b, kw["dt_dx"], kw["n_steps"], kw["rows"],
                                     kw["h0_rows"], None, keep=True)

        def vjp():
            return ops.swe_solve_vjp(b, ck, ck_mx, cot, **kw)

        # the shipped kernel, then the stamped one under the same wrapper
        ops._vjp_fn = None
        _build._loaded.pop("swe_solve_vjp", None)
        shipped = watched(torch, vjp, f"{case}: the shipped kernel")
        ops._vjp_fn = None
        _build._loaded["swe_solve_vjp"] = stamped
        got = watched(torch, vjp, f"{case}: the stamped kernel")
        same = all(torch.equal(g, w) for g, w in zip(got, shipped))
        ms = device_ms(torch, vjp, calls=1 if C * N > 16 * 512 else 3)
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * (len(parts) + 1))()
        err = read(cycles)
        if err != 0:
            raise RuntimeError(f"reading the stamps failed, cudaError {err}")
        total = cycles[len(parts)]
        n_steps = kw["n_steps"]
        split = {name: {"share": cycles[i] / total,
                        "us_per_step": cycles[i] / total * ms * 1e3 / n_steps}
                 for i, name in enumerate(parts)}
        line = {"case": case, "shape": [C, N], "n_steps": n_steps,
                "checkpoint_every": checkpoint_every(n_steps),
                "stamped_ms": ms, "us_per_step": ms * 1e3 / n_steps,
                "block0_cycles": total, "parts": split,
                "unstamped_parts_share": 1 - sum(cycles[i] for i in range(len(parts))) / total,
                "bit_for_bit_with_shipped": same, "card": smi.strip()}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del ck, ck_mx
        if not same:
            print(f"{case}: the stamped kernel differs from the shipped one", file=sys.stderr)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(l) + "\n" for l in lines))
    ops._vjp_fn = None
    _build._loaded.pop("swe_solve_vjp", None)
    return 0 if all(l["bit_for_bit_with_shipped"] for l in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
