#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Builds the port's CUDA kernels from `src/repro_torch/kernels/*/csrc/*.cu`
(into `build/repro_torch_kernels/`), holds each kernel against its plain
PyTorch version on the card at every shape the main path gives it, times
it, solves full tsunami waves at both published levels, and drives the paper's §4.3 main path once — two-level
ensemble MLDA through `EvaluationFabric(ModelBackend(TsunamiModel()))` —
checking that every step went through the kernel. Each phase prints one
JSON line; any failed check raises and the script exits non-zero. The last
two lines are the `{"kernels": [...]}` summary and
`{"ok": true, "device": {...}}`.

Imports torch, numpy and the port only — never JAX, never the JAX package.
Exits non-zero, printing nothing on stdout, without a CUDA device or
outside a checkout of the repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float operations per (cell, lane) of one SWE step, counting each face and
# each velocity once: velocity 10, face flux 48, divergence + update 9
SWE_OPS_PER_CELL_LANE = 67

# §4.3 campaign constants (benchmarks/mlda_tsunami.py); the prior box is
# `repro_torch.kernels.swe.testing.SOURCE_BOX`
TRUE_THETA = np.array([90.0, 2.5])
NOISE_SD = np.array([0.5, 0.05, 0.5, 0.05])  # arrival [min], height [m]
SEED = 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phases ---------------------------------------------------------------------


def phase_probe(torch, dev) -> dict:
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(dev)
    emit("probe", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(dev),
         capability=f"{cap[0]}.{cap[1]}", nvidia_smi=smi, nvcc=_build.nvcc(),
         device_count=torch.cuda.device_count())
    return {"smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: str(v.relative_to(ROOT)) for k, v in libs.items()})


def phase_kernel_vs_plain(torch, dev) -> dict:
    """The kernel against its plain version on the card, bit for bit (the
    bound and its reason: `repro_torch.kernels.swe.testing`), on the four
    limiter cases and at every [cells, lanes] shape the main path runs."""
    from repro_torch.kernels.swe import swe_step, swe_step_ref
    from repro_torch.kernels.swe.testing import CASES, assert_step_equal, case_inputs

    report = {}
    for case in CASES:
        h, hu, b, dt_dx = case_inputs(case, dev)
        got = swe_step(h, hu, b, dt_dx=dt_dx)
        torch.cuda.synchronize()
        report[case] = assert_step_equal(got, swe_step_ref(h, hu, b, dt_dx), (h, hu), case)
    worst = max(r[key]["max_abs"] for r in report.values() for key in ("h", "hu"))
    emit("kernel_vs_plain", kernel="swe_step", bound="bit for bit", cases=report)
    return {"max_abs_err": worst}


def _device_ms(torch, fn, calls: int, windows: int = 5) -> float:
    """Device time of one call of `fn`: the median over `windows` windows,
    each ONE pair of CUDA events around `calls` back-to-back calls, divided
    by `calls`. A spin kernel holds the queue while a window is enqueued, so
    the calls run back to back on the device and neither the host's launch
    latency nor the events' own cost enters the time (a window must fit the
    launch queue: ~1,000 pending launches)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning at H100 clocks
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_times(torch, dev, smi: str) -> dict:
    from repro_torch.kernels.swe import swe_step, swe_step_ref
    from repro_torch.kernels.swe.testing import main_path_state

    shapes = []
    for C in (512, 2048):
        for N in (4, 16, 64):
            h, hu, b, dt_dx = main_path_state(C, N, dev)
            pair = (torch.empty_like(h), torch.empty_like(hu))
            ms = _device_ms(
                torch, lambda: swe_step(h, hu, b, dt_dx=dt_dx, out=pair), calls=200
            )
            # ~45 PyTorch kernels a call: 16 calls fit the launch queue
            plain_ms = _device_ms(torch, lambda: swe_step_ref(h, hu, b, dt_dx), calls=16)
            # host side: wall time per launch of back-to-back steps, as the
            # solver issues them (without its buoy reduction)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                swe_step(h, hu, b, dt_dx=dt_dx, out=pair)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / 2000 * 1e3
            nbytes = (4 * C * N + C) * 4  # h, hu in; h, hu out; b in
            ops = SWE_OPS_PER_CELL_LANE * C * N
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
            shapes.append({
                "shape": [C, N], "ms": ms, "plain_ms": plain_ms,
                "host_ms_per_launch": host_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops,
            })
    emit("times", kernel="swe_step",
         timer="one CUDA event pair around 200 back-to-back steps (plain: 16), "
               "per step, median of 5 windows",
         shapes=shapes, library_ms=None, card=smi)
    return {"shapes": shapes}


def phase_full_solves(torch, dev) -> dict:
    """Whole waves through `TsunamiModel.evaluate_batch` at both levels, at
    the main path's 16 lanes and at 64, held bit for bit to the same solve
    on the plain path, with the kernel launches each wave took."""
    from repro_torch.apps.tsunami import TsunamiModel, level_grid, solve_batch
    from repro_torch.kernels.swe import swe_step, swe_step_ref_into
    from repro_torch.kernels.swe.testing import sources

    model = TsunamiModel(device="cuda")
    out = {}
    for level, (n_cells, smoothed) in enumerate(((512, True), (2048, False))):
        n_steps = level_grid(n_cells)[1]
        model.evaluate_batch(sources(4, 11), {"level": level})  # warm-up wave
        for lanes in (16, 64):
            thetas = sources(lanes, 11)
            before = swe_step.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = model.evaluate_batch(thetas, {"level": level})
            wall = time.perf_counter() - t0
            launched = swe_step.launches - before
            if launched != n_steps:
                raise AssertionError(f"level {level}, {lanes} lanes: {launched} "
                                     f"launches for one wave, expected {n_steps}")
            if ys.shape != (lanes, 4) or not np.isfinite(ys).all():
                raise AssertionError(f"level {level}: bad output {ys.shape}")
            t0 = time.perf_counter()
            plain = solve_batch(torch.as_tensor(thetas, device=dev), n_cells, smoothed,
                                step=swe_step_ref_into).cpu().numpy().astype(float)
            plain_wall = time.perf_counter() - t0
            # every step is bit for bit, and the buoy reduction is the same code
            np.testing.assert_array_equal(ys, plain, err_msg=f"level {level}, {lanes} lanes")
            out[f"{level}x{lanes}"] = {
                "level": level, "n_cells": n_cells, "n_steps": n_steps, "lanes": lanes,
                "launches": launched, "wall_s": wall, "evals_per_s": lanes / wall,
                "wall_ms_per_step": wall / n_steps * 1e3, "plain_wall_s": plain_wall,
            }
    emit("full_solves", waves=out, bound="bit for bit")
    return out


def phase_profile(torch) -> dict:
    """Device busy share of one coarse 16-lane wave, from a torch.profiler
    trace: the summed duration of the device's kernels, copies and memsets
    over the wave's wall time (one stream, so they never overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.kernels.swe.testing import sources

    model = TsunamiModel(device="cuda")
    thetas = sources(16, 11)
    model.evaluate_batch(thetas, {"level": 0})  # warm-up wave
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.evaluate_batch(thetas, {"level": 0})
    plain_wall_us = (time.perf_counter() - t0) * 1e6  # the same wave, unprofiled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.evaluate_batch(thetas, {"level": 0})
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = ROOT / "build" / "chip_smoke_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    busy = {"kernel": 0.0, "gpu_memcpy": 0.0, "gpu_memset": 0.0}
    swe_us, n_kernels = 0.0, 0
    for ev in events:
        cat = ev.get("cat")
        if cat in busy and ev.get("ph") == "X":
            busy[cat] += float(ev.get("dur", 0.0))
            if cat == "kernel":
                n_kernels += 1
                if "swe_step" in ev.get("name", ""):
                    swe_us += float(ev.get("dur", 0.0))
    device_us = sum(busy.values())
    # None: not measured. The profiler's host overhead lengthens the wave, so
    # the share is also given against the same wave's unprofiled wall time
    share = device_us / wall_us if n_kernels else None
    emit("profile", wave="coarse, 16 lanes", wall_ms=wall_us / 1e3,
         unprofiled_wall_ms=plain_wall_us / 1e3,
         device_busy_share_unprofiled=device_us / plain_wall_us if n_kernels else None,
         device_busy_ms=device_us / 1e3, swe_step_kernel_ms=swe_us / 1e3,
         device_kernels=n_kernels, device_busy_share=share,
         device_idle_share=None if share is None else 1.0 - share)
    return {"device_busy_share": share}


def phase_main_path(torch) -> dict:
    from repro_torch.apps.tsunami import TsunamiModel, level_grid
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.swe import swe_step
    from repro_torch.kernels.swe.testing import SOURCE_BOX, sources
    from repro_torch.uq.mlda import ensemble_mlda

    model = TsunamiModel()
    rng = np.random.default_rng(SEED)
    data = np.asarray(model([list(TRUE_THETA)], {"level": 1})[0])
    data = data + rng.standard_normal(4) * NOISE_SD * 0.5
    (x_lo, x_hi), (a_lo, a_hi) = SOURCE_BOX

    def logprior(theta):
        x0, A = float(theta[0]), float(theta[1])
        return 0.0 if x_lo <= x0 <= x_hi and a_lo <= A <= a_hi else -np.inf

    def loglik(obs):
        return float(-0.5 * np.sum(((np.asarray(obs) - data) / NOISE_SD) ** 2))

    K = 16
    x0s = sources(K, 11).astype(float)
    prop_cov = np.diag([8.0**2, 0.25**2])
    fabric = EvaluationFabric(ModelBackend(model), cache_size=8192)
    try:
        # every launch count starts at 0 right before the main path
        swe_step.launches = 0
        stats0, waves0 = dict(model.stats), dict(model.waves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ensemble_mlda(
            None, x0s, n_samples=4, subsampling=[5], prop_cov=prop_cov,
            rng=np.random.default_rng(501), fabric=fabric,
            level_configs=[{"level": 0}, {"level": 1}], loglik=loglik,
            logprior=logprior,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = swe_step.launches
        tel = fabric.telemetry()
    finally:
        fabric.shutdown()
    solves = {lvl: model.stats[lvl] - stats0[lvl] for lvl in (0, 1)}
    waves = {lvl: model.waves[lvl] - waves0[lvl] for lvl in (0, 1)}
    if not np.isfinite(res.samples).all() or res.samples.shape != (K, 4, 2):
        raise AssertionError(f"bad samples {res.samples.shape}")
    if not all(0.0 < r <= 1.0 for r in res.accept_rates):
        raise AssertionError(f"acceptance rates {res.accept_rates}")
    if min(waves.values()) <= 0 or sum(waves.values()) != tel["backend"]["native_batches"]:
        raise AssertionError(f"model waves per level {waves}, backend {tel['backend']}")
    # every step of every wave the fabric dispatched was one kernel launch
    expected = sum(n * level_grid(TsunamiModel.N_CELLS[lvl])[1] for lvl, n in waves.items())
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected} for "
                             f"waves per level {waves}")
    emit("main_path", chains=K, n_samples=4, subsampling=[5],
         n_waves=res.n_waves, evals_per_level=res.evals_per_level,
         model_solves_per_level=solves, model_waves_per_level=waves,
         accept_rates=res.accept_rates, wall_s=wall, swe_step_launches=launches,
         posterior_mean=res.samples.reshape(-1, 2).mean(0).tolist(),
         backend=tel["backend"])
    return {"launches": launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port under {SRC}; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    probe = phase_probe(torch, dev)
    phase_build()
    check = phase_kernel_vs_plain(torch, dev)
    times = phase_times(torch, dev, probe["smi"])
    solves = phase_full_solves(torch, dev)
    phase_profile(torch)
    main_path = phase_main_path(torch)

    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
    if leaked or "repro" in sys.modules:
        raise AssertionError(f"the smoke run imported the JAX package: {leaked}")
    fine = next(s for s in times["shapes"] if s["shape"] == [2048, 16])
    print(probe["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "swe_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/swe/csrc/swe_step.cu",
        "replaces": "src/repro/kernels/swe/swe.py:54",
        "launches": main_path["launches"],
        "max_abs_err": check["max_abs_err"],
        "ms": fine["ms"],
        "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"],
        "bound_by": fine["bound_by"],
        "library_ms": None,
        "shape": fine["shape"],
        "by_shape": times["shapes"],
        "launches_per_wave": {k: v["launches"] for k, v in solves.items()},
        "wall_ms_per_step": {k: v["wall_ms_per_step"] for k, v in solves.items()},
        "card": probe["smi"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
