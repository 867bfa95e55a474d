#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Builds the port's CUDA kernels from `src/repro_torch/kernels/*/csrc/*.cu`
(into `build/repro_torch_kernels/`), holds each kernel against its plain
PyTorch version on the card at every shape the main paths give it (the SWE
solve at every thread block cluster size it runs), and times it. Then it drives the port's two paths through the entry points a
user calls:

* the paper's §4.3 tsunami inversion: full tsunami waves at both published
  levels, and two-level ensemble MLDA through
  `EvaluationFabric(ModelBackend(TsunamiModel()))`, every wave (all its
  time steps and the buoy reduction) one launch of the SWE solve kernel;
  and the SWE step kernel on its own path, `solve_batch(step=swe_step)`,
  one launch per time step; then the model's derivative surface: a fused
  value-and-gradient, a JVP and an HVP wave of 16 lanes per level (wall,
  busy share under the profiler, peak memory, no kernel launch: the
  kernel is forward-only, derivative waves are PyTorch ops under autograd,
  as the JAX package's are scan ops), the gradient-informed campaign
  (`coarse_sampler="mala"`: coarse subchains on fused value-and-gradient
  waves, fine waves on the solve kernel) and the Laplace preview on the
  coarse level with both curvature modes; then the GP level of the
  hierarchy (`gp_level`: a 128-point Sobol' design solved as one coarse
  wave, four GPs fitted on the card), the paper's three-level ensemble
  MLDA over GP, smoothed and fully resolved levels through a
  `MultilevelModel` (`three_level_path`), and three-stage delayed
  acceptance behind a GP screen trained from the fabric's own coarse
  waves, against the blind run (`surrogate_da_path`); then the fused
  sampler blocks (`uq/fused.py`: S sampler steps a CUDA-graph replay, on
  the tsunami S `swe_solve` launches): steps/s of the fused block, the
  per-step reference and the host loop on benchmarks/fused_sampler.py's
  Gaussian and on the coarse tsunami posterior, fused == per-step bit for
  bit (`fused_sampler`), two fused steps through the kernel against the
  same steps through the plain loop (`fused_kernel_vs_plain`),
  `main_path`'s campaign with fused coarse subchains (`fused_main_path`)
  and a fused MALA kill-and-resume (`fused_checkpoint`); then the same
  campaign behind UM-Bridge HTTP model servers in this process
  (`core/server.py`): through `HTTPBackend` and a router of two servers
  (`wire_main_path`), two tenants at once under `UQService`
  (`service_path`), and a router whose second member dies halfway, under
  a `FleetManager` (`fleet_path`), each equal to `main_path`'s samples
  bit for bit; every wave width those paths gave the solve kernel that
  the fixed shapes do not cover, held against the plain loop as launched
  (`wave_widths_vs_plain`); and the paper's §4.1 L2-Sea sparse grid over
  the wire (`l2sea_wire`);
* the LM-as-UQ-model serving flow of `examples/serve_uq.py` on two
  full-width models from seeded random weights (bf16): mamba2-1.3b (48
  layers), every layer of every forward one launch of the SSD chunk-scan
  kernel, and qwen3-0.6b (28 layers, the model the example serves), every
  layer one launch of the bf16 tensor-core flash-attention kernel (wgmma
  and TMA, reading the model's [B, S, n, hd] tensors through strides). Each
  runs a level-4
  sparse grid of the NLL over (embedding scale, temperature) through the
  fabric, the surrogate's Monte Carlo, and 8 per-point submits; then one
  wave on the kernel path against the plain path, and one wave under the
  profiler;
* the RMSNorm kernel through its own entry point at qwen3-0.6b's norm
  shapes: as in the JAX package, no model calls it;
* the float32 flash-attention kernel (CUDA cores) on its own path: the
  reduced qwen3-0.6b in float32, as the port's tests run it, serving a
  level-2 sparse grid through the fabric.

Last, the port's analysis gate (`analysis_gate`, `repro_torch.analysis`):
its linter over the port and this script (every rule 0 findings, against
an empty baseline), its selftest, its race detector's stress harness with
the tap's online GP on the card, and the detector over the card's own
locks: evaluate waves from 8 threads through a monitored fabric beside two
gradient waves that capture their step graphs under the instrumented
`CAPTURE_LOCK`, every row bit for bit against a serial run.

The build phase is followed by the count of the tensor-core instructions in
the SASS of the two kernels that use them: HGMMA (wgmma) in the bf16 flash
kernel, HMMA (mma.sync, TF32) in the SSD kernel, with the SSD kernel's
registers and spills from its build log.

Each launch count is set to 0 just before a path and read just after. Each
phase prints one JSON line; any failed check raises and the script exits
non-zero. The last lines are the card's name and power limit, the
`{"kernels": [...]}` summary and `{"ok": true, "device": {...}}`.

Imports torch, numpy and the port only — never JAX, never the JAX package.
Exits non-zero, printing nothing on stdout, without a CUDA device or
outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# float operations per (cell, lane) of one SWE step, counting each face and
# each velocity once: velocity 10, face flux 48, divergence + update 9
SWE_OPS_PER_CELL_LANE = 67
# the solve's planned cluster size may take at most this much longer than
# one block a lane at a timed shape: the windows' spread is ~1-3%
PLAN_SLACK = 1.10

# the LM paths: examples/serve_uq.py's flow on full-width mamba2-1.3b and
# qwen3-0.6b (the model the example serves)
SSM_ARCH = "mamba2-1.3b"
DENSE_ARCH = "qwen3-0.6b"
LM_BATCH, LM_SEQ = 2, 2048
LM_BOX = (0.7, 1.3)  # sparse-grid box of (embedding scale, temperature)
LM_GRID_LEVEL = 4  # 41 points: one 41-point wave of 82 sequences, unpadded
LM_SUBMITS = 8
# bound on the relative NLL difference of the kernel path and the plain
# path. The SSD's float32 reordering (~5e-6 relative, ssd_kernel_vs_plain)
# flips bf16 roundings of the residual stream, which 48 layers spread: on an
# H100 (700 W) the mean NLLs of a wave differed by up to 8.3e-5 relative
# (PERF.md). 1e-3 is ten times that. It holds qwen3-0.6b too, whose plain
# path rounds the softmax to bf16 before the product with V (as the JAX
# package's XLA path does) where the flash kernel keeps float32.
LM_NLL_RTOL = 1e-3

# §4.3 campaign constants (benchmarks/mlda_tsunami.py); the prior box is
# `repro_torch.kernels.swe.testing.SOURCE_BOX`
TRUE_THETA = np.array([90.0, 2.5])
NOISE_SD = np.array([0.5, 0.05, 0.5, 0.05])  # arrival [min], height [m]
SEED = 3


#: the script's start: each phase line carries its seconds since then
T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - T_START},
                     default=float), flush=True)


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by wrapper name; each counts its
    launches in `.launches` (flash attention also by kernel, in
    `.launches_by_kernel`)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm_fused
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.swe import swe_solve, swe_step

    return {"swe_solve": swe_solve, "swe_step": swe_step, "ssd": ssd,
            "flash_attention": flash_attention, "rmsnorm": rmsnorm_fused}


def reset_launches() -> None:
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
        for name in getattr(wrapper, "launches_by_kernel", {}):
            wrapper.launches_by_kernel[name] = 0


def read_launches() -> dict:
    """Launches by kernel: flash attention's two kernels (the CUDA-core
    `flash_attention`, the tensor-core `flash_attention_wgmma`) apart."""
    counts = {}
    for name, wrapper in kernel_wrappers().items():
        counts.update(getattr(wrapper, "launches_by_kernel", {name: wrapper.launches}))
    return counts


class WaveWidths:
    """Records, while `installed`, every wave that `apps.tsunami.solve_batch`
    hands the solve kernel (the `swe_solve` name it calls): the distinct
    [cells, lanes] of each phase, and for each width its first wave, the
    inputs and the kernel's outputs, so that `phase_wave_widths_vs_plain`
    can hold exactly those launches against the plain version. The model's
    waves run unpadded, so a campaign gives widths that `SOLVE_SHAPES` does
    not list. The kernel's count is its wrapper's, untouched; a wave
    captured into a CUDA graph is not recorded (it runs at replay)."""

    def __init__(self, torch):
        self.torch = torch
        self.by_phase: dict[str, set] = {}
        self.first: dict[tuple, tuple] = {}
        self.phase = None
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def installed(self):
        import repro_torch.apps.tsunami as tsunami

        kernel = tsunami.swe_solve

        def recording(h, hu, b, **kw):
            out = kernel(h, hu, b, **kw)
            if not (h.is_cuda and self.torch.cuda.is_current_stream_capturing()):
                self._note(h, hu, b, kw, out)
            return out

        tsunami.swe_solve = recording
        try:
            yield self
        finally:
            tsunami.swe_solve = kernel

    def run(self, phase: str, fn, *args):
        """`fn(*args)`, its waves recorded under `phase`."""
        self.phase = phase
        try:
            return fn(*args)
        finally:
            self.phase = None

    def _note(self, h, hu, b, kw, out) -> None:
        key = tuple(h.shape)
        with self._lock:
            self.by_phase.setdefault(self.phase, set()).add(key)
            if key not in self.first:
                inputs = {k: v.clone() if self.torch.is_tensor(v) else v for k, v in kw.items()}
                self.first[key] = (dict(h=h.clone(), hu=hu.clone(), b=b.clone(), **inputs),
                                   tuple(t.clone() for t in out))


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
    # evidence that the bf16 flash kernel and the SSD kernel run on the
    # tensor cores: HGMMA (warpgroup MMA) and HMMA (mma.sync) in their SASS
    # (every function of the flash library; every instance of the SSD kernel)
    for stem, op, kernel in (("flash_attention_wgmma", "HGMMA", ""),
                             ("ssd", "HMMA", "ssd_chunk_scan_kernel")):
        counts = sass_counts(libs[stem], op)
        kernels = {f: n for f, n in counts.items() if kernel in f}
        if not kernels or min(kernels.values()) == 0:
            raise AssertionError(f"a tensor-core kernel without {op}: {counts}")
        fields = {}
        if stem == "ssd":
            # registers and spills of each instance (-Xptxas -v, SOURCE_FLAGS)
            log = libs[stem].with_suffix(".log").read_text().splitlines()
            fields["ptxas"] = [line.strip() for line in log
                               if "registers" in line or "spill" in line]
        emit("sass", library=str(libs[stem].relative_to(ROOT)),
             **{f"{op.lower()}_instructions": sum(kernels.values()),
                f"{op.lower()}_by_function": kernels}, **fields)


def sass_counts(library: Path, op: str) -> dict:
    """Instructions whose opcode starts with `op`, by function, in the SASS
    of `library` (`cuobjdump -sass`)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    by_function: dict[str, int] = {}
    function = ""
    for line in sass.splitlines():
        if "Function : " in line:
            function = line.split("Function : ")[1].strip()
            by_function[function] = 0
        elif op in line:
            by_function[function] = by_function.get(function, 0) + 1
    return by_function


def phase_kernel_vs_plain(torch, dev) -> dict:
    """Both SWE kernels against their plain versions on the card, bit for
    bit (the bound and its reason: `repro_torch.kernels.swe.testing`): the
    step kernel on the four limiter cases and at every [cells, lanes] shape
    the main path runs; the solve kernel on the limiter cases over 300 steps,
    on whole waves at both levels (1, 4, 8, 13, 16 and 64 lanes) and on a
    2,047-cell wave with its buoy rows on a slice edge, each at the plan's
    cluster size and at every other size the kernel runs, against one plain
    loop."""
    from repro_torch.kernels.swe import ops as swe_ops
    from repro_torch.kernels.swe import swe_solve, swe_solve_ref, swe_step, swe_step_ref
    from repro_torch.kernels.swe.testing import (
        CASES,
        CLUSTER_SIZES,
        SOLVE_CASES,
        assert_solve_equal,
        assert_step_equal,
        case_inputs,
        solve_case_inputs,
    )

    report = {}
    for case in CASES:
        h, hu, b, dt_dx = case_inputs(case, dev)
        got = swe_step(h, hu, b, dt_dx=dt_dx)
        torch.cuda.synchronize()
        report[case] = assert_step_equal(got, swe_step_ref(h, hu, b, dt_dx), (h, hu), case)
    worst = max(r[key]["max_abs"] for r in report.values() for key in ("h", "hu"))
    emit("kernel_vs_plain", kernel="swe_step", bound="bit for bit", cases=report)
    solves = {}
    for case in SOLVE_CASES:
        kw = solve_case_inputs(case, dev)
        h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
        C, N = h.shape
        want = swe_solve_ref(h, hu, b, **kw)
        by_cluster = {}
        for cluster in (None, *(cs for cs in CLUSTER_SIZES if cs <= C)):
            got = swe_solve(h, hu, b, **kw, cluster=cluster)
            torch.cuda.synchronize()
            by_cluster["plan" if cluster is None else str(cluster)] = assert_solve_equal(
                got, want, f"{case}, cluster {cluster}")
        solves[case] = dict(shape=[C, N], n_steps=kw["n_steps"], rows=list(kw["rows"]),
                            plan=swe_ops.cluster_plan(C, N), by_cluster=by_cluster)
    solve_worst = max(r[key]["max_abs"] for c in solves.values()
                      for r in c["by_cluster"].values() for key in ("mx", "arr"))
    emit("kernel_vs_plain", kernel="swe_solve", bound="bit for bit (mx, arr; NaN matches NaN)",
         cluster_sizes=list(CLUSTER_SIZES), cases=solves)
    return {"max_abs_err": worst, "solve_max_abs_err": solve_worst}


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


def solve_work(C: int, N: int, n_steps: int, R: int) -> dict:
    """Bytes one whole-wave solve must move (h, hu and b read once, the
    [R] depths at rest read once, mx and arr [R, N] written once) and its
    float operations (`SWE_OPS_PER_CELL_LANE` per cell, lane and step)."""
    return {"bytes": (2 * C * N + C + R + 2 * R * N) * 4,
            "ops": SWE_OPS_PER_CELL_LANE * C * N * n_steps}


def phase_times(torch, dev, smi: str) -> dict:
    """Device time of one step-kernel launch at the main path's shapes, and
    of one solve-kernel launch (a whole wave) at both levels and 16, 64 and
    512 lanes, each beside its bound, at every cluster size and the plan's
    (with the card's count of resident clusters of each size); the solve
    beside the step kernel's loop over the same wave (n_steps x the step's
    time) and the plain loop's device time. At 16 lanes every cluster size
    is held against the plain loop bit for bit."""
    from repro_torch.kernels.swe import ops as swe_ops
    from repro_torch.kernels.swe import swe_solve, swe_solve_ref, swe_step, swe_step_ref
    from repro_torch.kernels.swe.testing import (
        CLUSTER_SIZES,
        TIMED_SHAPES,
        assert_solve_equal,
        main_path_state,
        wave_inputs,
    )

    shapes = []
    for C in (512, 2048):
        for N in (4, 16, 64, 512):
            h, hu, b, dt_dx = main_path_state(C, N, dev)
            pair = (torch.empty_like(h), torch.empty_like(hu))
            ms = _device_ms(
                torch, lambda: swe_step(h, hu, b, dt_dx=dt_dx, out=pair), calls=200
            )
            # ~45 PyTorch kernels a call: 16 calls fit the launch queue
            plain_ms = _device_ms(torch, lambda: swe_step_ref(h, hu, b, dt_dx), calls=16)
            # host side: wall time per launch of back-to-back steps, as the
            # per-step path issues them (without its buoy reduction)
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
    step_ms = {tuple(s["shape"]): s["ms"] for s in shapes}
    waves = []
    for C, N in TIMED_SHAPES:
        kw = wave_inputs(C, N, dev)
        h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
        n_steps = kw["n_steps"]
        plan = swe_ops.cluster_plan(C, N)
        resident = {cs: swe_ops.max_active_clusters(C, cs) for cs in CLUSTER_SIZES}
        ms_by_cluster = {
            cs: _device_ms(torch, lambda: swe_solve(h, hu, b, **kw, cluster=cs), calls=5)
            for cs in CLUSTER_SIZES}
        # one loop a window: its ~50 small kernels a step overrun the
        # launch queue, so the host's issue rate enters, as it does on
        # the plain path
        plain = []
        plain_ms = _device_ms(torch, lambda: plain.append(swe_solve_ref(h, hu, b, **kw)),
                              calls=1, windows=1)
        if N == 16:
            # every cluster size against the plain loop, bit for bit
            for cs in CLUSTER_SIZES:
                got = swe_solve(h, hu, b, **kw, cluster=cs)
                torch.cuda.synchronize()
                assert_solve_equal(got, plain[-1], f"solve_times {C}x{N}, cluster {cs}")
        ms = ms_by_cluster[plan]
        if ms > PLAN_SLACK * ms_by_cluster[1]:
            raise AssertionError(f"solve_times {C}x{N}: the plan's cluster {plan} takes "
                                 f"{ms:.3f} ms, one block a lane {ms_by_cluster[1]:.3f} ms")
        work = solve_work(C, N, n_steps, len(kw["rows"]))
        t_bytes, t_ops = work["bytes"] / HBM_BYTES_PER_S, work["ops"] / FP32_FLOPS
        waves.append({
            "shape": [C, N], "n_steps": n_steps, "cluster": plan, "ms": ms,
            "ms_per_step": ms / n_steps,
            "plan_vs_one_block_a_lane": ms / ms_by_cluster[1],
            "ms_by_cluster": {str(cs): v for cs, v in ms_by_cluster.items()},
            "max_active_clusters": {str(cs): v for cs, v in resident.items()},
            "held_bit_for_bit_at_every_cluster": N == 16,
            "step_kernel_loop_ms": n_steps * step_ms[(C, N)],
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fraction_of_fp32_peak": t_ops * 1e3 / ms, **work,
        })
    emit("solve_times", kernel="swe_solve",
         timer="one CUDA event pair around 5 back-to-back solves (one wave each), per "
               "solve, median of 5 windows, at every cluster size; plain: one CUDA event "
               "pair around one plain loop",
         waves=waves, library_ms=None, card=smi)
    return {"shapes": shapes, "waves": waves}


def phase_full_solves(torch, dev) -> dict:
    """Whole waves through `TsunamiModel.evaluate_batch` at both levels and
    4, 16, 64 and 512 lanes: each ONE launch of the solve kernel and none of
    the step kernel. At 4, 16 and 64 lanes held bit for bit to the same
    solve on the plain path; at 512 lanes, where the plain path (x 8,899
    steps) would not fit the time limit, to the per-step kernel path
    (`solve_batch(step=swe_step)`, one step-kernel launch a step). The
    16-lane wave of each level also runs the per-step kernel path: the step
    kernel's own path, its launch counts set to 0 just before it and read
    just after."""
    from repro_torch.apps.tsunami import TsunamiModel, level_grid, solve_batch
    from repro_torch.kernels.swe import swe_solve, swe_step, swe_step_ref_into
    from repro_torch.kernels.swe.testing import sources

    model = TsunamiModel(device="cuda")
    out, step_path_launches = {}, 0
    for level, (n_cells, smoothed) in enumerate(((512, True), (2048, False))):
        n_steps = level_grid(n_cells)[1]
        model.evaluate_batch(sources(4, 11), {"level": level})  # warm-up wave
        for lanes in (4, 16, 64, 512):
            thetas = sources(lanes, 11)
            solves, steps = swe_solve.launches, swe_step.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = model.evaluate_batch(thetas, {"level": level})
            wall = time.perf_counter() - t0
            launched = {"swe_solve": swe_solve.launches - solves,
                        "swe_step": swe_step.launches - steps}
            if launched != {"swe_solve": 1, "swe_step": 0}:
                raise AssertionError(f"level {level}, {lanes} lanes: launches {launched} "
                                     "for one wave, expected one of swe_solve")
            if ys.shape != (lanes, 4) or not np.isfinite(ys).all():
                raise AssertionError(f"level {level}: bad output {ys.shape}")
            entry = {
                "level": level, "n_cells": n_cells, "n_steps": n_steps, "lanes": lanes,
                "launches": launched, "wall_s": wall, "evals_per_s": lanes / wall,
                "wall_ms_per_step": wall / n_steps * 1e3,
            }
            t_dev = torch.as_tensor(thetas, device=dev)
            if lanes in (16, 512):
                # every launch count starts at 0 right before the step path
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                per_step = solve_batch(t_dev, n_cells, smoothed,
                                       step=swe_step).cpu().numpy().astype(float)
                entry["per_step_kernel_path_wall_s"] = wall_s = time.perf_counter() - t0
                entry["per_step_kernel_path_evals_per_s"] = lanes / wall_s
                counts = read_launches()
                if counts["swe_step"] != n_steps or sum(counts.values()) != n_steps:
                    raise AssertionError(f"level {level}, {lanes} lanes, per step: "
                                         f"launches {counts}, expected {n_steps} of swe_step")
                np.testing.assert_array_equal(ys, per_step,
                                              err_msg=f"level {level}, {lanes} lanes, per step")
                if lanes == 16:
                    step_path_launches += counts["swe_step"]
            if lanes <= 64:
                t0 = time.perf_counter()
                plain = solve_batch(t_dev, n_cells, smoothed,
                                    step=swe_step_ref_into).cpu().numpy().astype(float)
                entry["plain_wall_s"] = time.perf_counter() - t0
                np.testing.assert_array_equal(ys, plain,
                                              err_msg=f"level {level}, {lanes} lanes")
            out[f"{level}x{lanes}"] = entry
    emit("full_solves", waves=out, step_path_launches=step_path_launches,
         bound="bit for bit: against the plain path at 4, 16 and 64 lanes, against "
               "the per-step kernel path at 16 and 512")
    return {"waves": out, "step_path_launches": step_path_launches}


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
    swe_us, n_kernels, n_solve, n_step = 0.0, 0, 0, 0
    for ev in events:
        cat = ev.get("cat")
        if cat in busy and ev.get("ph") == "X":
            busy[cat] += float(ev.get("dur", 0.0))
            if cat == "kernel":
                n_kernels += 1
                name = ev.get("name", "")
                if "swe_solve" in name:
                    n_solve += 1
                    swe_us += float(ev.get("dur", 0.0))
                n_step += "swe_step" in name
    # the wave is one launch of the solve kernel, by its symbol in the trace
    if n_kernels and (n_solve, n_step) != (1, 0):
        raise AssertionError(f"the trace holds {n_solve} swe_solve and {n_step} swe_step "
                             "kernels for one wave, expected 1 and 0")
    device_us = sum(busy.values())
    # None: not measured. The profiler's host overhead lengthens the wave, so
    # the share is also given against the same wave's unprofiled wall time
    share = device_us / wall_us if n_kernels else None
    emit("profile", wave="coarse, 16 lanes", wall_ms=wall_us / 1e3,
         unprofiled_wall_ms=plain_wall_us / 1e3,
         device_busy_share_unprofiled=device_us / plain_wall_us if n_kernels else None,
         device_busy_ms=device_us / 1e3, swe_solve_kernel_ms=swe_us / 1e3,
         swe_solve_launches_in_trace=n_solve,
         device_kernels=n_kernels, device_busy_share=share,
         device_idle_share=None if share is None else 1.0 - share)
    return {"device_busy_share": share}


def phase_main_path(torch, dev) -> dict:
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.uq.mlda import ensemble_mlda

    model = TsunamiModel()
    _, logprior, loglik, _ = tsunami_problem(torch, model, dev)
    K = 16
    x0s = sources(K, 11).astype(float)
    prop_cov = np.diag([8.0**2, 0.25**2])
    fabric = EvaluationFabric(ModelBackend(model), cache_size=8192)
    try:
        # every launch count starts at 0 right before the main path
        reset_launches()
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
        counts = read_launches()
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
    # every wave the fabric dispatched was one launch of the solve kernel
    launches = counts["swe_solve"]
    if launches != sum(waves.values()) or counts["swe_step"] != 0:
        raise AssertionError(f"kernel launches {counts}, expected {sum(waves.values())} of "
                             f"swe_solve and none of swe_step for waves per level {waves}")
    emit("main_path", chains=K, n_samples=4, subsampling=[5],
         n_waves=res.n_waves, evals_per_level=res.evals_per_level,
         model_solves_per_level=solves, model_waves_per_level=waves,
         accept_rates=res.accept_rates, wall_s=wall, swe_solve_launches=launches,
         launches=counts,
         posterior_mean=res.samples.reshape(-1, 2).mean(0).tolist(),
         backend=tel["backend"])
    return {"launches": launches, "wall_s": wall, "n_waves": res.n_waves,
            "samples": res.samples}


def tsunami_problem(torch, model, dev):
    """The §4.3 inverse problem of the main paths: synthetic data from the
    true source at the fine level, and its Gaussian log-likelihood, the
    likelihood's gradient in the outputs (torch: it rides the fused
    value-and-gradient wave) and the uniform prior."""
    from repro_torch.kernels.swe.testing import SOURCE_BOX

    rng = np.random.default_rng(SEED)
    data = np.asarray(model([list(TRUE_THETA)], {"level": 1})[0])
    data = data + rng.standard_normal(4) * NOISE_SD * 0.5
    (x_lo, x_hi), (a_lo, a_hi) = SOURCE_BOX
    data_t = torch.as_tensor(data, dtype=torch.float32, device=dev)
    var_t = torch.as_tensor(NOISE_SD**2, dtype=torch.float32, device=dev)

    def logprior(theta):
        x0, A = float(theta[0]), float(theta[1])
        return 0.0 if x_lo <= x0 <= x_hi and a_lo <= A <= a_hi else -np.inf

    def loglik(obs):
        return float(-0.5 * np.sum(((np.asarray(obs) - data) / NOISE_SD) ** 2))

    def grad_loglik(y):
        return -(y - data_t) / var_t

    return data, logprior, loglik, grad_loglik


#: time steps of a profiled derivative wave: a whole one traces ~10^6
#: kernels, whose export alone takes minutes
PROFILED_STEPS = 256


def _device_busy(torch, fn, what: str) -> dict:
    """`fn()` under torch.profiler: its profiled wall, and the device's busy
    time (kernels, copies and memsets, summed; one stream, so they never
    overlap) and kernel count from the exported trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    trace = ROOT / "build" / "chip_smoke_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    prof.export_chrome_trace(str(trace))
    busy_us, n_kernels = 0.0, 0
    for ev in json.loads(trace.read_text()).get("traceEvents", []):
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and ev.get("ph") == "X":
            busy_us += float(ev.get("dur", 0.0))
            n_kernels += ev.get("cat") == "kernel"
    trace.unlink()
    if n_kernels == 0:
        raise AssertionError(f"the profiler saw no device kernel in {what}")
    return {"profiled_wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
            "kernels": n_kernels, "trace_seconds": time.perf_counter() - t0}


def _profiled(torch, fn, wall: float, n_steps: int) -> dict:
    """`fn()`, a derivative wave, under torch.profiler with its time loop cut
    to its first `PROFILED_STEPS` steps (every step runs the same kernels
    on the same shapes): the device's busy time a step, its share of the
    cut wave's profiled wall, and its share of `wall`, the whole wave's
    unprofiled wall, as busy a step x `n_steps` over `wall`."""
    from repro_torch.apps import tsunami

    level_grid = tsunami.level_grid
    tsunami.level_grid = lambda n: (*level_grid(n)[:1], PROFILED_STEPS, *level_grid(n)[2:])
    try:
        p = _device_busy(torch, fn, "a derivative wave")
    finally:
        tsunami.level_grid = level_grid
    busy_per_step = p["device_busy_s"] / PROFILED_STEPS
    return {"profiled_steps": PROFILED_STEPS, "profiled_wall_s": p["profiled_wall_s"],
            "device_busy_s": p["device_busy_s"], "device_busy_ms_per_step": busy_per_step * 1e3,
            "device_busy_share": p["device_busy_s"] / p["profiled_wall_s"],
            "device_busy_share_unprofiled": busy_per_step * n_steps / wall,
            "device_kernels_per_step": p["kernels"] / PROFILED_STEPS,
            "trace_seconds": p["trace_seconds"]}


def _derivative_waves_vs_cpu(torch, config, thetas, senss, vecs, card: dict) -> dict:
    """Hold the card's gradient, JVP and HVP rows `card` on (thetas, senss,
    vecs) to `TsunamiModel(device="cpu")` on the same float32 inputs, the
    HVP lane by lane against the float64 HVP (`derivative_errors`); -> the
    errors and the CPU's wall."""
    from repro_torch.apps import tsunami
    from repro_torch.kernels.swe.testing import derivative_errors

    t0 = time.perf_counter()
    cpu = tsunami.TsunamiModel(device="cpu")
    want = {"gradient": cpu.gradient_batch(thetas, senss, config),
            "apply_jacobian": cpu.apply_jacobian_batch(thetas, vecs, config),
            "apply_hessian": cpu.apply_hessian_batch(thetas, senss, vecs, config)}
    level = config["level"]
    f64 = [torch.as_tensor(a.astype(np.float32).astype(float)) for a in (thetas, senss, vecs)]
    hvp64 = tsunami._hvp_batch(*f64, cpu.N_CELLS[level], level == 0).numpy()
    errors = derivative_errors(card, want, hvp64)
    return {"lanes": len(thetas), "errors": errors, "cpu_wall_s": time.perf_counter() - t0}


def phase_derivative_waves(torch, dev, smi: str) -> dict:
    """One fused value-and-gradient wave, one JVP wave and one HVP wave of
    16 lanes at both published levels through `TsunamiModel`: each wave's
    wall, its kernel launches (none: derivative waves run PyTorch ops under
    autograd, as the JAX package's run its scan; the kernel is
    forward-only) and peak device memory; then the same three waves again
    under the profiler, for the device's busy time. Checks: the fused
    wave's primal equals the evaluate wave (one `swe_solve` launch) bit for
    bit; sens.(J v) == (J^T sens).v within the JAX package's bound
    (tests/test_capabilities.py); every value finite; and at the coarse
    level, the card's waves (each step a replayed CUDA graph) on two lanes
    against the same model on the CPU (the eager step the JAX-parity tests
    pin), within the float32 bounds of `kernels.swe.testing` (the fine
    level's CPU waves would take minutes; tests/test_torch_gpu.py holds
    both levels of the small hierarchy)."""
    from repro_torch.apps import tsunami
    from repro_torch.kernels.swe.testing import sources

    class Warm(tsunami.TsunamiModel):
        N_CELLS = {0: 16, 1: 16}

    model = tsunami.TsunamiModel(device="cuda")
    _, _, _, grad_loglik = tsunami_problem(torch, model, dev)
    lanes = 16
    thetas = sources(lanes, 11)
    vecs = np.random.default_rng(SEED).standard_normal((lanes, 2))
    warm = Warm(device="cuda")  # every code path once, at 16 cells
    warm.value_and_gradient_batch(thetas[:2], grad_loglik)
    warm.apply_hessian_batch(thetas[:2], np.ones((2, 4)), vecs[:2])
    out = {}
    for level, n_cells in enumerate(model.N_CELLS.values()):
        c = {"level": level}
        n_steps = tsunami.level_grid(n_cells)[1]
        reset_launches()
        ev = model.evaluate_batch(thetas, c)
        if read_launches()["swe_solve"] != 1:
            raise AssertionError(f"level {level}: the evaluate wave was not one swe_solve launch")
        senss = None  # the HVP's: the likelihood's gradient at the fused wave's outputs
        calls = {
            "value_and_gradient": lambda: model.value_and_gradient_batch(thetas, grad_loglik, c),
            "apply_jacobian": lambda: model.apply_jacobian_batch(thetas, vecs, c),
            "apply_hessian": lambda: model.apply_hessian_batch(thetas, senss, vecs, c),
        }
        waves, results = {}, {}
        for kind, call in calls.items():
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            if sum(launches.values()) != 0:
                raise AssertionError(f"level {level} {kind}: kernel launches {launches}")
            for r in (res if isinstance(res, tuple) else (res,)):
                if not np.isfinite(r).all():
                    raise AssertionError(f"level {level} {kind}: non-finite values")
            results[kind] = res
            if kind == "value_and_gradient":
                ys, gs = res
                # the primal of the derivative wave IS the kernel's wave
                np.testing.assert_array_equal(ys, ev, err_msg=f"level {level}: fused primal")
                senss = (grad_loglik(torch.as_tensor(ys, dtype=torch.float32, device=dev))
                         .cpu().numpy().astype(float))
            waves[kind] = {"wall_s": wall, "ms_per_step": wall / n_steps * 1e3,
                           "launches": launches,
                           "max_memory_allocated": torch.cuda.max_memory_allocated()}
        # VJP/JVP duality through the fused wave's gradient (sens = the
        # likelihood's gradient at the wave's own outputs)
        _, gs = results["value_and_gradient"]
        jv = results["apply_jacobian"]
        lhs, rhs = (jv * senss).sum(1), (gs * vecs).sum(1)
        np.testing.assert_allclose(lhs, rhs, rtol=5e-2, atol=1e-4,
                                   err_msg=f"level {level}: VJP/JVP duality")
        # the device's busy time, one more wave of each kind under the profiler
        for kind, call in calls.items():
            waves[kind]["profile"] = _profiled(torch, call, waves[kind]["wall_s"], n_steps)
        out[level] = {"n_cells": n_cells, "n_steps": n_steps, "lanes": lanes,
                      "duality_max_rel": float(np.max(np.abs(lhs - rhs) / np.maximum(np.abs(rhs), 1e-30))),
                      "primal_equals_evaluate": True, "waves": waves}
        if level == 0:
            out[level]["vs_cpu"] = _derivative_waves_vs_cpu(
                torch, c, thetas[:2], senss[:2], vecs[:2],
                {"gradient": gs[:2], "apply_jacobian": jv[:2],
                 "apply_hessian": results["apply_hessian"][:2]})
        emit("derivative_waves", level=level, **out[level], card=smi)
    return out


def phase_mala_main_path(torch, dev) -> dict:
    """`ensemble_mlda(coarse_sampler="mala")` through
    `EvaluationFabric(ModelBackend(TsunamiModel()))` with `main_path`'s
    settings: every coarse subchain step one fused value-and-gradient wave
    (PyTorch ops), every fine wave one `swe_solve` launch."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.uq.mlda import ensemble_mlda

    model = TsunamiModel()
    _, logprior, loglik, grad_loglik = tsunami_problem(torch, model, dev)
    K = 16
    x0s = sources(K, 11).astype(float)
    fabric = EvaluationFabric(ModelBackend(model), cache_size=8192)
    try:
        # every launch count starts at 0 right before the path
        reset_launches()
        stats0, waves0 = dict(model.stats), dict(model.waves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ensemble_mlda(
            None, x0s, n_samples=4, subsampling=[5], prop_cov=np.diag([4.0, 0.01]),
            rng=np.random.default_rng(501), fabric=fabric,
            level_configs=[{"level": 0}, {"level": 1}], loglik=loglik,
            logprior=logprior, coarse_sampler="mala", mala_step=1.0,
            grad_loglik=grad_loglik, grad_logprior=lambda th: np.zeros(2),
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        tel = fabric.telemetry()
    finally:
        fabric.shutdown()
    evaluate_waves = {lvl: model.waves[lvl] - waves0[lvl] for lvl in (0, 1)}
    solves = {lvl: model.stats[lvl] - stats0[lvl] for lvl in (0, 1)}
    pc = tel["per_capability"]
    vg_waves = pc.get("value_and_gradient", {}).get("waves", 0)
    if not np.isfinite(res.samples).all() or res.samples.shape != (K, 4, 2):
        raise AssertionError(f"bad samples {res.samples.shape}")
    if not all(0.0 < r <= 1.0 for r in res.accept_rates):
        raise AssertionError(f"acceptance rates {res.accept_rates}")
    if vg_waves < 1 or evaluate_waves[0] != 0:
        raise AssertionError(f"level 0: {vg_waves} value-and-gradient waves and "
                             f"{evaluate_waves[0]} evaluate waves, expected >= 1 and 0")
    if counts["swe_solve"] != evaluate_waves[1] or evaluate_waves[1] < 1 or counts["swe_step"]:
        raise AssertionError(f"kernel launches {counts}, expected one swe_solve per fine "
                             f"evaluate wave ({evaluate_waves[1]}) and no swe_step")
    emit("mala_main_path", chains=K, n_samples=4, subsampling=[5], coarse_sampler="mala",
         n_waves=res.n_waves, evals_per_level=res.evals_per_level,
         model_solves_per_level=solves, evaluate_waves_per_level=evaluate_waves,
         value_and_gradient_waves=vg_waves, accept_rates=res.accept_rates, wall_s=wall,
         swe_solve_launches=counts["swe_solve"], launches=counts,
         posterior_mean=res.samples.reshape(-1, 2).mean(0).tolist(),
         per_capability=pc)
    return {"launches": counts["swe_solve"], "wall_s": wall}


def phase_laplace_path(torch, dev) -> dict:
    """`laplace_preview` on the coarse level with both curvature modes
    (benchmarks/second_order.py's settings, 4 iterations): "full" rides the
    HVP waves (reverse-over-forward), "gn" is the Jacobian-only control."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.uq.inference import laplace_preview

    model = TsunamiModel()
    data, *_ = tsunami_problem(torch, model, dev)
    out = {}
    for curvature in ("gn", "full"):
        with EvaluationFabric(ModelBackend(model), cache_size=0) as fab:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = laplace_preview(
                fab, data, np.diag(NOISE_SD**2), TRUE_THETA + [5.0, -0.3],
                np.diag([100.0, 0.25]), curvature=curvature, n_ensemble=4, n_iters=4,
                rng=np.random.default_rng(0), config={"level": 0},
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pc = fab.telemetry()["per_capability"]
        if not np.isfinite(res.mean).all() or not np.isfinite(res.cov).all():
            raise AssertionError(f"{curvature}: non-finite MAP or covariance")
        if not np.allclose(res.cov, res.cov.T) or np.linalg.eigvalsh(res.cov).min() <= 0:
            raise AssertionError(f"{curvature}: covariance not SPD: {res.cov}")
        hessian_waves = pc.get("apply_hessian", {}).get("waves", 0)
        if (hessian_waves > 0) != (curvature == "full"):
            raise AssertionError(f"{curvature}: {hessian_waves} Hessian waves")
        out[curvature] = {"wall_s": wall, "map": res.mean.tolist(),
                          "posterior_sd": np.sqrt(np.diag(res.cov)).tolist(),
                          "n_iters": res.n_iters, "waves": res.waves,
                          "hessian_waves": hessian_waves,
                          "value_grad_waves": pc["value_and_gradient"]["waves"],
                          "jacobian_waves": pc["apply_jacobian"]["waves"]}
    agreement = float(np.max(np.abs(np.asarray(out["full"]["map"]) - out["gn"]["map"])))
    emit("laplace_path", level=0, n_ensemble=4, n_iters=4, **out,
         map_agreement_gn_vs_full=agreement)
    return out


# the GP level of the §4.3 hierarchy (benchmarks/mlda_tsunami.py:131-190):
# a Sobol' design of the coarse level and one GP per observable
GP_TRAIN = 128
GP_ITERS = 250
GP_TEST = 64  # fresh Sobol' points (skip=GP_TRAIN) the GP is scored on
#: bound on a card-fitted GP's predictive mean against the same fit on the
#: CPU, in units of y's standard deviation: `tests/_torch_parity.py::FIT_TOL`,
#: the bound the port's fits are held to against the JAX package's
GP_FIT_TOL = 2e-3
L0, L1 = {"level": 0}, {"level": 1}


def gp_design(n: int, skip: int = 0) -> np.ndarray:
    """[n, 2] points of the Sobol' sequence scrambled with seed `SEED`, over
    the prior box: the GP level's training design (`skip=0`), as
    benchmarks/mlda_tsunami.py builds it."""
    from repro_torch.kernels.swe.testing import SOURCE_BOX
    from repro_torch.uq.qmc import sobol

    u = sobol(n, 2, scramble_seed=SEED, skip=skip)
    (x_lo, x_hi), (a_lo, a_hi) = SOURCE_BOX
    return np.stack([x_lo + u[:, 0] * (x_hi - x_lo), a_lo + u[:, 1] * (a_hi - a_lo)], axis=1)


def gp_outputs(gps):
    """The GP level as a batched model, [K, 2] -> [K, 4]: one `predict` per
    GP for all K points (the reference benchmark predicts point by point;
    tests/test_torch_hierarchy.py shows the two give the same values)."""
    return lambda X: np.stack([gp.predict(X) for gp in gps], axis=1)


def three_level_logposts(gps, ml, loglik, logprior) -> list:
    """The paper's three levels as batched log-posteriors, coarsest first:
    the GP emulator, then the smoothed and the fully resolved SWE through
    the `MultilevelModel` `ml` (and so through its fabric)."""
    from repro_torch.uq.mcmc import batched_logpost

    pde = [batched_logpost(lambda X, lvl=lvl: ml.evaluate_batch(lvl, X), loglik, logprior)
           for lvl in range(ml.n_levels)]
    return [batched_logpost(gp_outputs(gps), loglik, logprior), *pde]


def phase_gp_level(torch, dev) -> dict:
    """The offline GP level: the 128-point design solved as ONE coarse wave
    (one `swe_solve` launch; the reference solves it point by point, to the
    same values), four GPs fitted on the card (250 Adam steps each, one host
    sync a step), their `predict` walls, their error against the coarse
    model on 64 fresh Sobol' points, and one fit held to the same fit on
    the CPU."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.uq.gp import GP

    model = TsunamiModel()
    X = gp_design(GP_TRAIN)
    reset_launches()
    waves0 = dict(model.waves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Y = model.evaluate_batch(X, L0)
    torch.cuda.synchronize()
    design_wall = time.perf_counter() - t0
    counts = read_launches()
    if Y.shape != (GP_TRAIN, 4) or not np.isfinite(Y).all():
        raise AssertionError(f"design wave: shape {Y.shape}, finite {np.isfinite(Y).all()}")
    if counts["swe_solve"] != 1 or counts["swe_step"] or model.waves[0] - waves0[0] != 1:
        raise AssertionError(f"the design is one coarse wave and one swe_solve launch: {counts}")
    gps, fits = [], []
    for j in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp = GP.fit(X, Y[:, j], n_iters=GP_ITERS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if gp.device.type != "cuda" or not (gp._Xt.is_cuda and gp._ls_t.is_cuda):
            raise AssertionError(f"GP {j} is not on the card: {gp.device}")
        gps.append(gp)
        fits.append({"output": j, "wall_s": wall, "steps": gp.fit_steps,
                     "ms_per_step": 1e3 * wall / max(gp.fit_steps, 1),
                     "log_params": gp.log_params.tolist()})
    # one 50-step fit under the profiler: the device's share of a step
    prof = _device_busy(torch, lambda: GP.fit(X, Y[:, 0], n_iters=50, device=dev),
                        "a GP fit")
    profile = {"steps": 50, "profiled_wall_s": prof["profiled_wall_s"],
               "device_busy_ms_per_step": prof["device_busy_s"] / 50 * 1e3,
               "device_busy_share": prof["device_busy_s"] / prof["profiled_wall_s"],
               "kernels_per_step": prof["kernels"] / 50}
    predict = {}
    for Q in (16, 256):
        q = gp_design(Q, skip=GP_TRAIN + GP_TEST)
        for name, fn in (("one_gp", lambda: gps[0].predict(q)),
                         ("one_gp_with_var", lambda: gps[0].predict(q, return_var=True)),
                         ("four_gps", lambda: gp_outputs(gps)(q))):
            fn()
            walls = []
            for _ in range(20):
                t0 = time.perf_counter()
                fn()
                walls.append(time.perf_counter() - t0)
            predict[f"{name}_{Q}_ms"] = 1e3 * statistics.median(walls)
    X_test = gp_design(GP_TEST, skip=GP_TRAIN)
    Y_test = model.evaluate_batch(X_test, L0)
    pred = gp_outputs(gps)(X_test)
    arrival = np.abs(pred[:, [0, 2]] - Y_test[:, [0, 2]])
    height = np.abs(pred[:, [1, 3]] - Y_test[:, [1, 3]]) / np.abs(Y_test[:, [1, 3]])
    height_m = np.abs(pred[:, [1, 3]] - Y_test[:, [1, 3]])
    if not np.isfinite(pred).all():
        raise AssertionError("the GP level predicted non-finite observables")
    # a useful level 0 emulates the coarse level within the data's noise
    rms = np.sqrt(np.mean(np.stack([arrival, height_m]) ** 2, axis=(1, 2)))
    if not (rms < NOISE_SD[:2]).all():
        raise AssertionError(f"GP rms error {rms} (arrival min, height m) exceeds the "
                             f"data noise {NOISE_SD[:2]}")
    # the card's fit against the same fit on the CPU
    t0 = time.perf_counter()
    cpu_gp = GP.fit(X, Y[:, 0], n_iters=GP_ITERS, device="cpu")
    cpu_fit_wall = time.perf_counter() - t0
    vs_cpu = float(np.max(np.abs(gps[0].predict(X_test) - cpu_gp.predict(X_test)))
                   / Y[:, 0].std())
    if vs_cpu > GP_FIT_TOL:
        raise AssertionError(f"card fit vs CPU fit: {vs_cpu} y sd > {GP_FIT_TOL}")
    emit("gp_level", n_train=GP_TRAIN, n_iters=GP_ITERS, design_wave_wall_s=design_wall,
         design_launches=counts, fits=fits, fit_profile=profile, predict=predict,
         error_vs_coarse={"n_points": GP_TEST,
                          "arrival_min_max": arrival.max(0).tolist(),
                          "arrival_min_rms": np.sqrt((arrival**2).mean(0)).tolist(),
                          "height_rel_max": height.max(0).tolist(),
                          "height_rel_rms": np.sqrt((height**2).mean(0)).tolist(),
                          "height_m_rms": np.sqrt((height_m**2).mean(0)).tolist()},
         output_0_vs_cpu_fit_y_sd=vs_cpu, cpu_fit_wall_s=cpu_fit_wall,
         cpu_fit_steps=cpu_gp.fit_steps)
    return {"gps": gps, "launches": counts["swe_solve"]}


def phase_three_level_path(torch, dev, gps) -> dict:
    """The paper's three-level ensemble MLDA (examples/mlda_inversion.py's
    hierarchy: GP <- smoothed <- fully resolved, subsampling [10, 2]), K =
    16 chains: the GP level predicts each step's points in one `predict`
    per GP; the PDE levels go through one `EvaluationFabric` with a
    `MultilevelModel` bound to it, every wave one `swe_solve` launch."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.core.hierarchy import MultilevelModel
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.uq.mlda import ensemble_mlda

    model = TsunamiModel()
    _, logprior, loglik, _ = tsunami_problem(torch, model, dev)
    K = 16
    fabric = EvaluationFabric(ModelBackend(model), cache_size=8192)
    try:
        ml = MultilevelModel(fabric=fabric, configs=[L0, L1])
        lps = three_level_logposts(gps, ml, loglik, logprior)
        reset_launches()
        waves0 = dict(model.waves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ensemble_mlda(lps, sources(K, 11).astype(float), n_samples=4,
                            subsampling=[10, 2], prop_cov=np.diag([8.0**2, 0.25**2]),
                            rng=np.random.default_rng(501))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        report = ml.report()
        tel = fabric.telemetry()
    finally:
        fabric.shutdown()
    waves = {lvl: model.waves[lvl] - waves0[lvl] for lvl in (0, 1)}
    if not np.isfinite(res.samples).all() or res.samples.shape != (K, 4, 2):
        raise AssertionError(f"bad samples {res.samples.shape}")
    if not all(0.0 < r <= 1.0 for r in res.accept_rates):
        raise AssertionError(f"acceptance rates {res.accept_rates}")
    if min(waves.values()) <= 0 or sum(waves.values()) != tel["backend"]["native_batches"]:
        raise AssertionError(f"model waves per level {waves}, backend {tel['backend']}")
    if counts["swe_solve"] != sum(waves.values()) or counts["swe_step"]:
        raise AssertionError(f"kernel launches {counts}, expected {sum(waves.values())} of "
                             f"swe_solve and none of swe_step")
    if report["counts"] != [lp.points_evaluated for lp in lps[1:]]:
        raise AssertionError(f"MultilevelModel counts {report['counts']}")
    emit("three_level_path", chains=K, n_samples=4, subsampling=[10, 2], wall_s=wall,
         n_waves=res.n_waves, evals_per_level=res.evals_per_level,
         gp_level_points=lps[0].points_evaluated, model_waves_per_level=waves,
         multilevel_report=report, accept_rates=res.accept_rates,
         swe_solve_launches=counts["swe_solve"], launches=counts,
         posterior_mean=res.samples.reshape(-1, 2).mean(0).tolist(), backend=tel["backend"])
    return {"launches": counts["swe_solve"]}


def _pooled_min_ess(samples: np.ndarray) -> float:
    """Per-chain ESS summed over chains, the least over dimensions
    (benchmarks/grad_mcmc.py)."""
    from repro_torch.uq.mcmc import effective_sample_size

    K, _, d = samples.shape
    return float(min(sum(effective_sample_size(samples[k, :, j]) for k in range(K))
                     for j in range(d)))


def phase_surrogate_da_path(torch, dev) -> dict:
    """benchmarks/surrogate_da.py's quick run at the published widths: 8
    chains, 40 lockstep RWM warm-up steps on the coarse level, then two-level
    `ensemble_mlda` with subsampling 5 for 40 fine steps, once blind and once
    behind a GP screen (`SurrogateScreen.from_fabric`, on the card) trained
    by the warm-up's own coarse waves and frozen before the measured run."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.swe.testing import SOURCE_BOX
    from repro_torch.uq.mcmc import batched_logpost, ensemble_random_walk_metropolis
    from repro_torch.uq.mlda import ensemble_mlda
    from repro_torch.uq.surrogate import SurrogateScreen

    model = TsunamiModel()
    _, logprior, loglik, _ = tsunami_problem(torch, model, dev)
    n_chains, n_warm, n_fine, sub = 8, 40, 40, 5
    prop_cov = np.diag([8.0**2, 0.25**2])
    out, launches = {}, 0
    for run in ("blind", "screened"):
        fab = EvaluationFabric(ModelBackend(model), cache_size=8192)
        fab.label_config(L0, "coarse")
        fab.label_config(L1, "fine")
        try:
            screen = None
            if run == "screened":
                screen = SurrogateScreen.from_fabric(
                    fab, target=lambda th, y: loglik(y), config=L0, logprior=logprior,
                    window=256, min_train=48, hyper_iters=120, refit_every=64)
            rng = np.random.default_rng(11)
            x0s = np.stack([rng.uniform(*SOURCE_BOX[0], n_chains),
                            rng.uniform(*SOURCE_BOX[1], n_chains)], axis=1)
            reset_launches()
            waves0 = dict(model.waves)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            burn = ensemble_random_walk_metropolis(
                batched_logpost(fab, loglik, logprior, L0), x0s, n_warm,
                (2.38**2 / 2) * prop_cov, rng)
            torch.cuda.synchronize()
            warm_wall = time.perf_counter() - t0
            warm_counts = read_launches()
            warm_waves = model.waves[0] - waves0[0]
            if warm_counts["swe_solve"] != warm_waves or warm_counts["swe_step"]:
                raise AssertionError(f"warm-up: {warm_counts} for {warm_waves} waves")
            if screen is not None:
                if not screen.active:
                    raise AssertionError(f"warm-up traffic ({screen.store.n_points} points) "
                                         "did not reach min_train")
                screen.freeze()
                trained = screen.store.n_points
                if not screen.gp.frozen:
                    raise AssertionError("the screen did not freeze")
            pre = {k: dict(v) for k, v in fab.telemetry()["per_label"].items()}
            reset_launches()
            waves0 = dict(model.waves)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ensemble_mlda(
                None, burn.samples[:, -1, :], n_fine, [sub], prop_cov,
                np.random.default_rng(100), fabric=fab, loglik=loglik, logprior=logprior,
                level_configs=[L0, L1], surrogate=screen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            tel = fab.telemetry()
        finally:
            fab.shutdown()
        waves = {lvl: model.waves[lvl] - waves0[lvl] for lvl in (0, 1)}
        if counts["swe_solve"] != sum(waves.values()) or counts["swe_step"]:
            raise AssertionError(f"{run}: kernel launches {counts} for waves {waves}")
        if not np.isfinite(res.samples).all() or res.samples.shape != (n_chains, n_fine, 2):
            raise AssertionError(f"{run}: bad samples {res.samples.shape}")
        launches += counts["swe_solve"]
        coarse = tel["per_label"]["coarse"]["points"] - pre["coarse"]["points"]
        fine = tel["per_label"]["fine"]["points"] - pre["fine"]["points"]
        ess = _pooled_min_ess(res.samples)
        out[run] = {"wall_s": wall, "warm_up_wall_s": warm_wall, "warm_up_waves": warm_waves,
                    "coarse_model_points": coarse, "fine_model_points": fine,
                    "model_waves_per_level": waves, "n_waves": res.n_waves,
                    "coarse_evals_requested": res.evals_per_level[0], "ess": ess,
                    "coarse_points_per_ess": coarse / max(ess, 1e-9),
                    "accept_rates": res.accept_rates, "swe_solve_launches": counts["swe_solve"],
                    "posterior_mean": res.samples.reshape(-1, 2).mean(0).tolist()}
        if screen is not None:
            s = screen.stats()
            if not s["screened"] or s["pass_rate"] is None or not 0.0 < s["pass_rate"] < 1.0:
                raise AssertionError(f"the frozen screen screened nothing useful: {s}")
            # the GP took the warm-up's tap traffic and nothing after freeze()
            if s["gp"]["n_seen"] != trained or s["gp"]["hyper_fits"] < 1:
                raise AssertionError(f"the screen's GP saw {s['gp']['n_seen']} points, the "
                                     f"warm-up's tap {trained}: {s}")
            out[run]["screen"] = {k: s[k] for k in ("screened", "passed", "pass_rate", "skipped")}
            out[run]["gp"] = s["gp"]
            out[run]["store"] = s["store"]
            out[run]["fabric_screen_pass_rate"] = tel["screen_pass_rate"]
    emit("surrogate_da_path", chains=n_chains, warm_up_steps=n_warm, fine_steps=n_fine,
         subsampling=[sub], **out,
         coarse_points_per_ess_ratio=out["blind"]["coarse_points_per_ess"]
         / max(out["screened"]["coarse_points_per_ess"], 1e-9))
    return {"launches": launches}


# fused sampler blocks (`uq.fused`), as benchmarks/fused_sampler.py measures
# them: its Gaussian (d = 4, K = 8, S = 200) and the tsunami posterior at the
# coarse level (512 cells, smoothed; K = 16, S = 50) with the main path's
# data, noise, prior box and proposal
FUSED_GAUSS_D, FUSED_GAUSS_K, FUSED_GAUSS_S = 4, 8, 200
FUSED_TSUNAMI_K, FUSED_TSUNAMI_S = 16, 50
MAIN_PROP_COV = np.diag([8.0**2, 0.25**2])


def _generator(torch, dev, seed: int):
    return torch.Generator(device=dev).manual_seed(seed)


def coarse_target(torch, model, dev, step=None):
    """The coarse level's posterior as a tensor program: the Gaussian
    likelihood of `tsunami_problem`'s data over `solve_batch` at 512 cells
    (smoothed) and the prior box; `step=` as in `solve_batch`."""
    from functools import partial

    from repro_torch.apps.tsunami import solve_batch
    from repro_torch.kernels.swe.testing import SOURCE_BOX
    from repro_torch.uq.fused import gaussian_likelihood_target

    data, logprior, loglik, _ = tsunami_problem(torch, model, dev)
    forward = partial(solve_batch, n_cells=512, smoothed=True, step=step)
    return gaussian_likelihood_target(forward, data, NOISE_SD, SOURCE_BOX), logprior, loglik


def _timed(torch, fn):
    """(wall of fn() ending in a device sync, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _fused_vs_per_step_vs_host(torch, dev, lp, host_lp, x0s, cov, S, n_fused, n_per_step,
                               n_host, what: str) -> dict:
    """Steps/s of the fused block (n_fused steps), the per-step reference
    (`per_step=True`, n_per_step steps) and the host loop through
    `ensemble_random_walk_metropolis` over `host_lp` (n_host steps), each
    after a warm call (the capture); the fused and per-step samples of the
    same stream held equal bit for bit. Launch counts start at 0 right
    before the timed fused run."""
    from repro_torch.uq.fused import fused_ensemble_rwm
    from repro_torch.uq.mcmc import ensemble_random_walk_metropolis

    def fused(n, per_step=False, seed=0):
        return fused_ensemble_rwm(lp, x0s, n, cov, _generator(torch, dev, seed),
                                  fused_steps=S, per_step=per_step)

    fused(S)  # warm: the capture of the S-step graph
    fused(1, per_step=True)  # and of the one-step graph
    reset_launches()
    fused_wall, got = _timed(torch, lambda: fused(n_fused))
    counts = read_launches()
    per_wall, want = _timed(torch, lambda: fused(n_per_step, per_step=True))
    n = min(n_fused, n_per_step)
    for name in ("samples", "logposts"):
        np.testing.assert_array_equal(getattr(got, name)[:, :n], getattr(want, name)[:, :n],
                                      err_msg=f"{what}: fused vs per-step {name}")
    if not np.isfinite(got.samples).all() or not np.all(got.accept_rates > 0):
        raise AssertionError(f"{what}: accept rates {got.accept_rates}")
    ensemble_random_walk_metropolis(host_lp, x0s, 2, cov, np.random.default_rng(0))
    host_wall, _ = _timed(torch, lambda: ensemble_random_walk_metropolis(
        host_lp, x0s, n_host, cov, np.random.default_rng(0)))
    rates = {"fused": n_fused / fused_wall, "per_step": n_per_step / per_wall,
             "host_fabric": n_host / host_wall}
    return {"fused_steps": S, "chains": len(x0s), "n_steps": {"fused": n_fused,
            "per_step": n_per_step, "host_fabric": n_host},
            "walls_s": {"fused": fused_wall, "per_step": per_wall, "host_fabric": host_wall},
            "steps_per_s": rates,
            "speedup_vs_per_step": rates["fused"] / rates["per_step"],
            "speedup_vs_host_fabric": rates["fused"] / rates["host_fabric"],
            "fused_launches": counts, "accept_rate": got.accept_rate,
            "bitexact_steps": n}


def phase_fused_sampler(torch, dev) -> dict:
    """benchmarks/fused_sampler.py's two posteriors on the card: steps/s of
    the fused block (S steps a CUDA-graph replay), the per-step reference
    (the same body, S = 1, a replay and a host pull a step) and the host
    loop over an `EvaluationFabric`; fused == per-step bit for bit; on the
    tsunami, `swe_solve` launches == blocks x S + the initial wave, none of
    `swe_step`; and the device's busy share over one profiled block."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.uq.fused import fused_ensemble_rwm, gaussian_target
    from repro_torch.uq.mcmc import batched_logpost

    d, K, S = FUSED_GAUSS_D, FUSED_GAUSS_K, FUSED_GAUSS_S
    lp = gaussian_target(np.ones(d))

    def gauss_batch(thetas, cfg=None):
        xs = torch.as_tensor(np.atleast_2d(thetas), dtype=torch.float32, device=dev)
        return lp(xs).cpu().numpy()[:, None]

    fabric = EvaluationFabric(gauss_batch)
    try:
        gauss = _fused_vs_per_step_vs_host(
            torch, dev, lp, batched_logpost(fabric, lambda y: float(np.ravel(y)[0])),
            np.random.default_rng(0).normal(size=(K, d)), (2.4**2 / d) * np.eye(d), S,
            n_fused=10 * S, n_per_step=2 * S, n_host=2 * S, what="gaussian")
    finally:
        fabric.shutdown()

    model = TsunamiModel()
    lp_t, logprior, loglik = coarse_target(torch, model, dev)
    S, x0t = FUSED_TSUNAMI_S, sources(FUSED_TSUNAMI_K, 11).astype(float)
    fabric = EvaluationFabric(ModelBackend(model), cache_size=8192)
    try:
        tsunami = _fused_vs_per_step_vs_host(
            torch, dev, lp_t, batched_logpost(fabric, loglik, logprior, L0), x0t,
            MAIN_PROP_COV, S, n_fused=2 * S, n_per_step=2 * S, n_host=S, what="tsunami")
    finally:
        fabric.shutdown()
    counts = tsunami["fused_launches"]
    want = {"swe_solve": 2 * S + 1, "swe_step": 0}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"tsunami fused run: launches {counts}, expected {want} "
                             f"(2 blocks x {S} steps + the initial wave)")
    busy = _device_busy(torch, lambda: fused_ensemble_rwm(
        lp_t, x0t, S, MAIN_PROP_COV, _generator(torch, dev, 1), fused_steps=S),
        "a fused block")
    tsunami["profiled_block"] = {**busy, "device_busy_share":
                                 busy["device_busy_s"] / busy["profiled_wall_s"]}
    emit("fused_sampler", gaussian=gauss, tsunami_coarse=tsunami,
         timer="host clock around a whole run ending in a device sync (the "
               "initial wave and the host pulls included), after a warm run")
    return {"launches": counts["swe_solve"], "gaussian": gauss, "tsunami": tsunami}


def phase_fused_kernel_vs_plain(torch, dev) -> dict:
    """The solve kernel inside the fused path against its plain version:
    two fused RWM steps of 16 lanes at the coarse level from one generator
    state, once as a captured block over `solve_batch` (the kernel, in the
    graph) and once as the same step body run eagerly over
    `solve_batch(..., step=swe_step_ref_into)` (the plain loop). Samples,
    log-densities and accept counts equal bit for bit: the kernel equals
    the plain loop bit for bit, and the graph draws what the eager body
    draws from the same generator state."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.kernels.swe import swe_step_ref_into
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.uq.fused import _rwm_step, fused_ensemble_rwm

    model = TsunamiModel()
    lp_kernel, _, _ = coarse_target(torch, model, dev)
    lp_plain, _, _ = coarse_target(torch, model, dev, step=swe_step_ref_into)
    x0t, n = sources(FUSED_TSUNAMI_K, 11).astype(float), 2
    got = fused_ensemble_rwm(lp_kernel, x0t, n, MAIN_PROP_COV, _generator(torch, dev, 7),
                             fused_steps=n)
    t0 = time.perf_counter()
    gen = _generator(torch, dev, 7)
    step = _rwm_step(lp_plain, np.linalg.cholesky(MAIN_PROP_COV), dev)
    xs = torch.as_tensor(x0t, dtype=torch.float32, device=dev)
    carry = {"xs": xs, "lps": lp_plain(xs), "acc": torch.zeros_like(xs[:, 0])}
    samples, lps = [], []
    for _ in range(n):
        carry, (xs, lp) = step(carry, gen)
        samples.append(xs.cpu().numpy())
        lps.append(lp.cpu().numpy())
    plain_wall = time.perf_counter() - t0
    plain_samples = np.stack(samples, 1).astype(float)
    err = float(np.max(np.abs(got.samples - plain_samples)))
    np.testing.assert_array_equal(got.samples, plain_samples,
                                  err_msg="fused samples, kernel vs plain")
    np.testing.assert_array_equal(got.logposts, np.stack(lps, 1).astype(float),
                                  err_msg="fused log-densities, kernel vs plain")
    np.testing.assert_array_equal(got.accept_rates * n, carry["acc"].cpu().numpy(),
                                  err_msg="fused accept counts, kernel vs plain")
    emit("fused_kernel_vs_plain", kernel="swe_solve", steps=n, chains=len(x0t),
         bound="bit for bit (samples, log-densities, accept counts)",
         accepted=carry["acc"].cpu().numpy().tolist(), max_abs_err=err,
         plain_wall_s=plain_wall)
    return {"max_abs_err": err}


def phase_fused_main_path(torch, dev, main_path: dict) -> dict:
    """`main_path`'s campaign (K = 16, 4 fine samples, subsampling [5],
    rng 501) with `fused_level0=` the coarse level's tensor-program
    posterior: each coarse subchain one wave for its start log-densities
    plus one 5-step block (a graph replay), the fine waves through the
    fabric. `swe_solve` launches == fine waves + 4 x (1 + 5) + the
    capture's 5-step warm-up."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.uq.mlda import ensemble_mlda

    model = TsunamiModel()
    lp_coarse, logprior, loglik = coarse_target(torch, model, dev)
    K, n_samples, sub = 16, 4, 5
    fabric = EvaluationFabric(ModelBackend(model), cache_size=8192)
    try:
        reset_launches()
        waves0 = dict(model.waves)
        wall, res = _timed(torch, lambda: ensemble_mlda(
            None, sources(K, 11).astype(float), n_samples=n_samples, subsampling=[sub],
            prop_cov=MAIN_PROP_COV, rng=np.random.default_rng(501), fabric=fabric,
            level_configs=[L0, L1], loglik=loglik, logprior=logprior,
            fused_level0=lp_coarse))
        counts = read_launches()
    finally:
        fabric.shutdown()
    waves = {lvl: model.waves[lvl] - waves0[lvl] for lvl in (0, 1)}
    if not np.isfinite(res.samples).all() or res.samples.shape != (K, n_samples, 2):
        raise AssertionError(f"bad samples {res.samples.shape}")
    if not all(0.0 < r <= 1.0 for r in res.accept_rates):
        raise AssertionError(f"acceptance rates {res.accept_rates}")
    want = waves[1] + n_samples * (1 + sub) + sub
    if waves[0] != 0 or counts["swe_solve"] != want or counts["swe_step"]:
        raise AssertionError(f"kernel launches {counts} for model waves {waves}, expected "
                             f"{want} of swe_solve and no coarse fabric wave")
    emit("fused_main_path", chains=K, n_samples=n_samples, subsampling=[sub], wall_s=wall,
         n_waves=res.n_waves, evals_per_level=res.evals_per_level,
         model_waves_per_level=waves, accept_rates=res.accept_rates,
         swe_solve_launches=counts["swe_solve"], launches=counts,
         posterior_mean=res.samples.reshape(-1, 2).mean(0).tolist(),
         main_path={"wall_s": main_path["wall_s"], "n_waves": main_path["n_waves"],
                    "swe_solve_launches": main_path["launches"]})
    return {"launches": counts["swe_solve"], "wall_s": wall}


class _Preempted(RuntimeError):
    """The simulated kill of `phase_fused_checkpoint`."""


def phase_fused_checkpoint(torch, dev) -> dict:
    """tests/test_fused.py's MALA kill-and-resume on the card (S = 5, 20
    adaptation steps, a save every 10 steps, killed after the second): the
    resumed run gives the uninterrupted run's samples, log-densities and
    adapted step size bit for bit; and the fused MALA block equals its
    per-step reference bit for bit."""
    import shutil

    from repro_torch.core.fleet import CampaignCheckpoint
    from repro_torch.uq.fused import fused_ensemble_mala, gaussian_target

    mean, cov = np.array([1.0, -0.5]), np.array([[0.8, 0.3], [0.3, 0.5]])
    lp = gaussian_target(mean, cov)
    x0s = np.random.default_rng(3).normal(size=(6, 2))
    kw = dict(fused_steps=5, adapt_steps=20, precond=cov)
    want = fused_ensemble_mala(lp, x0s, 40, 0.6, _generator(torch, dev, 23), **kw)
    per_step = fused_ensemble_mala(lp, x0s, 40, 0.6, _generator(torch, dev, 23),
                                   per_step=True, **kw)
    np.testing.assert_array_equal(want.samples, per_step.samples, err_msg="MALA per step")
    if want.final_step_size != per_step.final_step_size:
        raise AssertionError("MALA's adapted step size differs per step")
    where = ROOT / "build" / "fused_checkpoint"
    shutil.rmtree(where, ignore_errors=True)

    class DieAfter:
        def __init__(self, ckpt, n):
            self.ckpt, self.n, self.saves = ckpt, n, 0

        def resume(self):
            return self.ckpt.resume()

        def save(self, step, arrays, meta):
            self.ckpt.save(step, arrays, meta)
            self.saves += 1
            if self.saves >= self.n:
                raise _Preempted("simulated preemption")

    try:
        fused_ensemble_mala(lp, x0s, 40, 0.6, _generator(torch, dev, 23),
                            checkpoint=DieAfter(CampaignCheckpoint(str(where)), 2),
                            checkpoint_every=10, **kw)
        raise AssertionError("the campaign was not killed")
    except _Preempted:
        pass
    _, meta, step = CampaignCheckpoint(str(where)).resume()
    got = fused_ensemble_mala(lp, x0s, 40, 0.6, _generator(torch, dev, 999),
                              checkpoint=CampaignCheckpoint(str(where)),
                              checkpoint_every=10, **kw)
    shutil.rmtree(where)
    np.testing.assert_array_equal(got.samples, want.samples, err_msg="resumed samples")
    np.testing.assert_array_equal(got.logposts, want.logposts, err_msg="resumed lps")
    if got.final_step_size != want.final_step_size:
        raise AssertionError(f"resumed step size {got.final_step_size}, "
                             f"uninterrupted {want.final_step_size}")
    emit("fused_checkpoint", sampler="mala", fused_steps=5, n_steps=40, resumed_at=step,
         key_device=meta["key_device"], final_step_size=got.final_step_size,
         bound="bit for bit (samples, log-densities, step size; and fused == per step)")
    return {}


# -- the wire, the service tier and the fleet (UM-Bridge over HTTP) -------------


def _serve(*models):
    """A port server in this process on a free port (port 0, read back):
    (server, its URL). The models pick the device: on the card here."""
    from repro_torch.core.server import serve_models

    server, _ = serve_models(list(models), 0, background=True)
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(servers) -> None:
    for server, _ in servers:
        server.shutdown()
        server.server_close()


def _get_json(url: str, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=30.0) as resp:
        return json.loads(resp.read())


def _assert_no_server_errors(urls) -> list:
    """Every server's `stats` from `/Health`: a model exception (a CUDA
    fault included) answers HTTP 400 and counts in `errors`, so a fault
    must not hide in that counter."""
    stats = [_get_json(url, "/Health")["stats"] for url in urls]
    if any(st["errors"] for st in stats):
        raise AssertionError(f"server errors: {dict(zip(urls, stats))}")
    return stats


def _main_path_campaign(fabric, logprior, loglik, seed: int = 501):
    """`main_path`'s campaign (K = 16 chains from `sources(16, 11)`, 4 fine
    samples, subsampling [5], `rng=default_rng(seed)`) on any evaluator."""
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.uq.mlda import ensemble_mlda

    return ensemble_mlda(
        None, sources(16, 11).astype(float), n_samples=4, subsampling=[5],
        prop_cov=MAIN_PROP_COV, rng=np.random.default_rng(seed), fabric=fabric,
        level_configs=[L0, L1], loglik=loglik, logprior=logprior,
    )


def _waves(models) -> list:
    return [dict(m.waves) for m in models]


def _waves_since(models, before) -> list:
    return [{lvl: m.waves[lvl] - b[lvl] for lvl in (0, 1)} for m, b in zip(models, before)]


def _join(threads, what: str, timeout_s: float = 600.0) -> None:
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{what}: threads still running after {timeout_s} s")


def _same_bits(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = (np.abs(got - want).max() if got.shape == want.shape else "shape")
        raise AssertionError(f"{what}: not bit for bit ({got.shape} vs {want.shape}, "
                             f"max abs diff {diff})")


def _two_waves_side_by_side(torch, model, repeats: int = 10) -> dict:
    """Median wall of two 16-lane coarse waves (16 of the card's SMs each):
    one after the other; from two threads on the legacy default stream, as
    two servers in one process run them; from two threads each on its own
    stream; and from one thread on device tensors, on one stream and on two.
    Measures whether the waves could overlap; the servers keep the default
    stream."""
    from repro_torch.apps.tsunami import solve_batch
    from repro_torch.kernels.swe.testing import sources

    thetas = [sources(16, 41 + i).astype(float) for i in (0, 1)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    want = [model.evaluate_batch(t, L0) for t in thetas]

    def wave(i, stream):
        if stream is None:
            return model.evaluate_batch(thetas[i], L0)
        with torch.cuda.stream(stream):
            return model.evaluate_batch(thetas[i], L0)

    def in_threads(own_streams: bool):
        out = [None, None]

        def run(i):
            out[i] = wave(i, streams[i] if own_streams else None)

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        _join(threads, "side-by-side waves")
        return out

    # the same two waves from one thread with no host copy in between
    # (`solve_batch` on device tensors): whether the card overlaps them at all
    on_card = [torch.as_tensor(t, dtype=torch.float32, device="cuda") for t in thetas]

    def device_waves(own_streams: bool):
        out = []
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        for i in (0, 1):
            with torch.cuda.stream(streams[i] if own_streams else torch.cuda.current_stream()):
                out.append(solve_batch(on_card[i], 512, True))
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        return [o.cpu().numpy().astype(float) for o in out]

    ways = {"serial": lambda: [wave(0, None), wave(1, None)],
            "threads_default_stream": lambda: in_threads(False),
            "threads_own_streams": lambda: in_threads(True),
            "device_serial": lambda: device_waves(False),
            "device_two_streams": lambda: device_waves(True)}
    walls = {}
    for name, fn in ways.items():
        fn()  # warm
        ts = []
        for _ in range(repeats):
            wall, out = _timed(torch, fn)
            ts.append(wall)
            for i in (0, 1):
                _same_bits(out[i], want[i], f"side-by-side waves ({name})")
        walls[name + "_ms"] = 1e3 * statistics.median(ts)
    return walls


def _wire_fixed_cost(url: str, calls: int = 50) -> dict:
    """Median ms of what every request pays before any model work: a TCP
    connect and close to the server (the client opens one connection per
    request, as the reference's does), and a whole POST /OutputSizes round
    trip (connect, handler thread, JSON both ways)."""
    import socket
    from urllib.parse import urlsplit

    from repro_torch.core.client import _post

    where = urlsplit(url)
    connect, post = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        socket.create_connection((where.hostname, where.port), timeout=10.0).close()
        t1 = time.perf_counter()
        _post(url, "/OutputSizes", {"name": "forward"})
        connect.append(t1 - t0)
        post.append(time.perf_counter() - t1)
    return {"connect_close_ms": 1e3 * statistics.median(connect),
            "post_output_sizes_ms": 1e3 * statistics.median(post)}


#: lanes of the timed /EvaluateBatch calls, and calls per width and level
WIRE_LANES = (16, 64, 512)
WIRE_CALLS = 50


def phase_wire_main_path(torch, dev, main_path: dict) -> dict:
    """The §4.3 campaign through the wire: two port servers in this process
    on the card, each with its own `TsunamiModel`. `main_path`'s campaign
    runs (a) through `EvaluationFabric(HTTPBackend([url0]))` and (b)
    through `EvaluationFabric(register_servers([url0, url1]))`, a router
    over both; each gives `main_path`'s samples bit for bit (JSON carries
    float64 by repr, and a lane of `swe_solve` does not depend on its
    wave), and `swe_solve` launches == the waves the servers' models
    solved. Then /EvaluateBatch timed against the in-process wave at 16, 64
    and 512 lanes per level, a 16-lane coarse /GradientBatch and
    /ApplyJacobianBatch == the in-process waves, and the same
    /GradientBatch from two client threads at once == the serial one."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.client import HTTPModel, probe_health, register_servers
    from repro_torch.core.fabric import EvaluationFabric, HTTPBackend
    from repro_torch.kernels.swe.testing import sources

    models = [TsunamiModel(), TsunamiModel()]
    servers = [_serve(m) for m in models]
    urls = [url for _, url in servers]
    try:
        _, logprior, loglik, _ = tsunami_problem(torch, TsunamiModel(), dev)
        caps = TsunamiModel().capabilities().to_json()
        for url in urls:
            doc = probe_health(url)
            if (doc is None or doc["status"] != "ok" or doc["models"] != ["forward"]
                    or doc["capabilities"] != {"forward": caps}):
                raise AssertionError(f"/Health of {url}: {doc}")
            if HTTPModel(url).capabilities().to_json() != caps:  # /ModelInfo
                raise AssertionError(f"/ModelInfo of {url} is not {caps}")
        runs = {}
        for name, make in (("http_backend", lambda: HTTPBackend([urls[0]])),
                           ("router", lambda: register_servers(urls))):
            backend = make()
            clients = backend.clients if name == "http_backend" else [
                c for b in backend for c in b.clients]
            trips0 = sum(c.round_trips for c in clients)
            fabric = EvaluationFabric(backend, cache_size=8192)
            try:
                # every launch count starts at 0 right before the path
                reset_launches()
                waves0 = _waves(models)
                wall, res = _timed(torch, lambda: _main_path_campaign(fabric, logprior, loglik))
                counts = read_launches()
                tel = fabric.telemetry()
            finally:
                fabric.shutdown()
            waves = _waves_since(models, waves0)
            n_waves = sum(sum(w.values()) for w in waves)
            _same_bits(res.samples, main_path["samples"], f"wire campaign ({name})")
            if counts["swe_solve"] != n_waves or counts["swe_step"] != 0:
                raise AssertionError(f"{name}: kernel launches {counts}, expected {n_waves} "
                                     f"of swe_solve (server waves {waves}) and no swe_step")
            trips = sum(c.round_trips for c in clients) - trips0
            runs[name] = dict(wall_s=wall, round_trips=trips, n_waves=res.n_waves,
                              waves_per_server=waves, swe_solve_launches=counts["swe_solve"],
                              launches=counts,
                              wire_s_per_round_trip=(wall - main_path["wall_s"]) / trips,
                              router=({k: tel["backend"][k] for k in ("waves", "steals")}
                                      if name == "router" else None))
        # the wire's cost per call: /EvaluateBatch against the in-process wave
        # on the same model, interleaved call by call
        client, model = HTTPModel(urls[0]), models[0]
        timing = []
        for cfg in (L0, L1):
            for n in WIRE_LANES:
                thetas = sources(n, 100 + n).astype(float)
                _same_bits(client.evaluate_batch(thetas, cfg), model.evaluate_batch(thetas, cfg),
                           f"/EvaluateBatch at {n} lanes, level {cfg['level']}")
                wire_s, local_s = [], []
                for _ in range(WIRE_CALLS):
                    t0 = time.perf_counter()
                    client.evaluate_batch(thetas, cfg)
                    t1 = time.perf_counter()
                    model.evaluate_batch(thetas, cfg)
                    local_s.append(time.perf_counter() - t1)
                    wire_s.append(t1 - t0)
                timing.append(dict(
                    level=cfg["level"], lanes=n, calls=WIRE_CALLS,
                    evals_per_s_wire=n * WIRE_CALLS / sum(wire_s),
                    evals_per_s_in_process=n * WIRE_CALLS / sum(local_s),
                    median_wire_ms=1e3 * statistics.median(wire_s),
                    median_in_process_ms=1e3 * statistics.median(local_s),
                    median_wire_cost_ms=1e3 * statistics.median(
                        w - l for w, l in zip(wire_s, local_s))))
        side_by_side = _two_waves_side_by_side(torch, model)
        fixed_cost = _wire_fixed_cost(urls[1])
        # derivative waves over the wire, serial and from two threads at once
        rng = np.random.default_rng(17)
        thetas = sources(16, 7).astype(float)
        senss, vecs = rng.standard_normal((16, 4)), rng.standard_normal((16, 2))
        want_g = model.gradient_batch(thetas, senss, L0)
        want_j = model.apply_jacobian_batch(thetas, vecs, L0)
        t0 = time.perf_counter()
        got_g = client.gradient_batch(thetas, senss, L0)
        grad_wall = time.perf_counter() - t0
        _same_bits(got_g, want_g, "/GradientBatch")
        _same_bits(client.apply_jacobian_batch(thetas, vecs, L0), want_j, "/ApplyJacobianBatch")
        both, errors = [None, None], []

        def send(i):
            try:
                both[i] = HTTPModel(urls[0]).gradient_batch(thetas, senss, L0)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        _join(threads, "concurrent /GradientBatch")
        concurrent_wall = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"concurrent /GradientBatch: {errors}")
        for i in (0, 1):
            _same_bits(both[i], want_g, f"concurrent /GradientBatch, thread {i}")
        stats = _assert_no_server_errors(urls)
    finally:
        _stop(servers)
    emit("wire_main_path", servers=2, runs=runs, main_path_wall_s=main_path["wall_s"],
         evaluate_batch_timing=timing, wire_fixed_cost=fixed_cost,
         two_coarse_waves=side_by_side,
         gradient_batch_16_wall_s=grad_wall,
         concurrent_gradient_batch_wall_s=concurrent_wall, server_stats=stats,
         bound="bit for bit (samples == main_path's; derivative waves == in-process; "
               "concurrent == serial)")
    return {"launches": runs["router"]["swe_solve_launches"],
            "launches_http_backend": runs["http_backend"]["swe_solve_launches"], "runs": runs}


#: the two tenants of `service_path`: priority, DRR weight, campaign rng seed
SERVICE_TENANTS = {"alice": ("high", 2.0, 601), "bob": ("low", 1.0, 602)}


def phase_service_path(torch, dev) -> dict:
    """A `UQService` over the router of two port servers runs two tenants at
    once (priorities high and low, weights 2 : 1), each `main_path`'s
    campaign with its own rng seed in its own thread. Each campaign's
    samples == its solo in-process run's bit for bit. The service stamps
    its wire requests with one identity (`X-UQ-Tenant: uq-service`; the
    fabric's per-tenant identity does not reach the HTTP client, in either
    package): each tenant's points charged == its fabric accounting (cache
    hits + misses + coalesced), and the points the fabric dispatched == the
    servers' /Tenants points == the models' solves."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.client import register_servers
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.core.service import UQService

    _, logprior, loglik, _ = tsunami_problem(torch, TsunamiModel(), dev)
    solo = {}
    for tenant, (_, _, seed) in SERVICE_TENANTS.items():
        fabric = EvaluationFabric(ModelBackend(TsunamiModel()), cache_size=8192)
        try:
            solo[tenant] = _main_path_campaign(fabric, logprior, loglik, seed).samples
        finally:
            fabric.shutdown()
    models = [TsunamiModel(), TsunamiModel()]
    servers = [_serve(m) for m in models]
    urls = [url for _, url in servers]
    try:
        svc = UQService(EvaluationFabric(register_servers(urls, tenant="uq-service"),
                                         cache_size=8192), max_concurrent_waves=2)
        out, errors = {}, []

        def run(tenant):
            priority, weight, seed = SERVICE_TENANTS[tenant]
            try:
                camp = svc.open_campaign(tenant, priority=priority, weight=weight)
                t0 = time.perf_counter()
                res = _main_path_campaign(camp, logprior, loglik, seed)
                out[tenant] = (time.perf_counter() - t0, res, camp.points_charged)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(t,)) for t in SERVICE_TENANTS]
        try:
            reset_launches()
            waves0, stats0 = _waves(models), [dict(m.stats) for m in models]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            _join(threads, "service campaigns")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            tel = svc.telemetry()
        finally:
            svc.close()
            svc.fabric.shutdown()
        if errors:
            raise AssertionError(f"service campaigns: {errors}")
        waves = _waves_since(models, waves0)
        solves = sum(m.stats[lvl] - s[lvl] for m, s in zip(models, stats0) for lvl in (0, 1))
        wire_points = sum(_get_json(url, "/Tenants")["tenants"].get(
            "uq-service", {}).get("points", 0) for url in urls)
        stats = _assert_no_server_errors(urls)
    finally:
        _stop(servers)
    per_tenant = {}
    for tenant in SERVICE_TENANTS:
        t_wall, res, charged = out[tenant]
        _same_bits(res.samples, solo[tenant], f"tenant {tenant} against its solo run")
        fab = tel["fabric_per_tenant"][tenant]
        accounted = fab["cache_hits"] + fab["cache_misses"] + fab["coalesced"]
        if charged != accounted:
            raise AssertionError(f"tenant {tenant}: {charged} points charged, {accounted} "
                                 f"accounted ({fab})")
        sched = tel["tenants"][tenant]
        per_tenant[tenant] = dict(priority=sched["priority"], weight=sched["weight"],
                                  wall_s=t_wall, p99_wave_s=sched["p99_wave_s"],
                                  p50_wave_s=sched["p50_wave_s"],
                                  granted_waves=sched["granted_waves"], points_charged=charged,
                                  points_dispatched=fab["points"], fabric_waves=fab["waves"])
    dispatched = sum(t["points_dispatched"] for t in per_tenant.values())
    n_waves = sum(sum(w.values()) for w in waves)
    if not dispatched == wire_points == solves:
        raise AssertionError(f"points dispatched {dispatched}, on the wire {wire_points}, "
                             f"solved {solves}")
    if counts["swe_solve"] != n_waves or counts["swe_step"] != 0:
        raise AssertionError(f"kernel launches {counts}, expected {n_waves} of swe_solve "
                             f"(server waves {waves})")
    emit("service_path", tenants=per_tenant, wall_s=wall, waves_per_server=waves,
         points_solved=solves, points_on_the_wire=wire_points,
         swe_solve_launches=counts["swe_solve"], launches=counts, server_stats=stats,
         bound="bit for bit (each tenant's samples == its solo in-process run)")
    return {"launches": counts["swe_solve"], "wall_s": wall}


def phase_fleet_path(torch, dev, main_path: dict, wire: dict) -> dict:
    """`main_path`'s campaign over a router (round robin) of two
    `FaultInjector(HTTPBackend([url]))` members, a `FleetManager` ticking
    beside it; the second member dies (`kill_after=`) halfway through the
    campaign: after half the dispatches it took in `wire_main_path`'s
    uninterrupted run over a router of the same two servers. The campaign
    finishes with `main_path`'s samples bit for bit; the manager drains the
    dead member; revived, one `tick()` reinstates it."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, FabricRouter, HTTPBackend
    from repro_torch.core.fleet import FaultInjector, FleetManager

    _, logprior, loglik, _ = tsunami_problem(torch, TsunamiModel(), dev)
    models = [TsunamiModel(), TsunamiModel()]
    servers = [_serve(m) for m in models]
    urls = [url for _, url in servers]
    share = sum(wire["runs"]["router"]["waves_per_server"][1].values())
    kill_after = share // 2
    try:
        members = [FaultInjector(HTTPBackend([urls[0]])),
                   FaultInjector(HTTPBackend([urls[1]]), kill_after=kill_after)]
        router = FabricRouter(members, policy="round_robin", backoff_s=0.05,
                              backoff_max_s=0.5)
        fabric = EvaluationFabric(router, cache_size=8192)
        mgr = FleetManager(fabric, retire_streak=3)
        try:
            reset_launches()
            waves0 = _waves(models)
            mgr.start(interval_s=0.01)
            wall, res = _timed(torch, lambda: _main_path_campaign(fabric, logprior, loglik))
            mgr.stop()
            counts = read_launches()
            rstats = router.stats()
            dead = [m.stats() for m in members]
            drained = list(mgr.events)
            members[1].revive()
            report = mgr.tick()
            admin = router.admin_states()
        finally:
            mgr.stop()
            fabric.shutdown()
        stats = _assert_no_server_errors(urls)
    finally:
        _stop(servers)
    waves = _waves_since(models, waves0)
    n_waves = sum(sum(w.values()) for w in waves)
    _same_bits(res.samples, main_path["samples"], "failover campaign")
    if not dead[1]["dead"] or not any(e["event"] == "drain" and e["backend"] == 1
                                      for e in drained):
        raise AssertionError(f"member 1 was not killed and drained: {dead[1]}, {drained}")
    if report["reinstated"] != [1] or admin != ["live", "live"]:
        raise AssertionError(f"revived member not reinstated: {report}, {admin}")
    if counts["swe_solve"] != n_waves or counts["swe_step"] != 0:
        raise AssertionError(f"kernel launches {counts}, expected {n_waves} of swe_solve "
                             f"(server waves {waves})")
    failures = [pb["failures"] for pb in rstats["per_backend"]]
    emit("fleet_path", wall_s=wall, main_path_wall_s=main_path["wall_s"],
         member_1_uninterrupted_dispatches=share, kill_after=kill_after,
         campaign_waves=rstats["waves"], dispatches=[d["dispatches"] for d in dead],
         events=[{k: v for k, v in e.items() if k != "t"} for e in drained],
         failovers={"steals": rstats["steals"], "failures_per_member": failures},
         waves_per_server=waves, swe_solve_launches=counts["swe_solve"], launches=counts,
         reinstated=report["reinstated"], server_stats=stats,
         bound="bit for bit (samples == main_path's)")
    return {"launches": counts["swe_solve"], "wall_s": wall}


def phase_wave_widths_vs_plain(torch, dev, widths: WaveWidths) -> dict:
    """The solve kernel against its plain version at every [cells, lanes]
    width the model gave it on the recorded paths that `kernel_vs_plain`
    does not already hold (`SOLVE_SHAPES`): the first wave of each such
    width as its path launched it, its inputs through `swe_solve_ref`, bit
    for bit. The plain loops run one after another: each is bound by
    launching its ~40 operations a step, and four at once from four
    threads took 4.7x longer in all (PERF.md)."""
    from repro_torch.kernels.swe import swe_solve_ref
    from repro_torch.kernels.swe.testing import SOLVE_SHAPES, assert_solve_equal

    held = sorted(set(widths.first) - set(SOLVE_SHAPES))
    report = {}
    t0 = time.perf_counter()
    for key in held:
        (inputs, got), name = widths.first[key], f"{key[0]}x{key[1]}"
        inputs = dict(inputs)
        h, hu, b = inputs.pop("h"), inputs.pop("hu"), inputs.pop("b")
        t1 = time.perf_counter()
        want = swe_solve_ref(h, hu, b, **inputs)
        report[name] = dict(assert_solve_equal(got, want, f"path wave {name}"),
                            plain_s=time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    worst = max((r[k]["max_abs"] for r in report.values() for k in ("mx", "arr")), default=0.0)
    emit("wave_widths_vs_plain", kernel="swe_solve", bound="bit for bit (mx, arr; NaN matches NaN)",
         widths_by_phase={ph: [list(k) for k in sorted(ks)]
                          for ph, ks in widths.by_phase.items()},
         already_held=[list(k) for k in sorted(set(widths.first) & set(SOLVE_SHAPES))],
         cases=report, wall_s=wall)
    return {"max_abs_err": worst, "held": [list(k) for k in held]}


#: the paper's §4.1 grid (benchmarks/sparse_grid_l2sea.py): levels, config
L2SEA_LEVELS = (5, 10, 15)
L2SEA_CONFIG = {"fidelity": 3}


def phase_l2sea_wire(torch, dev) -> dict:
    """The paper's §4.1 sparse grid of the L2-Sea model served on the card
    (`eval_cost_s=0`) through `HTTPBackend`: triangular x Beta(10, 10) Leja
    knots, nested levels 5, 10 and 15 (only new points evaluated), fidelity
    3, rebuilt with the port's `uq/sparse_grid.py`. Each level's values ==
    the in-process grid's bit for bit; one /GradientBatch == in-process."""
    from repro_torch.apps.l2sea import DRAFT_RANGE, FROUDE_RANGE, L2SeaModel, make_inputs
    from repro_torch.core.client import HTTPModel
    from repro_torch.core.fabric import EvaluationFabric, HTTPBackend, ModelBackend
    from repro_torch.uq import sparse_grid as sg

    knots = [sg.knots_triangular_leja(*FROUDE_RANGE),
             sg.knots_beta_leja(10.0, 10.0, *DRAFT_RANGE)]

    def grid(backend):
        fabric = EvaluationFabric(backend, cache_size=1024)
        rows, prev = [], None
        try:
            for w in L2SEA_LEVELS:
                Sr = sg.reduce_sparse_grid(sg.smolyak_grid(2, w, knots))
                new = []

                def f(pts):
                    new.append(len(pts))
                    return fabric.evaluate_batch(make_inputs(pts), L2SEA_CONFIG)

                wall, vals = _timed(torch, lambda: sg.evaluate_on_sparse_grid(f, Sr, previous=prev))
                prev = (Sr, vals)
                rows.append(dict(level=w, points=len(Sr.points), new_points=sum(new),
                                 wall_s=wall, values=vals))
        finally:
            fabric.shutdown()
        return rows

    served = _serve(L2SeaModel(eval_cost_s=0.0))
    url = served[1]
    try:
        local_model = L2SeaModel()
        warm = make_inputs(np.array([[0.3, -6.0]]))
        HTTPModel(url).evaluate_batch(warm, L2SEA_CONFIG)  # first calls outside the walls
        local_model.evaluate_batch(warm, L2SEA_CONFIG)
        wire = grid(HTTPBackend([url]))
        local = grid(ModelBackend(local_model))
        pts = make_inputs(np.asarray(sg.reduce_sparse_grid(
            sg.smolyak_grid(2, L2SEA_LEVELS[-1], knots)).points))
        senss = np.ones((len(pts), 1))
        _same_bits(HTTPModel(url).gradient_batch(pts, senss, L2SEA_CONFIG),
                   L2SeaModel().gradient_batch(pts, senss, L2SEA_CONFIG), "/GradientBatch")
        stats = _assert_no_server_errors([url])
    finally:
        _stop([served])
    for w, l in zip(wire, local):
        _same_bits(w["values"], l["values"], f"level {w['level']} of the grid")
        if not np.isfinite(w["values"]).all() or (w["values"] <= 0).any():
            raise AssertionError(f"level {w['level']}: resistance not finite and positive")
    emit("l2sea_wire", config=L2SEA_CONFIG, gradient_points=len(pts),
         levels=[{k: v for k, v in w.items() if k != "values"} | {
             "in_process_wall_s": l["wall_s"], "r_t_range_kn": [float(w["values"].min()),
                                                                 float(w["values"].max())]}
             for w, l in zip(wire, local)],
         server_stats=stats, bound="bit for bit (grid values, /GradientBatch)")
    return {}


# §4.2 protocol (benchmarks/qmc_defects.py): the truncated normal prior of
# the defect theta = (position across, position along, diameter) [mm], 256
# scrambled Sobol' points, 4 full solves against the ROM
COMPOSITE_PRIOR_MEAN = np.array([77.5, 210.0, 10.0])
COMPOSITE_PRIOR_SD = np.sqrt(np.array([8000.0, 4800.0, 2.0]))
COMPOSITE_QMC_POINTS, COMPOSITE_FULL_CHECKS = 256, 4
# the ROM's bound against the full solve (tests/test_apps.py), held at the
# protocol's first 4 points (most QMC defects miss the resin interlayer, and
# there the ROM reproduces the full solve) and at tests/test_apps.py's two
# defects that meet it
COMPOSITE_ROM_RTOL = 5e-3
COMPOSITE_DEFECTS = np.array([[77.5, 210.0, 10.0], [78.0, 180.0, 30.0]])
COMPOSITE_FULL_WAVES = (16, 64)


def composite_thetas(n: int) -> np.ndarray:
    """The first n scrambled Sobol' points (seed 11) through the truncated
    normal prior, cut at the part (benchmarks/qmc_defects.py:23-37)."""
    from scipy.special import ndtri

    from repro_torch.apps.composite import LENGTH_MM, WIDTH_MM
    from repro_torch.uq.qmc import sobol

    z = ndtri(np.clip(sobol(n, 3, scramble_seed=11), 1e-9, 1 - 1e-9))
    th = COMPOSITE_PRIOR_MEAN + COMPOSITE_PRIOR_SD * z
    th[:, 0] = np.clip(th[:, 0], 0.0, WIDTH_MM)
    th[:, 1] = np.clip(th[:, 1], 0.0, LENGTH_MM)
    th[:, 2] = np.clip(th[:, 2], 0.5, 60.0)
    return th


def phase_composite_qmc_path(torch, smi: str) -> dict:
    """The paper's §4.2 protocol at its full size: `CompositeModel()` on the
    card (its offline stage: 16 local eigenproblems and one CG solve), 256
    QMC points through `EvaluationFabric(ModelBackend(model), cache_size=0)`
    in ROM mode (one wave), then 4 full solves as point calls. One 16-point
    chunk of the ROM wave again, split into its host part (per-theta basis
    rebuilds on the subdomains the defect meets, B's assembly, the copy to
    the card) and its device program (Galerkin projection, batched solve,
    energy). The ROM must stay within 5e-3 of the full solve."""
    from repro_torch.apps import composite as tc
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend

    offline_s, model = _timed(torch, tc.CompositeModel)
    thetas = composite_thetas(COMPOSITE_QMC_POINTS)
    fabric = EvaluationFabric(ModelBackend(model), cache_size=0)
    try:
        rom_s, energies = _timed(torch, lambda: fabric.evaluate_batch(thetas, {"mode": "rom"}))
        tel = fabric.telemetry()
    finally:
        fabric.shutdown()
    energies = energies[:, 0]
    full_s, full = _timed(torch, lambda: np.array(
        [model([list(t)], {"mode": "full"})[0][0] for t in thetas[:COMPOSITE_FULL_CHECKS]]))
    rel = np.abs(full - energies[:COMPOSITE_FULL_CHECKS]) / np.abs(full)
    at_defects = [(model([list(t)], {"mode": "full"})[0][0], model([list(t)])[0][0])
                  for t in COMPOSITE_DEFECTS]
    rel_defects = np.array([abs(r - f) / abs(f) for f, r in at_defects])
    # one ROM chunk, host prep apart from the device program
    part = thetas[: model.BATCH_CHUNK]

    systems_s, sys = _timed(torch, lambda: [model.rom._defect_system(t) for t in part])
    copy_s, B = _timed(torch, lambda: model._t(np.stack([s[2] for s in sys]).astype(np.float32)))
    fx, fy = torch.stack([s[0] for s in sys]), torch.stack([s[1] for s in sys])
    chunk_updated = [len(s[3]) for s in sys]
    host_s = systems_s + copy_s
    device_s, chunk = _timed(torch, lambda: tc._rom_energy_batch(fx, fy, B))
    # locality at the prior mean (a defect off the resin interlayer, as
    # where the prior's tails clip it to the part's edge, updates none)
    _, info = model.rom.online(COMPOSITE_PRIOR_MEAN)
    if energies.shape != (COMPOSITE_QMC_POINTS,) or not np.isfinite(energies).all() \
            or (energies <= 0).any() or not np.isfinite(full).all():
        raise AssertionError(f"ROM energies {energies.shape}, finite "
                             f"{np.isfinite(energies).all()}, full {full}")
    if max(rel.max(), rel_defects.max()) >= COMPOSITE_ROM_RTOL:
        raise AssertionError(f"ROM vs full: {rel.tolist()}, at the defects "
                             f"{rel_defects.tolist()} (bound {COMPOSITE_ROM_RTOL})")
    _same_bits(chunk.cpu().numpy(), energies[: model.BATCH_CHUNK], "the ROM chunk run again")
    if not 1 <= len(info["updated_subdomains"]) <= 8 or info["n_red"] != 171:
        raise AssertionError(f"ROM locality / size: {info}")
    if tel["backend"]["native_batches"] != 1 or tel["backend"]["padded"] != 0:
        raise AssertionError(f"the QMC wave was not one unpadded wave: {tel['backend']}")
    emit("composite_qmc_path", card=smi, points=COMPOSITE_QMC_POINTS, offline_s=offline_s,
         rom_wave_s=rom_s, rom_ms_per_eval=rom_s / COMPOSITE_QMC_POINTS * 1e3,
         rom_chunk={"lanes": len(part), "host_s": host_s, "defect_systems_s": systems_s,
                    "stack_and_copy_s": copy_s, "device_s": device_s,
                    "host_share": host_s / (host_s + device_s)},
         full_checks=COMPOSITE_FULL_CHECKS, full_ms_per_eval=full_s / COMPOSITE_FULL_CHECKS * 1e3,
         online_speedup=(full_s / COMPOSITE_FULL_CHECKS) / (rom_s / COMPOSITE_QMC_POINTS),
         rom_max_rel_err_vs_full=rel.max(), rom_rel_err_vs_full_at_defects=rel_defects.tolist(),
         bound=COMPOSITE_ROM_RTOL,
         energy={"mean": energies.mean(), "sd": energies.std(), "min": energies.min(),
                 "max": energies.max()},
         n_red=info["n_red"], updated_subdomains_at_prior_mean=info["updated_subdomains"],
         updated_subdomains_per_point_in_chunk=chunk_updated, model_stats=dict(model.stats))
    return {"model": model, "thetas": thetas}


def phase_composite_full_waves(torch, model, thetas, smi: str) -> dict:
    """Full-mode evaluate waves at 16 and 64 lanes (chunks of 16, each one
    CG whose lanes stop on their own tests, CG_CHECK_EVERY iterations a
    replay of the chunk shape's cached CUDA graph), and one smooth-mode
    gradient wave of 16 lanes (the forward CG, the adjoint CG and the
    matvec's linearisation): wall, device busy share (profiled once more),
    peak memory. The graph's CG, at its shape's first solve (captured, then
    replayed) and at the next (replayed), against the eager loop that
    checks every iteration, bit for bit, on a 16-lane wave; the capture's
    time; CG iterations a lane. Memory is each wave's peak above
    what the process held before it (earlier phases' tensors). The adjoint's gradient against
    central differences of the smooth energy in float64 on the card (the
    diameter component within 5e-2, every component within 5e-3 of the
    largest: tests/test_capabilities.py's bounds)."""
    from repro_torch.apps import composite as tc

    full = {"mode": "full"}
    waves = {}
    for n in COMPOSITE_FULL_WAVES:
        model.evaluate_batch(thetas[:n], full)  # the same program, outside the wall
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        wall, out = _timed(torch, lambda: model.evaluate_batch(thetas[:n], full))
        if out.shape != (n, 1) or not np.isfinite(out).all():
            raise AssertionError(f"full wave of {n}: {out.shape}, finite {np.isfinite(out).all()}")
        waves[n] = {"wall_s": wall, "ms_per_eval": wall / n * 1e3,
                    "peak_memory_above_held": torch.cuda.max_memory_allocated() - held}
    n = COMPOSITE_FULL_WAVES[0]
    busy = _device_busy(torch, lambda: model.evaluate_batch(thetas[:n], full), "a full wave")
    waves[n]["device_busy_share"] = busy["device_busy_s"] / busy["profiled_wall_s"]
    waves[n]["profile"] = busy
    # graph against eager, on the wave's own system
    ks = [tc.coefficient_field(t) for t in thetas[:n]]
    fx, fy = tc._face_coeffs(model._t(np.stack([k[0] for k in ks])),
                             model._t(np.stack([k[1] for k in ks])))
    rhs = tc._rhs_from_lifting(fx, fy, tc._lifting(fx.dtype, fx.device))
    # the CG's graph: captured and replayed (cold: the shape's first solve;
    # with no cache every solve paid it) against replayed only (warm)
    tc._SOLVERS.clear()
    cold_s, (x0, k0) = _timed(torch, lambda: tc.cg(fx, fy, rhs))
    graph_s, (x, k) = _timed(torch, lambda: tc.cg(fx, fy, rhs))
    eager_s, (x1, k1) = _timed(torch, lambda: tc.cg(fx, fy, rhs, check_every=1))
    for got, what in ((x0, "cold"), (x, "warm")):
        _same_bits(got.cpu().numpy(), x1.cpu().numpy(),
                   f"CG: graph ({what}) vs the eager per-iteration loop")
    _same_bits(k0.cpu().numpy(), k1.cpu().numpy(), "CG iterations: graph (cold) vs eager")
    _same_bits(k.cpu().numpy(), k1.cpu().numpy(), "CG iterations: graph (warm) vs eager")
    k = k.cpu().numpy()
    # one gradient wave on defects that meet the resin interlayer (most QMC
    # points miss it, and their gradient is ~0), the first two
    # tests/test_capabilities.py's
    soft = tc.DEFECT_SOFTNESS
    rng = np.random.default_rng(SEED)
    gthetas = np.concatenate([[[77.5, 210.0, 10.0], [70.0, 205.0, 8.0]], np.stack(
        [rng.uniform(72.0, 83.0, n - 2), rng.uniform(40.0, 380.0, n - 2),
         rng.uniform(5.0, 20.0, n - 2)], 1)])
    senss = np.ones((n, 1))
    cfg = {"mode": "full", "defect_softness": soft}
    model.gradient_batch(gthetas, senss, cfg)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    grad_s, g = _timed(torch, lambda: model.gradient_batch(gthetas, senss, cfg))
    grad_peak = torch.cuda.max_memory_allocated() - held
    gbusy = _device_busy(torch, lambda: model.gradient_batch(gthetas, senss, cfg),
                         "a gradient wave")
    pts = gthetas[:2]
    h = 1e-4 * np.maximum(np.abs(pts), 1.0)
    shifted = np.concatenate([pts + s * np.eye(3)[i] * h[:, i:i + 1]
                              for i in range(3) for s in (1.0, -1.0)])
    th64 = torch.as_tensor(shifted, dtype=torch.float64, device=fx.device)
    e = tc._smooth_energy_batch(th64, soft).detach().cpu().numpy().reshape(3, 2, 2)
    fd = ((e[:, 0] - e[:, 1]) / (2 * h.T)).T  # [2 points, 3]
    ad = g[:2]
    if not np.isfinite(g).all() or g.shape != (n, 3):
        raise AssertionError(f"gradient wave {g.shape}, finite {np.isfinite(g).all()}")
    np.testing.assert_allclose(fd[:, 2], ad[:, 2], rtol=5e-2)
    np.testing.assert_allclose(fd, ad, atol=5e-3 * np.abs(ad).max())
    emit("composite_full_waves", card=smi, check_every=tc.CG_CHECK_EVERY,
         waves={str(w): v for w, v in waves.items()},
         cg_iterations={"min": int(k.min()), "max": int(k.max()), "lanes": n},
         cg_graph_cold_s=cold_s, cg_graph_s=graph_s, cg_eager_per_iteration_s=eager_s,
         capture_s=cold_s - graph_s, capture_share_of_cold=(cold_s - graph_s) / cold_s,
         graph_vs_eager="bit for bit (x and every lane's iteration count, cold and warm)",
         gradient_wave={"lanes": n, "softness": soft, "wall_s": grad_s,
                        "peak_memory_above_held": grad_peak,
                        "device_busy_share": gbusy["device_busy_s"] / gbusy["profiled_wall_s"],
                        "profile": gbusy},
         gradient_vs_central_differences={
             "points": pts.tolist(), "adjoint_f32": ad.tolist(), "fd_f64": fd.tolist(),
             "diameter_rel_err": (np.abs(fd[:, 2] - ad[:, 2]) / np.abs(fd[:, 2])).tolist(),
             "bound": "diameter rtol 5e-2; all atol 5e-3 x max |grad|"},
         model_stats=dict(model.stats))
    return {}


def phase_pool_path(torch, lm, smi: str) -> dict:
    """The device pool: 64 per-point submits through
    `BatchingExecutor(ModelPool(TorchModel(...)))` on the card (fewer than
    64 waves; every value == the model's `evaluate_batch` of all 64 bit for
    bit); `SPMDBackend.dispatch` for each derivative op == the model's own
    batched op bit for bit; and the qwen3-0.6b level-4 grid (`lm`, the
    dense LM path's model) through `EvaluationFabric(ModelPool(lm))`, as
    examples/serve_uq.py serves it, == through `ModelBackend` bit for bit
    in the same number of waves, with both walls."""
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend, SPMDBackend
    from repro_torch.core.interface import TorchModel
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.scheduler import BatchingExecutor
    from repro_torch.uq import sparse_grid as sg

    def elementwise(th):  # no reduction across lanes: a row's value is any width's
        return torch.stack([th[0] ** 2 + th[1] * th[2], torch.sin(th[0]) * th[1]])

    tm = TorchModel(elementwise, 3, 2)
    pool = ModelPool(tm)
    rng = np.random.default_rng(7)
    X, S, V = rng.standard_normal((64, 3)), rng.standard_normal((64, 2)), rng.standard_normal((64, 3))
    with BatchingExecutor(pool, linger_s=0.01) as ex:
        t0 = time.perf_counter()
        got = np.stack([f.result() for f in [ex.submit(t) for t in X]])
        submits_s = time.perf_counter() - t0
        waves = ex.telemetry()["waves"]
    _same_bits(got, tm.evaluate_batch(X), "64 submits through BatchingExecutor")
    if waves >= 64 or pool.stats["padded"] != 0:
        raise AssertionError(f"executor waves {waves}, pool {pool.stats}")
    backend = SPMDBackend(pool)
    ops = {"gradient": (S, lambda: tm.gradient_batch(X, S)),
           "apply_jacobian": (V, lambda: tm.apply_jacobian_batch(X, V)),
           "apply_hessian": ((S, V), lambda: tm.apply_hessian_batch(X, S, V))}
    for op, (extra, want) in ops.items():
        _same_bits(backend.dispatch(op, X, extra, None), want(), f"SPMDBackend {op}")
    ys, gs = backend.dispatch("value_and_gradient", X, lambda y: 1.0 - y, None)
    wys, wgs = tm.value_and_gradient_batch(X, lambda y: 1.0 - y)
    _same_bits(ys, wys, "SPMDBackend value_and_gradient (values)")
    _same_bits(gs, wgs, "SPMDBackend value_and_gradient (gradients)")
    # the LM grid, through the pool and through ModelBackend
    reduced = sg.reduce_sparse_grid(
        sg.smolyak_grid(2, LM_GRID_LEVEL, [sg.knots_uniform_leja(*LM_BOX)] * 2))
    lm_runs = {}
    for name, backend in (("model_pool", ModelPool(lm)), ("model_backend", ModelBackend(lm))):
        with EvaluationFabric(backend) as fab:
            wall, vals = _timed(torch, lambda: sg.evaluate_on_sparse_grid(fab, reduced))
            tel = fab.telemetry()
        lm_runs[name] = {"wall_s": wall, "waves": tel["waves"], "values": vals,
                         "backend": {k: v for k, v in tel["backend"].items()
                                     if k in ("kind", "batches", "native_batches", "padded",
                                              "bucket_shapes")}}
    _same_bits(lm_runs["model_pool"]["values"], lm_runs["model_backend"]["values"],
               "the LM grid through ModelPool vs ModelBackend")
    if lm_runs["model_pool"]["waves"] != lm_runs["model_backend"]["waves"] \
            or lm_runs["model_pool"]["backend"]["padded"] != 0:
        raise AssertionError(f"LM grid waves: {lm_runs}")
    emit("pool_path", card=smi, n_instances=pool.n_instances, submits=len(X),
         executor_waves=waves, submits_s=submits_s, pool_stats=dict(pool.stats),
         derivative_ops=sorted(ops) + ["value_and_gradient"],
         lm={"arch": lm.cfg.name, "grid_points": len(reduced.points),
             **{k: {kk: vv for kk, vv in v.items() if kk != "values"}
                for k, v in lm_runs.items()}},
         bound="bit for bit (submits, derivative ops, LM grid)")
    return {}


def ssd_work(B: int, H: int, G: int, S: int, P: int, N: int) -> dict:
    """Bytes the SSD scan must move (each input read once, each output
    written once, float32) and the float operations it needs: per chunk of
    Q = 128 and head, the causal triangle of C B^T (Q(Q+1)/2 N multiply-
    adds) and of scores X (Q(Q+1)/2 P), plus C S and the state update
    (2 Q N P). `flops_square` counts the full [Q, Q] products instead, as
    the Pallas kernel computes them. The kernel computes these products on
    the tensor cores in 3xTF32 (three TF32 products for each float32 one),
    so its work there is 3 x `flops`."""
    Q = 128
    chunks = B * H * (S // Q)
    tri = Q * (Q + 1) // 2
    nbytes = 4 * (2 * B * H * S * P + B * H * S + 2 * B * G * S * N + H + 2 * B * H * N * P)
    flops = chunks * 2 * (tri * N + tri * P + 2 * Q * N * P)
    flops_square = chunks * 2 * (Q * Q * N + Q * Q * P + 2 * Q * N * P)
    return {"bytes": nbytes, "flops": flops, "flops_square": flops_square}


def phase_ssd_kernel_vs_plain(torch, dev) -> dict:
    """The SSD kernel against its plain version (`ssd_chunked_ref`) on the
    card, within a relative bound (value and reason:
    `repro_torch.kernels.ssd.testing`): the JAX package's SSD_CASES shapes,
    a non-zero initial state, an S the adapter pads, and the main path's
    shapes (one point, a wave of 8, the 41-point grid as one wave)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd, ssd_chunk_scan, ssd_chunked_ref
    from repro_torch.kernels.ssd import testing as T

    report = {}
    for i, case in enumerate(T.CASES):
        inputs = T.kernel_inputs(case, dev, seed=i)
        got = ssd_chunk_scan(*inputs)
        torch.cuda.synchronize()
        name = T.case_name(case)
        report[name] = T.assert_close(got, ssd_chunked_ref(*inputs), name)
        del inputs, got
        torch.cuda.empty_cache()
    # through the adapter, S = 200 padded to 256 with dt = 0; the plain side
    # runs the same adapter on the CPU
    args = T.padded_adapter_inputs(dev, seed=len(T.CASES))
    cfg = get_config(SSM_ARCH)
    got = ssd(cfg, *args)
    torch.cuda.synchronize()
    report["adapter_S200_state"] = T.assert_close(
        tuple(t.cpu() for t in got), ssd(cfg, *(t.cpu() for t in args)), "adapter S=200")
    worst_abs = max(r[k]["max_abs_err"] for r in report.values() for k in ("y", "state"))
    worst_rel = max(r[k]["rel_err"] for r in report.values() for k in ("y", "state"))
    emit("ssd_kernel_vs_plain", kernel="ssd",
         bound=f"max|kernel - plain| / max|plain| <= {T.REL_TOL} for y and the final state "
               "(repro_torch/kernels/ssd/testing.py)",
         max_rel_err=worst_rel, max_abs_err=worst_abs, cases=report)
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel}


def phase_ssd_times(torch, dev, smi: str) -> dict:
    """Device time of one SSD launch at the main path's shapes, beside its
    bound and the plain version's time. The bound is the larger of the
    bytes at the HBM rate and the 3xTF32 work (3 x flops) at the TF32
    tensor-core peak; `fp32_cuda_core_ops_ms` is the float32 work at the
    CUDA cores' peak, the bound of the kernel before it used the tensor
    cores."""
    from repro_torch.kernels.ssd import ssd_chunk_scan, ssd_chunked_ref
    from repro_torch.kernels.ssd import testing as T

    shapes = []
    torch.cuda.reset_peak_memory_stats()
    for B in T.MAIN_PATH_BATCHES:
        H, G, S, P, N = T.MAMBA2_HEADS, 1, T.MAIN_PATH_SEQ, T.MAMBA2_P, T.MAMBA2_N
        inputs = T.kernel_inputs((B, H, G, S, P, N, False), dev)
        ms = _device_ms(torch, lambda: ssd_chunk_scan(*inputs), calls=max(2, 40 // B))
        # ~300 PyTorch kernels a call
        plain_ms = _device_ms(torch, lambda: ssd_chunked_ref(*inputs), calls=1, windows=3)
        work = ssd_work(B, H, G, S, P, N)
        t_bytes, t_tc = work["bytes"] / HBM_BYTES_PER_S, 3 * work["flops"] / TF32_FLOPS
        t_fp32 = work["flops"] / FP32_FLOPS
        bound_ms = max(t_bytes, t_tc) * 1e3
        shapes.append({
            "shape": [B, H, S, P, N], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "bytes_ms": t_bytes * 1e3, "tc_ops_ms": t_tc * 1e3,
            "share_of_bound": bound_ms / ms,
            "fp32_cuda_core_ops_ms": t_fp32 * 1e3,
            "fp32_cuda_core_square_ops_ms": work["flops_square"] / FP32_FLOPS * 1e3,
            "share_of_fp32_cuda_core_peak": t_fp32 * 1e3 / ms, **work,
        })
        del inputs
        torch.cuda.empty_cache()
    emit("ssd_times", kernel="ssd",
         bound="max(bytes at 3.35 TB/s, 3 x flops at the 495 TFLOP/s TF32 peak)",
         timer="one CUDA event pair around back-to-back launches (40 // B, at least 2; "
               "plain: 1), per launch, median of 5 windows (plain: 3)",
         shapes=shapes, library_ms=None,
         max_memory_allocated=torch.cuda.max_memory_allocated(), card=smi)
    return {"shapes": shapes}


def rmsnorm_work(n: int, d: int, x_bytes: int, w_bytes: int) -> dict:
    """Bytes the RMSNorm must move (x read once, y written once, w once) and
    its float operations: per element the square, its sum, the scale by
    the row's rsqrt and the product with w."""
    return {"bytes": 2 * n * d * x_bytes + d * w_bytes, "flops": 4 * n * d}


def phase_rmsnorm_kernel_vs_plain(torch, dev) -> dict:
    """The RMSNorm kernel against its plain version (`rmsnorm_ref`) on the
    card (bound and reason: `repro_torch.kernels.rmsnorm.testing`): the JAX
    package's RMS_CASES and qwen3-0.6b's norm shapes."""
    from repro_torch.kernels.rmsnorm import rmsnorm_fused, rmsnorm_ref
    from repro_torch.kernels.rmsnorm import testing as R

    report = {}
    for i, case in enumerate(R.CASES):
        x, w = R.case_inputs(case, dev, seed=i)
        got = rmsnorm_fused(x, w)
        torch.cuda.synchronize()
        report[R.case_name(case)] = R.assert_close(got, rmsnorm_ref(x, w), R.case_name(case))
        del x, w, got
    worst = max(r["max_abs_err"] for r in report.values())
    emit("rmsnorm_kernel_vs_plain", kernel="rmsnorm",
         bound=f"max abs error <= {R.F32_ATOL} in float32, <= {R.BF16_ULPS} bf16 ulp in bf16 "
               "(repro_torch/kernels/rmsnorm/testing.py)",
         max_abs_err=worst, max_bf16_ulp=max(r.get("max_ulp", 0.0) for r in report.values()),
         cases=report)
    return {"max_abs_err": worst}


def phase_rmsnorm_times(torch, dev, smi: str) -> dict:
    """Device time of one RMSNorm launch at every case, beside its bound,
    the plain version's time and `F.rms_norm`'s on the same inputs (with a
    float32 w and bf16 x PyTorch takes its unfused path; the fused one,
    with w cast to x's dtype, is given beside it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_fused, rmsnorm_ref
    from repro_torch.kernels.rmsnorm import testing as R

    shapes = []
    for i, case in enumerate(R.CASES):
        n, d = case[0], case[1]
        x, w = R.case_inputs(case, dev, seed=i)
        calls = 200 if n * d <= 2**22 else 20
        ms = _device_ms(torch, lambda: rmsnorm_fused(x, w), calls=calls)
        plain_ms = _device_ms(torch, lambda: rmsnorm_ref(x, w), calls=calls // 10)
        library_ms = _device_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-5), calls=calls // 10)
        w_x = w.to(x.dtype)
        library_cast_ms = _device_ms(torch, lambda: F.rms_norm(x, (d,), w_x, 1e-5), calls=calls)
        work = rmsnorm_work(n, d, x.element_size(), w.element_size())
        peak = FP32_FLOPS
        t_bytes, t_ops = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / peak
        shapes.append({
            "shape": [n, d], "dtype": case[2], "w_dtype": case[3], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_ms_w_in_x_dtype": library_cast_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fraction_of_hbm_rate": t_bytes * 1e3 / ms, **work,
        })
        del x, w, w_x
    emit("rmsnorm_times", kernel="rmsnorm",
         timer="one CUDA event pair around back-to-back launches (200, or 20 above 4 M "
               "elements; plain and F.rms_norm with float32 w: a tenth), per launch, "
               "median of 5 windows",
         library="torch.nn.functional.rms_norm(x, (d,), w, 1e-5)", shapes=shapes, card=smi)
    return {"shapes": shapes}


def phase_rmsnorm_path(torch, dev) -> dict:
    """The RMSNorm kernel's own path: its entry point `rmsnorm_fused`, called
    as a user calls it on model-layout activations at qwen3-0.6b's norm
    shapes (a point's and the 41-point grid wave's hidden states, a point's
    queries per head), with the model's float32 scale. No model calls it,
    as in the JAX package; the LM paths check that it stays at 0."""
    from repro_torch.kernels.rmsnorm import rmsnorm_fused

    gen = torch.Generator(device=dev).manual_seed(11)
    inputs = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
              for shape in ((LM_BATCH, LM_SEQ, 1024), (41 * LM_BATCH, LM_SEQ, 1024),
                            (LM_BATCH, LM_SEQ, 16, 128))]
    scales = [torch.ones(x.shape[-1], device=dev) for x in inputs]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [rmsnorm_fused(x, w) for x, w in zip(inputs, scales)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    for x, y in zip(inputs, outs):
        if y.shape != x.shape or y.dtype != x.dtype or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"rmsnorm_fused: output {tuple(y.shape)} {y.dtype}")
        # unit scale: every row of the output has a mean square of ~1
        ms_rows = y.float().pow(2).mean(-1)
        if not bool(((ms_rows - 1).abs() < 0.02).all()):
            raise AssertionError("rmsnorm_fused: rows are not normalised")
    if counts["rmsnorm"] != len(inputs) or sum(counts.values()) != len(inputs):
        raise AssertionError(f"launches {counts}, expected {len(inputs)} of rmsnorm")
    emit("rmsnorm_path", shapes=[list(x.shape) for x in inputs], wall_s=wall, launches=counts)
    return {"launches": counts["rmsnorm"]}


def flash_work(B: int, nq: int, nkv: int, Sq: int, Sk: int, hd: int, causal: bool,
               elem: int) -> dict:
    """Bytes flash attention must move (q, k, v read once, o written once)
    and its float operations: two multiply-adds per (q row, key, column)
    for q k^T and P V, over the (row, key) pairs the mask keeps (S(S+1)/2
    per head when causal)."""
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    return {"bytes": elem * (2 * B * nq * Sq * hd + 2 * B * nkv * Sk * hd),
            "flops": 4 * B * nq * hd * pairs}


#: the float32 flash kernel's own path: the reduced qwen3-0.6b (float32, 4 q
#: heads and 2 kv heads of 32) over a level-2 grid (13 points, one wave)
F32_LM_BATCH, F32_LM_SEQ, F32_GRID_LEVEL = 2, 512, 2
#: its attention shape on that path: 13 points x 2 sequences
F32_PATH_CASE = (13 * F32_LM_BATCH, 4, 2, F32_LM_SEQ, F32_LM_SEQ, 32, True, "float32")


def _model_layout(q, k, v):
    """The same values as transposed views of [B, S, n, hd] tensors: the
    layout the qwen3 path hands the kernel."""
    return tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))


def phase_flash_kernel_vs_plain(torch, dev) -> dict:
    """Both flash kernels against their plain version (`attention_ref`) on
    the card (bound and reason: `repro_torch.kernels.flash_attention.testing`):
    the JAX package's FLASH_CASES, ragged shapes, and qwen3-0.6b's attention
    at one point, a wave of 8 and the 41-point grid wave (at its model layout,
    through strides), and the float32 path's shape. Each case goes through
    the wrapper to the kernel of its dtype (`flash_attention_wgmma` for bf16,
    `flash_attention` for float32), and the CUDA-core kernel also runs every
    bf16 case."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import testing as T

    report = {"flash_attention_wgmma": {}, "flash_attention": {}}
    for i, case in enumerate(T.CASES + (F32_PATH_CASE,)):
        name, causal = T.case_name(case), case[6]
        q, k, v = T.case_inputs(case, dev, seed=i)
        if case in T.MODEL_CASES:
            q, k, v = _model_layout(q, k, v)
        want = T.plain(q, k, v, causal)
        before = dict(flash_attention.launches_by_kernel)
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        kernel = ops.KERNEL_OF[q.dtype]
        if flash_attention.launches_by_kernel[kernel] != before[kernel] + 1:
            raise AssertionError(f"{name}: the wrapper did not launch {kernel}")
        report[kernel][name] = T.assert_close(got, want, f"{kernel} {name}")
        if kernel != "flash_attention":  # the CUDA-core kernel on the same bf16 inputs
            got = torch.empty_like(q)
            ops.launch("flash_attention", q, k, v, got, causal)
            torch.cuda.synchronize()
            report["flash_attention"][name] = T.assert_close(got, want, f"flash_attention {name}")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    worst = {kernel: {dt: max((r["max_abs_err"] for n, r in cases.items() if n.endswith(dt)),
                              default=None) for dt in T.ATOL}
             for kernel, cases in report.items()}
    emit("flash_kernel_vs_plain", kernels=list(report),
         bound="max abs error <= 2e-5 in float32, <= 2e-2 in bf16, the JAX package's "
               "(repro_torch/kernels/flash_attention/testing.py)",
         max_abs_err_by_kernel_and_dtype=worst, cases=report)
    return {"wgmma": worst["flash_attention_wgmma"]["bfloat16"],
            "cuda_core": worst["flash_attention"]["float32"],
            "cuda_core_bf16": worst["flash_attention"]["bfloat16"], "by_kernel": worst}


def phase_flash_times(torch, dev, smi: str) -> dict:
    """Device time of one launch of each flash kernel at the FLASH_CASES
    shapes, qwen3-0.6b's main-path shapes (at the model layout, through
    strides) and the float32 path's shape, beside the bound (operations at
    the peak of the inputs' type), the plain version's time and
    `scaled_dot_product_attention`'s. `ms` is the kernel the wrapper takes;
    at bf16 shapes `cuda_core_ms` is the CUDA-core kernel on the same
    inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import testing as T

    shapes = []
    for i, case in enumerate(T.FLASH_CASES + T.MODEL_CASES + (F32_PATH_CASE,)):
        B, nq, nkv, Sq, Sk, hd, causal, dt = case
        q, k, v = T.case_inputs(case, dev, seed=i)
        if case in T.MODEL_CASES:
            q, k, v = _model_layout(q, k, v)
        work = flash_work(B, nq, nkv, Sq, Sk, hd, causal, q.element_size())
        big = work["flops"] > 1e11
        ms = _device_ms(torch, lambda: flash_attention(q, k, v, causal=causal),
                        calls=10 if big else 50)
        entry = {"shape": [B, nq, nkv, Sq, hd], "causal": causal, "dtype": dt,
                 "kernel": ops.KERNEL_OF[q.dtype], "model_layout": case in T.MODEL_CASES,
                 "ms": ms}
        if dt == "bfloat16":
            o = torch.empty_like(q)
            entry["cuda_core_ms"] = _device_ms(
                torch, lambda: ops.launch("flash_attention", q, k, v, o, causal),
                calls=2 if big else 50)
        entry["plain_ms"] = _device_ms(torch, lambda: T.plain(q, k, v, causal),
                                       calls=1 if big else 10, windows=3 if big else 5)
        entry["library_ms"] = _device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), calls=10 if big else 50)
        peak = BF16_FLOPS if dt == "bfloat16" else FP32_FLOPS
        t_bytes, t_ops = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / peak
        entry.update({
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3,
            "fp32_ops_ms": work["flops"] / FP32_FLOPS * 1e3, **work,
        })
        if dt == "bfloat16":
            entry["fraction_of_bf16_peak"] = t_ops * 1e3 / ms
            entry["cuda_core_fraction_of_fp32_peak"] = entry["fp32_ops_ms"] / entry["cuda_core_ms"]
        else:
            entry["fraction_of_fp32_peak"] = entry["fp32_ops_ms"] / ms
        shapes.append(entry)
        del q, k, v
        torch.cuda.empty_cache()
    emit("flash_times", kernels=["flash_attention_wgmma", "flash_attention"],
         timer="one CUDA event pair around back-to-back launches (50; 10 above 0.1 TFLOP, "
               "the CUDA-core kernel 2; plain: 10, or 1 in 3 windows), per launch, median of "
               "5 windows",
         library="F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)",
         shapes=shapes, card=smi)
    return {"shapes": shapes}


#: the kernel each LM path runs once per layer, and its name in a trace
LM_KERNELS = {SSM_ARCH: ("ssd", "ssd_chunk_scan"),
              DENSE_ARCH: ("flash_attention_wgmma", "flash_attention_wgmma_kernel")}
#: the phase names' prefix of each LM path
LM_PHASE = {SSM_ARCH: "lm", DENSE_ARCH: "dense_lm"}


def phase_lm_main_path(torch, arch: str) -> dict:
    """examples/serve_uq.py's flow on a full-width LM: a level-4 sparse grid
    of the NLL (41 points, one unpadded wave), the surrogate's 4,000-sample
    Monte Carlo, and 8 per-point submits, all through
    `EvaluationFabric(ModelBackend(LMUQModel))`. Every forward launches the
    model's kernel once per layer, and no other kernel."""
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.uq import sparse_grid as sg

    kernel = LM_KERNELS[arch][0]
    t0 = time.perf_counter()
    model = LMUQModel(arch, reduced=False, batch=LM_BATCH, seq=LM_SEQ)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    knots = [sg.knots_uniform_leja(*LM_BOX)] * 2
    grid = sg.smolyak_grid(2, LM_GRID_LEVEL, knots)
    reduced = sg.reduce_sparse_grid(grid)
    rng = np.random.default_rng(0)
    sample = np.stack([rng.uniform(0.9, 1.1, 4000), rng.uniform(0.8, 1.2, 4000)], 1)
    fabric = EvaluationFabric(ModelBackend(model), cache_size=4096)
    try:
        # every launch count starts at 0 right before the main path
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = sg.evaluate_on_sparse_grid(fabric, reduced)
        grid_s = time.perf_counter() - t0
        nlls = sg.interpolate_on_sparse_grid(grid, reduced, vals, sample)[:, 0]
        t0 = time.perf_counter()
        futs = [fabric.submit([1.0 + 0.02 * i, 1.0]) for i in range(LM_SUBMITS)]
        sens = np.array([float(f.result()[0]) for f in futs])
        submits_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = read_launches()
        peak = torch.cuda.max_memory_allocated()
        tel = fabric.telemetry()
    finally:
        fabric.shutdown()
    n = len(reduced.points)
    forwards = tel["backend"]["native_batches"]
    if vals.shape != (n, 1) or not np.isfinite(vals).all():
        raise AssertionError(f"grid values {vals.shape}, finite {np.isfinite(vals).all()}")
    # the NLL of a V-way softmax is positive; a random model sits near ln V
    # (10.8 for mamba2's 50,280 tokens, 11.9 for qwen3's 151,936), so a value
    # outside (0, 30) means broken logits
    if not (np.isfinite(nlls).all() and np.isfinite(sens).all()
            and 0 < vals.min() and vals.max() < 30 and 0 < sens.min() and sens.max() < 30):
        raise AssertionError(f"NLL out of range: grid {vals.min()}..{vals.max()}, "
                             f"submits {sens}")
    # the surrogate interpolates: it reproduces the grid values at the grid
    np.testing.assert_allclose(sg.interpolate_on_sparse_grid(grid, reduced, vals, reduced.points),
                               vals, rtol=1e-9, atol=1e-9)
    # every forward the fabric dispatched launched the kernel once per layer
    launches = counts[kernel]
    if forwards < 2 or launches != model.cfg.n_layers * forwards:
        raise AssertionError(f"{kernel} kernel launches {launches}, expected "
                             f"{model.cfg.n_layers} x {forwards} native batches")
    if sum(counts.values()) != launches:
        raise AssertionError(f"other kernels launched on the {arch} path: {counts}")
    # no wave is padded: the port has no trace cache for padding to bound
    if tel["backend"]["padded"] != 0:
        raise AssertionError(f"padded waves on the {arch} path: {tel['backend']}")
    emit(f"{LM_PHASE[arch]}_main_path", arch=arch, batch=LM_BATCH, seq=LM_SEQ,
         layers=model.cfg.n_layers, init_s=init_s, grid_points=n, grid_wave_s=grid_s,
         grid_evals_per_s=n / grid_s, submits=LM_SUBMITS, submits_s=submits_s,
         nll_grid={"min": vals.min(), "max": vals.max(), "at_1_1": sens[0]},
         nll_surrogate_mc={"mean": nlls.mean(), "std": nlls.std(),
                           "p95": np.percentile(nlls, 95)},
         nll_vs_embedding_scale=sens.tolist(), forwards=forwards,
         **{f"{kernel}_launches": launches}, launches=counts, max_memory_allocated=peak,
         backend=tel["backend"],
         fabric={k: tel[k] for k in ("waves", "points", "cache_hits", "mean_wave_size")})
    return {"launches": launches, "model": model, "points": reduced.points, "grid_s": grid_s}


def phase_lm_kernel_vs_plain(torch, model) -> dict:
    """One full-width wave of 8 points on the kernel path against the plain
    path (`attn_impl="plain"`: `ssd_scan`, or `_grouped_attention`, in torch
    ops) on the same weights. The two differ only in the kernel's float32
    summation order (and, for attention, the plain path's bf16 softmax),
    rounded to bf16 after each layer."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    from repro_torch.models.layers import lm_head

    arch = model.cfg.name
    kernel = LM_KERNELS[arch][0]
    plain = copy.copy(model)
    plain.cfg = model.cfg.replace(attn_impl="plain")
    thetas = np.array([[1.0 + 0.02 * i, 1.0] for i in range(LM_SUBMITS)])
    before = read_launches()[kernel]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.evaluate_batch(thetas)[:, 0]
    kernel_s = time.perf_counter() - t0
    launched = read_launches()[kernel] - before
    if launched != model.cfg.n_layers:
        raise AssertionError(f"{launched} {kernel} launches for one forward")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = plain.evaluate_batch(thetas)[:, 0]
    plain_s = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated()
    rel = float(np.abs(got / want - 1.0).max())
    if not rel <= LM_NLL_RTOL:
        raise AssertionError(f"kernel path NLL {got} vs plain {want}: {rel:.3g} > {LM_NLL_RTOL}")
    # how far the two paths drift apart token by token, at theta = (1, 1)
    token_nll = []
    for m in (model, plain):
        with torch.inference_mode():
            hidden, _, _ = transformer.forward(m.cfg, m.params, m.batch["tokens"], skip_head=True)
            logits = M.mask_padded_logits(m.cfg, lm_head(m.params["embed"], hidden).float())
            tgt = torch.gather(logits, -1, m.batch["targets"][..., None])[..., 0]
            token_nll.append(torch.logsumexp(logits, dim=-1) - tgt)
    emit(f"{LM_PHASE[arch]}_kernel_vs_plain", points=len(thetas), bound=LM_NLL_RTOL,
         nll_rel_err=rel, nll_kernel=got.tolist(), nll_plain=want.tolist(),
         kernel_wave_s=kernel_s, plain_wave_s=plain_s,
         plain_max_memory_allocated=plain_peak,
         token_nll_max_abs_diff=float((token_nll[0] - token_nll[1]).abs().max()),
         token_nll_std=float(token_nll[1].std()))
    return {"nll_rel_err": rel}


def phase_lm_profile(torch, model, points, unprofiled_s: float) -> dict:
    """The grid wave again under torch.profiler: the model kernel's and the
    GEMMs' shares of the wave's wall time, the rest of the device time
    (elementwise glue, norms, softmax of the head), and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    arch = model.cfg.name
    kernel, trace_name = LM_KERNELS[arch]
    thetas = np.asarray(points, float)  # the grid wave as the fabric runs it
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.evaluate_batch(thetas)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = ROOT / "build" / f"chip_smoke_{LM_PHASE[arch]}_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    busy = {kernel: 0.0, "gemm": 0.0, "other": 0.0, "memcpy_memset": 0.0}
    by_name: dict[str, list] = {}
    n_kernels = n_model_kernel = 0
    for ev in json.loads(trace.read_text()).get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name, dur = ev.get("cat"), ev.get("name", ""), float(ev.get("dur", 0.0))
        if cat in ("gpu_memcpy", "gpu_memset"):
            busy["memcpy_memset"] += dur
        elif cat == "kernel":
            n_kernels += 1
            low = name.lower()
            if trace_name in low:
                busy[kernel] += dur
                n_model_kernel += 1
            elif any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):  # cuBLAS
                busy["gemm"] += dur
            else:
                busy["other"] += dur
            entry = by_name.setdefault(name[:90], [0, 0.0])
            entry[0] += 1
            entry[1] += dur
    if not n_kernels:
        raise AssertionError("the profiler recorded no device kernel")
    # the wave is one forward: one launch of the model's kernel per layer,
    # under its own name in the trace
    if n_model_kernel != model.cfg.n_layers:
        raise AssertionError(f"the trace holds {n_model_kernel} launches of {trace_name}, "
                             f"expected {model.cfg.n_layers}")
    device_us = sum(busy.values())
    emit(f"{LM_PHASE[arch]}_profile", wave=f"{len(thetas)} grid points, unpadded",
         wall_ms=wall_us / 1e3, unprofiled_wall_ms=unprofiled_s * 1e3,
         device_kernels=n_kernels, device_busy_ms=device_us / 1e3,
         **{f"{kernel}_launches_in_trace": n_model_kernel},
         busy_ms={k: v / 1e3 for k, v in busy.items()},
         share_of_wall={k: v / wall_us for k, v in busy.items()},
         device_busy_share=device_us / wall_us, device_idle_share=1.0 - device_us / wall_us,
         top_kernels=[{"name": k, "launches": n, "ms": us / 1e3} for k, (n, us) in
                      sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]])
    return {"kernel_share": busy[kernel] / wall_us, "idle_share": 1.0 - device_us / wall_us}


def phase_flash_f32_path(torch) -> dict:
    """The float32 flash kernel's own path: the reduced qwen3-0.6b in
    float32 (the config the port's parity tests hold to the JAX package)
    as an UM-Bridge model, a level-2 sparse grid of its NLL through
    `EvaluationFabric(ModelBackend(LMUQModel))` as one unpadded wave, and the
    same wave on the plain path. Every forward launches the CUDA-core flash
    kernel once per layer, at `F32_PATH_CASE`'s shape, and no other kernel."""
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.uq import sparse_grid as sg

    model = LMUQModel(DENSE_ARCH, reduced=True, batch=F32_LM_BATCH, seq=F32_LM_SEQ)
    if model.cfg.act_dtype != "float32":
        raise AssertionError(f"the reduced {DENSE_ARCH} runs in {model.cfg.act_dtype}")
    knots = [sg.knots_uniform_leja(*LM_BOX)] * 2
    reduced = sg.reduce_sparse_grid(sg.smolyak_grid(2, F32_GRID_LEVEL, knots))
    wave = len(reduced.points)  # one wave, unpadded
    if wave * F32_LM_BATCH != F32_PATH_CASE[0]:
        raise AssertionError(f"a wave of {wave} points, F32_PATH_CASE has {F32_PATH_CASE[0]}")
    fabric = EvaluationFabric(ModelBackend(model), cache_size=64)
    try:
        # every launch count starts at 0 right before the path
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = sg.evaluate_on_sparse_grid(fabric, reduced)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        backend = fabric.telemetry()["backend"]
    finally:
        fabric.shutdown()
    forwards = backend["native_batches"]
    launches = counts["flash_attention"]
    if forwards < 1 or launches != model.cfg.n_layers * forwards or sum(counts.values()) != launches:
        raise AssertionError(f"launches {counts}, expected {model.cfg.n_layers} x {forwards} "
                             "of flash_attention and no other kernel")
    if backend["padded"] != 0:
        raise AssertionError(f"the grid wave was padded: {backend}")
    plain = copy.copy(model)
    plain.cfg = model.cfg.replace(attn_impl="plain")
    want = plain.evaluate_batch(np.asarray(reduced.points, float))
    rel = float(np.abs(vals / want - 1.0).max())
    if vals.shape != (len(reduced.points), 1) or not np.isfinite(vals).all() or not rel <= 1e-5:
        raise AssertionError(f"float32 path NLL {vals.ravel()} vs plain {want.ravel()}: {rel:.3g}")
    emit("flash_f32_path", arch=f"{DENSE_ARCH} (reduced, float32)", batch=F32_LM_BATCH,
         seq=F32_LM_SEQ, layers=model.cfg.n_layers, grid_points=len(reduced.points),
         forwards=forwards, wall_s=wall, flash_attention_launches=launches, launches=counts,
         nll_grid={"min": vals.min(), "max": vals.max()}, nll_rel_err_vs_plain=rel,
         bound=1e-5)
    return {"launches": launches}


def run_lm_path(torch, arch: str, smi: str) -> dict:
    """The main path, the kernel-vs-plain wave and the profiled wave of one
    LM, and for qwen3-0.6b (the model examples/serve_uq.py serves) the
    device pool's path; the model's memory is released afterwards."""
    lm = phase_lm_main_path(torch, arch)
    phase_lm_kernel_vs_plain(torch, lm["model"])
    phase_lm_profile(torch, lm["model"], lm["points"], lm["grid_s"])
    if arch == DENSE_ARCH:
        phase_pool_path(torch, lm["model"], smi)
    launches = lm["launches"]
    del lm
    torch.cuda.empty_cache()
    return {"launches": launches}


#: the analysis gate's card part (`analysis_gate`, part "card_locks"):
#: caller threads mixing submit and evaluate_batch over the points, each at
#: least GATE_MIN_ROUNDS rounds and on until the gradient threads are done,
#: each of which runs one 2-lane gradient wave
GATE_CALLERS = 8
GATE_POINTS = 48
GATE_GRAD_THREADS = 2
GATE_MIN_ROUNDS = 10
#: the captured bodies the torch rule must resolve in the port
GATE_BODIES = ("uq/fused.py::_Block._body", "apps/tsunami.py::_Sweep.forward.body",
               "apps/tsunami.py::_Sweep.pull.body", "apps/composite.py::_CG.steps")


def _gate_card_locks(torch, dev) -> dict:
    """The race detector over the card's own locks: a fabric over a coarse
    `TsunamiModel`, both built inside `monitored(LockMonitor(...))`, takes
    evaluate waves from GATE_CALLERS threads while GATE_GRAD_THREADS threads
    each run a 2-lane gradient wave through it, whose step graphs are
    captured under `CAPTURE_LOCK` (built at import, so each module's binding
    of it is instrumented here, and put back after). Every row is held to a
    serial run of the same points bit for bit."""
    from repro_torch.analysis.races import (
        GuardedDict,
        LockMonitor,
        instrument_attr,
        monitored,
        watch_fields,
    )
    from repro_torch.apps import composite, tsunami
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core import device as core_device
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.swe.testing import SOURCE_BOX
    from repro_torch.uq import fused

    rng = np.random.default_rng(0)
    points = np.stack([rng.uniform(*SOURCE_BOX[0], GATE_POINTS),
                       rng.uniform(*SOURCE_BOX[1], GATE_POINTS)], axis=1)
    lanes = [points[2 * i:2 * i + 2] for i in range(GATE_GRAD_THREADS)]
    senss = [rng.standard_normal((2, 4)) for _ in range(GATE_GRAD_THREADS)]
    serial = TsunamiModel(dev)
    t0 = time.perf_counter()
    want = serial.evaluate_batch(points)
    want_g = [serial.gradient_batch(th, ss) for th, ss in zip(lanes, senss)]
    serial_s = time.perf_counter() - t0

    mon = LockMonitor(seed=0, perturb=True)
    bindings = (core_device, tsunami, fused, composite)
    plain = [mod.CAPTURE_LOCK for mod in bindings]
    rows, grads, errors, rounds = [], [None] * GATE_GRAD_THREADS, [], [0] * GATE_CALLERS
    book = threading.Lock()  # the harness's own, outside the monitor
    grads_left = [GATE_GRAD_THREADS]
    grads_done = threading.Event()
    deadline = time.monotonic() + 300.0

    def caller(k: int) -> None:
        crng = np.random.default_rng(100 + k)
        try:
            while (rounds[k] < GATE_MIN_ROUNDS or not grads_done.is_set()) \
                    and time.monotonic() < deadline:
                if crng.random() < 0.5:
                    idx = crng.integers(GATE_POINTS, size=1)
                    got = np.asarray(fabric.submit(points[idx[0]]).result(timeout=120))[None]
                else:
                    idx = crng.integers(GATE_POINTS, size=int(crng.integers(1, 9)))
                    got = np.asarray(fabric.evaluate_batch(points[idx]))
                with book:
                    rows.append((idx, got))
                rounds[k] += 1
        except Exception as e:  # noqa: BLE001 — raised after the join
            errors.append(f"caller {k}: {e!r}")

    def gradient(i: int) -> None:
        try:
            grads[i] = fabric.gradient_batch(lanes[i], senss[i])
        except Exception as e:  # noqa: BLE001 — raised after the join
            errors.append(f"gradient {i}: {e!r}")
        finally:
            with book:
                grads_left[0] -= 1
                if grads_left[0] == 0:
                    grads_done.set()

    with monitored(mon):
        capture = instrument_attr(core_device, "CAPTURE_LOCK", "cuda.capture", mon)
        for mod in bindings[1:]:
            mod.CAPTURE_LOCK = capture
        try:
            model = TsunamiModel(dev)
            model.stats = GuardedDict(mon, "tsunami.stats", model.stats)
            model.waves = GuardedDict(mon, "tsunami.waves", model.waves)
            fabric = EvaluationFabric(ModelBackend(model), max_batch=8, linger_s=1e-3,
                                      cache_size=16)
            fabric.stats = GuardedDict(mon, "fabric.stats", fabric.stats)
            threads = ([threading.Thread(target=caller, args=(k,)) for k in range(GATE_CALLERS)]
                       + [threading.Thread(target=gradient, args=(i,))
                          for i in range(GATE_GRAD_THREADS)])
            reset_launches()
            t0 = time.perf_counter()
            try:
                with watch_fields(mon, EvaluationFabric,
                                  ("linger_s", "max_batch", "_wave_latency_ewma"), tag="fabric"):
                    for t in threads:
                        t.start()
                    _join(threads, "analysis_gate card_locks", timeout_s=360.0)
            finally:
                fabric.shutdown()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            tel = fabric.telemetry()
        finally:
            for mod, lock in zip(bindings, plain):
                mod.CAPTURE_LOCK = lock
    if errors:
        raise AssertionError(f"analysis_gate card_locks: {errors}")
    for idx, got in rows:
        _same_bits(got, want[idx], f"analysis_gate: rows {idx.tolist()} against the serial wave")
    for i in range(GATE_GRAD_THREADS):
        _same_bits(grads[i], want_g[i], f"analysis_gate: gradient wave {i} against serial")
    report = mon.report()
    captures = report["acquisitions_by_lock"].get("cuda.capture", 0)
    if report["lock_order_cycles"] or report["unguarded_writes"]:
        raise AssertionError(f"analysis_gate card_locks: cycles {report['lock_order_cycles']}, "
                             f"unguarded writes {report['unguarded_writes']}")
    if captures < GATE_GRAD_THREADS:
        raise AssertionError(f"cuda.capture taken {captures} times under the monitor: the "
                             f"gradient waves' captures went unseen")
    # every evaluate wave one launch of the solve kernel; derivative waves none
    if counts["swe_solve"] != model.waves[0] or not model.waves[0] or model.waves[1]:
        raise AssertionError(f"launches {counts} for the model's waves {dict(model.waves)}")
    return {"rounds": sum(rounds), "rows_checked": sum(len(idx) for idx, _ in rows),
            "gradient_lanes_checked": 2 * GATE_GRAD_THREADS,
            "model_waves": dict(model.waves), "swe_solve_launches": counts["swe_solve"],
            "fabric": {k: tel[k] for k in ("waves", "points", "cache_hits", "coalesced")
                       if k in tel},
            "capture_acquisitions": captures, "acquisitions_by_lock": report["acquisitions_by_lock"],
            "lock_order_edges": report["lock_order_edges"],
            "lock_order_cycles": report["lock_order_cycles"],
            "unguarded_writes": report["unguarded_writes"],
            "serial_s": serial_s, "wall_s": wall}


def phase_analysis_gate(torch, dev) -> dict:
    """The port's analysis gate on the card, one line a part: (a) `lint`:
    the linter over the port's source and this script against the port's
    baseline, 0 findings for every rule, and the captured bodies the torch
    rule resolves; (b) `selftest`; (c) `stress`: the race detector's stress
    harness with its tap's online GP on the card; (d) `card_locks`: the
    detector over the card's own locks (`_gate_card_locks`)."""
    import repro_torch
    from repro_torch.analysis import (
        DEFAULT_BASELINE,
        RULE_IDS,
        apply_baseline,
        load_baseline,
        run_lint,
    )
    from repro_torch.analysis.rules.torch_discipline import captured_bodies
    from repro_torch.analysis.selftest import run_selftest
    from repro_torch.analysis.stress import run_stress

    t_phase = time.perf_counter()
    src = Path(repro_torch.__file__).resolve().parent
    t0 = time.perf_counter()
    new, old = apply_baseline(run_lint([src, ROOT / "chip_smoke.py"]),
                              load_baseline(DEFAULT_BASELINE))
    bodies = captured_bodies([src])
    lint_s = time.perf_counter() - t0
    if new:
        raise AssertionError("analysis_gate lint:\n" + "\n".join(map(str, new)))
    unresolved = [b for b in GATE_BODIES if not any(x.endswith(f"/{b}") for x in bodies)]
    if unresolved:
        raise AssertionError(f"the torch rule resolves no {unresolved} in {sorted(bodies)}")
    emit("analysis_gate", part="lint", findings_by_rule={r: 0 for r in RULE_IDS},
         baselined=len(old), captured_bodies=len(bodies), wall_s=lint_s)

    t0 = time.perf_counter()
    selftest = run_selftest()
    selftest_s = time.perf_counter() - t0
    if not selftest["passed"]:
        raise AssertionError(f"analysis_gate selftest: {json.dumps(selftest)}")
    emit("analysis_gate", part="selftest", passed=True,
         bad_findings={r: e["bad_findings"] for r, e in selftest["rules"].items()},
         wall_s=selftest_s)

    t0 = time.perf_counter()
    stress = run_stress(n_threads=8, seed=0, device=dev)
    stress_s = time.perf_counter() - t0
    tap = stress["scenarios"]["tap_exactly_once"]
    if not stress["passed"] or not tap["gp_device"].startswith("cuda"):
        raise AssertionError(f"analysis_gate stress: {json.dumps(stress, default=str)}")
    emit("analysis_gate", part="stress", passed=True,
         scenarios={name: {k: v for k, v in sc.items() if k != "violations"}
                    for name, sc in stress["scenarios"].items()},
         lock_order_cycles=stress["monitor"]["lock_order_cycles"],
         unguarded_writes=stress["monitor"]["unguarded_writes"],
         acquisitions=stress["monitor"]["acquisitions"], locks=stress["monitor"]["locks"],
         wall_s=stress_s)

    card = _gate_card_locks(torch, dev)
    emit("analysis_gate", part="card_locks", callers=GATE_CALLERS, points=GATE_POINTS,
         gradient_threads=GATE_GRAD_THREADS, **card,
         bound="bit for bit (every row and gradient == the serial run)")
    return {"wall_s": time.perf_counter() - t_phase}


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
    # every wave the paths hand the solve kernel, by width, for
    # `wave_widths_vs_plain`
    widths = WaveWidths(torch)
    with widths.installed():
        main_path = widths.run("main_path", phase_main_path, torch, dev)
        widths.run("derivative_waves", phase_derivative_waves, torch, dev, probe["smi"])
        mala = widths.run("mala_main_path", phase_mala_main_path, torch, dev)
        widths.run("laplace_path", phase_laplace_path, torch, dev)
        gp_level = widths.run("gp_level", phase_gp_level, torch, dev)
        three_level = widths.run("three_level_path", phase_three_level_path, torch, dev,
                                 gp_level["gps"])
        surrogate_da = widths.run("surrogate_da_path", phase_surrogate_da_path, torch, dev)
        fused = widths.run("fused_sampler", phase_fused_sampler, torch, dev)
        fused_check = widths.run("fused_kernel_vs_plain", phase_fused_kernel_vs_plain, torch,
                                 dev)
        fused_main = widths.run("fused_main_path", phase_fused_main_path, torch, dev, main_path)
        widths.run("fused_checkpoint", phase_fused_checkpoint, torch, dev)
        wire = widths.run("wire_main_path", phase_wire_main_path, torch, dev, main_path)
        service = widths.run("service_path", phase_service_path, torch, dev)
        fleet = widths.run("fleet_path", phase_fleet_path, torch, dev, main_path, wire)
    width_check = phase_wave_widths_vs_plain(torch, dev, widths)
    phase_l2sea_wire(torch, dev)
    composite = phase_composite_qmc_path(torch, probe["smi"])
    phase_composite_full_waves(torch, composite["model"], composite["thetas"], probe["smi"])
    del composite
    ssd_check = phase_ssd_kernel_vs_plain(torch, dev)
    ssd_times = phase_ssd_times(torch, dev, probe["smi"])
    lm = run_lm_path(torch, SSM_ARCH, probe["smi"])
    rms_check = phase_rmsnorm_kernel_vs_plain(torch, dev)
    rms_times = phase_rmsnorm_times(torch, dev, probe["smi"])
    rms_path = phase_rmsnorm_path(torch, dev)
    flash_check = phase_flash_kernel_vs_plain(torch, dev)
    flash_times = phase_flash_times(torch, dev, probe["smi"])
    f32_path = phase_flash_f32_path(torch)
    dense = run_lm_path(torch, DENSE_ARCH, probe["smi"])
    phase_analysis_gate(torch, dev)

    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
    if leaked or "repro" in sys.modules:
        raise AssertionError(f"the smoke run imported the JAX package: {leaked}")
    fine = next(s for s in times["shapes"] if s["shape"] == [2048, 16])
    fine_wave = next(s for s in times["waves"] if s["shape"] == [2048, 16])
    point = ssd_times["shapes"][0]  # one point: B = 2
    # one point: qwen3-0.6b's attention over 2 sequences, and its layer norm;
    # the float32 flash kernel at its own path's shape
    flash_point = next(s for s in flash_times["shapes"]
                       if s["shape"] == [LM_BATCH, 16, 8, LM_SEQ, 128])
    f32_shape = [F32_PATH_CASE[i] for i in (0, 1, 2, 3, 5)]
    f32_point = next(s for s in flash_times["shapes"]
                     if s["shape"] == f32_shape and s["dtype"] == "float32")
    rms_point = next(s for s in rms_times["shapes"] if s["shape"] == [LM_BATCH * LM_SEQ, 1024])
    print(probe["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "swe_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/swe/csrc/swe_solve.cu",
        "replaces": "src/repro/kernels/swe/swe.py:54",
        "replaces_scan": "src/repro/apps/tsunami.py:172",
        "launches": main_path["launches"],
        # the gradient-informed campaign's fine waves (its coarse waves are
        # derivative waves, PyTorch ops: the kernel is forward-only)
        "launches_mala_main_path": mala["launches"],
        # the GP level's design wave, and the three-level and surrogate-DA
        # campaigns (their warm-ups apart): every PDE wave one launch
        "launches_gp_level": gp_level["launches"],
        "launches_three_level_path": three_level["launches"],
        "launches_surrogate_da_path": surrogate_da["launches"],
        # the fused samplers: a timed run of 2 blocks x 50 steps + its
        # initial wave, and the fused-subchain campaign (`fused_level0`)
        "launches_fused_sampler": fused["launches"],
        "launches_fused_main_path": fused_main["launches"],
        # the same campaign behind HTTP model servers: through a router of
        # two servers, two tenants under the service tier, and a router
        # whose second member dies halfway
        "launches_wire_main_path": wire["launches"],
        "launches_wire_main_path_http_backend": wire["launches_http_backend"],
        "launches_service_path": service["launches"],
        "launches_fleet_path": fleet["launches"],
        "max_abs_err": check["solve_max_abs_err"],
        "max_abs_err_fused_path": fused_check["max_abs_err"],
        # every other width the paths above gave it, each held as launched
        "max_abs_err_path_widths": width_check["max_abs_err"],
        "path_widths_held": width_check["held"],
        "ms": fine_wave["ms"],
        "plain_ms": fine_wave["plain_ms"],
        "bound_ms": fine_wave["bound_ms"],
        "bound_by": fine_wave["bound_by"],
        "library_ms": None,
        "shape": fine_wave["shape"],
        "n_steps": fine_wave["n_steps"],
        # the plan's cluster size at this shape, and the same wave's time
        # at every cluster size ("1": one block a lane, the design before
        # clusters)
        "cluster": fine_wave["cluster"],
        "ms_by_cluster": fine_wave["ms_by_cluster"],
        "step_kernel_loop_ms": fine_wave["step_kernel_loop_ms"],
        "by_shape": times["waves"],
        "launches_per_wave": {k: v["launches"]["swe_solve"]
                              for k, v in solves["waves"].items()},
        "wall_s_per_wave": {k: v["wall_s"] for k, v in solves["waves"].items()},
        "card": probe["smi"],
    }, {
        "name": "swe_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/swe/csrc/swe_step.cu",
        "replaces": "src/repro/kernels/swe/swe.py:54",
        # its own path, a 16-lane wave per level through
        # solve_batch(step=swe_step): the model's waves take the solve kernel
        "launches": solves["step_path_launches"],
        "max_abs_err": check["max_abs_err"],
        "ms": fine["ms"],
        "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"],
        "bound_by": fine["bound_by"],
        "library_ms": None,
        "shape": fine["shape"],
        "by_shape": times["shapes"],
        "per_step_path_wall_s_per_wave": {k: v["per_step_kernel_path_wall_s"]
                                          for k, v in solves["waves"].items()
                                          if "per_step_kernel_path_wall_s" in v},
        "card": probe["smi"],
    }, {
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:89",
        "launches": lm["launches"],
        "max_abs_err": ssd_check["max_abs_err"],
        "max_rel_err": ssd_check["max_rel_err"],
        "ms": point["ms"],
        "plain_ms": point["plain_ms"],
        "bound_ms": point["bound_ms"],
        "bound_by": point["bound_by"],
        "library_ms": None,
        "shape": point["shape"],
        "by_shape": ssd_times["shapes"],
        "card": probe["smi"],
    }, {
        "name": "flash_attention_wgmma",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
        "dtype": "bfloat16",
        "launches": dense["launches"],
        "max_abs_err": flash_check["wgmma"],
        "ms": flash_point["ms"],
        "plain_ms": flash_point["plain_ms"],
        "bound_ms": flash_point["bound_ms"],
        "bound_by": flash_point["bound_by"],
        "library_ms": flash_point["library_ms"],
        "cuda_core_ms": flash_point["cuda_core_ms"],
        "shape": flash_point["shape"],
        "by_shape": [s for s in flash_times["shapes"] if s["dtype"] == "bfloat16"],
        "card": probe["smi"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
        "dtype": "float32",
        # its own path: the reduced qwen3-0.6b in float32 (bf16 goes to the
        # tensor-core kernel)
        "launches": f32_path["launches"],
        "max_abs_err": flash_check["cuda_core"],
        "max_abs_err_bf16": flash_check["cuda_core_bf16"],
        "ms": f32_point["ms"],
        "plain_ms": f32_point["plain_ms"],
        "bound_ms": f32_point["bound_ms"],
        "bound_by": f32_point["bound_by"],
        "library_ms": f32_point["library_ms"],
        "shape": f32_point["shape"],
        "by_shape": [s for s in flash_times["shapes"] if s["dtype"] == "float32"],
        "card": probe["smi"],
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:26",
        # its own path, the entry point at qwen3-0.6b's norm shapes: no model
        # calls it, as in the JAX package
        "launches": rms_path["launches"],
        "max_abs_err": rms_check["max_abs_err"],
        "ms": rms_point["ms"],
        "plain_ms": rms_point["plain_ms"],
        "bound_ms": rms_point["bound_ms"],
        "bound_by": rms_point["bound_by"],
        "library_ms": rms_point["library_ms"],
        "shape": rms_point["shape"],
        "by_shape": rms_times["shapes"],
        "card": probe["smi"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
