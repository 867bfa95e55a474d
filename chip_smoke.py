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
  one launch per time step; the solve's hand-written adjoint
  (`swe_solve_vjp`: the reverse mode of a whole wave in one launch, from
  the checkpoints the solve's launch keeps, a lane over a cluster as the
  solve's) against the plain differentiable solver and, bit for bit at
  every cluster size, its plain version, timed at every cluster size
  (`swe_vjp_vs_plain`); then the model's
  derivative surface: a fused value-and-gradient, a JVP and an HVP wave of
  16 lanes per level (wall, busy share under the profiler, peak memory;
  the fused wave one solve and one adjoint launch, the JVP and HVP waves
  PyTorch ops under autograd, as the JAX package's are scan ops), the
  gradient-informed campaign (`coarse_sampler="mala"`: coarse subchains on
  fused value-and-gradient waves, fine waves on the solve kernel) and the
  Laplace preview on the coarse level with both curvature modes; then the
  GP level of the
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
  `main_path`'s campaign with fused coarse subchains (`fused_main_path`),
  a fused MALA kill-and-resume (`fused_checkpoint`), and fused MALA over
  the coarse tsunami (`fused_mala_tsunami`: S solve and S adjoint launches
  a replay, fused == per-step bit for bit, the host loop in law); then the
  same campaign behind UM-Bridge HTTP model servers in this process
  (`core/server.py`): through `HTTPBackend` and a router of two servers
  (`wire_main_path`), two tenants at once under `UQService`
  (`service_path`), and a router whose second member dies halfway, under
  a `FleetManager` (`fleet_path`), each equal to `main_path`'s samples
  bit for bit; every wave width those paths gave the solve kernel that
  the fixed shapes do not cover, held against the plain loop as launched
  (`wave_widths_vs_plain`); and the paper's §4.1 L2-Sea sparse grid over
  the wire (`l2sea_wire`);
* the LM-as-UQ-model serving flow of `examples/serve_uq.py` on three
  full-width models from seeded random weights (bf16): mamba2-1.3b (48
  layers), every layer of every forward one launch of the SSD chunk-scan
  kernel; qwen3-0.6b (28 layers, the model the example serves), every
  layer one launch of the bf16 tensor-core flash-attention kernel (wgmma
  and TMA, reading the model's [B, S, n, hd] tensors through strides); and
  deepseek-moe-16b whole (28 layers, 64 routed experts top-6 and 2 shared,
  30.5 GiB), every layer one flash launch, the experts library GEMMs, each
  grid point routed on its own. Each runs a level-4 sparse grid of the NLL
  over (embedding scale, temperature) through the fabric, the surrogate's
  Monte Carlo, and 8 per-point submits; then one wave on the kernel path
  against the plain path, and one wave under the profiler;
* one lighter phase each for the rest of the zoo's families, at full
  width: zamba2-1.2b (hybrid: 32 SSD scans and 6 flash launches of its
  shared block a forward), minicpm3-4b (MLA: 62 flash launches, its heads
  zero-padded to hd 128 at scale 1/sqrt(96)), llama-3.2-vision-90b cut to
  10 layers (8 causal self-attentions and 2 full cross-attentions of 2,048
  tokens against 1,601 context tokens) and kimi-k2-1t-a32b cut to 2 layers
  (one MoE of 384 experts): one wave on the kernel path, exact launches,
  against the plain path, then under the profiler;
* after each of those LMs' waves, its serving steps (`models/model.py::
  prefill_step`, `decode_step`): a prefill of 2 × 2,016 tokens on the
  kernels (exactly one forward's launches), then 32 decode steps of plain
  PyTorch (no launch), timed, beside their bytes bound and busy share;
  the logits held to the full forward at the same positions, each unit of
  the stack teacher-forced (`UnitTap`), and layer 0's decode-written cache
  rows to a prefill's; the same in float32 for six families
  (`decode_f32_*`), and qwen3-0.6b's step at the grid wave's 82 sequences
  (`dense_lm_serving_batch`, 19.3 GB of KV cache);
* the RMSNorm kernel through its own entry point at qwen3-0.6b's norm
  shapes: as in the JAX package, no model calls it;
* the float32 flash-attention kernel (mma.sync in 3xTF32) on its own path: the
  reduced qwen3-0.6b in float32, as the port's tests run it, serving a
  level-2 sparse grid through the fabric;
* the flash-attention backward kernels (three a call: bf16
  `flash_attention_bwd_wgmma.cu`, float32 `flash_attention_bwd_3xbf16.cu`,
  both wgmma and TMA, float32 in 3xBF16) against the plain backward at the
  training shapes of the zoo, each kernel's time from a trace and two calls
  at qwen3-0.6b's training shape, bf16 and float32, bit for bit
  (`flash_bwd_vs_plain`), then the LM
  zoo's training through `repro_torch.launch.train.train`: qwen3-0.6b at
  full width and depth in bf16 (remat "full", 4 x 4,096 tokens, 8 steps, a
  checkpoint every 4, a StepFailure and a NaN injected: retried, restored
  and replayed bit for bit; launches exactly 56 forward and 28 of each
  backward kernel a step; every attention's gradients held in situ against
  the plain backward; `train_path`), the same training on a 1x1 NCCL mesh
  (`train(..., ctx=)`: its first 6 steps, the failure and the NaN
  included, train_path's losses bit for bit, its checkpoint restored
  without a mesh leaf for leaf; `train_mesh_path`), and one float32 step of
  its first 4 layers against the plain path's gradients (`train_f32_path`);
* the LM-as-UQ-model's derivative operations (`apps/lm_model.py`): on
  qwen3-0.6b at full width and depth a `gradient_batch` wave of 8 points
  through the fabric, one forward and one reverse pass of the stack,
  launching exactly 56 bf16 flash forwards (forward and remat recompute)
  and 28 of each backward kernel, held to the plain path's gradients,
  `apply_jacobian_batch` == gradient . vec, and an `apply_hessian_batch`
  wave (plain attention, 512 tokens a sequence) that launches no kernel
  (`dense_lm_gradient_path`); mamba2-1.3b's gradient wave on the plain SSD,
  no kernel (`lm_gradient`);
* the deployment driver as a user starts it, `python -m
  repro_torch.launch.serve --model lm --arch qwen3-0.6b --port 0`, in a
  subprocess: `/ModelInfo` lists all eight operations, an Evaluate and a
  Gradient round trip equal the in-process model's (`serve_driver`); and
  the five `examples/torch_*.py` as subprocesses on the card, side by side
  (`examples_on_card`);
* the device mesh on the UQ path (`distributed/sharding.py`,
  `launch/mesh.py`), after qwen3-0.6b's derivative operations: on a 1x1
  mesh in this process (world size 1, NCCL) `main_path`'s campaign through
  `SPMDBackend(ModelPool(TsunamiModel(), ctx))` and qwen3-0.6b's 8-point
  wave through `LMUQModel(ctx=)`, each bit for bit against its run without
  a mesh (`mesh_main_path`); then two ranks on the one card over `gloo`,
  each a process of this script (`--mesh-rank`) under a host watchdog: a
  fine wave split 8/8 and a fused coarse RWM split 8/8, bit for bit, the
  RWM's rank-0 checkpoint resumed in this process, the LM wave split 4/4
  within LM_NLL_RTOL; then qwen3-0.6b (2 layers) trained FSDP over data = 2
  and, from that checkpoint, TP over model = 2, within MESH_TRAIN_RTOL of
  one device, and minicpm3-4b (2 layers, float32) served on (1, 2), its
  latent cache split over its rows, by flash decoding with no all-gather,
  within MLA_MESH_RTOL of one device (`mesh_two_ranks`).

Last, the port's analysis gate (`analysis_gate`, `repro_torch.analysis`):
its linter over the port and this script (every rule 0 findings, against
an empty baseline), its selftest, its race detector's stress harness with
the tap's online GP on the card, and the detector over the card's own
locks: evaluate waves from 8 threads through a monitored fabric beside two
gradient waves that capture their step graphs under the instrumented
`CAPTURE_LOCK`, every row bit for bit against a serial run.

The build phase is followed by the count of the tensor-core instructions in
the SASS of the kernels that use them: HGMMA (wgmma) in the bf16 flash
kernel and in both backwards' dK/dV and dQ kernels (with the float32
backward's HMMA count beside it: 0, no mma.sync left), HMMA (mma.sync,
TF32) in the float32 flash kernel and in the SSD kernel, with the registers
and spills of all but the first from their build logs (both backwards'
dK/dV and dQ kernels must not spill at hd 128).

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
import gc
import json
import os
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
# float operations per (cell, lane) of one reverse step of the SWE adjoint
# (csrc/swe_solve_vjp.cu), counted from its source as above: the step again
# up to the limiter (velocity 10, face 48, divergence, limiter and wet mask
# 9), each face's adjoint (its cotangents 2, its reconstruction again 19,
# the transpose 73) and each cell's (its shares 3, the velocity's adjoint
# 30). The kernel also recomputes each forward step once (67 more)
SWE_VJP_OPS_PER_CELL_LANE = 194
# the solve's planned cluster size may take at most this much longer than
# one block a lane at a timed shape: the windows' spread is ~1-3%
PLAN_SLACK = 1.10

# the LM paths: examples/serve_uq.py's flow on full-width mamba2-1.3b,
# qwen3-0.6b (the model the example serves) and deepseek-moe-16b (whole, 28
# layers, 30.5 GiB of bf16 weights); then one lighter phase each for the
# hybrid, MLA, vlm and trillion-parameter MoE members of the zoo
SSM_ARCH = "mamba2-1.3b"
DENSE_ARCH = "qwen3-0.6b"
MOE_ARCH = "deepseek-moe-16b"
ZOO_SSM_ARCH = "zamba2-1.2b"
#: the lighter phases: (arch, layers kept at full width or None for all,
#: points in the wave). llama-3.2-vision-90b's 100 layers (163 GiB) and
#: kimi-k2's 61 (1.9 TiB) do not fit one card: 10 layers (8 self, 2 cross;
#: 10.68B parameters) and 2 (one dense, one MoE of 384 experts; 19.97B)
ZOO_PATHS = ((ZOO_SSM_ARCH, None, 8), ("minicpm3-4b", None, 8),
             ("llama-3.2-vision-90b", 10, 8), ("kimi-k2-1t-a32b", 2, 2))
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
# the same bound for the rest of the zoo (deepseek-moe-16b, zamba2-1.2b,
# minicpm3-4b, llama-3.2-vision-90b, kimi-k2). Their random bf16 forwards
# are far less well conditioned (no qk-norm; in float32 at the reduced size
# 100-400x qwen3-0.6b's error against float64, tests/_torch_zoo.py): on an
# H100 (700 W) deepseek's kernel path moved its own NLL by 2.9e-3 between
# an 8-point wave and one-point forwards (other GEMM tilings, nothing else),
# and the kernel paths differed from the plain paths by 2.4e-3 to 3.8e-3
# (PERF.md, PR 26). 1e-2 is 2.6x the largest. A MoE's plain wave replays
# the kernel wave's experts (`PinnedRouting`). What holds the kernel in
# these models is `in_situ_attention`, every launch against the plain
# version on the model's own tensors.
ZOO_NLL_RTOL = 1e-2

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
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_fused
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.swe import swe_solve, swe_solve_vjp, swe_step

    return {"swe_solve": swe_solve, "swe_solve_vjp": swe_solve_vjp, "swe_step": swe_step,
            "ssd": ssd,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "rmsnorm": rmsnorm_fused}


def reset_launches() -> None:
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
        for name in getattr(wrapper, "launches_by_kernel", {}):
            wrapper.launches_by_kernel[name] = 0


def read_launches() -> dict:
    """Launches by kernel: flash attention's two kernels (the float32
    `flash_attention`, the bf16 `flash_attention_wgmma`) apart, and each
    backward library's three (`ops.BWD_KERNELS`: bf16
    `flash_attention_bwd_wgmma_stats`, `_dkdv`, `_dq`; float32
    `flash_attention_bwd_3xbf16_split`, `_dkdv`, `_dq`)."""
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
                # a gradient wave's tensors carry its graph: keep their values
                inputs = {k: v.detach().clone() if self.torch.is_tensor(v) else v
                          for k, v in kw.items()}
                self.first[key] = (dict(h=h.detach().clone(), hu=hu.detach().clone(),
                                        b=b.detach().clone(), **inputs),
                                   tuple(t.detach().clone() for t in out))


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
    # evidence that the flash kernels and the SSD kernel run on the tensor
    # cores: HGMMA (warpgroup MMA) in the bf16 flash kernel's SASS and in
    # both backwards' dK/dV and dQ kernels, HMMA (mma.sync) in the float32
    # forward's and the SSD kernel's (every function of the forward's wgmma
    # library; every instance of the other kernels named)
    for stem, op, names in (("flash_attention_wgmma", "HGMMA", ("",)),
                            ("flash_attention_bwd_wgmma", "HGMMA", BWD_RING_KERNELS[
                                "flash_attention_bwd_wgmma"]),
                            ("flash_attention_bwd_3xbf16", "HGMMA", BWD_RING_KERNELS[
                                "flash_attention_bwd_3xbf16"]),
                            ("flash_attention", "HMMA", ("flash_attention_kernel",)),
                            ("ssd", "HMMA", ("ssd_chunk_scan_kernel",))):
        counts = sass_counts(libs[stem], op)
        kernels = {f: n for f, n in counts.items() if any(k in f for k in names)}
        if any(not any(k in f for f in kernels) for k in names) or min(kernels.values()) == 0:
            raise AssertionError(f"a tensor-core kernel without {op}: {counts}")
        fields = {}
        if stem != "flash_attention_wgmma":
            # registers and spills of each instance (-Xptxas -v, SOURCE_FLAGS)
            fields["ptxas"] = ptxas_lines(libs[stem])
        if stem in BWD_RING_KERNELS:
            spills = bwd_spills_hd128(fields["ptxas"], names)
            fields["spills_hd128"] = spills
            if set(spills) != set(names) or any(spills.values()):
                raise AssertionError(f"{stem}: the backward's wgmma kernels at hd 128 spill or "
                                     f"are missing from the build log: {spills}")
            # no mma.sync left in the float32 backward: every product on wgmma
            hmma = sass_counts(libs[stem], "HMMA")
            fields["hmma_by_function"] = {f: n for f, n in hmma.items()
                                          if any(k in f for k in names)}
        emit("sass", library=str(libs[stem].relative_to(ROOT)),
             **{f"{op.lower()}_instructions": sum(kernels.values()),
                f"{op.lower()}_by_function": kernels}, **fields)
    # the SWE adjoint: registers and spills of its two instances (1 and 2
    # cells a thread; 1,024 threads a block allow 64 registers)
    emit("ptxas", library=str(libs["swe_solve_vjp"].relative_to(ROOT)),
         ptxas=ptxas_lines(libs["swe_solve_vjp"]))


def ptxas_lines(library: Path) -> list:
    """The `-Xptxas -v` lines of a library's build log (`SOURCE_FLAGS`):
    each instance's name, registers and spills."""
    log = library.with_suffix(".log").read_text().splitlines()
    return [line.strip() for line in log
            if "Compiling entry" in line or "registers" in line or "spill" in line]


#: the dK/dV and dQ kernels of each backward library, by their symbols
BWD_RING_KERNELS = {"flash_attention_bwd_wgmma": ("dkdv_wgmma_kernel", "dq_wgmma_kernel"),
                    "flash_attention_bwd_3xbf16": ("dkdv_3xbf16_kernel", "dq_3xbf16_kernel")}


def bwd_spills_hd128(lines: list, names) -> dict:
    """Spill stores + loads (bytes) of the hd-128 instances of a backward's
    dK/dV and dQ kernels (`names`, their symbols), from their `ptxas_lines`
    (each instance's "Compiling entry function" line, then its spill
    line)."""
    spills, current = {}, None
    for line in lines:
        if "Compiling entry" in line:
            current = next((k for k in names if k in line and "ILi128E" in line), None)
        elif current and "spill" in line:
            stores, loads = (int(w) for w in
                             (line.split("bytes spill stores")[0].split()[-1],
                              line.split("bytes spill loads")[0].split()[-1]))
            spills[current] = stores + loads
            current = None
    return spills


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


#: plain solves of at most this many steps run eagerly in `kernel_vs_plain`;
#: longer ones (the whole waves: 2,224 and 8,899 steps) replay a CUDA graph
#: a step, which saves ~1 min of host launches a run
EAGER_PLAIN_STEPS = 1000


def phase_kernel_vs_plain(torch, dev) -> dict:
    """Both SWE kernels against their plain versions on the card, bit for
    bit (the bound and its reason: `repro_torch.kernels.swe.testing`): the
    step kernel on the four limiter cases, at every [cells, lanes] shape
    the main path runs and at ragged shapes, each at the plan's strip depth
    and at every other depth; the solve kernel on the limiter cases over 300 steps,
    on whole waves at both levels (1, 4, 8, 13, 16 and 64 lanes) and on a
    2,047-cell wave with its buoy rows on a slice edge, each at the plan's
    cluster size and at every other size the kernel runs, against one plain
    loop (the whole waves' as a CUDA graph a step, `EAGER_PLAIN_STEPS`)."""
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
        swe_solve_ref_replayed,
    )

    report = {}
    for case in CASES:
        h, hu, b, dt_dx = case_inputs(case, dev)
        want = swe_step_ref(h, hu, b, dt_dx)
        for strip in (*swe_ops.STRIP_DEPTHS, None):  # the plan's last: its errors are kept
            got = swe_step(h, hu, b, dt_dx=dt_dx, strip=strip)
            torch.cuda.synchronize()
            errors = assert_step_equal(got, want, (h, hu), f"{case}, strip {strip}")
        report[case] = dict(strip=swe_ops.strip_plan(*h.shape), **errors)
    worst = max(r[key]["max_abs"] for r in report.values() for key in ("h", "hu"))
    emit("kernel_vs_plain", kernel="swe_step", bound="bit for bit at every strip depth",
         strip_depths=list(swe_ops.STRIP_DEPTHS), cases=report)
    solves = {}
    for case in SOLVE_CASES:
        kw = solve_case_inputs(case, dev)
        h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
        C, N = h.shape
        # the whole waves' plain loop as a CUDA graph a step (the same
        # operations, bit for bit the eager loop: tests/test_torch_gpu.py),
        # as `wave_widths_vs_plain` runs it; the short cases eagerly
        plain = swe_solve_ref if kw["n_steps"] <= EAGER_PLAIN_STEPS else swe_solve_ref_replayed
        want = plain(h, hu, b, **kw)
        by_cluster = {}
        for cluster in (None, *(cs for cs in CLUSTER_SIZES if cs <= C)):
            got = swe_solve(h, hu, b, **kw, cluster=cluster)
            torch.cuda.synchronize()
            by_cluster["plan" if cluster is None else str(cluster)] = assert_solve_equal(
                got, want, f"{case}, cluster {cluster}")
        solves[case] = dict(shape=[C, N], n_steps=kw["n_steps"], rows=list(kw["rows"]),
                            plain="eager" if plain is swe_solve_ref else "a graph a step",
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


#: the waves whose plain loop `solve_times` times beside the 16-lane ones
#: (the kernel table's 512-lane fine wave; (512, 64), (2048, 64) and
#: (512, 512) were timed too until the trainer on a mesh needed the run's
#: time: ~15 s of eager loops)
SOLVE_PLAIN_TIMED = ((2048, 512),)


def phase_times(torch, dev, smi: str, solves: dict) -> dict:
    """Device time of one step-kernel launch at the main path's shapes, at
    the plan's strip depth and at every depth, beside its bytes bound and
    its floor (one launch of the smallest step, [2, 1], timed the same
    way), with the step kernel's own path's wall per wave (`solves`, from
    `full_solves`); and of one solve-kernel launch (a whole wave) at both
    levels and 16, 64 and 512 lanes, each beside its bound, at every
    cluster size and the plan's (with the card's count of resident
    clusters of each size); the solve beside the step kernel's loop over
    the same wave (n_steps x the step's time) and the plain loop's device
    time. At 16 lanes every cluster size is held against the plain loop bit
    for bit."""
    from repro_torch.convert import swe_state_from_numpy
    from repro_torch.kernels.swe import ops as swe_ops
    from repro_torch.kernels.swe import swe_solve, swe_solve_ref, swe_step, swe_step_ref
    from repro_torch.kernels.swe.testing import (
        CASE_DT_DX,
        CLUSTER_SIZES,
        TIMED_SHAPES,
        assert_solve_equal,
        main_path_state,
        swe_state,
        wave_inputs,
    )

    def time_step(h, hu, b, dt_dx, pair, strip=None):
        return _device_ms(
            torch, lambda: swe_step(h, hu, b, dt_dx=dt_dx, out=pair, strip=strip), calls=200)

    # the floor: the smallest step, two cells of one lane
    h, hu, b = swe_state_from_numpy(*swe_state("moving", 2, 1), dev)
    floor_ms = time_step(h, hu, b, CASE_DT_DX, (torch.empty_like(h), torch.empty_like(hu)))
    shapes = []
    for C in (512, 2048):
        for N in (4, 16, 64, 512):
            h, hu, b, dt_dx = main_path_state(C, N, dev)
            pair = (torch.empty_like(h), torch.empty_like(hu))
            ms = time_step(h, hu, b, dt_dx, pair)
            by_strip = {str(d): time_step(h, hu, b, dt_dx, pair, d)
                        for d in swe_ops.STRIP_DEPTHS}
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
            bound_ms = max(t_bytes, t_ops) * 1e3
            shapes.append({
                "shape": [C, N], "strip": swe_ops.strip_plan(C, N), "ms": ms,
                "ms_by_strip": by_strip, "plain_ms": plain_ms,
                "host_ms_per_launch": host_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "share_of_bound": bound_ms / ms,
                # below the floor, one launch's own cost sets the time
                "bound_below_floor": bound_ms < floor_ms,
                "bytes": nbytes, "ops": ops,
            })
    path = {k: {"wall_s": v["per_step_kernel_path_wall_s"], "n_steps": v["n_steps"],
                "wall_ms_per_step": v["per_step_kernel_path_wall_s"] / v["n_steps"] * 1e3}
            for k, v in solves["waves"].items() if "per_step_kernel_path_wall_s" in v}
    emit("times", kernel="swe_step",
         timer="one CUDA event pair around 200 back-to-back steps (plain: 16), "
               "per step, median of 5 windows",
         floor={"shape": [2, 1], "ms": floor_ms}, shapes=shapes,
         step_path_wall_by_wave=path, library_ms=None, card=smi)
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
        plain, plain_ms = [], None
        if N == 16 or (C, N) in SOLVE_PLAIN_TIMED:
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
               "pair around one plain loop (16 lanes and SOLVE_PLAIN_TIMED; else null)",
         waves=waves, library_ms=None, card=smi)
    return {"shapes": shapes, "waves": waves, "floor_ms": floor_ms, "step_path": path}


def vjp_work(C: int, N: int, n_steps: int, R: int) -> dict:
    """Bytes one adjoint launch must move (the checkpoints, b, the depths at
    rest and the cotangent read once, (gh, ghu) written once; its scratch
    is its own) and its float operations (a forward step recomputed and a
    reverse step per cell, lane and step)."""
    from repro_torch.kernels.swe.ref import checkpoint_every

    n_seg = -(-n_steps // checkpoint_every(n_steps))
    return {"bytes": (n_seg * (2 * C * N + R * N) + C + R + R * N + 2 * C * N) * 4,
            "ops": (SWE_OPS_PER_CELL_LANE + SWE_VJP_OPS_PER_CELL_LANE) * C * N * n_steps}


#: the adjoint's timed cases: both levels at 16 lanes (a derivative wave's
#: chunk) and the coarse level at 512 lanes
VJP_TIMED = ("wave_512x16", "wave_2048x16", "wave_512x512")


def phase_swe_vjp_vs_plain(torch, dev, smi: str) -> dict:
    """The SWE solve's adjoint kernel (`swe_solve_vjp`, through `swe_solve`'s
    autograd rule: the solve's checkpointing launch, then the adjoint's)
    against the plain differentiable solver (`apps.tsunami._Sweep`, float32,
    a replayed CUDA graph a step) on the same inputs at every
    `testing.VJP_CASES` case, within GRAD_RTOL32 of each cotangent's largest
    entry, each case twice, bit for bit; the limiter cases against the
    kernel's plain version `swe_solve_vjp_ref` too, bit for bit at every
    cluster size (`cluster=`); the whole
    waves at `VJP_TIMED` at every cluster size, each the plan's bits; the
    checkpointing launch against the launch without checkpoints, bit for
    bit, at every cluster size (both levels, 16 lanes). Times at
    `VJP_TIMED`: the adjoint launch alone beside its bound at the plan's
    cluster size and at each other, the solve with and without
    checkpoints, and the `_Sweep` wave's wall (the plain path, forward and
    reverse)."""
    from repro_torch.kernels.swe import ops as swe_ops
    from repro_torch.kernels.swe import swe_solve, swe_solve_vjp, swe_solve_vjp_ref
    from repro_torch.kernels.swe.ref import checkpoint_every
    from repro_torch.kernels.swe.testing import (
        CLUSTER_SIZES,
        GRAD_RTOL32,
        VJP_CASES,
        assert_solve_equal,
        assert_vjp_close,
        solve_vjp,
        sweep_vjp,
        vjp_case_inputs,
    )

    cases = {}
    for case in VJP_CASES:
        kw = vjp_case_inputs(case, dev)
        h, hu, b, cot = kw.pop("h"), kw.pop("hu"), kw.pop("b"), kw.pop("cot_mx")
        C, N = h.shape
        reset_launches()
        got = solve_vjp(h, hu, b, cot, **kw)
        again = solve_vjp(h, hu, b, cot, **kw)
        torch.cuda.synchronize()
        counts = read_launches()
        if (counts["swe_solve"], counts["swe_solve_vjp"]) != (2, 2):
            raise AssertionError(f"{case}: launches {counts}, expected 2 of swe_solve and "
                                 "2 of swe_solve_vjp")
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"{case}: two calls of the adjoint differ")
        sweep_s, want = _timed(torch, lambda: sweep_vjp(h, hu, b, cot, **kw))
        entry = {"shape": [C, N], "n_steps": kw["n_steps"],
                 "checkpoint_every": checkpoint_every(kw["n_steps"]),
                 "vs_sweep": assert_vjp_close(got, want, f"{case} against _Sweep"),
                 "two_calls_bit_for_bit": True, "sweep_wall_s": sweep_s}
        args = (h, hu, b, kw["dt_dx"], kw["n_steps"], kw["rows"], kw["h0_rows"], None)
        if case.startswith("solve_"):
            ref_s, ref = _timed(torch, lambda: swe_solve_vjp_ref(h, hu, b, cot, **kw))
            entry["vs_plain_version"] = assert_vjp_close(got, ref, f"{case} against the "
                                                         "plain version")
            _, _, ck, ck_mx = swe_ops._solve(*args, keep=True)
            sizes = [cs for cs in CLUSTER_SIZES if cs == 1 or 2 * cs <= C]
            for cs in sizes:
                by_cs = swe_solve_vjp(b, ck, ck_mx, cot, **kw, cluster=cs)
                if not (torch.equal(by_cs[0], ref[0]) and torch.equal(by_cs[1], ref[1])):
                    raise AssertionError(f"{case}, cluster {cs}: the adjoint differs from "
                                         "its plain version")
            entry["bit_for_bit_with_plain_version"] = {"cluster_sizes": sizes, "equal": True}
            entry["plain_version_wall_s"] = ref_s
            del ck, ck_mx
        if case in VJP_TIMED:
            _, _, ck, ck_mx = swe_ops._solve(*args, keep=True)
            calls = 1 if C * N > 16 * 512 else 3
            plan = swe_ops.vjp_cluster_plan(C, N)
            ms_by_cluster = {}
            for cs in CLUSTER_SIZES:
                by_cs = swe_solve_vjp(b, ck, ck_mx, cot, **kw, cluster=cs)
                if not (torch.equal(by_cs[0], got[0]) and torch.equal(by_cs[1], got[1])):
                    raise AssertionError(f"{case}, cluster {cs}: the adjoint differs from "
                                         f"the plan's (cluster {plan})")
                ms_by_cluster[str(cs)] = _device_ms(
                    torch, lambda: swe_solve_vjp(b, ck, ck_mx, cot, **kw, cluster=cs),
                    calls=calls)
            ms = ms_by_cluster[str(plan)]
            work = vjp_work(C, N, kw["n_steps"], len(kw["rows"]))
            t_bytes, t_ops = work["bytes"] / HBM_BYTES_PER_S, work["ops"] / FP32_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            entry.update(
                cluster=plan, ms_by_cluster=ms_by_cluster, bit_for_bit_by_cluster=True,
                ms=ms, ms_per_step=ms / kw["n_steps"],
                solve_with_checkpoints_ms=_device_ms(
                    torch, lambda: swe_ops._solve(*args, keep=True), calls=5),
                solve_ms=_device_ms(torch, lambda: swe_solve(h, hu, b, **kw), calls=5),
                plain_ms=sweep_s * 1e3, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                share_of_bound=bound_ms / ms, **work)
            del ck, ck_mx
        cases[case] = entry
    primal = {}
    for case in ("wave_512x16", "wave_2048x16"):
        kw = vjp_case_inputs(case, dev)
        h, hu, b, _ = kw.pop("h"), kw.pop("hu"), kw.pop("b"), kw.pop("cot_mx")
        for cs in CLUSTER_SIZES:
            want = swe_solve(h, hu, b, **kw, cluster=cs)
            got = swe_ops._solve(h, hu, b, kw["dt_dx"], kw["n_steps"], kw["rows"],
                                 kw["h0_rows"], cs, keep=True)
            torch.cuda.synchronize()
            assert_solve_equal(got[:2], want, f"{case}, cluster {cs}, with checkpoints")
        primal[case] = {"cluster_sizes": list(CLUSTER_SIZES), "bit_for_bit": True}
    worst = max(e["vs_sweep"][k]["rel_to_largest"] for e in cases.values() for k in ("gh", "ghu"))
    emit("swe_vjp_vs_plain", kernel="swe_solve_vjp",
         bound=f"{GRAD_RTOL32} of each cotangent's largest entry against _Sweep (float32) "
               "and the plain version; the limiter cases bit for bit with the plain version "
               "at every cluster size; two calls, every cluster size and the checkpointing "
               "primal bit for bit",
         timer="adjoint and solves: one CUDA event pair around back-to-back launches, median "
               "of 5 windows; _Sweep and the plain version: host wall ending in a sync",
         cases=cases, checkpointing_primal=primal, worst_rel_to_largest=worst, card=smi)
    return {"cases": cases, "max_rel_err": worst}


#: the lanes at which `full_solves` holds the model's wave to its plain path
#: (eager, ~50 kernels a step: ~2.8 s coarse, ~10 s fine on the card's
#: host); 4 and 64 lanes were held too until the trainer on a mesh needed
#: the run's time: `kernel_vs_plain` holds the kernel itself at 1, 4, 8, 13,
#: 16 and 64 lanes (`testing.SOLVE_SHAPES`)
FULL_SOLVE_PLAIN_LANES = (16,)


def phase_full_solves(torch, dev) -> dict:
    """Whole waves through `TsunamiModel.evaluate_batch` at both levels and
    4, 16, 64 and 512 lanes: each ONE launch of the solve kernel and none of
    the step kernel. At FULL_SOLVE_PLAIN_LANES held bit for bit to the same
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
            if lanes in FULL_SOLVE_PLAIN_LANES:
                t0 = time.perf_counter()
                plain = solve_batch(t_dev, n_cells, smoothed,
                                    step=swe_step_ref_into).cpu().numpy().astype(float)
                entry["plain_wall_s"] = time.perf_counter() - t0
                np.testing.assert_array_equal(ys, plain,
                                              err_msg=f"level {level}, {lanes} lanes")
            out[f"{level}x{lanes}"] = entry
    emit("full_solves", waves=out, step_path_launches=step_path_launches,
         bound=f"bit for bit: against the plain path at {FULL_SOLVE_PLAIN_LANES} lanes, "
               "against the per-step kernel path at 16 and 512")
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
        _pad_trace(torch)
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
        if cat in busy and ev.get("ph") == "X" and TRACE_PAD_NAME not in ev.get("name", ""):
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


#: one-cycle spin kernels (`torch.cuda._sleep(1)`, symbol `spin_kernel`)
#: launched and synchronised at the start of a profiled session, ahead of
#: the window it measures: late in a run a session's trace can lose its
#: first device records (24-28 of a backward window's 61 kernels; one of a
#: zamba2 wave's 32 SSD launches), so those records are these, which every
#: reader skips
TRACE_PAD, TRACE_PAD_NAME = 256, "spin_kernel"


def _pad_trace(torch) -> None:
    """`TRACE_PAD` spin kernels, then a device sync: call first thing in a
    profiled session, before its timed window."""
    for _ in range(TRACE_PAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


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
            "samples": res.samples, "waves": waves}


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
#: kernels, whose export alone takes minutes (256 until the trainer on a
#: mesh needed the run's time: their six traces took ~33 s to export and
#: read; every step replays the same graph)
PROFILED_STEPS = 64


def _device_busy(torch, fn, what: str) -> dict:
    """`fn()` under torch.profiler: its profiled wall, and the device's busy
    time (kernels, copies and memsets, summed; one stream, so they never
    overlap) and kernel count from the exported trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad_trace(torch)
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
        if (ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and ev.get("ph") == "X"
                and TRACE_PAD_NAME not in ev.get("name", "")):
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


def phase_derivative_waves(torch, dev, smi: str) -> dict:
    """One fused value-and-gradient wave, one JVP wave and one HVP wave of
    16 lanes at both published levels through `TsunamiModel`: each wave's
    wall, its kernel launches (the fused wave exactly one `swe_solve`, which
    keeps the adjoint's checkpoints, and one `swe_solve_vjp`, the reverse
    mode on the hand-written adjoint; the JVP and HVP waves none: PyTorch
    ops under autograd, as the JAX package's run its scan) and peak device
    memory; then the same three waves again under the profiler, for the
    device's busy time. Checks: the fused wave's primal equals the evaluate
    wave (one `swe_solve` launch) bit for bit; sens.(J v) == (J^T sens).v
    within the JAX package's bound
    (tests/test_capabilities.py); every value finite. The card's waves
    against the same model on the CPU are tests/test_torch_gpu.py's
    (`test_derivative_waves_on_cuda_match_the_cpu`, both levels of the small
    hierarchy); this phase held two coarse lanes so too until the trainer on
    a mesh needed the run's time (~40 s of CPU)."""
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
            want = {"swe_solve": 1, "swe_solve_vjp": 1} if kind == "value_and_gradient" else {}
            if {k: v for k, v in launches.items() if v} != want:
                raise AssertionError(f"level {level} {kind}: kernel launches {launches}, "
                                     f"expected {want}")
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
        emit("derivative_waves", level=level, **out[level], card=smi)
    return out


def phase_mala_main_path(torch, dev) -> dict:
    """`ensemble_mlda(coarse_sampler="mala")` through
    `EvaluationFabric(ModelBackend(TsunamiModel()))` with `main_path`'s
    settings: every coarse subchain step one fused value-and-gradient wave
    (one `swe_solve` and one `swe_solve_vjp` launch: 16 chains, one
    chunk), every fine wave one `swe_solve` launch."""
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
    if (counts["swe_solve_vjp"] != vg_waves
            or counts["swe_solve"] != evaluate_waves[1] + vg_waves
            or evaluate_waves[1] < 1 or counts["swe_step"]):
        raise AssertionError(f"kernel launches {counts}, expected one swe_solve per fine "
                             f"evaluate wave ({evaluate_waves[1]}), one swe_solve and one "
                             f"swe_solve_vjp per value-and-gradient wave ({vg_waves}), "
                             "and no swe_step")
    emit("mala_main_path", chains=K, n_samples=4, subsampling=[5], coarse_sampler="mala",
         n_waves=res.n_waves, evals_per_level=res.evals_per_level,
         model_solves_per_level=solves, evaluate_waves_per_level=evaluate_waves,
         value_and_gradient_waves=vg_waves, accept_rates=res.accept_rates, wall_s=wall,
         swe_solve_launches=counts["swe_solve"], launches=counts,
         posterior_mean=res.samples.reshape(-1, 2).mean(0).tolist(),
         per_capability=pc)
    return {"launches": counts["swe_solve"], "vjp_launches": counts["swe_solve_vjp"],
            "wall_s": wall}


#: `laplace_path`'s Gauss-Newton / Newton iterations (benchmarks/
#: second_order.py runs 4, as this phase did until the trainer on a mesh
#: needed the run's time: ~10 s an iteration of both modes)
LAPLACE_ITERS = 2


def phase_laplace_path(torch, dev) -> dict:
    """`laplace_preview` on the coarse level with both curvature modes
    (benchmarks/second_order.py's settings but LAPLACE_ITERS iterations):
    "full" rides the HVP waves (reverse-over-forward), "gn" is the
    Jacobian-only control."""
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
                np.diag([100.0, 0.25]), curvature=curvature, n_ensemble=4,
                n_iters=LAPLACE_ITERS,
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
    emit("laplace_path", level=0, n_ensemble=4, n_iters=LAPLACE_ITERS, **out,
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
    from repro_torch.uq.fused import _Lanes, _rwm_step, fused_ensemble_rwm

    model = TsunamiModel()
    lp_kernel, _, _ = coarse_target(torch, model, dev)
    lp_plain, _, _ = coarse_target(torch, model, dev, step=swe_step_ref_into)
    x0t, n = sources(FUSED_TSUNAMI_K, 11).astype(float), 2
    got = fused_ensemble_rwm(lp_kernel, x0t, n, MAIN_PROP_COV, _generator(torch, dev, 7),
                             fused_steps=n)
    t0 = time.perf_counter()
    gen = _generator(torch, dev, 7)
    step = _rwm_step(lp_plain, np.linalg.cholesky(MAIN_PROP_COV), dev, _Lanes.whole(len(x0t)))
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


#: fused MALA over the coarse tsunami: K chains, S steps a block, steps of
#: each run, the step-size adaptation's steps, and the law check's burn-in
#: share (past the adaptation), its sigmas and least pooled ESS
#: (tests/_stat_harness.py's)
FUSED_MALA_K, FUSED_MALA_S, FUSED_MALA_STEPS, FUSED_MALA_ADAPT = 16, 5, 300, 50
FUSED_MALA_BURN, FUSED_MALA_Z, FUSED_MALA_MIN_ESS = 0.3, 5.0, 50.0
FUSED_MALA_PRECOND = np.diag([4.0, 0.01])


def _pooled_moments(samples: np.ndarray, burn: float) -> dict:
    """Pooled mean, variance and per-dimension ESS (summed over chains) of
    [K, n, d] samples after the first `burn` share of each chain, as
    tests/_stat_harness.py pools them (with the port's ESS)."""
    from repro_torch.uq.mcmc import effective_sample_size

    x = np.asarray(samples, float)[:, int(burn * samples.shape[1]):]
    d = x.shape[2]
    ess = np.asarray([sum(effective_sample_size(x[k, :, j]) for k in range(len(x)))
                      for j in range(d)])
    flat = x.reshape(-1, d)
    return {"mean": flat.mean(0), "var": flat.var(0), "ess": ess}


def assert_same_law(a: np.ndarray, b: np.ndarray, what: str) -> dict:
    """Two samplers' chains in law: tests/_stat_harness.py's bounds on the
    pooled mean and variance, each sample's Monte Carlo error from its
    pooled ESS, for the difference of two samples: |mean_a - mean_b| <= z
    sqrt(var_a / ess_a + var_b / ess_b), |var_a - var_b| <= z sqrt(2
    var_a^2 / ess_a + 2 var_b^2 / ess_b), each ESS at least the harness's
    least (chains too short certify nothing)."""
    ma, mb = (_pooled_moments(s, FUSED_MALA_BURN) for s in (a, b))
    if min(ma["ess"].min(), mb["ess"].min()) < FUSED_MALA_MIN_ESS:
        raise AssertionError(f"{what}: pooled ESS {ma['ess']} / {mb['ess']} below "
                             f"{FUSED_MALA_MIN_ESS}: the chains are too short to compare")
    se_mean = np.sqrt(ma["var"] / ma["ess"] + mb["var"] / mb["ess"])
    se_var = np.sqrt(2 * ma["var"] ** 2 / ma["ess"] + 2 * mb["var"] ** 2 / mb["ess"])
    mean_err, var_err = np.abs(ma["mean"] - mb["mean"]), np.abs(ma["var"] - mb["var"])
    report = {"mean": [ma["mean"].tolist(), mb["mean"].tolist()],
              "var": [ma["var"].tolist(), mb["var"].tolist()],
              "ess": [ma["ess"].tolist(), mb["ess"].tolist()],
              "mean_err_in_se": (mean_err / se_mean).tolist(),
              "var_err_in_se": (var_err / se_var).tolist()}
    if np.any(mean_err > FUSED_MALA_Z * se_mean) or np.any(var_err > FUSED_MALA_Z * se_var):
        raise AssertionError(f"{what}: the two samplers differ in law: {report}")
    return report


def phase_fused_mala_tsunami(torch, dev) -> dict:
    """Fused MALA over the coarse tsunami posterior (512 cells, `main_path`'s
    data, noise and prior box), FUSED_MALA_K chains started near the true
    source, through `ensemble_mala(fused_steps=FUSED_MALA_S)`: each step's
    drift through `swe_solve`'s autograd rule, so a block's graph holds S
    `swe_solve` and S `swe_solve_vjp` launches (the backward captured from
    the autograd engine's thread). A warm run captures the graph; then the
    timed run (launches == 1 + n of each: the start's value and gradient,
    then one forward and one adjoint a step), the per-step reference (bit
    for bit), and `ensemble_mala`'s host loop over
    `EvaluationFabric(ModelBackend(TsunamiModel()))` (a fused
    value-and-gradient wave a step), held to the fused run in law
    (`assert_same_law`). Steps/s of each."""
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.swe import swe_solve, swe_solve_vjp
    from repro_torch.uq import fused
    from repro_torch.uq.mcmc import batched_value_grad_logpost, ensemble_mala

    model = TsunamiModel()
    lp, logprior, loglik = coarse_target(torch, model, dev)
    *_, grad_loglik = tsunami_problem(torch, model, dev)
    K, S, n = FUSED_MALA_K, FUSED_MALA_S, FUSED_MALA_STEPS
    x0s = TRUE_THETA + np.random.default_rng(SEED).standard_normal((K, 2)) * [2.0, 0.1]
    kw = dict(precond=FUSED_MALA_PRECOND, adapt_steps=FUSED_MALA_ADAPT)

    def run(steps, seed):
        return ensemble_mala(lp, x0s, steps, 1.0, np.random.default_rng(0), fused_steps=S,
                             fused_key=_generator(torch, dev, seed), **kw)

    def run_per_step(steps, seed):
        return fused.fused_ensemble_mala(lp, x0s, steps, 1.0, _generator(torch, dev, seed),
                                         fused_steps=S, per_step=True, **kw)

    run(S, 1)  # warm: the captures of the S-step graph and the one-step one
    run_per_step(1, 1)
    blocks = [b for b in fused._BLOCK_MEMO.values()
              if isinstance(b, fused._Block) and b.S == S and b.graph is not None
              and (swe_solve_vjp, None) in b.held]
    if len(blocks) != 1 or blocks[0].held != {(swe_solve, None): S, (swe_solve_vjp, None): S}:
        raise AssertionError(f"fused MALA blocks {[b.held for b in blocks]}, expected one "
                             f"holding {S} swe_solve and {S} swe_solve_vjp launches")
    reset_launches()
    fused_wall, got = _timed(torch, lambda: run(n, 7))
    counts = read_launches()
    if (counts["swe_solve"], counts["swe_solve_vjp"], counts["swe_step"]) != (1 + n, 1 + n, 0):
        raise AssertionError(f"fused MALA: launches {counts}, expected {1 + n} of swe_solve "
                             f"and of swe_solve_vjp ({n // S} replays of {S} + the start)")
    per_wall, per_step = _timed(torch, lambda: run_per_step(n, 7))
    for name in ("samples", "logposts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(per_step, name),
                                      err_msg=f"fused MALA vs per-step {name}")
    if got.final_step_size != per_step.final_step_size:
        raise AssertionError("fused MALA's adapted step size differs per step")
    if not np.isfinite(got.samples).all() or not 0.0 < got.accept_rate <= 1.0:
        raise AssertionError(f"fused MALA: acceptance {got.accept_rates}")
    fabric = EvaluationFabric(ModelBackend(model), cache_size=0)
    try:
        value_grad = batched_value_grad_logpost(fabric, loglik, grad_loglik, logprior,
                                                config=L0)
        ensemble_mala(value_grad, x0s, 2, 1.0, np.random.default_rng(1), **kw)
        host_wall, host = _timed(torch, lambda: ensemble_mala(
            value_grad, x0s, n, 1.0, np.random.default_rng(11), **kw))
    finally:
        fabric.shutdown()
    law = assert_same_law(got.samples, host.samples, "fused MALA vs the host loop")
    rates = {"fused": n / fused_wall, "per_step": n / per_wall, "host_fabric": n / host_wall}
    emit("fused_mala_tsunami", chains=K, fused_steps=S, n_steps=n, adapt_steps=FUSED_MALA_ADAPT,
         level=0, walls_s={"fused": fused_wall, "per_step": per_wall, "host_fabric": host_wall},
         steps_per_s=rates, speedup_vs_per_step=rates["fused"] / rates["per_step"],
         speedup_vs_host_fabric=rates["fused"] / rates["host_fabric"],
         launches=counts, launches_per_replay={"swe_solve": S, "swe_solve_vjp": S},
         accept_rate={"fused": got.accept_rate, "host_fabric": host.accept_rate},
         final_step_size={"fused": got.final_step_size, "host_fabric": host.final_step_size},
         law=law, bound="fused == per-step bit for bit; fused vs host loop in law "
                        f"(z = {FUSED_MALA_Z}, burn-in {FUSED_MALA_BURN})",
         timer="host clock around a whole run ending in a device sync, after a warm run")
    return {"launches": counts, "steps_per_s": rates}


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
    width as its path launched it, its inputs through the plain solve, bit
    for bit. The plain solve runs each step as one replayed CUDA graph
    (`testing.swe_solve_ref_replayed`: `swe_solve_ref`'s operations in its
    order, one launch a step instead of ~40); the eager loop took 159 s of
    the run in PR 23. The waves run one after another."""
    from repro_torch.kernels.swe.testing import (
        SOLVE_SHAPES,
        assert_solve_equal,
        swe_solve_ref_replayed,
    )

    held = sorted(set(widths.first) - set(SOLVE_SHAPES))
    report = {}
    t0 = time.perf_counter()
    for key in held:
        (inputs, got), name = widths.first[key], f"{key[0]}x{key[1]}"
        inputs = dict(inputs)
        h, hu, b = inputs.pop("h"), inputs.pop("hu"), inputs.pop("b")
        t1 = time.perf_counter()
        want = swe_solve_ref_replayed(h, hu, b, **inputs)
        report[name] = dict(assert_solve_equal(got, want, f"path wave {name}"),
                            plain_s=time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    worst = max((r[k]["max_abs"] for r in report.values() for k in ("mx", "arr")), default=0.0)
    emit("wave_widths_vs_plain", kernel="swe_solve", bound="bit for bit (mx, arr; NaN matches NaN)",
         plain="swe_solve_ref's step, one replayed CUDA graph a step",
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


# -- the device mesh on the UQ path (distributed/sharding.py, launch/mesh.py) ----

#: the mesh phases' fine wave (16 lanes: 8 a rank on two), the fused coarse
#: RWM's length (2 blocks of FUSED_TSUNAMI_S steps) and generator seed, and
#: qwen3-0.6b's 8-point wave (4 a rank on two)
MESH_WAVE_SEED, MESH_FUSED_STEPS, MESH_FUSED_SEED = 31, 100, 5
MESH_LM_POINTS = np.array([[0.9 + 0.025 * i, 1.1 - 0.025 * i] for i in range(8)])
#: the host watchdog of the two ranks, and their collectives' time limit
MESH_RANKS_TIMEOUT_S, MESH_COLLECTIVE_TIMEOUT_S = 300.0, 120.0


def _mesh_fused(torch, model, dev, ctx, checkpoint=None, seed=MESH_FUSED_SEED,
                steps_run=MESH_FUSED_STEPS):
    """The fused coarse-tsunami RWM of the mesh phases: 16 chains from
    `fused_sampler`'s starts, MESH_FUSED_STEPS steps in blocks of
    FUSED_TSUNAMI_S, on `ctx` (None: no mesh), with a checkpoint every
    block if one is given; `steps_run` of them run here (fewer when the
    checkpoint resumes the run), each one `swe_solve` launch of a replay,
    beside the capture's warm-up block and the initial wave."""
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.uq.fused import fused_ensemble_rwm

    lp, _, _ = coarse_target(torch, model, dev)
    reset_launches()
    res = fused_ensemble_rwm(lp, sources(FUSED_TSUNAMI_K, 11).astype(float), MESH_FUSED_STEPS,
                             MAIN_PROP_COV, _generator(torch, dev, seed),
                             fused_steps=FUSED_TSUNAMI_S, ctx=ctx, checkpoint=checkpoint,
                             checkpoint_every=FUSED_TSUNAMI_S if checkpoint else 0)
    torch.cuda.synchronize()
    want = FUSED_TSUNAMI_S + steps_run + 1
    if read_launches()["swe_solve"] != want:
        raise AssertionError(f"fused RWM on the mesh: launches {read_launches()}, expected "
                             f"{want} of swe_solve")
    return res


def phase_mesh_main_path(torch, dev, main_path: dict, lm, smi: str) -> dict:
    """The device mesh in this process: a 1x1 mesh (world size 1, NCCL,
    `launch.mesh.make_mesh`). `main_path`'s campaign through
    `EvaluationFabric(SPMDBackend(ModelPool(TsunamiModel(), ctx)))` gives
    its samples and waves bit for bit, every wave one `swe_solve` launch;
    qwen3-0.6b's 8-point wave (`lm`, full width and depth) through
    `LMUQModel(ctx=)` equals the same wave without `ctx` bit for bit, one
    forward's 28 flash launches. Also the references of `mesh_two_ranks`:
    the one-process fine wave, the fused coarse RWM with this `ctx`."""
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fabric import EvaluationFabric, SPMDBackend
    from repro_torch.core.pool import ModelPool
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.launch.mesh import destroy_ranks, make_mesh
    from repro_torch.uq.mlda import ensemble_mlda

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ctx = ShardingCtx(make_mesh((1, 1), ("data", "model"), backend="nccl"))
    try:
        model = TsunamiModel()
        _, logprior, loglik, _ = tsunami_problem(torch, model, dev)
        pool = ModelPool(model, ctx)
        fabric = EvaluationFabric(SPMDBackend(pool), cache_size=8192)
        try:
            reset_launches()
            waves0 = dict(model.waves)
            wall, res = _timed(torch, lambda: ensemble_mlda(
                None, sources(16, 11).astype(float), n_samples=4, subsampling=[5],
                prop_cov=MAIN_PROP_COV, rng=np.random.default_rng(501),
                fabric=fabric, level_configs=[L0, L1], loglik=loglik, logprior=logprior))
            counts = read_launches()
        finally:
            fabric.shutdown()
        waves = {lvl: model.waves[lvl] - waves0[lvl] for lvl in (0, 1)}
        _same_bits(res.samples, main_path["samples"], "main_path's campaign on the 1x1 mesh")
        if waves != main_path["waves"] or counts["swe_solve"] != main_path["launches"] \
                or counts["swe_solve"] != sum(waves.values()) or pool.stats["padded"]:
            raise AssertionError(f"1x1 mesh: waves {waves}, launches {counts}, pool "
                                 f"{pool.stats}; main_path: {main_path['waves']}, "
                                 f"{main_path['launches']} launches")
        fine = model.evaluate_batch(sources(16, MESH_WAVE_SEED), L1)
        fused = _mesh_fused(torch, model, dev, ctx)

        plain = lm.evaluate_batch(MESH_LM_POINTS)
        on_mesh = LMUQModel(DENSE_ARCH, reduced=False, batch=LM_BATCH, seq=LM_SEQ,
                            params=lm.params, ctx=ctx)
        _same_bits(on_mesh.batch["tokens"].cpu(), lm.batch["tokens"].cpu(), "the LM's batch")
        reset_launches()
        lm_wall, nlls = _timed(torch, lambda: on_mesh.evaluate_batch(MESH_LM_POINTS))
        lm_launches_ = check_launches(read_launches(), lm.cfg, 1, "LMUQModel(ctx=) on 1x1")
        _same_bits(nlls, plain, "qwen3-0.6b's 8-point wave with ctx= vs without")
    finally:
        destroy_ranks()
    peak = torch.cuda.max_memory_allocated()
    emit("mesh_main_path", card=smi, mesh=[1, 1], backend="nccl",
         campaign={"wall_s": wall, "n_waves": res.n_waves, "model_waves_per_level": waves,
                   "swe_solve_launches": counts["swe_solve"], "pool_stats": dict(pool.stats),
                   "main_path_wall_s": main_path["wall_s"]},
         fused_rwm={"chains": FUSED_TSUNAMI_K, "n_steps": MESH_FUSED_STEPS,
                    "accept_rate": float(np.mean(fused.accept_rates))},
         lm={"arch": DENSE_ARCH, "points": len(MESH_LM_POINTS), "wall_s": lm_wall,
             "launches": lm_launches_, "nll": nlls[:, 0].tolist()},
         wall_s=time.perf_counter() - t_phase, max_memory_allocated=peak,
         bound="bit for bit (main_path's samples and waves; the LM wave with and without ctx)")
    return {"fine": fine, "fused": fused, "nlls": nlls, "swe_solve": counts["swe_solve"],
            "flash": lm_launches_}


def _watched_ranks(flag: str, where: Path, timeout_s: float) -> list:
    """Two processes of this script (`flag R --mesh-dir DIR`), their logs in
    DIR, under a host watchdog: returns each rank's JSON; a rank that fails
    or outlasts the watchdog fails the run."""
    logs = [open(where / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag, str(r),
                               "--mesh-dir", str(where)], stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=ROOT) for r in range(2)]
    try:
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        tails = "\n".join(f"rank {r} (exit {c}):\n" + (where / f"rank{r}.log").read_text()[-3000:]
                          for r, c in enumerate(codes))
        raise AssertionError(f"{flag}: exit codes {codes} (watchdog {timeout_s} s)\n{tails}")
    return [json.loads((where / f"rank{r}.json").read_text()) for r in range(2)]


#: `mesh_two_ranks`' trainer: qwen3-0.6b at full width, MESH_TRAIN_LAYERS
#: layers, bf16 as published, MESH_TRAIN_BATCH x MESH_TRAIN_SEQ tokens a step;
#: MESH_TRAIN_FIRST steps FSDP over data = 2 (a checkpoint at the last), then
#: the elastic restart onto model = 2 (TP) from that checkpoint, continued to
#: MESH_TRAIN_STEPS; every loss within MESH_TRAIN_RTOL (relative) of the same
#: training on one device in this process
MESH_TRAIN_LAYERS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 2, 512
MESH_TRAIN_FIRST, MESH_TRAIN_STEPS, MESH_TRAIN_RTOL = 2, 4, 1e-4
#: its learning rate (no warmup). At train_path's 1e-3 the losses of 3 FSDP
#: and 3 TP steps drifted up to 2.1e-4 (relative) from one device's (NVIDIA
#: H100 80GB HBM3, 700.00 W; `scripts/mesh_slice_check.py --lr 1e-3 --steps
#: 3,6`): the bf16 gradient summed over two ranks rounds
#: once more than one device's, and AdamW's first steps move every weight
#: by about the learning rate whatever the gradient's size, so the bf16
#: weights round apart; the drift scales with the rate
MESH_TRAIN_LR = 1e-4
#: `mesh_two_ranks`' sharded serving: minicpm3-4b at full width,
#: MLA_MESH_LAYERS layers, in float32 (so that the float32 decode tests'
#: bound holds: MLA_MESH_RTOL is tests/_torch_zoo.py's LOGITS_RTOL for
#: minicpm3-4b), on (data, model) = (1, 2): a prompt of MLA_MESH_PROMPT tokens
#: in a latent cache of MLA_MESH_CACHE rows split over model (the second rank
#: holds rows 32..63, every one masked at the first decode steps), then
#: MLA_MESH_STEPS decode steps
MLA_MESH_ARCH, MLA_MESH_LAYERS = "minicpm3-4b", 2
MLA_MESH_PROMPT, MLA_MESH_CACHE, MLA_MESH_STEPS, MLA_MESH_RTOL = 28, 64, 8, 1e-5


def mesh_train_case():
    """(config, TrainConfig) of `mesh_two_ranks`' training."""
    from repro_torch.configs import get_config
    from repro_torch.types import TrainConfig

    cfg = get_config(DENSE_ARCH).replace(n_layers=MESH_TRAIN_LAYERS)
    return cfg, TrainConfig(lr=MESH_TRAIN_LR, warmup_steps=1, total_steps=MESH_TRAIN_STEPS,
                            checkpoint_every=0, keep_checkpoints=2)


def mla_mesh_case(torch, dev):
    """(config, weights, tokens) of `mesh_two_ranks`' sharded serving: the
    weights from seed 0 and a [2, prompt + steps] batch from seed 1 on
    `dev`, the same on every rank and in this process."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(MLA_MESH_ARCH).replace(param_dtype="float32", act_dtype="float32",
                                            n_layers=MLA_MESH_LAYERS)
    params = M.init_params(cfg, _generator(torch, dev, 0))
    batch = M.make_synth_batch(cfg, 2, MLA_MESH_PROMPT + MLA_MESH_STEPS, _generator(torch, dev, 1))
    return cfg, params, batch["tokens"]


def mla_serve(torch, cfg, params, tokens, ctx=None) -> dict:
    """`prefill_step` of the prompt at MLA_MESH_CACHE rows, then
    MLA_MESH_STEPS `decode_step`s; on `ctx`'s mesh the weights sharded by
    `param_specs` and the latent cache split over its rows on 'model' (flash
    decoding). -> the logits of each step as float32 numpy (on a mesh
    assembled by all-reduces, `sharding.assemble`), each decode step's
    all-gathers (those of its op stream, `launch.hlo_analysis.OpRecorder`,
    and those made sums on a `gloo` mesh on the card), whether the cache's
    rows are split, the launches and the walls."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.hlo_analysis import OpRecorder, analyze
    from repro_torch.models import model as M

    def full(t):
        return (sharding.assemble(t) if ctx is not None else t).float().cpu().numpy()

    if ctx is not None:
        params = M.shard_params(cfg, params, ctx)
    reset_launches()
    prefill_s, (last, cache) = _timed(torch, lambda: M.prefill_step(
        cfg, params, tokens[:, :MLA_MESH_PROMPT], cache_len=MLA_MESH_CACHE, ctx=ctx))
    logits, gathers = [full(last)], []
    t0 = time.perf_counter()
    for j in range(MLA_MESH_STEPS):
        pos = MLA_MESH_PROMPT + j
        if ctx is None:
            step, cache = M.decode_step(cfg, params, cache, tokens[:, pos:pos + 1], pos)
            logits.append(full(step))
            continue
        before = sharding.GATHERS_BY_SUM["n"]
        with OpRecorder() as rec:
            step, cache = M.decode_step(cfg, params, cache, tokens[:, pos:pos + 1], pos, ctx=ctx)
        gathers.append(analyze(rec.ops, 1)["collective_counts"]["all-gather"]
                       + sharding.GATHERS_BY_SUM["n"] - before)
        logits.append(full(step))
    torch.cuda.synchronize()
    c_kv = cache[0]["attn"]["c_kv"]
    split = ctx is not None and repr(c_kv.placements[-1]) == "Shard(dim=2)"
    return {"logits": np.stack(logits), "all_gathers": gathers, "rows_split": split,
            "launches": {k: n for k, n in read_launches().items() if n},
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0}


def rank_train_elastic(torch, where: Path, ctx21, ctx12) -> dict:
    """One rank's part of `mesh_two_ranks`' training: `launch.train.train`
    FSDP over data = 2 (`ctx21`) for MESH_TRAIN_FIRST steps, its checkpoint
    assembled by all-reduces and written by rank 0, then TP over model = 2
    (`ctx12`) from that checkpoint (`restore(shardings=)`) to
    MESH_TRAIN_STEPS: each part's history, launches and walls."""
    from repro_torch.launch import train as L

    cfg, tc = mesh_train_case()
    out = {}
    for name, ctx, steps in (("fsdp", ctx21, MESH_TRAIN_FIRST), ("tp", ctx12, MESH_TRAIN_STEPS)):
        log = []
        reset_launches()
        wall, (_, _, hist) = _timed(torch, lambda: L.train(
            cfg, tc, steps, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, str(where / "train_ckpt"),
            log_every=1000, log=log, ctx=ctx))
        out[name] = {"hist": hist, "launches": {k: n for k, n in read_launches().items() if n},
                     "steps_run": sum(e.get("action") == "ok" for e in log),
                     "checkpoint_s": [e["s"] for e in log if "checkpoint" in e], "wall_s": wall}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_mesh_two_ranks(torch, dev, ref: dict, smi: str) -> dict:
    """Two ranks on the one card, over `gloo` (NCCL refuses two ranks on one
    GPU), each a process of this script (`--mesh-rank`) under a host
    watchdog: a 16-lane fine wave through `ModelPool(TsunamiModel(), ctx)`
    split 8/8 == the one-process wave bit for bit, one `swe_solve` launch a
    rank; the fused coarse RWM of 16 chains split 8/8 == the one-rank `ctx`
    run of `mesh_main_path` bit for bit, and its rank-0 checkpoint (after
    the first block) resumed in this process == the same run bit for bit;
    qwen3-0.6b's 8-point wave split 4/4 within LM_NLL_RTOL of the
    one-process wave, one forward's 28 flash launches a rank; then the
    trainer (`rank_train_elastic`: FSDP over data = 2, its checkpoint
    assembled by all-reduces and written by rank 0, then the elastic
    restart onto model = 2) within MESH_TRAIN_RTOL of the same training on
    one device, and minicpm3-4b's serving on a latent cache split over its
    rows (`mla_serve`) within MLA_MESH_RTOL of one device, no all-gather in
    any decode step (`_check_two_rank_slice`). A rank that fails fails the
    run."""
    import shutil

    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fleet import CampaignCheckpoint

    where = ROOT / "build" / "mesh_two_ranks"
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    t_phase = time.perf_counter()
    ranks = _watched_ranks("--mesh-rank", where, MESH_RANKS_TIMEOUT_S)
    arrays = [np.load(where / f"rank{r}.npz") for r in range(2)]
    for r, (meta, arr) in enumerate(zip(ranks, arrays)):
        _same_bits(arr["fine"], ref["fine"], f"rank {r}: the 16-lane fine wave split 8/8")
        _same_bits(arr["samples"], ref["fused"].samples, f"rank {r}: fused RWM samples")
        _same_bits(arr["logposts"], ref["fused"].logposts, f"rank {r}: fused RWM logposts")
        if meta["launches"]["fine"]["swe_solve"] != 1:
            raise AssertionError(f"rank {r}: fine wave launches {meta['launches']['fine']}")
    lm_err = max(float(np.max(np.abs(arr["nlls"] / ref["nlls"] - 1.0))) for arr in arrays)
    if not lm_err < LM_NLL_RTOL:
        raise AssertionError(f"the 8-point wave split 4/4: NLLs off by {lm_err} relative "
                             f"(bound {LM_NLL_RTOL})")
    ranks_s = time.perf_counter() - t_phase
    # the one-device references, after the ranks: run beside them, they
    # slowed the ranks' host-bound work by more than they took (~30 s)
    t_ref = time.perf_counter()
    train_ref, mla_ref = mesh_two_ranks_references(torch, dev)
    refs_s = time.perf_counter() - t_ref
    elastic, mla = _check_two_rank_slice(torch, ranks, arrays, train_ref, mla_ref)
    # rank 0's checkpoint after the first block, resumed in this process
    ckpt = where / "fused_ckpt"
    shutil.rmtree(ckpt / f"step_{MESH_FUSED_STEPS:08d}")
    resumed = _mesh_fused(torch, TsunamiModel(), dev, None, CampaignCheckpoint(str(ckpt)),
                          seed=999, steps_run=MESH_FUSED_STEPS - FUSED_TSUNAMI_S)
    _same_bits(resumed.samples, ref["fused"].samples, "the rank-0 checkpoint resumed")
    emit("mesh_two_ranks", card=smi, mesh=[2, 1], backend="gloo", ranks=ranks,
         fine_wave={"lanes": 16, "per_rank": 8, "bound": "bit for bit"},
         fused_rwm={"chains": FUSED_TSUNAMI_K, "per_rank": FUSED_TSUNAMI_K // 2,
                    "n_steps": MESH_FUSED_STEPS, "bound": "bit for bit, and the resume"},
         lm={"arch": DENSE_ARCH, "points": len(MESH_LM_POINTS), "per_rank": 4,
             "nll_max_rel_diff": lm_err, "bound": LM_NLL_RTOL},
         elastic_train=elastic, mla_serving=mla, ranks_s=ranks_s, references_s=refs_s,
         wall_s=time.perf_counter() - t_phase)
    return {"swe_solve": [m["launches"]["fine"]["swe_solve"] + m["launches"]["fused"]["swe_solve"]
                          for m in ranks],
            "flash": [m["launches"]["lm"]["flash_attention_wgmma"] for m in ranks],
            "train": [{part: m["train"][part]["launches"] for part in ("fsdp", "tp")}
                      for m in ranks],
            "mla": [m["mla"]["launches"] for m in ranks],
            "seconds": {"ranks": [m["wall_s"] for m in ranks],
                        "train_fsdp": [m["train"]["fsdp"]["wall_s"] for m in ranks],
                        "train_tp": [m["train"]["tp"]["wall_s"] for m in ranks],
                        "mla_serving": [m["mla"]["prefill_s"] + m["mla"]["decode_s"]
                                        for m in ranks],
                        "references": refs_s}}


def mesh_two_ranks_references(torch, dev):
    """The one-device runs the two ranks' trainer and MLA serving are held
    to: (the history of `mesh_train_case` trained MESH_TRAIN_STEPS steps on
    `dev`, `mla_serve` of `mla_mesh_case` without a mesh)."""
    import tempfile

    from repro_torch.launch import train as L

    cfg, tc = mesh_train_case()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_train_") as ckpt_dir:
        _, _, hist = L.train(cfg, tc, MESH_TRAIN_STEPS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ,
                             ckpt_dir, log_every=1000, device=dev)
    mla = mla_serve(torch, *mla_mesh_case(torch, dev))
    gc.collect()
    torch.cuda.empty_cache()
    return hist, mla


def _check_two_rank_slice(torch, ranks: list, arrays: list, train_ref: list, mla_ref: dict):
    """Hold the ranks' trainer (FSDP, then TP from its checkpoint) to the
    one-device history within MESH_TRAIN_RTOL, with each step's flash
    launches (forward and remat recompute, each backward kernel once a
    layer), and their MLA serving to the one-device logits within
    MLA_MESH_RTOL, the cache's rows split, no all-gather in any decode step,
    every logit finite. -> the two summaries."""
    from repro_torch.kernels.flash_attention import ops

    cfg, _ = mesh_train_case()
    per_step = {"flash_attention_wgmma": 2 * cfg.n_layers,
                **dict.fromkeys(ops.BWD_KERNELS[ops.bwd_stem(torch.bfloat16)],
                                cfg.n_layers)}
    want_losses = np.array([l for _, l in train_ref])
    problems, errs, mla_errs = [], [], []
    for meta, arr in zip(ranks, arrays):
        r, t = meta["rank"], meta["train"]
        hist = t["fsdp"]["hist"] + t["tp"]["hist"]
        if [s for s, _ in hist] != [s for s, _ in train_ref]:
            problems.append(f"rank {r}: trained steps {[s for s, _ in hist]}")
            continue
        errs.append(float(np.max(np.abs(np.array([l for _, l in hist]) / want_losses - 1.0))))
        for part in ("fsdp", "tp"):
            want = {k: n * t[part]["steps_run"] for k, n in per_step.items()}
            if t[part]["launches"] != want:
                problems.append(f"rank {r} {part}: launches {t[part]['launches']}, want {want}")
        m = meta["mla"]
        got = arr["mla_logits"]
        if not np.isfinite(got).all() or got.shape != mla_ref["logits"].shape:
            problems.append(f"rank {r}: MLA logits {got.shape}, finite {np.isfinite(got).all()}")
            continue
        mla_errs.append(max(float(np.abs(g - w).max() / np.abs(w).max())
                            for g, w in zip(got, mla_ref["logits"])))
        if not m["rows_split"] or any(m["all_gathers"]):
            problems.append(f"rank {r}: MLA cache rows split {m['rows_split']}, all-gathers "
                            f"a decode step {m['all_gathers']}")
    worst = max(errs, default=float("inf"))
    mla_worst = max(mla_errs, default=float("inf"))
    print(f"mesh_two_ranks: FSDP then TP training within {worst:.3g} of one device "
          f"(bound {MESH_TRAIN_RTOL}); MLA serving on split caches within {mla_worst:.3g} "
          f"(bound {MLA_MESH_RTOL})", flush=True)
    if not worst <= MESH_TRAIN_RTOL:
        problems.append(f"training losses off by {worst} relative (bound {MESH_TRAIN_RTOL})")
    if not mla_worst <= MLA_MESH_RTOL:
        problems.append(f"MLA logits off by {mla_worst} (bound {MLA_MESH_RTOL})")
    if problems:
        raise AssertionError("mesh_two_ranks: " + "; ".join(problems))
    elastic = {"arch": DENSE_ARCH, "layers": MESH_TRAIN_LAYERS, "batch": MESH_TRAIN_BATCH,
               "seq": MESH_TRAIN_SEQ, "fsdp_mesh": [2, 1], "tp_mesh": [1, 2],
               "fsdp_steps": MESH_TRAIN_FIRST, "steps": MESH_TRAIN_STEPS,
               "losses_one_device": train_ref, "losses_rank0": ranks[0]["train"]["fsdp"]["hist"]
               + ranks[0]["train"]["tp"]["hist"], "max_rel_diff": worst,
               "bound": MESH_TRAIN_RTOL, "launches_per_step": per_step,
               "by_rank": [m["train"] for m in ranks],
               "reduced": [f"n_layers 28 -> {MESH_TRAIN_LAYERS} (widths kept)",
                           f"tokens a step {MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ}"]}
    mla = {"arch": MLA_MESH_ARCH, "layers": MLA_MESH_LAYERS, "dtype": "float32",
           "mesh": [1, 2], "prompt": MLA_MESH_PROMPT, "cache_rows": MLA_MESH_CACHE,
           "decode_steps": MLA_MESH_STEPS, "max_rel_diff": mla_worst, "bound": MLA_MESH_RTOL,
           "all_gathers": [m["mla"]["all_gathers"] for m in ranks],
           "rows_split": [m["mla"]["rows_split"] for m in ranks],
           "launches": [m["mla"]["launches"] for m in ranks],
           "walls": [{k: m["mla"][k] for k in ("prefill_s", "decode_s")} for m in ranks],
           "one_device_walls": {k: mla_ref[k] for k in ("prefill_s", "decode_s")},
           "reduced": ["n_layers 62 -> 2 (widths kept)", "bfloat16 -> float32"]}
    return elastic, mla


def mesh_rank_main(rank: int, where: Path) -> int:
    """One rank of `mesh_two_ranks` (`--mesh-rank R --mesh-dir DIR`): joins
    the 2-rank `gloo` group through a FileStore in DIR, runs the sharded
    parts on the card (on the (2, 1) mesh the fine wave, the fused RWM and
    the LM wave; the trainer's FSDP steps, then on the (1, 2) mesh its TP
    steps and the MLA serving) and writes rankR.json (launches, walls,
    histories, all-gathers, peak memory) and rankR.npz (the gathered
    results)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.apps.tsunami import TsunamiModel
    from repro_torch.core.fleet import CampaignCheckpoint
    from repro_torch.core.pool import ModelPool
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.swe.testing import sources
    from repro_torch.launch.mesh import destroy_ranks, make_mesh, rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ctx = ShardingCtx(make_mesh((2, 1), ("data", "model"), backend="gloo", rank=rank,
                                world_size=2, store=dist.FileStore(str(where / "store"), 2),
                                timeout_s=MESH_COLLECTIVE_TIMEOUT_S))
    dev = rank_device()
    walls, launches = {"start_s": time.perf_counter() - t0}, {}
    try:
        model = TsunamiModel()
        thetas = sources(16, MESH_WAVE_SEED)
        pool = ModelPool(model, ctx)
        reset_launches()
        walls["fine_s"], fine = _timed(torch, lambda: pool.evaluate(thetas, L1))
        launches["fine"] = {k: n for k, n in read_launches().items() if n}
        walls["fused_s"], fused = _timed(torch, lambda: _mesh_fused(
            torch, model, dev, ctx,
            CampaignCheckpoint(str(where / "fused_ckpt"), keep_last=4)))
        launches["fused"] = {k: n for k, n in read_launches().items() if n}
        t1 = time.perf_counter()
        lm = LMUQModel(DENSE_ARCH, reduced=False, batch=LM_BATCH, seq=LM_SEQ, ctx=ctx)
        torch.cuda.synchronize()
        walls["lm_init_s"] = time.perf_counter() - t1
        reset_launches()
        walls["lm_wave_s"], nlls = _timed(torch, lambda: lm.evaluate_batch(MESH_LM_POINTS))
        launches["lm"] = check_launches(read_launches(), lm.cfg, 1, f"rank {rank}'s LM wave")
        del lm
        gc.collect()
        torch.cuda.empty_cache()
        ctx12 = ShardingCtx(make_mesh((1, 2), ("data", "model"), backend="gloo"))
        train = rank_train_elastic(torch, where, ctx, ctx12)
        mla = mla_serve(torch, *mla_mesh_case(torch, dev), ctx=ctx12)
    finally:
        destroy_ranks()
    np.savez(where / f"rank{rank}.npz", fine=fine, samples=fused.samples,
             logposts=fused.logposts, nlls=nlls, mla_logits=mla.pop("logits"))
    rows = ctx.rows(len(thetas))
    (where / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "rows": [rows.start, rows.stop], "walls": walls,
        "launches": launches, "train": train, "mla": mla,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "wall_s": time.perf_counter() - t0}, default=float))
    return 0


#: the LM's layout on a mesh (`mesh_lm_sharded`): the two ranks' TP mesh, and
#: the q and kv heads each rank's flash launches take there (qwen3-0.6b's 16
#: and 8 over model = 2)
LM_TP_MESH, LM_TP_HEADS = (1, 2), (8, 4)


def phase_mesh_lm_sharded(torch, model, smi: str) -> dict:
    """The LM's layout on a mesh at full width and depth (qwen3-0.6b, `model`
    its one-device LMUQModel). On a 1x1 NCCL mesh in this process,
    `LMUQModel(ctx=)` holds its weights as DTensors placed by
    `param_specs`: its 8-point evaluate wave == the wave without ctx bit for
    bit (one forward's 28 flash launches, on each rank's local shard by
    `local_map`), and its gradient wave == the unsharded gradient wave bit
    for bit (2 x 28 forward launches, forward and remat recompute, and 28 of
    each backward kernel), and its Hessian-action wave (LM_HESS_POINTS
    points cut to LM_HESS_SEQ tokens, as `dense_lm_gradient_path` cuts it:
    reverse over reverse through the mesh layer's own DTensor rules on the
    card's torch) == the unsharded Hessian
    wave bit for bit, launching no kernel. Then two `gloo` ranks on the one
    card on the (data, model) = (1, 2) mesh (`--lm-tp-rank`, a host
    watchdog): the same
    8-point wave with TP over 'model', each rank's NLLs within LM_NLL_RTOL
    of the one-process wave, 28 flash launches a rank, every one on 8 q
    heads and 4 kv heads."""
    import shutil

    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import destroy_ranks, make_mesh
    from repro_torch.models.params import tree_leaves

    cfg = model.cfg
    t_phase = time.perf_counter()
    K = len(MESH_LM_POINTS)
    senss = np.array([[(-2.0) ** (i % 3 - 1)] for i in range(K)])
    plain = model.evaluate_batch(MESH_LM_POINTS)
    plain_grads = model.gradient_batch(MESH_LM_POINTS, senss)
    hess_batch = {k: v[:, :LM_HESS_SEQ] for k, v in model.batch.items()}
    h_thetas, h_senss = MESH_LM_POINTS[:LM_HESS_POINTS], senss[:LM_HESS_POINTS]
    h_vecs = np.eye(2)[np.arange(LM_HESS_POINTS) % 2]
    hess_model = copy.copy(model)
    hess_model.batch = hess_batch
    plain_hvp = hess_model.apply_hessian_batch(h_thetas, h_senss, h_vecs)
    del hess_model
    per_grad_wave = {"flash_attention_wgmma": 2 * cfg.n_layers,
                     **dict.fromkeys(ops.BWD_KERNELS[ops.bwd_stem(torch.bfloat16)],
                                     cfg.n_layers)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctx = ShardingCtx(make_mesh((1, 1), ("data", "model"), backend="nccl"))
    try:
        on_mesh = LMUQModel(DENSE_ARCH, reduced=False, batch=LM_BATCH, seq=LM_SEQ,
                            params=model.params, ctx=ctx)
        if not all(type(t).__name__ == "DTensor" for t in tree_leaves(on_mesh.params)):
            raise AssertionError("LMUQModel(ctx=): weights that are not DTensors")
        reset_launches()
        eval_s, nlls = _timed(torch, lambda: on_mesh.evaluate_batch(MESH_LM_POINTS))
        eval_launches = check_launches(read_launches(), cfg, 1, "LMUQModel(ctx=) on 1x1")
        _same_bits(nlls, plain, "the 8-point wave on DTensor weights vs without ctx")
        reset_launches()
        grad_s, grads = _timed(torch, lambda: on_mesh.gradient_batch(MESH_LM_POINTS, senss))
        counts = read_launches()
        want = dict.fromkeys(counts, 0)
        want.update(per_grad_wave)
        if counts != want:
            raise AssertionError(f"the gradient wave on DTensor weights: launches {counts}, "
                                 f"expected {want}")
        _same_bits(grads, plain_grads, "the gradient wave on DTensor weights vs without ctx")
        on_mesh.batch = hess_batch
        reset_launches()
        hess_s, hvp = _timed(torch, lambda: on_mesh.apply_hessian_batch(h_thetas, h_senss,
                                                                        h_vecs))
        hess_counts = read_launches()
        if any(hess_counts.values()):
            raise AssertionError(f"the Hessian wave on DTensor weights launched {hess_counts} "
                                 "(no kernel has a second derivative)")
        _same_bits(hvp, plain_hvp, "the Hessian wave on DTensor weights vs without ctx")
        del on_mesh
    finally:
        destroy_ranks()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    where = ROOT / "build" / "mesh_lm_sharded"
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    t_ranks = time.perf_counter()
    ranks = _watched_ranks("--lm-tp-rank", where, MESH_RANKS_TIMEOUT_S)
    ranks_s = time.perf_counter() - t_ranks
    tp_nlls = [np.load(where / f"rank{r}.npz")["nlls"] for r in range(2)]
    tp_err = max(float(np.max(np.abs(n / plain - 1.0))) for n in tp_nlls)
    print(f"mesh_lm_sharded: TP over model = 2, largest relative NLL difference from the "
          f"one-process wave {tp_err:.3g} (bound {LM_NLL_RTOL})", flush=True)
    problems = []
    if not tp_err < LM_NLL_RTOL:
        problems.append(f"TP wave NLLs off by {tp_err} relative (bound {LM_NLL_RTOL})")
    for meta in ranks:
        if meta["launches"] != {"flash_attention_wgmma": cfg.n_layers}:
            problems.append(f"rank {meta['rank']}: launches {meta['launches']}")
        if meta["heads"] != [list(LM_TP_HEADS)]:
            problems.append(f"rank {meta['rank']}: flash launches on (q, kv) heads "
                            f"{meta['heads']}, expected {list(LM_TP_HEADS)}")
    if problems:
        raise AssertionError("mesh_lm_sharded: " + "; ".join(problems))
    emit("mesh_lm_sharded", card=smi, arch=DENSE_ARCH, points=K,
         one_by_one={"mesh": [1, 1], "backend": "nccl", "evaluate_s": eval_s,
                     "gradient_s": grad_s, "evaluate_launches": eval_launches,
                     "gradient_launches": {k: n for k, n in counts.items() if n},
                     "hessian": {"points": LM_HESS_POINTS, "seq": LM_HESS_SEQ,
                                 "wave_s": hess_s, "launches": sum(hess_counts.values()),
                                 "hvp_e1_e2": hvp.tolist()},
                     "bound": "bit for bit (evaluate, gradient and Hessian waves)",
                     "max_memory_allocated": peak},
         tp={"mesh": list(LM_TP_MESH), "backend": "gloo", "ranks": ranks,
             "nll_max_rel_diff": tp_err, "bound": LM_NLL_RTOL, "wall_s": ranks_s},
         wall_s=time.perf_counter() - t_phase)
    return {"flash": eval_launches["flash_attention_wgmma"],
            "gradient": {k: n for k, n in counts.items() if n},
            "tp_flash": [m["launches"]["flash_attention_wgmma"] for m in ranks]}


def lm_tp_rank_main(rank: int, where: Path) -> int:
    """One rank of `mesh_lm_sharded`'s TP pair (`--lm-tp-rank R --mesh-dir
    DIR`): joins the 2-rank `gloo` group on the (1, 2) mesh, builds
    qwen3-0.6b at full width and depth sharded over it, runs the 8-point
    wave with every flash launch's head counts recorded, and writes rankR.json
    (launches, heads, walls, peak memory) and rankR.npz (the NLLs)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import destroy_ranks, make_mesh
    from repro_torch.models import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ctx = ShardingCtx(make_mesh(LM_TP_MESH, ("data", "model"), backend="gloo", rank=rank,
                                world_size=2, store=dist.FileStore(str(where / "store"), 2),
                                timeout_s=MESH_COLLECTIVE_TIMEOUT_S))
    walls, heads = {"start_s": time.perf_counter() - t0}, set()
    real = attention.flash_attention

    def recording(q, k, v, **kw):
        heads.add((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    try:
        t1 = time.perf_counter()
        lm = LMUQModel(DENSE_ARCH, reduced=False, batch=LM_BATCH, seq=LM_SEQ, ctx=ctx)
        torch.cuda.synchronize()
        walls["lm_init_s"] = time.perf_counter() - t1
        attention.flash_attention = recording
        reset_launches()
        walls["lm_wave_s"], nlls = _timed(torch, lambda: lm.evaluate_batch(MESH_LM_POINTS))
        launches = {k: n for k, n in read_launches().items() if n}
    finally:
        attention.flash_attention = real
        destroy_ranks()
    np.savez(where / f"rank{rank}.npz", nlls=nlls)
    (where / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "walls": walls, "launches": launches, "heads": sorted(heads),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "wall_s": time.perf_counter() - t0}, default=float))
    return 0


#: the dry run's full-size cells on the host (`dryrun_cells`): (arch, shape,
#: mesh name of `launch.dryrun.MESHES`)
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", "single"), ("deepseek-moe-16b", "decode_32k", "multi"))


def phase_dryrun_cells(smi: str) -> dict:
    """The dry run (`repro_torch.launch.dryrun.run_cell`) of DRYRUN_CELLS at
    full size on the host, in this process, each cell on a fake process
    group of 256 or 512 ranks (torn down after): per-device flops, bytes
    and collectives and the roofline terms against the H100 datasheet
    peaks, printed as ANALYSIS (no card runs them), and each cell's JSON
    in build/dryrun_cells; the two cells' trace times summed."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    where = ROOT / "build" / "dryrun_cells"
    where.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    cells = []
    try:
        for arch, shape, mesh in DRYRUN_CELLS:
            data = dryrun.run_cell(arch, shape, dryrun.fake_mesh(*dryrun.MESHES[mesh]))
            (where / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(data, indent=1))
            cells.append({k: data[k] for k in (
                "arch", "shape", "mesh", "n_devices", "flops_per_device", "bytes_per_device",
                "collectives", "collective_bytes_per_device", "roofline_terms_s", "dominant",
                "model_flops_per_device", "param_local_bytes", "cache_local_bytes",
                "t_trace_s")})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    emit("dryrun_cells", card=smi, kind="analysis: predicted per-device flops, bytes and "
         "collectives of one rank of a fake 256/512-rank mesh, terms against the H100 SXM5 "
         "datasheet peaks (no card ran them)", hardware="h100-sxm5-80gb", cells=cells,
         trace_s_total=sum(c["t_trace_s"] for c in cells), wall_s=time.perf_counter() - t_phase)
    return {"cells": cells}


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
    """Device time of one SSD launch at the main path's shapes and at
    zamba2-1.2b's (a wave of 8 points), beside its bound and the plain
    version's time. The bound is the larger of the
    bytes at the HBM rate and the 3xTF32 work (3 x flops) at the TF32
    tensor-core peak; `fp32_cuda_core_ops_ms` is the float32 work at the
    CUDA cores' peak, the bound of the kernel before it used the tensor
    cores."""
    from repro_torch.kernels.ssd import ssd_chunk_scan, ssd_chunked_ref
    from repro_torch.kernels.ssd import testing as T

    shapes = []
    torch.cuda.reset_peak_memory_stats()
    cases = [(B, T.MAMBA2_HEADS, 1, T.MAIN_PATH_SEQ, T.MAMBA2_P, T.MAMBA2_N, False)
             for B in T.MAIN_PATH_BATCHES] + [T.ZAMBA2_CASE]
    for B, H, G, S, P, N, _ in cases:
        inputs = T.kernel_inputs((B, H, G, S, P, N, False), dev)
        ms = _device_ms(torch, lambda: ssd_chunk_scan(*inputs), calls=max(2, 40 // B))
        # ~300 PyTorch kernels a call
        plain_ms = _device_ms(torch, lambda: ssd_chunked_ref(*inputs), calls=1, windows=3)
        work = ssd_work(B, H, G, S, P, N)
        t_bytes, t_tc = work["bytes"] / HBM_BYTES_PER_S, 3 * work["flops"] / TF32_FLOPS
        t_fp32 = work["flops"] / FP32_FLOPS
        bound_ms = max(t_bytes, t_tc) * 1e3
        shapes.append({
            "shape": [B, H, S, P, N], "arch": SSM_ARCH if N == T.MAMBA2_N else ZOO_SSM_ARCH,
            "ms": ms, "plain_ms": plain_ms,
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
               elem: int, hd_v: int | None = None) -> dict:
    """Bytes flash attention must move (q, k, v read once, o written once)
    and its float operations: two multiply-adds per (q row, key, column)
    for q k^T (hd columns) and P V (hd_v, default hd), over the (row, key)
    pairs the mask keeps (S(S+1)/2 per head when causal)."""
    hd_v = hd if hd_v is None else hd_v
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    return {"bytes": elem * (B * nq * Sq * (hd + hd_v) + B * nkv * Sk * (hd + hd_v)),
            "flops": 2 * B * nq * (hd + hd_v) * pairs}


#: the float32 flash kernel's own path: the reduced qwen3-0.6b (float32, 4 q
#: heads and 2 kv heads of 32) over a level-2 grid (13 points, one wave)
F32_LM_BATCH, F32_LM_SEQ, F32_GRID_LEVEL = 2, 512, 2
#: its attention shape on that path: 13 points x 2 sequences (the first of
#: the float32 cases of `kernels/flash_attention/testing.py`)
F32_PATH_CASE = (13 * F32_LM_BATCH, 4, 2, F32_LM_SEQ, F32_LM_SEQ, 32, True, "float32")


def _model_layout(q, k, v):
    """The same values as transposed views of [B, S, n, hd] tensors: the
    layout the qwen3 path hands the kernel."""
    return tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))


def phase_flash_kernel_vs_plain(torch, dev) -> dict:
    """Both flash kernels against their plain version (`attention_ref`) on
    the card (bound and reason: `repro_torch.kernels.flash_attention.testing`):
    the JAX package's FLASH_CASES, ragged shapes, the float32 path's shape
    and qwen3-0.6b's width in float32, and qwen3-0.6b's attention at one
    point, a wave of 8 and the 41-point grid wave (at its model layout,
    through strides). Each case goes through the wrapper to the kernel of
    its dtype (`flash_attention_wgmma` for bf16, `flash_attention` for
    float32), and the float32 kernel also runs every bf16 case; then the LM
    zoo's shapes (`T.ZOO_CASES`) on the wgmma kernel."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import testing as T

    if T.F32_CASES[0] != F32_PATH_CASE:
        raise AssertionError(f"the float32 path's shape {F32_PATH_CASE} is not the first "
                             f"float32 case {T.F32_CASES[0]}")
    report = {"flash_attention_wgmma": {}, "flash_attention": {}}
    for i, case in enumerate(T.CASES):
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
        if kernel != "flash_attention":  # the float32 kernel's body on the same bf16 inputs
            got = torch.empty_like(q)
            ops.launch("flash_attention", q, k, v, got, causal)
            torch.cuda.synchronize()
            report["flash_attention"][name] = T.assert_close(got, want, f"flash_attention {name}")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    # the LM zoo's shapes on their paths, at the model layout: MLA's padded
    # heads at its own scale, cross-attention full with Sq != Sk
    for i, (arch, zoo) in enumerate(T.ZOO_CASES.items()):
        name, causal = f"{arch}_{T.case_name(zoo.case)}", zoo.case[6]
        q, k, v = _model_layout(*T.case_inputs(zoo.case, dev, seed=100 + i, widths=zoo.widths))
        want = T.plain(q, k, v, causal, zoo.scale)
        before = flash_attention.launches_by_kernel["flash_attention_wgmma"]
        got = flash_attention(q, k, v, causal=causal, scale=zoo.scale)
        torch.cuda.synchronize()
        if flash_attention.launches_by_kernel["flash_attention_wgmma"] != before + 1:
            raise AssertionError(f"{name}: the wrapper did not launch flash_attention_wgmma")
        report["flash_attention_wgmma"][name] = dict(
            T.assert_close(got, want, f"flash_attention_wgmma {name}"), scale=zoo.scale,
            widths=zoo.widths)
        if zoo.widths is not None and bool(got[..., zoo.widths[1]:].any()):
            raise AssertionError(f"{name}: the padded columns of o are not zero")
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
            "f32_kernel": worst["flash_attention"]["float32"],
            "f32_kernel_bf16": worst["flash_attention"]["bfloat16"], "by_kernel": worst}


def phase_flash_times(torch, dev, smi: str) -> dict:
    """Device time of one launch of each flash kernel at the FLASH_CASES
    shapes, the float32 cases (the float32 path's shape and qwen3-0.6b's
    width) and qwen3-0.6b's main-path shapes (at the model layout, through
    strides), beside the bound, the plain version's time and
    `scaled_dot_product_attention`'s. `ms` is the kernel the wrapper takes.
    The bound is the larger of the bytes at the HBM rate and the operations
    at the tensor cores' rate for the kernel's work: bf16 at its peak, and
    float32 in 3xTF32 (3 x flops at the TF32 peak), as the SSD's;
    `fp32_cuda_core_ops_ms` is the float32 work at the CUDA cores' peak, the
    bound of the float32 kernel before it ran on the tensor cores. At bf16
    shapes `f32_kernel_ms` is `flash_attention.cu`'s body on the same inputs,
    the wgmma kernel's yardstick. Then the LM zoo's shapes (`T.ZOO_CASES`)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import testing as T

    shapes = []
    for i, case in enumerate(T.FLASH_CASES + T.F32_CASES + T.MODEL_CASES):
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
            entry["f32_kernel_ms"] = _device_ms(
                torch, lambda: ops.launch("flash_attention", q, k, v, o, causal),
                calls=2 if big else 50)
        entry["plain_ms"] = _device_ms(torch, lambda: T.plain(q, k, v, causal),
                                       calls=1 if big else 10, windows=3 if big else 5)
        entry["library_ms"] = _device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), calls=10 if big else 50)
        t_bytes = work["bytes"] / HBM_BYTES_PER_S
        t_ops = work["flops"] / BF16_FLOPS if dt == "bfloat16" else (
            3 * work["flops"] / TF32_FLOPS)
        t_fp32 = work["flops"] / FP32_FLOPS
        entry.update({
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "tc_ops_ms": t_ops * 1e3,
            "fp32_cuda_core_ops_ms": t_fp32 * 1e3, **work,
        })
        entry["share_of_bound"] = entry["bound_ms"] / ms
        if dt == "bfloat16":
            entry["fraction_of_bf16_peak"] = t_ops * 1e3 / ms
            entry["f32_kernel_fraction_of_fp32_peak"] = t_fp32 * 1e3 / entry["f32_kernel_ms"]
        else:
            entry["fp32_cuda_core_bound_ms"] = max(t_bytes, t_fp32) * 1e3
            entry["fraction_of_fp32_peak"] = t_fp32 * 1e3 / ms
        shapes.append(entry)
        del q, k, v
        torch.cuda.empty_cache()
    # the LM zoo's shapes on the wgmma kernel, at the model layout. The bound
    # is the function's own work: MLA's at its native widths (q.k over 96
    # columns, v over 64), which the kernel computes zero-padded to 128 (its
    # `kernel_flops`); SDPA runs at the native widths with MLA's scale
    for i, (arch, zoo) in enumerate(T.ZOO_CASES.items()):
        B, nq, nkv, Sq, Sk, hd, causal, dt = zoo.case
        dqk, dv = zoo.widths or (hd, hd)
        q, k, v = _model_layout(*T.case_inputs(zoo.case, dev, seed=200 + i, widths=zoo.widths))
        qn, kn, vn = (t[..., :w].contiguous() for t, w in ((q, dqk), (k, dqk), (v, dv)))
        work = flash_work(B, nq, nkv, Sq, Sk, dqk, causal, 2, hd_v=dv)
        ms = _device_ms(torch, lambda: flash_attention(q, k, v, causal=causal, scale=zoo.scale),
                        calls=10)
        plain_ms = _device_ms(torch, lambda: T.plain(q, k, v, causal, zoo.scale), calls=1,
                              windows=3)
        library_ms = _device_ms(torch, lambda: F.scaled_dot_product_attention(
            qn, kn, vn, is_causal=causal, enable_gqa=True, scale=zoo.scale), calls=10)
        t_bytes, t_ops = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / BF16_FLOPS
        shapes.append({
            "shape": [B, nq, nkv, Sq, hd], "sk": Sk, "arch": arch, "causal": causal,
            "dtype": dt, "kernel": "flash_attention_wgmma", "model_layout": True,
            "scale": zoo.scale, "widths": [dqk, dv], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "tc_ops_ms": t_ops * 1e3,
            "share_of_bound": max(t_bytes, t_ops) * 1e3 / ms,
            "kernel_flops": flash_work(B, nq, nkv, Sq, Sk, hd, causal, 2)["flops"], **work,
        })
        del q, k, v, qn, kn, vn
        torch.cuda.empty_cache()
    emit("flash_times", kernels=["flash_attention_wgmma", "flash_attention"],
         timer="one CUDA event pair around back-to-back launches (50; 10 above 0.1 TFLOP, "
               "the float32 kernel on bf16 2; plain: 10, or 1 in 3 windows), per launch, "
               "median of 5 windows",
         bound="max(bytes at 3.35 TB/s, operations at the tensor cores' peak: bf16 989 "
               "TFLOP/s; float32 as 3 x flops at the 495 TFLOP/s TF32 peak)",
         library="F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)",
         shapes=shapes, card=smi)
    return {"shapes": shapes}


#: each kernel of the LM paths by its name in a trace
LM_TRACE = {"ssd": "ssd_chunk_scan", "flash_attention_wgmma": "flash_attention_wgmma_kernel"}
#: the phase names' prefix of each LM path
LM_PHASE = {SSM_ARCH: "lm", DENSE_ARCH: "dense_lm", MOE_ARCH: "moe_lm",
            ZOO_SSM_ARCH: "hybrid_lm", "minicpm3-4b": "mla_lm",
            "llama-3.2-vision-90b": "vlm_lm", "kimi-k2-1t-a32b": "kimi_lm"}


def lm_launches(cfg) -> dict:
    """The launches of one forward of `cfg` on the kernel path, by kernel
    (`transformer.kernel_launches`: one SSD scan per ssm unit, one flash
    attention per attention), with every other kernel at 0."""
    from repro_torch.models import transformer

    want = dict.fromkeys(read_launches(), 0)
    want.update(transformer.kernel_launches(cfg))
    return want


def check_launches(counts: dict, cfg, forwards: int, what: str) -> dict:
    """Raises unless `counts` are exactly `forwards` forwards' launches of
    `cfg` (no other kernel); returns the launched kernels' counts."""
    want = {k: forwards * n for k, n in lm_launches(cfg).items()}
    if forwards < 1 or counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {forwards} forwards' {want}")
    return {k: n for k, n in counts.items() if n}


#: bound on each flash launch of a model forward against the plain version
#: on the same tensors (`in_situ_attention`): the largest error over the
#: largest output. Both sides round their result to bf16 once (2^-8 of an
#: output, relative) and the kernel also rounds P; 1e-2 is ~2.5 bf16 ulps of
#: the largest output. A wrong scale, mask or padding moves outputs by O(1).
IN_SITU_RTOL = 1e-2


def in_situ_attention(torch, model) -> dict:
    """One point's forward on the kernel path (`model.evaluate_batch` at
    theta = (1, 1)) with every flash launch of the model held, on the
    tensors the model hands it (its layout, MLA's padding and scale, the
    cross-attention's context), against the plain version
    (`testing.plain`): the attention kernel checked inside the model, where
    the NLL of a random model sees only gross faults."""
    from repro_torch.kernels.flash_attention import testing as T
    from repro_torch.models import attention

    real, seen = attention.flash_attention, []

    def checked(q, k, v, *, causal=True, scale=None):
        o = real(q, k, v, causal=causal, scale=scale)
        want = T.plain(q, k, v, causal, scale)
        seen.append(float((o.float() - want.float()).abs().max() / want.float().abs().max()))
        return o

    attention.flash_attention = checked
    try:
        model.evaluate_batch(np.array([[1.0, 1.0]]))
    finally:
        attention.flash_attention = real
    calls = sum(n for k, n in lm_launches(model.cfg).items() if k.startswith("flash"))
    worst = max(seen, default=0.0)
    if len(seen) != calls or not worst <= IN_SITU_RTOL:
        raise AssertionError(f"in-situ attention: {len(seen)} calls (expected {calls}), "
                             f"worst {worst:.3g} > {IN_SITU_RTOL}")
    return {"calls": len(seen), "max_rel_err": worst, "bound": IN_SITU_RTOL}


class PinnedRouting:
    """The experts every MoE layer of one run picked, replayed in a later
    run. A MoE's top-k is discontinuous: in bf16 the kernel path and the
    plain path round the residual stream differently, and where two experts'
    router probabilities nearly tie (64 experts from a random router tie
    often) the two paths route a token differently; the token then takes
    another expert's output, and through attention so do the tokens after
    it. Replaying the kernel path's choices in the plain path (the combine
    weights still from the plain path's own router probabilities, so
    capacity drops and dispatch order are the same) leaves the attention
    path as the one difference. On deepseek-moe-16b (H100, 700 W) that took
    the two paths' NLL difference from 4.4e-3 to 2.5e-3 (PERF.md, PR 26)."""

    def __init__(self):
        self.choices: list = []

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.models import moe

        real = moe.router_topk

        def record(cfg, params, x):
            w, idx, aux = real(cfg, params, x)
            self.choices.append(idx)
            return w, idx, aux

        moe.router_topk = record
        try:
            yield self
        finally:
            moe.router_topk = real

    @contextlib.contextmanager
    def replaying(self):
        import torch

        from repro_torch.models import moe

        real, pending = moe.router_topk, iter(self.choices)

        def replay(cfg, params, x):
            idx = next(pending)
            probs = torch.softmax(x.float() @ params["router"], dim=-1)
            w = probs.gather(-1, idx)
            return (w / w.sum(-1, keepdim=True)).to(x.dtype), idx, real(cfg, params, x)[2]

        moe.router_topk = replay
        try:
            yield self
        finally:
            moe.router_topk = real
        if next(pending, None) is not None:
            raise AssertionError("the pinned run took fewer MoE layers than were recorded")


def phase_lm_main_path(torch, arch: str) -> dict:
    """examples/serve_uq.py's flow on a full-width LM: a level-4 sparse grid
    of the NLL (41 points, one unpadded wave), the surrogate's 4,000-sample
    Monte Carlo, and 8 per-point submits, all through
    `EvaluationFabric(ModelBackend(LMUQModel))`. Every forward launches
    exactly `lm_launches` (the model's kernels once per layer that runs
    them), and no other kernel."""
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    from repro_torch.uq import sparse_grid as sg

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
    # every forward the fabric dispatched launched its kernels once per layer
    if forwards < 2:
        raise AssertionError(f"{forwards} forwards on the {arch} path")
    launches = check_launches(counts, model.cfg, forwards, f"the {arch} path")
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
         launches_per_forward=transformer.kernel_launches(model.cfg), launches=counts,
         params=M.n_params(model.cfg), max_memory_allocated=peak,
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
    plain = copy.copy(model)
    plain.cfg = model.cfg.replace(attn_impl="plain")
    thetas = np.array([[1.0 + 0.02 * i, 1.0] for i in range(LM_SUBMITS)])
    pin = PinnedRouting()
    before = read_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pin.recording():
        got = model.evaluate_batch(thetas)[:, 0]
    kernel_s = time.perf_counter() - t0
    kernel_peak = torch.cuda.max_memory_allocated()
    after = read_launches()
    check_launches({k: after[k] - before[k] for k in after}, model.cfg, 1,
                   f"one {arch} wave")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with pin.replaying() if pin.choices else contextlib.nullcontext():
        want = plain.evaluate_batch(thetas)[:, 0]
    plain_s = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated()
    rel = float(np.abs(got / want - 1.0).max())
    bound = LM_NLL_RTOL if arch in (SSM_ARCH, DENSE_ARCH) else ZOO_NLL_RTOL
    moe_fields = {}
    if pin.choices:  # and each path routing on its own: reported, not bounded
        free = plain.evaluate_batch(thetas)[:, 0]
        moe_fields = {"routing": "the plain path replays the kernel path's experts",
                      "nll_plain_own_routing": free.tolist(),
                      "nll_rel_err_own_routing": float(np.abs(got / free - 1.0).max())}
    # the same points on the kernel path, one forward each: the model's own
    # bf16 spread between two wave sizes (other GEMM tilings)
    single = np.array([model.evaluate_batch(t[None])[0, 0] for t in thetas])
    in_situ = in_situ_attention(torch, model) if model.cfg.family != "ssm" else None
    # how far the two paths drift apart token by token, at theta = (1, 1)
    token_nll = []
    for m in (model, plain):
        with torch.inference_mode():
            hidden, _, _ = transformer.forward(m.cfg, m.params, m.batch["tokens"], skip_head=True,
                                               ctx_embed=m.batch.get("ctx_embed"))
            logits = M.mask_padded_logits(m.cfg, lm_head(m.params["embed"], hidden).float())
            tgt = torch.gather(logits, -1, m.batch["targets"][..., None])[..., 0]
            token_nll.append(torch.logsumexp(logits, dim=-1) - tgt)
    emit(f"{LM_PHASE[arch]}_kernel_vs_plain", points=len(thetas), bound=bound,
         nll_rel_err=rel, nll_kernel=got.tolist(), nll_plain=want.tolist(),
         kernel_wave_s=kernel_s, plain_wave_s=plain_s,
         kernel_max_memory_allocated=kernel_peak, plain_max_memory_allocated=plain_peak,
         token_nll_max_abs_diff=float((token_nll[0] - token_nll[1]).abs().max()),
         token_nll_std=float(token_nll[1].std()),
         nll_rel_spread_wave_vs_points=float(np.abs(got / single - 1.0).max()),
         in_situ_attention=in_situ, **moe_fields)
    if not rel <= bound:
        raise AssertionError(f"kernel path NLL {got} vs plain {want}: {rel:.3g} > {bound}")
    return {"nll_rel_err": rel}


def phase_lm_profile(torch, model, points, unprofiled_s: float) -> dict:
    """The grid wave again under torch.profiler: the model kernel's and the
    GEMMs' shares of the wave's wall time, the rest of the device time
    (elementwise glue, norms, softmax of the head), and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    arch = model.cfg.name
    per_forward = {k: n for k, n in lm_launches(model.cfg).items() if n}
    thetas = np.asarray(points, float)  # the grid wave as the fabric runs it
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad_trace(torch)
        t0 = time.perf_counter()
        model.evaluate_batch(thetas)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = ROOT / "build" / f"chip_smoke_{LM_PHASE[arch]}_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    busy = {**dict.fromkeys(per_forward, 0.0), "gemm": 0.0, "other": 0.0, "memcpy_memset": 0.0}
    in_trace = dict.fromkeys(per_forward, 0)
    by_name: dict[str, list] = {}
    n_kernels = 0
    for ev in json.loads(trace.read_text()).get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name, dur = ev.get("cat"), ev.get("name", ""), float(ev.get("dur", 0.0))
        if TRACE_PAD_NAME in name:
            continue
        if cat in ("gpu_memcpy", "gpu_memset"):
            busy["memcpy_memset"] += dur
        elif cat == "kernel":
            n_kernels += 1
            low = name.lower()
            mine = [k for k in per_forward if LM_TRACE[k] in low]
            if mine:
                busy[mine[0]] += dur
                in_trace[mine[0]] += 1
            elif any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):  # cuBLAS
                busy["gemm"] += dur
            else:
                busy["other"] += dur
            entry = by_name.setdefault(name[:90], [0, 0.0])
            entry[0] += 1
            entry[1] += dur
    if not n_kernels:
        raise AssertionError("the profiler recorded no device kernel")
    # the wave is one forward: its kernels' launches, each under its own
    # name in the trace
    if in_trace != per_forward:
        raise AssertionError(f"the trace holds {in_trace} launches of "
                             f"{[LM_TRACE[k] for k in per_forward]}, expected {per_forward}")
    device_us = sum(busy.values())
    emit(f"{LM_PHASE[arch]}_profile", wave=f"{len(thetas)} grid points, unpadded",
         wall_ms=wall_us / 1e3, unprofiled_wall_ms=unprofiled_s * 1e3,
         device_kernels=n_kernels, device_busy_ms=device_us / 1e3,
         launches_in_trace=in_trace,
         busy_ms={k: v / 1e3 for k, v in busy.items()},
         share_of_wall={k: v / wall_us for k, v in busy.items()},
         device_busy_share=device_us / wall_us, device_idle_share=1.0 - device_us / wall_us,
         top_kernels=[{"name": k, "launches": n, "ms": us / 1e3} for k, (n, us) in
                      sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]])
    return {"kernel_share": sum(busy[k] for k in per_forward) / wall_us,
            "idle_share": 1.0 - device_us / wall_us}


def phase_flash_f32_path(torch) -> dict:
    """The float32 flash kernel's own path: the reduced qwen3-0.6b in
    float32 (the config the port's parity tests hold to the JAX package)
    as an UM-Bridge model, a level-2 sparse grid of its NLL through
    `EvaluationFabric(ModelBackend(LMUQModel))` as one unpadded wave, and the
    same wave on the plain path. Every forward launches the float32 flash
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


#: the serving steps after each LM phase's waves: a prefill of LM_BATCH
#: prompts of LM_SEQ - DECODE_STEPS tokens at cache_len LM_SEQ, then
#: DECODE_STEPS teacher-forced decode steps on the next tokens, timed after
#: DECODE_WARMUP steps (and DECODE_PROFILED more under the profiler) on a
#: copy of the cache
DECODE_STEPS, DECODE_WARMUP, DECODE_PROFILED = 32, 2, 2
#: kimi-k2's full forward at no-drop capacity (384 experts, each of its
#: [E, tokens, d] slots kept) does not fit beside its 40 GB of weights at
#: 2,048 tokens: its prompt is cut to 224 tokens (256 with the steps)
DECODE_PROMPT = {"kimi-k2-1t-a32b": 224}
#: bound on each decode step's logits against the full forward's at the same
#: position, relative to the largest logit: the JAX package's 2e-2
#: (tests/test_smoke_archs.py:58) in bf16, DECODE_F32_RTOL in float32, and
#: at least twice the full forward's own spread at those positions. The
#: spread is the larger of two: the two sequences together against one at a
#: time (0 on an H100 for most of the zoo: the GEMMs give each row the same
#: sums at B = 1 and 2), and the kernel path's forward against the plain
#: path's (the same function, rounded elsewhere). The random forwards of
#: the configs without qk-norm are chaotic in bf16 and in float32 alike:
#: the last rounding bit of one layer moves a token's logits by up to 100%
#: of the largest 40 layers later (PERF.md §6). So the sharp check
#: of the decode logic at full width is `UnitTap`'s, a layer at a time
DECODE_RTOL = 2e-2
DECODE_F32_RTOL = 1e-4
#: bound on each unit's output in a teacher-forced decode step (`UnitTap`)
#: against the full forward's at the same position, relative to the unit's
#: largest output. On an H100 (700 W) the largest were 1.64e-2 in
#: bf16 (kimi-k2's MoE layer; 4.8e-3-1.3e-2 elsewhere) and 1.03e-4 in
#: float32 (llama-3.2-vision's first layer, whose 28,672-wide MLP sums in
#: float32 over 2 rows and over 4,096 rows differ; <= 4.7e-5 elsewhere):
#: 2^-5 (4 bf16 ulps) and 1e-3 are 1.9x and 9.7x those. A rope position one
#: off moves a unit by ~0.4 of its largest output
UNIT_RTOL = {"bfloat16": 2.0 ** -5, "float32": 1e-3}
#: the float32 serving runs: (arch, layers kept at full width or None for
#: all). deepseek-moe-16b's 28 layers are 65 GB in float32: 4 (one dense,
#: three MoE) kept its widths; kimi-k2's one MoE layer alone is 68 GB in
#: float32, and deepseek's MoE layers run the same code. To make room for
#: the training phases in the run's time, three more were cut in depth,
#: widths kept (every unit kind still runs): qwen3-0.6b 28 -> 4 layers and
#: mamba2-1.3b 48 -> 4 (their end-to-end logits bound, 1e-4, holds at any
#: depth: 6.0e-6 and 4.3e-6 at 4 layers on an H100), minicpm3-4b 62 -> 8
#: and llama-3.2-vision 10 -> 5 (one vlm group: 4 self and 1 cross); to make
#: room for the trainer on a mesh, qwen3-0.6b, mamba2-1.3b and
#: deepseek-moe-16b (one dense layer, one MoE) are cut to 2 and minicpm3-4b
#: to 4. The
#: chaotic models' end-to-end bound is twice the forward's own spread, and
#: zamba2-1.2b's decode logits sit at 1.8-2.1x its plain path's spread at 8
#: and 14 layers (1.008e-4 against a bound of 1e-4 at 8): it runs whole,
#: as before, its units teacher-forced within 1.6e-5 at every depth
F32_DECODE_PATHS = ((DENSE_ARCH, 2), (SSM_ARCH, 2), (ZOO_SSM_ARCH, None),
                    ("minicpm3-4b", 4), ("llama-3.2-vision-90b", 5), (MOE_ARCH, 2))
#: layer 0's cache rows that decode wrote against a prefill's: K and V after
#: rope, MLA's latent and k_pe, the SSM conv window and the cross caches
#: within one bf16 ulp of the largest value (two float32 sums that differ in
#: their last bits can round to neighbouring bf16 values); the SSM state,
#: float32, summed chunk by chunk in the prefill and step by step in decode,
#: within SSM_STATE_RTOL
BF16_ULP = 2.0 ** -7
SSM_STATE_RTOL = 1e-4
#: qwen3-0.6b's serving batch: the grid wave's 82 sequences (41 points x 2),
#: its peak memory under SERVING_PEAK_CACHES x its KV cache (2.21 on an H100
#: at 700 W: the prefill's per-layer caches, their stacked copy, 1.2 GB of
#: weights)
SERVING_BATCH = 82
SERVING_PEAK_CACHES = 2.5


def _rel(torch, got, want) -> float:
    """Largest error over the largest value."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _no_drop(cfg):
    """`cfg` with every MoE pair kept (capacity_factor = n_experts / top_k):
    a decode step of B <= 8 tokens never drops a pair (the capacity floor of
    8 slots), so the prefill and the full forward it is held to must not."""
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k) if cfg.n_experts else cfg


def _logits_from(cfg, params, tokens, ctx_embed, start: int):
    """The full forward's logits at positions start.. (float32)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import lm_head

    hidden, _, _ = transformer.forward(cfg, params, tokens, ctx_embed=ctx_embed, skip_head=True)
    return lm_head(params["embed"], hidden[:, start:]).float()


def _leaves(tree) -> dict:
    """The tensors of a cache tree by path ("/0/attn/k", ...)."""
    from repro_torch.models.params import walk

    out = {}
    walk(tree, lambda t, path: out.setdefault(path, t))
    return out


def _clone(tree):
    from repro_torch.models.params import walk

    return walk(tree, lambda t, _p: t.clone())


def decode_step_bytes(torch, cfg, params, cache, B: int, pos: int, experts=None) -> dict:
    """The bytes one decode step at `pos` must move: every weight it reads
    (the embedding table only through the head when it is tied, B rows of it
    otherwise; no vlm context projection: the cross caches hold its
    product) and the valid cache, rows 0..pos of each attention cache, the
    cross caches whole, the SSM windows and states read and written.
    `experts` (a MoE's expert ids of each layer of one step) also gives the
    bytes with only the routed experts' weights read."""
    leaves = _leaves(params)
    weights = sum(t.numel() * t.element_size() for path, t in leaves.items()
                  if path not in ("/ctx_proj", "/embed/embedding"))
    table = params["embed"]["embedding"]
    weights += (table.numel() * table.element_size() if "head" not in params["embed"]
                else B * table.shape[1] * table.element_size())
    cache_bytes = 0
    for path, t in _leaves(cache).items():
        n = t.numel() * t.element_size()
        if "/ssm/" in path:
            cache_bytes += 2 * n
        elif "/cross/" in path:
            cache_bytes += n
        else:  # the rows axis follows [n, (p-1,) B]
            cache_bytes += n * (pos + 1) // t.shape[3 if "/self/" in path else 2]
    out = {"weights": weights, "cache": cache_bytes, "total": weights + cache_bytes,
           "bound_ms": (weights + cache_bytes) / HBM_BYTES_PER_S * 1e3}
    if experts:
        per_expert = sum(t[0, 0].numel() * t.element_size() for path, t in leaves.items()
                         if path.endswith(("/moe/w_gate", "/moe/w_up", "/moe/w_down")))
        unused = sum(cfg.n_experts - len(torch.unique(idx)) for idx in experts)
        routed = weights - unused * per_expert
        out.update(weights_routed=routed,
                   bound_ms_routed=(routed + cache_bytes) / HBM_BYTES_PER_S * 1e3)
    return out


def _layer0_rows(torch, got, want, start: int, stop: int) -> dict:
    """Layer 0's cache leaves that decode wrote (`got`, rows start..stop-1
    of the attention caches; the SSM window and state; the cross caches)
    against a prefill of all stop tokens (`want`): the largest error over the
    largest value of each, and the bound it is held to."""
    wanted = _leaves(want[0])  # group 0
    out = {}
    for path, t in _leaves(got[0]).items():
        t, w = t[0], wanted[path][0]  # unit 0
        if "/self/" in path:  # a vlm unit's first self-attention
            t, w = t[0], w[0]
        if "/ssm/" not in path and "/cross/" not in path:
            t, w = t[:, start:stop], w[:, start:stop]
        bound = SSM_STATE_RTOL if path.endswith("/state") else BF16_ULP
        out[path.strip("/")] = {"rel_err": _rel(torch, t, w), "bound": bound}
    return out


def _prefill_and_decode(torch, cfg, params, tokens, ctx_embed, prompt: int, phase: str,
                        keep_prefill: bool = False) -> dict:
    """Prefill `prompt` tokens of each sequence on the kernel path, then
    DECODE_STEPS teacher-forced decode steps, each timed (host clock around
    a synchronised step; DECODE_WARMUP steps first, and DECODE_PROFILED
    under the profiler, on a copy of the cache; `keep_prefill` keeps
    another copy, as the prefill left it). Launch counts start at 0 right
    before the prefill; every decode step must launch no kernel."""
    from repro_torch.models import model as M

    total = prompt + DECODE_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = M.prefill_step(cfg, params, tokens[:, :prompt], ctx_embed=ctx_embed,
                                 cache_len=total)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = read_launches()
    check_launches(prefill_launches, cfg, 1, f"{phase}'s prefill")
    warm = _clone(cache)
    kept = _clone(cache) if keep_prefill else None
    for j in range(DECODE_WARMUP):
        M.decode_step(cfg, params, warm, tokens[:, prompt + j:prompt + j + 1], prompt + j)
    pin = PinnedRouting()

    def profiled():
        with pin.recording():
            for j in range(DECODE_WARMUP, DECODE_WARMUP + DECODE_PROFILED):
                M.decode_step(cfg, params, warm, tokens[:, prompt + j:prompt + j + 1], prompt + j)

    busy = _device_busy(torch, profiled, f"{phase}'s decode steps")
    del warm
    logits, step_s = [], []
    for j in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, cache = M.decode_step(cfg, params, cache, tokens[:, prompt + j:prompt + j + 1],
                                    prompt + j)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        logits.append(step.float())
    counts = read_launches()
    if counts != prefill_launches:
        raise AssertionError(f"{phase}: the decode steps launched kernels: {prefill_launches} "
                             f"after the prefill, {counts} after the steps")
    peak = torch.cuda.max_memory_allocated()
    B = tokens.shape[0]
    step_ms = statistics.median(step_s) * 1e3
    experts = pin.choices[:cfg.n_layers - cfg.first_k_dense] if cfg.n_experts else None
    bounds = [decode_step_bytes(torch, cfg, params, cache, B, prompt + j, experts)
              for j in range(DECODE_STEPS)]
    bound = {k: statistics.fmean(b[k] for b in bounds) for k in bounds[0]}
    return {
        "cache": cache, "prefill_cache": kept, "last": last, "logits": torch.stack(logits, 1),
        "launches": {k: n for k, n in prefill_launches.items() if n},
        "fields": dict(
            batch=B, prompt=prompt, cache_len=total, steps=DECODE_STEPS, prefill_s=prefill_s,
            step_ms_median=step_ms, step_ms_min=min(step_s) * 1e3,
            step_ms_max=max(step_s) * 1e3, tokens_per_s=B / (step_ms / 1e3),
            cache_bytes=sum(t.numel() * t.element_size() for t in _leaves(cache).values()),
            resident_before=resident, max_memory_allocated=peak,
            step_bytes=bound["total"], step_weight_bytes=bound["weights"],
            step_cache_bytes=bound["cache"], step_bound_ms=bound["bound_ms"],
            step_bound_share=bound["bound_ms"] / step_ms,
            **({"step_bound_ms_routed_experts": bound["bound_ms_routed"]}
               if "bound_ms_routed" in bound else {}),
            prefill_launches={k: n for k, n in prefill_launches.items() if n},
            launches_per_decode_step=0,
            profiled_steps=DECODE_PROFILED,
            step_device_busy_share=busy["device_busy_s"] / busy["profiled_wall_s"],
            step_host_share=1.0 - busy["device_busy_s"] / busy["profiled_wall_s"],
            step_device_kernels=busy["kernels"] / DECODE_PROFILED),
    }


class UnitTap:
    """Each unit of the stack (`transformer._dense_unit`, `_ssm_unit`,
    `_cross_unit`) checked on its own in decode at full width, where the
    random models' chaos makes the end-to-end logits a weak check.
    `recording()` keeps, over a full prefill, each unit call's input and
    output rows at positions start..stop-1 and each MoE layer's experts
    there; `forcing(j)` then runs one decode step at position start + j
    with every unit fed the full forward's input row (teacher forcing, a
    unit at a time) and every MoE layer given the full forward's experts
    for that token (weighted by its own router, as `PinnedRouting`
    replays), and keeps per unit the largest error of its output over its
    largest output (`errs`)."""

    UNITS = ("_dense_unit", "_ssm_unit", "_cross_unit")

    def __init__(self, torch, start: int, stop: int):
        self.torch, self.start, self.stop = torch, start, stop
        self.rows: list = []
        self.experts: list = []
        self.errs: list = []

    @contextlib.contextmanager
    def _patched(self, unit, router):
        from repro_torch.models import moe, transformer

        real = {name: getattr(transformer, name) for name in self.UNITS}
        real_router = moe.router_topk
        for name, fn in real.items():
            setattr(transformer, name, unit(fn))
        moe.router_topk = router(real_router)
        try:
            yield self
        finally:
            for name, fn in real.items():
                setattr(transformer, name, fn)
            moe.router_topk = real_router

    def recording(self):
        rows = slice(self.start, self.stop)

        def unit(real):
            def record(cfg, params, x, **kw):
                out = real(cfg, params, x, **kw)
                self.rows.append((x[:, rows].clone(), out[0][:, rows].clone()))
                return out
            return record

        def router(real):
            def record(cfg, params, x):
                w, idx, aux = real(cfg, params, x)
                self.experts.append(idx[:, rows].clone())
                return w, idx, aux
            return record

        return self._patched(unit, router)

    def forcing(self, j: int):
        torch = self.torch
        units, experts = iter(range(len(self.rows))), iter(self.experts)
        self.errs = self.errs or [0.0] * len(self.rows)

        def unit(real):
            def forced(cfg, params, x, **kw):
                i = next(units)
                x_in, x_out = (r[:, j:j + 1] for r in self.rows[i])
                out = real(cfg, params, x_in, **kw)
                self.errs[i] = max(self.errs[i], _rel(torch, out[0], x_out))
                return out
            return forced

        def router(real):
            def pinned(cfg, params, x):
                idx = next(experts)[:, j:j + 1]
                w = torch.softmax(x.float() @ params["router"], dim=-1).gather(-1, idx)
                return (w / w.sum(-1, keepdim=True)).to(x.dtype), idx, real(cfg, params, x)[2]
            return pinned

        return self._patched(unit, router)


def phase_lm_decode(torch, cfg, params, batch, phase: str, reduced=()) -> dict:
    """The serving steps on a full-width LM (`models/model.py::prefill_step`,
    `decode_step`): `_prefill_and_decode` over LM_BATCH seeded sequences (a vlm model's
    with its context embeddings), the prefill's last logits and each step's
    held to the kernel path's full forward over all prompt + DECODE_STEPS
    tokens at the same positions within DECODE_RTOL (a MoE at no-drop
    capacity throughout); each unit of the stack in the same 32 steps,
    teacher-forced, within UNIT_RTOL (`UnitTap`); and layer 0's rows that
    decode wrote to the rows a prefill of all the tokens writes."""
    from repro_torch.models import model as M

    cfg = _no_drop(cfg)
    arch = cfg.name
    prompt = DECODE_PROMPT.get(arch, LM_SEQ - DECODE_STEPS)
    if arch in DECODE_PROMPT:
        reduced = [*reduced, f"prompt {LM_SEQ - DECODE_STEPS} -> {prompt} tokens (the no-drop "
                             "full forward it is held to does not fit beside the weights)"]
    total = prompt + DECODE_STEPS
    tokens = batch["tokens"][:, :total]
    ctx_embed = batch.get("ctx_embed")
    B = tokens.shape[0]
    spread = {}
    with torch.inference_mode():
        # the prefill's last position and the DECODE_STEPS decoded ones
        want = _logits_from(cfg, params, tokens, ctx_embed, prompt - 1)
        # the full forward's own spread (DECODE_RTOL)
        alone = torch.cat([_logits_from(cfg, params, tokens[i:i + 1],
                                  None if ctx_embed is None else ctx_embed[i:i + 1],
                                  prompt - 1) for i in range(B)])
        spread["sequences_one_at_a_time"] = _rel(torch, alone, want)
        del alone
        plain = _logits_from(cfg.replace(attn_impl="plain"), params, tokens, ctx_embed,
                             prompt - 1)
        spread["plain_path"] = _rel(torch, plain, want)
        del plain
        f32 = cfg.act_dtype == "float32"
        bound = max(DECODE_F32_RTOL if f32 else DECODE_RTOL, 2.0 * max(spread.values()))
        run = _prefill_and_decode(torch, cfg, params, tokens, ctx_embed, prompt, phase,
                                  keep_prefill=True)
        prefill_err = _rel(torch, run["last"], want[:, 0])
        errs = [_rel(torch, run["logits"][:, j], want[:, 1 + j]) for j in range(DECODE_STEPS)]
        tap = UnitTap(torch, prompt, total)
        with tap.recording():
            _, full = M.prefill_step(cfg, params, tokens, ctx_embed=ctx_embed, cache_len=total)
        rows = _layer0_rows(torch, run["cache"], full, prompt, total)
        # the teacher-forced steps read the full forward's own attention
        # rows (a chaotic model's prefill of the prompt alone rounds them
        # otherwise, deep layers by O(1)) and the prompt's SSM windows and
        # states; each step writes its row before it reads it
        forced, prompt_cache = full, _leaves(run.pop("prefill_cache"))
        for path, t in _leaves(forced).items():
            if "/ssm/" in path:
                t.copy_(prompt_cache[path])
        del prompt_cache
        for j in range(DECODE_STEPS):
            with tap.forcing(j):
                M.decode_step(cfg, params, forced, tokens[:, prompt + j:prompt + j + 1],
                              prompt + j)
        unit_bound = UNIT_RTOL[cfg.act_dtype]
        worst = max(range(len(tap.errs)), key=tap.errs.__getitem__)
    finite = bool(torch.isfinite(run["logits"]).all())
    emit(phase, arch=arch, reduced=list(reduced), layers=cfg.n_layers,
         capacity_factor=cfg.capacity_factor if cfg.n_experts else None,
         **run["fields"], prefill_last_logits_rel_err=prefill_err,
         logits_rel_err_max=max(errs), logits_rel_err_by_step=errs,
         full_forward_spread=spread, bound=bound,
         units_teacher_forced={"units": len(tap.errs), "rel_err_max": tap.errs[worst],
                               "worst_unit": worst, "bound": unit_bound,
                               "rel_err_by_unit": tap.errs},
         layer0_rows=rows)
    if not finite or not max(errs + [prefill_err]) <= bound:
        raise AssertionError(f"{phase}: prefill {prefill_err:.3g} and decode logits "
                             f"{max(errs):.3g} vs the full forward, bound {bound} "
                             f"(finite {finite})")
    if not tap.errs[worst] <= unit_bound:
        raise AssertionError(f"{phase}: unit {worst} of a teacher-forced decode step vs the "
                             f"full forward: {tap.errs[worst]:.3g} > {unit_bound}")
    bad = {k: v for k, v in rows.items() if not v["rel_err"] <= v["bound"]}
    if bad:
        raise AssertionError(f"{phase}: layer 0's decode-written cache rows vs a prefill: {bad}")
    launches = run["launches"]
    del run, full
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


def phase_decode_f32_path(torch) -> dict:
    """The sharpest check of the decode logic at full width: each family's
    config in float32 (parameters and activations; TF32 off, as the script
    sets it; depth cut as F32_DECODE_PATHS says), one `phase_lm_decode`
    each: every teacher-forced unit within UNIT_RTOL["float32"], the logits
    within DECODE_F32_RTOL of the largest (qwen3-0.6b, mamba2-1.3b) or
    twice the chaotic forward's own spread. Their prefills run the float32
    flash kernel and the SSD kernel. -> the launches by phase."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    dev = torch.device("cuda", 0)
    launches = {}
    for arch, n_layers in F32_DECODE_PATHS:
        full = get_config(arch)
        cfg = full.replace(param_dtype="float32", act_dtype="float32",
                           n_layers=n_layers or full.n_layers)
        params = M.init_params(cfg, _generator(torch, dev, 0))
        batch = M.make_synth_batch(cfg, LM_BATCH, LM_SEQ, _generator(torch, dev, 1))
        reduced = ["param_dtype, act_dtype bfloat16 -> float32"]
        if n_layers:
            reduced.append(f"n_layers {full.n_layers} -> {n_layers} (widths kept)")
        phase = f"decode_f32_{LM_PHASE[arch]}"
        launches[phase] = phase_lm_decode(torch, cfg, params, batch, phase, reduced)["launches"]
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_serving_batch(torch, model) -> dict:
    """qwen3-0.6b's decode step at the grid wave's 82 sequences: a prefill
    of 82 seeded prompts of LM_SEQ - DECODE_STEPS tokens at cache_len LM_SEQ
    (28 flash launches; the KV cache 19.3 GB), then DECODE_STEPS timed
    steps, DECODE_PROFILED of them under the profiler for the busy share.
    Held: the launches, finite logits, and the peak memory under
    SERVING_PEAK_CACHES x the cache: the prefill's per-layer caches and
    their stacked copy, no third copy (a functional cache update in decode
    would be one)."""
    from repro_torch.models import model as M

    dev = torch.device("cuda", 0)
    batch = M.make_synth_batch(model.cfg, SERVING_BATCH, LM_SEQ, _generator(torch, dev, 7))
    prompt = LM_SEQ - DECODE_STEPS
    with torch.inference_mode():
        run = _prefill_and_decode(torch, model.cfg, model.params, batch["tokens"], None,
                                  prompt, "dense_lm_serving_batch")
    finite = bool(torch.isfinite(run["logits"]).all())
    peak = run["fields"]["max_memory_allocated"]
    emit("dense_lm_serving_batch", arch=model.cfg.name, **run["fields"], finite=finite)
    caches = peak / run["fields"]["cache_bytes"]
    if not finite or not caches < SERVING_PEAK_CACHES:
        raise AssertionError(f"serving batch: finite {finite}, peak {peak} B = {caches:.3g} "
                             f"caches (bound {SERVING_PEAK_CACHES})")
    launches = run["launches"]
    del run, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


# -- the LM zoo's training ------------------------------------------------------


def flash_bwd_work(B: int, nq: int, nkv: int, Sq: int, Sk: int, hd: int, causal: bool,
                   elem: int, hd_v: int | None = None) -> dict:
    """Bytes the flash backward must move (q, k, v, o and dO read once,
    the log-sum-exp read once, dq, dk and dv written once) and its float
    operations: the gradient's five products (S = q k^T, dV, dP, dK, dQ),
    2.5 times the forward's two (`flash_work`), over the pairs the mask
    keeps."""
    hd_v = hd if hd_v is None else hd_v
    fwd = flash_work(B, nq, nkv, Sq, Sk, hd, causal, elem, hd_v)
    q_side = B * nq * Sq * (2 * hd + 2 * hd_v)  # q, dq; o, dO
    kv_side = 2 * B * nkv * Sk * (hd + hd_v)  # k, v; dk, dv
    return {"bytes": elem * (q_side + kv_side) + 4 * B * nq * Sq, "flops": 2.5 * fwd["flops"]}


#: the backward cases whose two calls on the same inputs must agree bit for
#: bit in `flash_bwd_vs_plain` (`train_path`'s shape; qwen3-0.6b's heads in
#: float32)
BWD_REPEAT_CASES = ("qwen3-0.6b_train", "float32_hd128")


#: each backward kernel, by its launch counter, by its symbol in a trace
#: (bf16 flash_attention_bwd_wgmma.cu, float32 flash_attention_bwd_3xbf16.cu)
BWD_TRACE = {"flash_attention_bwd_wgmma_stats": "bwd_stats_kernel",
             "flash_attention_bwd_wgmma_dkdv": "dkdv_wgmma_kernel",
             "flash_attention_bwd_wgmma_dq": "dq_wgmma_kernel",
             "flash_attention_bwd_3xbf16_split": "bwd_split_kernel",
             "flash_attention_bwd_3xbf16_dkdv": "dkdv_3xbf16_kernel",
             "flash_attention_bwd_3xbf16_dq": "dq_3xbf16_kernel"}
#: cycles of the spin kernel ahead of a profiled backward window (~0.1 s at
#: H100 clocks), and the one-element adds launched behind it
BWD_TRACE_SPIN, BWD_TRACE_PAD = 200_000_000, 256


def _bwd_kernel_ms(torch, call, stem: str, calls: int) -> tuple:
    """Device ms of each of the backward's three kernels (library `stem`)
    in one call, from a torch.profiler trace: behind a spin kernel (so that
    all runs back to back on the device) `BWD_TRACE_PAD` one-element adds,
    then 2 x `calls` calls of `call`, a whole backward; each kernel's mean
    duration over its last `calls` records in the trace (matched by
    `BWD_TRACE`). Late in a run a short session's trace lost its first
    records (the spin and the first 8-9 of 20 calls; a session of 3 calls,
    all of them), hence the adds and the untimed calls ahead. -> ({kernel:
    ms, or None where the trace held no record of it}, {kernel: records
    averaged})."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops

    names = ops.BWD_KERNELS[stem]
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(BWD_TRACE_SPIN)
        for _ in range(BWD_TRACE_PAD):
            pad.add_(1.0)
        for _ in range(2 * calls):
            call()
        torch.cuda.synchronize()
    trace = ROOT / "build" / "chip_smoke_bwd_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    records = {k: [] for k in names}
    for ev in json.loads(trace.read_text()).get("traceEvents", []):
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            mine = [k for k in names if BWD_TRACE[k] in ev.get("name", "")]
            if mine:
                records[mine[0]].append((float(ev["ts"]), float(ev.get("dur", 0.0))))
    trace.unlink()
    if any(len(r) > 2 * calls for r in records.values()):
        raise AssertionError(f"{stem}: {2 * calls} calls traced "
                             f"{ {k: len(r) for k, r in records.items()} } of its kernels")
    last = {k: sorted(r)[-calls:] for k, r in records.items()}
    return ({k: sum(d for _, d in r) / len(r) / 1e3 if r else None for k, r in last.items()},
            {k: len(r) for k, r in last.items()})


def phase_flash_bwd_vs_plain(torch, dev, smi: str) -> dict:
    """The flash backward kernels (three a call: bf16
    `csrc/flash_attention_bwd_wgmma.cu`, float32
    `csrc/flash_attention_bwd_3xbf16.cu`)
    at every `testing.BWD_CASES` shape, at the model layout:
    `testing.check_bwd` (the forward with its log-sum-exp, within LSE_ATOL
    of the plain forward's; then dq, dk and dv against the plain backward
    run from the plain forward's own o and log-sum-exp, within BWD_RTOL of
    each gradient's largest element: 2e-2 bf16, 1e-4 float32),
    each kernel of the dtype's library launched once and no other; at each
    of BWD_REPEAT_CASES two more calls on the same inputs, bit for bit; then each
    case's backward timed (one CUDA event pair around back-to-back calls,
    `_device_ms`), and each of its kernels from a trace (`_bwd_kernel_ms`), beside its
    bound (the five products at the tensor cores' bf16 peak, 3x that for
    float32 in 3xBF16, or the bytes), the plain backward's time and the
    backward of `F.scaled_dot_product_attention` at the same shape, native
    widths and scale (for comparison only: the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
    from repro_torch.kernels.flash_attention import testing as T

    shapes = []
    repeat = {}
    for i, (name, zoo) in enumerate(T.BWD_CASES.items()):
        B, nq, nkv, Sq, Sk, hd, causal, dt = zoo.case
        q, k, v, do = T.bwd_inputs(zoo, dev, seed=300 + i)
        stem = ops.bwd_stem(q.dtype)
        before = dict(flash_attention_bwd.launches_by_kernel)
        errors = T.check_bwd(q, k, v, do, causal, zoo.scale, name)
        torch.cuda.synchronize()
        launched = {kk: n - before[kk] for kk, n in flash_attention_bwd.launches_by_kernel.items()}
        if launched != {kk: int(kk in ops.BWD_KERNELS[stem]) for kk in before}:
            raise AssertionError(f"{name}: the backward launched {launched}")
        o, lse = ops._forward(q, k, v, causal, zoo.scale, want_lse=True)
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal,  # noqa: E731
                                           scale=zoo.scale)
        if name in BWD_REPEAT_CASES:
            first, second = call(), call()
            repeat[name] = {g: bool(torch.equal(a, b))
                            for g, a, b in zip(("dq", "dk", "dv"), first, second)}
            del first, second
            if not all(repeat[name].values()):
                raise AssertionError(f"{name}: two backward calls differ: {repeat[name]}")
        big = B * nq * Sq * Sk * hd > 2e11
        ms = _device_ms(torch, call, calls=5 if big else 20, windows=3)
        kernel_ms, kernel_records = _bwd_kernel_ms(torch, call, stem, calls=5 if big else 20)
        plain_ms = _device_ms(torch, lambda: T.plain_bwd(q, k, v, o, lse, do, causal, zoo.scale),
                              calls=1, windows=3)
        dqk, dv = zoo.widths or (hd, hd)
        qs, ks, vs = (t[..., :w].detach().requires_grad_()
                      for t, w in ((q, dqk), (k, dqk), (v, dv)))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True,
                                             scale=zoo.scale)
        do_n = do[..., :dv]
        library_ms = _device_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), do_n,
                                                                   retain_graph=True),
                                calls=5 if big else 20, windows=3)
        work = flash_bwd_work(B, nq, nkv, Sq, Sk, dqk, causal, q.element_size(), hd_v=dv)
        t_bytes = work["bytes"] / HBM_BYTES_PER_S
        # the kernel's products: bf16 on the tensor cores; float32 as 3xBF16
        t_ops = work["flops"] / BF16_FLOPS * (1 if dt == "bfloat16" else 3)
        entry = {"case": name, "shape": [B, nq, nkv, Sq, hd], "sk": Sk, "causal": causal,
                 "dtype": dt, "scale": zoo.scale, "widths": [dqk, dv], "library": stem,
                 "launches": {kk: n for kk, n in launched.items() if n},
                 "ms": ms, "kernel_ms": kernel_ms, "kernel_records": kernel_records,
                 "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "bytes_ms": t_bytes * 1e3, "tc_ops_ms": t_ops * 1e3,
                 "share_of_bound": max(t_bytes, t_ops) * 1e3 / ms,
                 "kernel_flops": flash_bwd_work(B, nq, nkv, Sq, Sk, hd, causal, 2)["flops"],
                 **work, **errors}
        if dt == "float32":
            t_fp32 = work["flops"] / FP32_FLOPS
            entry["fp32_cuda_core_bound_ms"] = max(t_bytes, t_fp32) * 1e3
        shapes.append(entry)
        del q, k, v, do, o, lse, qs, ks, vs, out, do_n
        torch.cuda.empty_cache()
    worst = {dt: max((max(e[g]["rel"] for g in ("dq", "dk", "dv")) for e in shapes
                      if e["dtype"] == dt), default=None) for dt in T.BWD_RTOL}
    lse_worst = {dt: max((e["lse_max_abs_err"] for e in shapes if e["dtype"] == dt),
                         default=None) for dt in T.BWD_RTOL}
    emit("flash_bwd_vs_plain", kernel="flash_attention_bwd",
         kernels={str(dt).removeprefix("torch."): ops.BWD_KERNELS[stem]
                  for dt, stem in ops.BWD_KERNEL_OF.items()},
         repeat_cases=BWD_REPEAT_CASES, repeat_bit_for_bit=repeat,
         bound="each of dq, dk, dv: max abs error <= 2e-2 (bf16) / 1e-4 (float32) of its "
               "largest element, against attention_bwd_ref run from the plain forward's own "
               "o and log-sum-exp; the forward kernel's log-sum-exp within "
               f"{T.LSE_ATOL} of the plain one",
         lse_max_abs_err_by_dtype=lse_worst,
         timer="one CUDA event pair around back-to-back backward calls (5 at the largest "
               "shapes, 20 otherwise; plain: 1), per call, median of 3 windows; each "
               "kernel (kernel_ms): its mean device time over its last as many records "
               "(kernel_records) in a torch.profiler trace of twice as many calls",
         work_bound="max(bytes at 3.35 TB/s, the five products (2.5 x the forward's flops) "
                    "at 989 TFLOP/s bf16; float32 3 x that: 3xBF16 on wgmma)",
         library="torch.autograd.grad of F.scaled_dot_product_attention(q, k, v, "
                 "is_causal=causal, enable_gqa=True, scale=scale) at the native widths",
         max_rel_err_by_dtype=worst, shapes=shapes, card=smi)
    if set(repeat) != set(BWD_REPEAT_CASES):
        raise AssertionError(f"BWD_CASES lacks one of {BWD_REPEAT_CASES}: repeated {repeat}")
    return {"shapes": shapes, "worst": worst, "lse_worst": lse_worst, "repeat": repeat}


#: the training path: qwen3-0.6b at full width and depth, bf16, as published
#: (remat "full", loss_chunk 0), B = 4 sequences of SHAPES["train_4k"]'s
#: 4,096 tokens (its global batch of 256 cut to fit one card), TRAIN_STEPS
#: steps, a checkpoint every TRAIN_CKPT_EVERY, one StepFailure injected at
#: TRAIN_FAIL_STEP (retried) and one NaN loss at TRAIN_NAN_STEP (restored
#: from step TRAIN_CKPT_EVERY - 1 and replayed)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_CKPT_EVERY = 8, 4, 4
TRAIN_FAIL_STEP, TRAIN_NAN_STEP = 2, 5
#: bound on each attention call's dq, dk and dv in a training step against
#: the plain backward on the same saved tensors (relative to the largest
#: element): UnitTap's 2^-5, four bf16 ulps
TRAIN_IN_SITU_RTOL = 2.0 ** -5
#: the float32 training step: qwen3-0.6b's widths, TRAIN_F32_LAYERS layers,
#: each gradient leaf on the kernel path within TRAIN_F32_RTOL of the leaf's
#: largest element of the same step on the plain path
TRAIN_F32_LAYERS, TRAIN_F32_RTOL = 4, 1e-3


#: each kernel of a training step by its name in a trace (the backward's
#: three by their symbols in flash_attention_bwd_wgmma.cu, `BWD_TRACE`)
TRAIN_TRACE = {"flash_attention_wgmma": "flash_attention_wgmma_kernel",
               **{k: BWD_TRACE[k] for k in ("flash_attention_bwd_wgmma_stats",
                                            "flash_attention_bwd_wgmma_dkdv",
                                            "flash_attention_bwd_wgmma_dq")}}


def _train_step_profile(torch, step, per_step: dict) -> dict:
    """`step()`, one training step, under torch.profiler: the device time
    of each of its hand-written kernels (held to `per_step` launches in the
    trace), of the cuBLAS GEMMs and of everything else (the glue: norms,
    rope, SwiGLU, the loss over the logits, AdamW, casts), each as a share
    of the step's profiled wall, and the busy and idle shares."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad_trace(torch)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = ROOT / "build" / "chip_smoke_train_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    busy = {**dict.fromkeys(per_step, 0.0), "gemm": 0.0, "other": 0.0, "memcpy_memset": 0.0}
    in_trace = dict.fromkeys(per_step, 0)
    by_name: dict[str, list] = {}
    for ev in json.loads(trace.read_text()).get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name, dur = ev.get("cat"), ev.get("name", ""), float(ev.get("dur", 0.0))
        if TRACE_PAD_NAME in name:
            continue
        if cat in ("gpu_memcpy", "gpu_memset"):
            busy["memcpy_memset"] += dur
        elif cat == "kernel":
            mine = [k for k in per_step if TRAIN_TRACE[k] in name]
            if mine:
                busy[mine[0]] += dur
                in_trace[mine[0]] += 1
            elif any(k in name.lower() for k in ("gemm", "cutlass", "xmma", "nvjet")):
                busy["gemm"] += dur
            else:
                busy["other"] += dur
            entry = by_name.setdefault(name[:90], [0, 0.0])
            entry[0] += 1
            entry[1] += dur
    trace.unlink()
    if in_trace != per_step:
        raise AssertionError(f"the training step's trace holds {in_trace} launches, expected "
                             f"{per_step}")
    device_us = sum(busy.values())
    return {"profiled_wall_ms": wall_us / 1e3, "device_busy_ms": device_us / 1e3,
            "device_kernels": sum(n for n, _ in by_name.values()),
            "launches_in_trace": in_trace, "busy_ms": {k: v / 1e3 for k, v in busy.items()},
            "share_of_wall": {k: v / wall_us for k, v in busy.items()},
            "device_busy_share": device_us / wall_us,
            "device_idle_share": 1.0 - device_us / wall_us,
            "top_kernels": [{"name": k, "launches": n, "ms": us / 1e3} for k, (n, us) in
                            sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]]}


def phase_train_path(torch, dev, smi: str) -> dict:
    """The training path through `repro_torch.launch.train.train`, the
    entry point a user calls: qwen3-0.6b at full width and depth in bf16
    (see TRAIN_STEPS), into a temporary checkpoint directory. Held: every
    loss finite, the last below the first; the fault loop retried once and
    restored once; the first replayed step's loss equals the first
    attempt's bit for bit (same parameters, same batch, no atomics in any
    kernel of the step); the launches exactly the step executions'
    (forward kernel 2 x 28 a step, forward and recompute; each backward
    kernel 28). Measured: step ms (median of the unfaulted steps after the
    first), tokens/s, peak memory, the checkpoints' seconds on the train
    thread, and one more step under the profiler (`_train_step_profile`:
    device time by kernel, GEMMs and glue; busy share). Then one more step
    under `testing.backward_tap`: every attention call's log-sum-exp held
    to the plain forward's (LSE_ATOL) and its dq, dk and dv to the plain
    backward from its saved q, k, v (TRAIN_IN_SITU_RTOL)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import testing as T
    from repro_torch.launch import train as L
    from repro_torch.types import SHAPES, TrainConfig

    cfg = get_config(DENSE_ARCH)
    if (cfg.remat, cfg.loss_chunk, cfg.attn_impl, cfg.act_dtype) != (
            "full", 0, "kernel", "bfloat16"):
        raise AssertionError(f"{cfg.name} is not as published: {cfg}")
    S, B = SHAPES["train_4k"].seq_len, TRAIN_BATCH
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS,
                     checkpoint_every=TRAIN_CKPT_EVERY, keep_checkpoints=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as ckpt_dir:
        reset_launches()
        t0 = time.perf_counter()
        params, opt, hist = L.train(cfg, tc, TRAIN_STEPS, B, S, ckpt_dir,
                                    inject_fail=(TRAIN_FAIL_STEP,), inject_nan=(TRAIN_NAN_STEP,),
                                    log_every=1, device=dev, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    attempts = [e for e in log if "action" in e]
    runs = [e for e in attempts if e["action"] in ("ok", "restore")]  # a step executed
    per_step = {"flash_attention_wgmma": 2 * cfg.n_layers,
                **dict.fromkeys(ops.BWD_KERNELS[ops.bwd_stem(torch.bfloat16)], cfg.n_layers)}
    want = dict.fromkeys(counts, 0)
    want.update({k: n * len(runs) for k, n in per_step.items()})
    losses = [l for _, l in hist]
    ok = [e for e in attempts if e["action"] == "ok"]
    first_four = [e["loss"] for e in ok if e["step"] == TRAIN_CKPT_EVERY]
    actions = [e["action"] for e in attempts]
    problems = []
    if counts != want:
        problems.append(f"launches {counts}, expected {len(runs)} steps' {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}")
    if actions.count("retry") != 1 or actions.count("restore") != 1:
        problems.append(f"fault actions {actions}")
    if len(first_four) != 2 or first_four[0] != first_four[1]:
        problems.append(f"step {TRAIN_CKPT_EVERY}'s first attempt and replay: {first_four}")
    step_s = [e["wall_s"] for e in ok[1:]]
    step_ms = statistics.median(step_s) * 1e3

    data = SyntheticLMData(cfg, B, S, seed=tc.seed, device=dev)
    batch = data.batch(TRAIN_STEPS)
    step_fn = L.build_train_step(cfg, tc)
    profile = _train_step_profile(torch, lambda: step_fn(params, opt, batch), per_step)

    with T.backward_tap(rtol=TRAIN_IN_SITU_RTOL) as seen:
        step_fn(params, opt, data.batch(TRAIN_STEPS + 1))
        torch.cuda.synchronize()
    failed = [e["error"] for e in seen if "error" in e]
    in_situ = max((max(e[g]["rel"] for g in ("dq", "dk", "dv")) for e in seen
                   if "error" not in e), default=float("inf"))
    in_situ_lse = max((e["lse_max_abs_err"] for e in seen if "error" not in e),
                      default=float("inf"))
    if len(seen) != cfg.n_layers or failed:
        problems.append(f"in situ: {len(seen)} attention backwards (expected "
                        f"{cfg.n_layers}), {len(failed)} past a bound: {failed[:2]}")
    checkpoints = [e for e in log if "checkpoint" in e]
    fields = dict(
        arch=cfg.name, batch=B, seq=S, steps=TRAIN_STEPS, remat=cfg.remat,
        loss_chunk=cfg.loss_chunk, attn_impl=cfg.attn_impl, dtype=cfg.act_dtype,
        reduced=[f"global_batch {SHAPES['train_4k'].global_batch} -> {B} (one card)"],
        train_config={"lr": tc.lr, "warmup_steps": tc.warmup_steps,
                      "checkpoint_every": tc.checkpoint_every,
                      "opt_state_dtype": tc.opt_state_dtype},
        injected={"step_failure": TRAIN_FAIL_STEP, "nan": TRAIN_NAN_STEP},
        wall_s=wall, step_ms_median=step_ms, step_ms_min=min(step_s) * 1e3,
        step_ms_max=max(step_s) * 1e3, tokens_per_s=B * S / (step_ms / 1e3),
        max_memory_allocated=peak, step_executions=len(runs),
        launches=counts, launches_per_step=per_step,
        losses=[[s, l] for s, l in hist], attempts=attempts,
        replayed_step_loss=first_four, checkpoint_s=[e["s"] for e in checkpoints],
        checkpoint_s_total=sum(e["s"] for e in checkpoints),
        step_device_busy_share=profile["device_busy_share"], step_profile=profile,
        in_situ_calls=len(seen), in_situ_max_rel_err=in_situ,
        in_situ_bound=TRAIN_IN_SITU_RTOL, in_situ_lse_max_abs_err=in_situ_lse,
        in_situ_lse_bound=T.LSE_ATOL, card=smi)
    emit("train_path", **fields)
    if problems:
        raise AssertionError("train_path: " + "; ".join(problems))
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: v for k, v in counts.items() if v}, "per_step": per_step,
            "step_ms": step_ms, "in_situ": in_situ, "in_situ_lse": in_situ_lse,
            "hist": hist, "attempts": [(e["step"], e["action"]) for e in attempts]}


#: `train_mesh_path`: the first TRAIN_MESH_STEPS steps of train_path's
#: schedule (the failure at TRAIN_FAIL_STEP retried, the NaN at
#: TRAIN_NAN_STEP restored from step TRAIN_CKPT_EVERY - 1 and replayed)
TRAIN_MESH_STEPS = 6


def phase_train_mesh_path(torch, dev, smi: str, train: dict) -> dict:
    """train_path's training through `launch.train.train(..., ctx=)` on a
    1x1 NCCL mesh in this process (`launch.mesh.make_mesh`): qwen3-0.6b at
    full width and depth in bf16, B x S as train_path, the parameters,
    moments and batches as DTensors, the first TRAIN_MESH_STEPS steps of
    train_path's schedule. Held: the losses and fault actions == train_path's
    bit for bit (every DTensor op on a 1x1 mesh runs the one-device op); the
    launches exactly the step executions' (56 forward, 28 of each backward
    kernel a step); its last checkpoint (assembled from the DTensors and
    written by rank 0) restored without a mesh == the mesh's final weights
    and moments leaf for leaf bit for bit. Measured: step ms (median of the
    unfaulted steps after the first), peak memory, the checkpoints'
    seconds on the train thread."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import train as L
    from repro_torch.launch.mesh import destroy_ranks, make_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.types import SHAPES, TrainConfig

    cfg = get_config(DENSE_ARCH)
    S, B = SHAPES["train_4k"].seq_len, TRAIN_BATCH
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS,
                     checkpoint_every=TRAIN_CKPT_EVERY, keep_checkpoints=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    log = []
    ctx = ShardingCtx(make_mesh((1, 1), ("data", "model"), backend="nccl"))
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_mesh_") as ckpt_dir:
            reset_launches()
            t0 = time.perf_counter()
            params, opt, hist = L.train(cfg, tc, TRAIN_MESH_STEPS, B, S, ckpt_dir,
                                        inject_fail=(TRAIN_FAIL_STEP,),
                                        inject_nan=(TRAIN_NAN_STEP,), log_every=1, device=dev,
                                        log=log, ctx=ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            peak = torch.cuda.max_memory_allocated()
            mesh_leaves = tree_leaves((params, opt))
            # every leaf a DTensor but the step counter (a plain tensor, as adamw_init makes it)
            plain = [i for i, t in enumerate(mesh_leaves) if type(t).__name__ != "DTensor"]
            t0 = time.perf_counter()
            restored, step = CheckpointManager(ckpt_dir).restore((params, opt), device=dev)
            differ = [i for i, (t, r) in enumerate(zip(mesh_leaves, tree_leaves(restored)))
                      if type(r).__name__ == "DTensor" or not torch.equal(
                          t.to_local() if type(t).__name__ == "DTensor" else t, r)]
            restore_s = time.perf_counter() - t0
    finally:
        destroy_ranks()
    del params, opt, restored, mesh_leaves
    gc.collect()
    torch.cuda.empty_cache()
    attempts = [e for e in log if "action" in e]
    runs = [e for e in attempts if e["action"] in ("ok", "restore")]  # a step executed
    want = dict.fromkeys(counts, 0)
    want.update({k: n * len(runs) for k, n in train["per_step"].items()})
    ok = [e for e in attempts if e["action"] == "ok"]
    step_s = [e["wall_s"] for e in ok[1:]]
    step_ms = statistics.median(step_s) * 1e3
    checkpoints = [e for e in log if "checkpoint" in e]
    same = bool(hist) and hist == train["hist"][:len(hist)]
    problems = []
    if not same:
        problems.append(f"losses {hist}, train_path's {train['hist'][:len(hist)]}")
    if [(e["step"], e["action"]) for e in attempts] != train["attempts"][:len(attempts)]:
        problems.append(f"fault actions {[(e['step'], e['action']) for e in attempts]}")
    if counts != want:
        problems.append(f"launches {counts}, expected {len(runs)} steps' {want}")
    if len(plain) != 1:
        problems.append(f"leaves {plain} of the state are not DTensors")
    if step != TRAIN_MESH_STEPS - 1 or differ:
        problems.append(f"the checkpoint of step {step} restored without a mesh: leaves "
                        f"{differ} differ from the mesh's")
    emit("train_mesh_path", arch=cfg.name, mesh=[1, 1], backend="nccl", batch=B, seq=S,
         steps=TRAIN_MESH_STEPS, schedule="train_path's first steps",
         injected={"step_failure": TRAIN_FAIL_STEP, "nan": TRAIN_NAN_STEP},
         losses=[[s, l] for s, l in hist], losses_equal_train_path=same,
         step_executions=len(runs), launches=counts, launches_per_step=train["per_step"],
         step_ms_median=step_ms, step_ms_min=min(step_s) * 1e3, step_ms_max=max(step_s) * 1e3,
         train_path_step_ms=train["step_ms"], tokens_per_s=B * S / (step_ms / 1e3),
         max_memory_allocated=peak, plain_leaves=plain, checkpoint_step=step,
         checkpoint_leaves_bit_for_bit=not differ, checkpoint_restore_s=restore_s,
         checkpoint_s=[e["s"] for e in checkpoints], train_wall_s=wall,
         wall_s=time.perf_counter() - t_phase, card=smi)
    if problems:
        raise AssertionError("train_mesh_path: " + "; ".join(problems))
    return {"launches": {k: v for k, v in counts.items() if v}, "step_ms": step_ms,
            "wall_s": time.perf_counter() - t_phase}


def phase_train_f32_path(torch, dev) -> dict:
    """One training step of qwen3-0.6b in float32 (its widths,
    TRAIN_F32_LAYERS layers, LM_BATCH x LM_SEQ tokens of the synthetic
    data): the gradient on the kernel path (`flash_attention.cu`, then the
    backward kernel) against the same gradient on the plain path on the
    same card, each leaf within TRAIN_F32_RTOL of its largest element; the
    launches exactly one step's (forward kernel 2 a layer, each backward
    kernel 1); then `train_step` itself on the kernel path (finite)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init, tree_leaves_with_path, tree_leaves
    from repro_torch.types import TrainConfig

    full = get_config(DENSE_ARCH)
    cfg = full.replace(param_dtype="float32", act_dtype="float32", n_layers=TRAIN_F32_LAYERS)
    params = M.init_params(cfg, _generator(torch, dev, 0))
    batch = SyntheticLMData(cfg, LM_BATCH, LM_SEQ, seed=0, device=dev).batch(0)
    reset_launches()
    loss_k, _, grads_k = M.loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    counts = read_launches()
    want = dict.fromkeys(counts, 0)
    want.update({"flash_attention": 2 * cfg.n_layers,
                 **dict.fromkeys(ops.BWD_KERNELS[ops.bwd_stem(torch.float32)], cfg.n_layers)})
    loss_p, _, grads_p = M.loss_and_grads(cfg.replace(attn_impl="plain"), params, batch)
    errs = {}
    for (path, g), w in zip(tree_leaves_with_path(grads_k), tree_leaves(grads_p)):
        errs["/".join(map(str, path))] = float((g - w).abs().max() / w.abs().max())
    worst = max(errs.values())
    loss_err = abs(float(loss_k) / float(loss_p) - 1)
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    opt = adamw_init(params, tc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, opt, metrics = M.train_step(cfg, tc, params, opt, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    emit("train_f32_path", arch=cfg.name, layers=cfg.n_layers, batch=LM_BATCH, seq=LM_SEQ,
         reduced=["param_dtype, act_dtype bfloat16 -> float32",
                  f"n_layers {full.n_layers} -> {cfg.n_layers} (widths kept)"],
         launches=counts, loss_kernel=float(loss_k), loss_plain=float(loss_p),
         loss_rel_err=loss_err, grad_max_rel_err=worst, grad_rel_err_by_leaf=errs,
         bound=TRAIN_F32_RTOL, train_step_loss=loss, train_step_s=step_s)
    if counts != want or not worst <= TRAIN_F32_RTOL or not np.isfinite(loss):
        raise AssertionError(f"train_f32_path: launches {counts} (expected {want}), worst "
                             f"gradient leaf {worst:.3g} (bound {TRAIN_F32_RTOL}), loss {loss}")
    del params, opt, grads_k, grads_p, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: v for k, v in counts.items() if v}, "grad_max_rel_err": worst}


#: the LM derivative waves (`LMUQModel.gradient_batch` and friends) on the
#: qwen3-0.6b model of the dense path, LM_BATCH x LM_SEQ tokens a point:
#: a gradient wave of LM_GRAD_POINTS points through the fabric; its check
#: against the plain path at LM_GRAD_PLAIN_POINTS of them (the plain
#: attention's float32 [B, n, S, S] scores and their gradients, a layer at
#: a time under remat); the Hessian wave (reverse over reverse on the plain
#: attention, which keeps every layer's scores, probabilities and their
#: first gradients, and under remat every layer's recompute, for the second
#: backward) at LM_HESS_POINTS points of LM_HESS_SEQ tokens: at 1,024 tokens
#: it peaked at 65.2 GB on the card (NVIDIA H100 80GB HBM3, 700.00 W)
LM_GRAD_POINTS = 8
LM_GRAD_PLAIN_POINTS = 2
LM_HESS_POINTS = 2
LM_HESS_SEQ = 512
#: bound on the kernel path's gradient rows against the plain path's (the
#: largest error over the largest element): the two paths round the
#: residual stream to bf16 after every layer in another order (their NLLs
#: within LM_NLL_RTOL), and the backward adds the flash backward's bf16
#: products. Measured 1.5e-4 (NVIDIA H100 80GB HBM3, 700.00 W)
LM_GRAD_RTOL = 2e-3
#: apply_jacobian_batch against gradient . vec from the gradient wave (the
#: same reverse wave at sens = 1, the senss powers of two): float64 rounding
#: of a two-term dot product
LM_JAC_RTOL = 1e-6


def phase_dense_lm_gradient_path(torch, model, smi: str) -> dict:
    """The LM-as-UQ-model's derivative operations on qwen3-0.6b at full width
    and depth: one `gradient_batch` wave of LM_GRAD_POINTS points through
    `EvaluationFabric(ModelBackend(model))`: ONE forward of the stack
    (counted) and ONE reverse pass, launching exactly the bf16 flash forward
    2 x 28 times (forward and remat recompute) and each of the three
    backward kernels 28 times, no other kernel; the same wave under the
    profiler (busy share); `apply_jacobian_batch` == gradient . vec; the
    gradients of LM_GRAD_PLAIN_POINTS points against the plain path's
    (LM_GRAD_RTOL); one `apply_hessian_batch` wave, cut to LM_HESS_SEQ
    tokens, that launches no kernel at all (plain attention; reported: the
    asymmetry of H from e1 and e2 at one point)."""
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer

    cfg = model.cfg
    if (cfg.remat, cfg.attn_impl, cfg.act_dtype) != ("full", "kernel", "bfloat16"):
        raise AssertionError(f"{cfg.name} is not as published: {cfg}")
    K = LM_GRAD_POINTS
    thetas = np.array([[1.0 + 0.02 * i, 1.0 - 0.01 * i] for i in range(K)])
    # powers of two, of both signs: a gradient row over its sens is exact
    senss = np.array([[(-2.0) ** (i % 3 - 1)] for i in range(K)])
    per_wave = {"flash_attention_wgmma": 2 * cfg.n_layers,
                **dict.fromkeys(ops.BWD_KERNELS[ops.bwd_stem(torch.bfloat16)], cfg.n_layers)}
    forwards = []
    real_forward = transformer.forward

    def counted(*args, **kwargs):
        forwards.append(kwargs.get("mode"))
        return real_forward(*args, **kwargs)

    fabric = EvaluationFabric(ModelBackend(model))
    gc.collect()
    torch.cuda.empty_cache()
    # every launch count starts at 0 right before the path
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    transformer.forward = counted
    try:
        wall, grads = _timed(torch, lambda: fabric.gradient_batch(thetas, senss))
        tel = fabric.telemetry()
    finally:
        transformer.forward = real_forward
        fabric.shutdown()
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(counts, 0)
    want.update(per_wave)
    problems = []
    if counts != want:
        problems.append(f"launches {counts}, expected one wave's {want}")
    if forwards != ["train"]:
        problems.append(f"stack forwards in the wave: {forwards} (expected one)")
    if grads.shape != (K, 2) or not np.isfinite(grads).all():
        problems.append(f"gradients {grads.shape}, finite {np.isfinite(grads).all()}")
    # the same wave again, warm (the first also sets up the backward's
    # GEMMs), then under the profiler
    warm_s, _ = _timed(torch, lambda: model.gradient_batch(thetas, senss))
    busy = _device_busy(torch, lambda: model.gradient_batch(thetas, senss),
                        "the LM gradient wave")
    vecs = np.random.default_rng(5).standard_normal((K, 2))
    jac_s, jv = _timed(torch, lambda: model.apply_jacobian_batch(thetas, vecs))
    jv_want = np.sum(grads / senss * vecs, axis=1, keepdims=True)
    jac_err = float(np.abs(jv - jv_want).max() / np.abs(jv_want).max())
    if not jac_err <= LM_JAC_RTOL:
        problems.append(f"apply_jacobian_batch {jv.ravel()} vs gradient . vec "
                        f"{jv_want.ravel()}: {jac_err:.3g} > {LM_JAC_RTOL}")
    # the plain path on the same weights, LM_GRAD_PLAIN_POINTS points
    P = LM_GRAD_PLAIN_POINTS
    plain = copy.copy(model)
    plain.cfg = cfg.replace(attn_impl="plain")
    torch.cuda.reset_peak_memory_stats()
    plain_s, grads_plain = _timed(torch, lambda: plain.gradient_batch(thetas[:P], senss[:P]))
    plain_peak = torch.cuda.max_memory_allocated()
    grad_err = float(np.abs(grads[:P] - grads_plain).max() / np.abs(grads_plain).max())
    if not grad_err <= LM_GRAD_RTOL:
        problems.append(f"kernel path gradients {grads[:P].tolist()} vs plain "
                        f"{grads_plain.tolist()}: {grad_err:.3g} > {LM_GRAD_RTOL}")
    # the Hessian wave, cut to LM_HESS_SEQ tokens: e1 and e2 at one point
    hess_model = copy.copy(model)
    hess_model.batch = {k: v[:, :LM_HESS_SEQ] for k, v in model.batch.items()}
    h_thetas = np.ones((LM_HESS_POINTS, 2))
    h_senss = np.ones((LM_HESS_POINTS, 1))
    h_vecs = np.eye(2)[np.arange(LM_HESS_POINTS) % 2]
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    hess_s, hvp = _timed(torch, lambda: hess_model.apply_hessian_batch(h_thetas, h_senss,
                                                                       h_vecs))
    hess_counts = read_launches()
    hess_peak = torch.cuda.max_memory_allocated()
    if any(hess_counts.values()):
        problems.append(f"the Hessian wave launched {hess_counts} (no kernel has a second "
                        "derivative)")
    if hvp.shape != (LM_HESS_POINTS, 2) or not np.isfinite(hvp).all():
        problems.append(f"Hessian actions {hvp.tolist()}")
    asymmetry = float(abs(hvp[0, 1] - hvp[1, 0]) / np.abs(hvp).max())
    emit("dense_lm_gradient_path", arch=cfg.name, layers=cfg.n_layers, batch=LM_BATCH,
         seq=LM_SEQ, remat=cfg.remat, points=K, senss=senss.ravel().tolist(),
         wave_s=wall, warm_wave_s=warm_s, forwards_per_wave=len(forwards), launches=counts,
         launches_per_wave=per_wave, max_memory_allocated=peak,
         device_busy_share=busy["device_busy_s"] / busy["profiled_wall_s"],
         profiled=busy, backend=tel["backend"], gradients=grads.tolist(),
         plain={"points": P, "wave_s": plain_s, "max_memory_allocated": plain_peak,
                "gradients": grads_plain.tolist(), "rel_err": grad_err,
                "bound": LM_GRAD_RTOL},
         jacobian={"wave_s": jac_s, "rel_err_vs_gradient_dot_vec": jac_err,
                   "bound": LM_JAC_RTOL},
         hessian={"points": LM_HESS_POINTS, "seq": LM_HESS_SEQ, "attn_impl": "plain",
                  "reduced": [f"seq {LM_SEQ} -> {LM_HESS_SEQ} (a double backward through "
                              "plain attention keeps every layer's scores)"],
                  "wave_s": hess_s, "launches": hess_counts,
                  "max_memory_allocated": hess_peak, "hvp_e1_e2": hvp.tolist(),
                  "asymmetry": asymmetry},
         card=smi)
    if problems:
        raise AssertionError("dense_lm_gradient_path: " + "; ".join(problems))
    del plain, hess_model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: v for k, v in counts.items() if v}, "grad_rel_err": grad_err,
            "warm_wave_s": warm_s}


#: mamba2's gradient wave: points of LM_BATCH x LM_SEQ tokens on the plain
#: SSD (the SSD kernel has no backward yet, ROADMAP queue 2 item 13e)
SSM_GRAD_POINTS = 2


def phase_lm_gradient_plain_ssd(torch, model) -> dict:
    """One `gradient_batch` wave of SSM_GRAD_POINTS points of the full-width
    mamba2 model: its first derivatives take the plain SSD (as
    `launch/train.py` trains the family), so the wave launches no kernel at
    all; its gradients finite."""
    arch = model.cfg.name
    thetas = np.array([[1.0 + 0.02 * i, 1.0 - 0.01 * i] for i in range(SSM_GRAD_POINTS)])
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    wall, grads = _timed(torch, lambda: model.gradient_batch(thetas,
                                                             np.ones((len(thetas), 1))))
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    emit(f"{LM_PHASE[arch]}_gradient", arch=arch, layers=model.cfg.n_layers, batch=LM_BATCH,
         seq=LM_SEQ, points=len(thetas), route="attn_impl='plain' (the plain SSD)",
         wave_s=wall, launches=counts, max_memory_allocated=peak, gradients=grads.tolist())
    if any(counts.values()) or grads.shape != (len(thetas), 2) \
            or not np.isfinite(grads).all():
        raise AssertionError(f"{arch} gradient wave: launches {counts}, gradients {grads}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"wave_s": wall}


#: the serving driver's time to name its address (a fresh process: torch,
#: the card's context, the full-width model from its seed) and each
#: request's
SERVE_START_S = 300.0
SERVE_REQUEST_S = 120.0


def phase_serve_driver(torch, smi: str) -> dict:
    """The deployment driver as a user starts it: `python -m
    repro_torch.launch.serve --model lm --arch qwen3-0.6b --port 0` (full
    width, on the card) in a subprocess. Through `core/client.py::HTTPModel`:
    `/ModelInfo` lists all eight operations; one Evaluate and one Gradient
    round trip equal the same calls on the same model built in this process
    (`build_model`, the same seed), exactly in float64 JSON. Then the driver
    is stopped."""
    from repro_torch.core.client import HTTPModel
    from repro_torch.launch import serve

    argv = ["--model", "lm", "--arch", DENSE_ARCH, "--port", "0"]
    t0 = time.perf_counter()
    proc, url = serve.start(argv, SERVE_START_S)
    start_s = time.perf_counter() - t0
    try:
        remote = HTTPModel(url, f"lm-{DENSE_ARCH}", timeout=SERVE_REQUEST_S)
        caps = remote.capabilities().to_json()
        local = serve.build_model("lm", DENSE_ARCH, False)
        theta, sens = [[1.05, 0.95]], [1.0]
        t0 = time.perf_counter()
        value = remote(theta)
        evaluate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        grad = remote.gradient(0, 0, theta, sens)
        gradient_s = time.perf_counter() - t0
        want_value, want_grad = local(theta), local.gradient(0, 0, theta, sens)
        running = proc.poll() is None
    finally:
        code = serve.stop(proc)
    emit("serve_driver", command=["python", "-m", "repro_torch.launch.serve", *argv], url=url,
         start_s=start_s, model_info=caps, evaluate=value, evaluate_local=want_value,
         evaluate_s=evaluate_s, gradient=grad, gradient_local=want_grad,
         gradient_s=gradient_s, exit_code=code, card=smi)
    problems = []
    if caps != local.capabilities().to_json() or not all(caps.values()):
        problems.append(f"/ModelInfo {caps}")
    if value != want_value or grad != want_grad:
        problems.append(f"over the wire {value}, {grad}; in process {want_value}, {want_grad}")
    if not running:
        problems.append("the driver exited while serving")
    if problems:
        raise AssertionError("serve_driver: " + "; ".join(problems))
    del local
    gc.collect()
    torch.cuda.empty_cache()
    return {"start_s": start_s}


#: the port's examples as a user runs them (on the card by default), each
#: with its arguments; torch_train_lm.py cut to EXAMPLE_TRAIN_STEPS steps
#: (one checkpoint at step 50)
EXAMPLE_TRAIN_STEPS = 60
EXAMPLES = (("torch_quickstart.py", ["--port", "0"]), ("torch_sparse_grid_uq.py", []),
            ("torch_mlda_inversion.py", []), ("torch_serve_uq.py", []),
            ("torch_train_lm.py", ["--steps", str(EXAMPLE_TRAIN_STEPS)]))
EXAMPLE_TIMEOUT_S = 300.0


def phase_examples_on_card(torch) -> dict:
    """Each of the five `examples/torch_*.py` once, as a subprocess on the
    card (no --device), all started together, each under its own
    EXAMPLE_TIMEOUT_S; a nonzero exit or a timeout fails the run. Reports
    each one's wall and last line."""
    import os
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        running = {}
        for script, args in EXAMPLES:
            if script == "torch_train_lm.py":
                args = [*args, "--ckpt-dir", str(Path(tmp) / "ckpt")]
            log = open(Path(tmp) / f"{script}.log", "w")
            proc = subprocess.Popen([sys.executable, str(ROOT / "examples" / script), *args],
                                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp)
            running[script] = (proc, time.perf_counter(), log, args)
        try:
            while running:
                for script, (proc, t0, log, args) in list(running.items()):
                    wall = time.perf_counter() - t0
                    if proc.poll() is None and wall < EXAMPLE_TIMEOUT_S:
                        continue
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    log.close()
                    lines = (Path(tmp) / f"{script}.log").read_text().strip().splitlines()
                    results[script] = {"args": args, "exit_code": proc.returncode,
                                       "timed_out": wall >= EXAMPLE_TIMEOUT_S, "wall_s": wall,
                                       "last_lines": lines[-3:]}
                    del running[script]
                time.sleep(0.05)
        finally:
            for proc, _, log, _ in running.values():
                proc.kill()
                proc.wait()
                log.close()
    emit("examples_on_card", examples=results, timeout_s=EXAMPLE_TIMEOUT_S)
    failed = {s: r for s, r in results.items() if r["exit_code"] != 0 or r["timed_out"]}
    if failed:
        raise AssertionError(f"examples failed on the card: {failed}")
    return {s: r["wall_s"] for s, r in results.items()}


def run_lm_path(torch, arch: str, smi: str, main_path: dict | None = None) -> dict:
    """The main path, the kernel-vs-plain wave and the profiled wave of one
    LM, its serving steps, its gradient wave (mamba2: on the plain SSD),
    and for qwen3-0.6b (the model examples/serve_uq.py serves) the serving
    batch, the device pool's path, the derivative operations and the mesh
    phases (with the tsunami's `main_path`); the model's memory is released
    afterwards."""
    lm = phase_lm_main_path(torch, arch)
    model = lm["model"]
    phase_lm_kernel_vs_plain(torch, model)
    phase_lm_profile(torch, model, lm["points"], lm["grid_s"])
    decode = phase_lm_decode(torch, model.cfg, model.params, model.batch,
                             f"{LM_PHASE[arch]}_decode")
    serving = gradient = mesh = None
    if arch == SSM_ARCH:
        phase_lm_gradient_plain_ssd(torch, model)
    if arch == DENSE_ARCH:
        serving = phase_serving_batch(torch, model)
        phase_pool_path(torch, model, smi)
        gradient = phase_dense_lm_gradient_path(torch, model, smi)
        mesh_ref = phase_mesh_main_path(torch, model.device, main_path, model, smi)
        mesh = {"main_path": mesh_ref,
                "two_ranks": phase_mesh_two_ranks(torch, model.device, mesh_ref, smi),
                "lm_sharded": phase_mesh_lm_sharded(torch, model, smi)}
    launches = lm["launches"]
    del lm, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "decode": decode["launches"],
            "serving": serving and serving["launches"],
            "gradient": gradient and gradient["launches"], "mesh": mesh}


def phase_zoo_lm(torch, arch: str, n_layers, points: int) -> dict:
    """A lighter LM path: `arch` at full width from seeded random weights
    (cut to `n_layers` where the whole model does not fit the card), one
    wave of `points` points (2 sequences of 2,048 tokens each) on the
    kernel path, exactly `lm_launches` and no other kernel, its NLLs in
    (0, 30) and within ZOO_NLL_RTOL of the same wave on the plain path (a
    MoE's experts pinned), every attention launch of a point's forward held
    in situ (`in_situ_attention`); then the wave once more under the
    profiler. The model is freed afterwards."""
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    phase = LM_PHASE[arch]
    resident = torch.cuda.memory_allocated()  # what earlier phases left on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LMUQModel(arch, reduced=False, batch=LM_BATCH, seq=LM_SEQ, n_layers=n_layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    cfg = model.cfg
    thetas = np.array([[1.0 + 0.02 * i, 1.0 - 0.01 * i] for i in range(points)])
    pin = PinnedRouting()  # the MoE's experts on the kernel path, for the plain wave
    # every launch count starts at 0 right before the path
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pin.recording():
        got = model.evaluate_batch(thetas)[:, 0]
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    launches = check_launches(counts, cfg, 1, f"the {arch} wave")
    plain = copy.copy(model)
    plain.cfg = cfg.replace(attn_impl="plain")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with pin.replaying() if pin.choices else contextlib.nullcontext():
        want = plain.evaluate_batch(thetas)[:, 0]
    plain_s = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated()
    rel = float(np.abs(got / want - 1.0).max())
    single = np.array([model.evaluate_batch(t[None])[0, 0] for t in thetas])
    in_situ = in_situ_attention(torch, model)
    reduced = ([f"n_layers {get_config(arch).n_layers} -> {cfg.n_layers} (widths kept)"]
               if n_layers is not None else [])
    emit(f"{phase}_path", arch=arch, reduced=reduced, layers=cfg.n_layers,
         params=M.n_params(cfg), batch=LM_BATCH, seq=LM_SEQ, points=points,
         resident_before=resident, init_s=init_s, init_max_memory_allocated=init_peak,
         wave_s=wave_s,
         evals_per_s=points / wave_s, max_memory_allocated=peak,
         launches_per_forward=lm_launches(cfg), launches=counts,
         nll_kernel=got.tolist(), nll_plain=want.tolist(), nll_rel_err=rel, bound=ZOO_NLL_RTOL,
         routing="the plain path replays the kernel path's experts" if pin.choices else None,
         nll_rel_spread_wave_vs_points=float(np.abs(got / single - 1.0).max()),
         in_situ_attention=in_situ, plain_wave_s=plain_s, plain_max_memory_allocated=plain_peak)
    if not (np.isfinite(got).all() and 0 < got.min() and got.max() < 30):
        raise AssertionError(f"{arch}: NLL out of range: {got}")
    if not rel <= ZOO_NLL_RTOL:
        raise AssertionError(f"{arch}: kernel path NLL {got} vs plain {want}: {rel:.3g} > "
                             f"{ZOO_NLL_RTOL}")
    del plain
    profile = phase_lm_profile(torch, model, thetas, wave_s)
    decode = phase_lm_decode(torch, cfg, model.params, model.batch, f"{phase}_decode", reduced)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "wave_s": wave_s, "peak": peak, "decode": decode["launches"],
            **profile}


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
    each run a 2-lane gradient wave through it (one solve launch and one
    adjoint launch) and then a 2-lane JVP wave, whose step graphs are
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
    vecs = [rng.standard_normal((2, 2)) for _ in range(GATE_GRAD_THREADS)]
    serial = TsunamiModel(dev)
    t0 = time.perf_counter()
    want = serial.evaluate_batch(points)
    want_g = [serial.gradient_batch(th, ss) for th, ss in zip(lanes, senss)]
    want_j = [serial.apply_jacobian_batch(th, v) for th, v in zip(lanes, vecs)]
    serial_s = time.perf_counter() - t0

    mon = LockMonitor(seed=0, perturb=True)
    bindings = (core_device, tsunami, fused, composite)
    plain = [mod.CAPTURE_LOCK for mod in bindings]
    rows, errors, rounds = [], [], [0] * GATE_CALLERS
    grads, jvps = [None] * GATE_GRAD_THREADS, [None] * GATE_GRAD_THREADS
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
            jvps[i] = fabric.apply_jacobian_batch(lanes[i], vecs[i])
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
        _same_bits(jvps[i], want_j[i], f"analysis_gate: JVP wave {i} against serial")
    report = mon.report()
    captures = report["acquisitions_by_lock"].get("cuda.capture", 0)
    if report["lock_order_cycles"] or report["unguarded_writes"]:
        raise AssertionError(f"analysis_gate card_locks: cycles {report['lock_order_cycles']}, "
                             f"unguarded writes {report['unguarded_writes']}")
    if captures < GATE_GRAD_THREADS:
        raise AssertionError(f"cuda.capture taken {captures} times under the monitor: the "
                             f"JVP waves' captures went unseen")
    # every evaluate wave one launch of the solve kernel, every gradient wave
    # one of the solve and one of its adjoint; the JVP waves none
    if (counts["swe_solve"] != model.waves[0] + GATE_GRAD_THREADS
            or counts["swe_solve_vjp"] != GATE_GRAD_THREADS
            or not model.waves[0] or model.waves[1]):
        raise AssertionError(f"launches {counts} for the model's waves {dict(model.waves)} "
                             f"and {GATE_GRAD_THREADS} gradient waves")
    return {"rounds": sum(rounds), "rows_checked": sum(len(idx) for idx, _ in rows),
            "gradient_lanes_checked": 2 * GATE_GRAD_THREADS,
            "jvp_lanes_checked": 2 * GATE_GRAD_THREADS,
            "swe_solve_vjp_launches": counts["swe_solve_vjp"],
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
    if "--mesh-rank" in sys.argv:  # one rank of `mesh_two_ranks`
        args = sys.argv[sys.argv.index("--mesh-rank"):]
        return mesh_rank_main(int(args[1]), Path(args[args.index("--mesh-dir") + 1]))
    if "--lm-tp-rank" in sys.argv:  # one rank of `mesh_lm_sharded`'s TP pair
        args = sys.argv[sys.argv.index("--lm-tp-rank"):]
        return lm_tp_rank_main(int(args[1]), Path(args[args.index("--mesh-dir") + 1]))
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
    solves = phase_full_solves(torch, dev)
    times = phase_times(torch, dev, probe["smi"], solves)
    vjp = phase_swe_vjp_vs_plain(torch, dev, probe["smi"])
    phase_profile(torch)
    # every wave the paths hand the solve kernel, by width, for
    # `wave_widths_vs_plain`
    widths = WaveWidths(torch)
    with widths.installed():
        main_path = widths.run("main_path", phase_main_path, torch, dev)
        derivative = widths.run("derivative_waves", phase_derivative_waves, torch, dev,
                                probe["smi"])
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
        fused_mala = widths.run("fused_mala_tsunami", phase_fused_mala_tsunami, torch, dev)
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
    bwd = phase_flash_bwd_vs_plain(torch, dev, probe["smi"])
    f32_path = phase_flash_f32_path(torch)
    dense = run_lm_path(torch, DENSE_ARCH, probe["smi"], main_path)
    decode_f32 = phase_decode_f32_path(torch)
    train = phase_train_path(torch, dev, probe["smi"])
    train_mesh = phase_train_mesh_path(torch, dev, probe["smi"], train)
    train_f32 = phase_train_f32_path(torch, dev)
    moe = run_lm_path(torch, MOE_ARCH, probe["smi"])
    zoo = {arch: phase_zoo_lm(torch, arch, n_layers, points)
           for arch, n_layers, points in ZOO_PATHS}
    phase_serve_driver(torch, probe["smi"])
    phase_examples_on_card(torch)
    phase_dryrun_cells(probe["smi"])
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
                       if s["shape"] == [LM_BATCH, 16, 8, LM_SEQ, 128] and s["dtype"] == "bfloat16")
    f32_shape = [F32_PATH_CASE[i] for i in (0, 1, 2, 3, 5)]
    f32_point = next(s for s in flash_times["shapes"]
                     if s["shape"] == f32_shape and s["dtype"] == "float32")
    rms_point = next(s for s in rms_times["shapes"] if s["shape"] == [LM_BATCH * LM_SEQ, 1024])
    # the bf16 backward at the training path's shape, the float32 one at its
    # own path's
    bwd_point = next(s for s in bwd["shapes"] if s["case"] == "qwen3-0.6b_train")
    bwd_f32_point = next(s for s in bwd["shapes"] if s["case"] == "float32_path")
    from repro_torch.kernels.flash_attention import ops
    two = dense["mesh"]["two_ranks"]
    emit("mesh_slice_seconds", train_mesh_path=train_mesh["wall_s"], **two["seconds"])
    print(probe["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "swe_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/swe/csrc/swe_solve.cu",
        "replaces": "src/repro/kernels/swe/swe.py:54",
        "replaces_scan": "src/repro/apps/tsunami.py:172",
        "launches": main_path["launches"],
        # the gradient-informed campaign: its fine waves, and one
        # checkpointing launch a coarse value-and-gradient wave
        "launches_mala_main_path": mala["launches"],
        # fused MALA over the coarse tsunami: the start, then one a step
        "launches_fused_mala_tsunami": fused_mala["launches"]["swe_solve"],
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
        # the device mesh: main_path's campaign through ModelPool(ctx=) on a
        # 1x1 mesh; then two ranks on the card, each one launch for its 8
        # lanes of the fine wave and its fused coarse RWM's 151
        "launches_mesh_main_path": dense["mesh"]["main_path"]["swe_solve"],
        "launches_mesh_two_ranks_per_rank": dense["mesh"]["two_ranks"]["swe_solve"],
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
        "name": "swe_solve_vjp",
        "route": "cuda",
        "source": "src/repro_torch/kernels/swe/csrc/swe_solve_vjp.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the JAX package differentiates its lax.scan over "
                         "the checkpointed step (src/repro/apps/tsunami.py:172, the scan "
                         "body of src/repro/kernels/swe/swe.py:54); the same adjoint, by "
                         "hand, from checkpoints every ceil(sqrt(n_steps)) steps",
        # the gradient-informed campaign: one a coarse value-and-gradient wave
        "launches": mala["vjp_launches"],
        # one a fused value-and-gradient wave of 16 lanes, per level
        "launches_derivative_waves": {
            level: v["waves"]["value_and_gradient"]["launches"]["swe_solve_vjp"]
            for level, v in derivative.items()},
        # fused MALA over the coarse tsunami: the start, then one a step
        "launches_fused_mala_tsunami": fused_mala["launches"]["swe_solve_vjp"],
        # against the plain differentiable solver (_Sweep, float32), each
        # cotangent's error relative to its largest entry, worst case
        "max_abs_err": max(e["vs_sweep"][k]["max_abs"] for e in vjp["cases"].values()
                           for k in ("gh", "ghu")),
        "max_rel_err": vjp["max_rel_err"],
        "ms": vjp["cases"]["wave_2048x16"]["ms"],
        # the plain path's wall on the same wave (_Sweep: forward and reverse)
        "plain_ms": vjp["cases"]["wave_2048x16"]["plain_ms"],
        "bound_ms": vjp["cases"]["wave_2048x16"]["bound_ms"],
        "bound_by": vjp["cases"]["wave_2048x16"]["bound_by"],
        "library_ms": None,
        "shape": vjp["cases"]["wave_2048x16"]["shape"],
        "n_steps": vjp["cases"]["wave_2048x16"]["n_steps"],
        "by_shape": {case: {k: e[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                              "solve_with_checkpoints_ms", "solve_ms",
                                              "cluster", "ms_by_cluster")}
                     for case, e in vjp["cases"].items() if "ms" in e},
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
        "strip": fine["strip"],
        # one launch of the smallest step, [2, 1]: at and below the 64-lane
        # shapes the launch, not the bytes, sets the time
        "floor_ms": times["floor_ms"],
        "by_shape": times["shapes"],
        "per_step_path_wall_s_per_wave": {k: v["wall_s"] for k, v in times["step_path"].items()},
        "card": probe["smi"],
    }, {
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:89",
        "launches": lm["launches"]["ssd"],
        # zamba2-1.2b's wave of 8 points: 32 ssm units a forward
        "launches_hybrid_lm_path": zoo[ZOO_SSM_ARCH]["launches"]["ssd"],
        # the serving steps: each prefill one launch per ssm unit, each
        # decode step none
        "launches_decode_lm": lm["decode"]["ssd"],
        "launches_decode_hybrid_lm": zoo[ZOO_SSM_ARCH]["decode"]["ssd"],
        **{f"launches_{phase}": n["ssd"] for phase, n in decode_f32.items() if "ssd" in n},
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
        "launches": dense["launches"]["flash_attention_wgmma"],
        # deepseek-moe-16b's main path (28 a forward), and the lighter paths:
        # zamba2's shared block (6), minicpm3's MLA padded to hd 128 (62),
        # llama-3.2-vision's 8 causal self and 2 full cross (10), kimi-k2 (2)
        "launches_moe_lm_main_path": moe["launches"]["flash_attention_wgmma"],
        **{f"launches_{LM_PHASE[arch]}_path": zoo[arch]["launches"]["flash_attention_wgmma"]
           for arch, _, _ in ZOO_PATHS},
        # the serving steps: each prefill one launch per attention, each
        # decode step none; and qwen3-0.6b's prefill of 82 sequences
        "launches_decode_dense_lm": dense["decode"]["flash_attention_wgmma"],
        "launches_decode_moe_lm": moe["decode"]["flash_attention_wgmma"],
        **{f"launches_decode_{LM_PHASE[arch]}": zoo[arch]["decode"]["flash_attention_wgmma"]
           for arch, _, _ in ZOO_PATHS},
        "launches_decode_dense_lm_serving_batch": dense["serving"]["flash_attention_wgmma"],
        # the training path: 2 a layer a step (forward and remat recompute);
        # the LM's gradient wave the same, 2 a layer
        "launches_train_path": train["launches"]["flash_attention_wgmma"],
        "launches_dense_lm_gradient_path": dense["gradient"]["flash_attention_wgmma"],
        # the device mesh: the 8-point wave through LMUQModel(ctx=) on a 1x1
        # mesh, and split 4/4 over two ranks (each one forward, 28)
        "launches_mesh_main_path": dense["mesh"]["main_path"]["flash"]["flash_attention_wgmma"],
        "launches_mesh_two_ranks_per_rank": dense["mesh"]["two_ranks"]["flash"],
        # the LM's layout on the mesh: the 8-point wave and the gradient wave
        # on DTensor weights (1x1), and the wave with TP over model = 2
        "launches_mesh_lm_sharded": dense["mesh"]["lm_sharded"]["flash"],
        "launches_mesh_lm_sharded_gradient": dense["mesh"]["lm_sharded"]["gradient"],
        "launches_mesh_lm_tp_per_rank": dense["mesh"]["lm_sharded"]["tp_flash"],
        # the trainer on a mesh: train_path's first steps on a 1x1 mesh (56 a
        # step), and two ranks' FSDP then TP steps of 2 layers (4 a step)
        "launches_train_mesh_path": train_mesh["launches"]["flash_attention_wgmma"],
        "launches_mesh_two_ranks_train_per_rank": [
            {part: r[part].get("flash_attention_wgmma", 0) for part in r} for r in two["train"]],
        "max_abs_err": flash_check["wgmma"],
        "ms": flash_point["ms"],
        "plain_ms": flash_point["plain_ms"],
        "bound_ms": flash_point["bound_ms"],
        "bound_by": flash_point["bound_by"],
        "library_ms": flash_point["library_ms"],
        "f32_kernel_ms": flash_point["f32_kernel_ms"],
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
        # wgmma kernel); and the prefill of full-width qwen3-0.6b in float32
        # before its decode steps
        "launches": f32_path["launches"],
        **{f"launches_{phase}": n["flash_attention"] for phase, n in decode_f32.items()
           if "flash_attention" in n},
        "launches_train_f32_path": train_f32["launches"]["flash_attention"],
        # minicpm3-4b's prefill in float32 on (1, 2), a layer's heads halved
        "launches_mesh_two_ranks_mla_prefill_per_rank": [
            r.get("flash_attention", 0) for r in two["mla"]],
        "max_abs_err": flash_check["f32_kernel"],
        "max_abs_err_bf16": flash_check["f32_kernel_bf16"],
        "ms": f32_point["ms"],
        "plain_ms": f32_point["plain_ms"],
        # 3xTF32 on the tensor cores; and float32 on the CUDA cores
        "bound_ms": f32_point["bound_ms"],
        "bound_by": f32_point["bound_by"],
        "fp32_cuda_core_bound_ms": f32_point["fp32_cuda_core_bound_ms"],
        "library_ms": f32_point["library_ms"],
        "shape": f32_point["shape"],
        "by_shape": [s for s in flash_times["shapes"] if s["dtype"] == "float32"],
        "card": probe["smi"],
    }, {
        "name": "flash_attention_bwd_wgmma",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_wgmma.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the JAX package cannot differentiate its pallas_call "
                         "(src/repro/kernels/flash_attention/flash_attention.py:129) and "
                         "trains on XLA; the port's attention path is the forward kernel, so "
                         "its gradient is a kernel of its own (FlashAttention-3's backward, "
                         "dQ recomputed rather than added atomically)",
        "dtype": "bfloat16",
        "kernels": list(ops.BWD_KERNELS["flash_attention_bwd_wgmma"]),
        # the training path: qwen3-0.6b, 28 layers, each of the three kernels
        # once a layer a step
        "launches": train["launches"]["flash_attention_bwd_wgmma_dkdv"],
        "launches_by_kernel": {k: v for k, v in train["launches"].items()
                               if k.startswith("flash_attention_bwd_wgmma")},
        # the LM's gradient wave (dense_lm_gradient_path): once a layer each
        "launches_dense_lm_gradient_path": {k: v for k, v in dense["gradient"].items()
                                            if k.startswith("flash_attention_bwd_wgmma")},
        # the trainer on a mesh (1x1, and each of two ranks' FSDP and TP steps)
        "launches_train_mesh_path": {k: v for k, v in train_mesh["launches"].items()
                                     if k.startswith("flash_attention_bwd_wgmma")},
        "launches_mesh_two_ranks_train_per_rank": [
            {part: {k: v for k, v in r[part].items() if k.startswith("flash_attention_bwd")}
             for part in r} for r in two["train"]],
        "max_abs_err": max(bwd_point[g]["max_abs_err"] for g in ("dq", "dk", "dv")),
        "max_rel_err": bwd["worst"]["bfloat16"],
        # the forward kernel's log-sum-exp, which the backward reads
        "lse_max_abs_err": bwd["lse_worst"]["bfloat16"],
        "in_situ_max_rel_err_train_path": train["in_situ"],
        "in_situ_lse_max_abs_err_train_path": train["in_situ_lse"],
        "repeat_bit_for_bit": bwd["repeat"]["qwen3-0.6b_train"],
        "ms": bwd_point["ms"],
        "kernel_ms": bwd_point["kernel_ms"],
        "plain_ms": bwd_point["plain_ms"],
        "bound_ms": bwd_point["bound_ms"],
        "bound_by": bwd_point["bound_by"],
        "library_ms": bwd_point["library_ms"],
        "shape": bwd_point["shape"],
        "by_shape": [e for e in bwd["shapes"] if e["dtype"] == "bfloat16"],
        "card": probe["smi"],
    }, {
        "name": "flash_attention_bwd_3xbf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_3xbf16.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel (as flash_attention_bwd_wgmma): the float32 "
                         "gradient, FlashAttention-3's backward without atomics in 3xBF16 "
                         "on wgmma: q, k, v and dO split once into bf16 hi and lo parts, "
                         "TMA-fed rings of hi/lo tiles, three wgmmas a k-step",
        "dtype": "float32",
        "kernels": list(ops.BWD_KERNELS["flash_attention_bwd_3xbf16"]),
        # its own path: the float32 step's 4 layers, each kernel once a layer
        "launches": train_f32["launches"]["flash_attention_bwd_3xbf16_dkdv"],
        "launches_by_kernel": {k: v for k, v in train_f32["launches"].items()
                               if k.startswith("flash_attention_bwd_3xbf16")},
        "max_abs_err": max(bwd_f32_point[g]["max_abs_err"] for g in ("dq", "dk", "dv")),
        "max_rel_err": bwd["worst"]["float32"],
        "lse_max_abs_err": bwd["lse_worst"]["float32"],
        "repeat_bit_for_bit": bwd["repeat"]["float32_hd128"],
        "ms": bwd_f32_point["ms"],
        "kernel_ms": bwd_f32_point["kernel_ms"],
        "plain_ms": bwd_f32_point["plain_ms"],
        "bound_ms": bwd_f32_point["bound_ms"],
        "bound_by": bwd_f32_point["bound_by"],
        "library_ms": bwd_f32_point["library_ms"],
        "shape": bwd_f32_point["shape"],
        "by_shape": [e for e in bwd["shapes"] if e["dtype"] == "float32"],
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
