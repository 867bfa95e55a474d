"""Public wrappers of the SWE kernels.

`swe_step` (counterpart of `repro.kernels.swe.ops.swe_step`) is one step:
`csrc/swe_step.cu`, each thread a strip of cells of one lane; `strip_plan`
picks the strip depth from the step's shape and the card (`_strip_plan`),
and `strip=` forces it. `swe_solve` is a whole wave, all its steps with the
buoy reduction, in one launch of `csrc/swe_solve.cu`: the counterpart of
the JAX package's `lax.scan` over `swe_step_kernel`
(`repro.apps.tsunami._solve_batch`). The solve splits each lane's column
over a thread block cluster of `cs` blocks; `cluster_plan` picks `cs` from
the wave's shape and the card (`_cluster_plan`), and `cluster=` forces it.

`swe_solve` is differentiable in (h, hu), first order: under autograd it
goes through `SweSolve`, whose forward is the same launch keeping a
checkpoint of the state every `k` steps (`ref.checkpoint_every`), and
whose backward is `swe_solve_vjp`, the wave's reverse mode in one launch
of `csrc/swe_solve_vjp.cu` (the JAX package differentiates its scan
instead: it has no Pallas kernel for this). The adjoint also splits each
lane's column over a cluster, with a plan of its own (`vjp_cluster_plan`,
the same rule on its own occupancy), and `cluster=` forces it.

A CUDA tensor goes to the hand-written Hopper kernel or the call raises; a
CPU tensor goes to the plain version (`ref.swe_step_ref`,
`ref.swe_solve_ref`, `ref.swe_solve_vjp_ref`). There is no switch and no
fallback: on the card the kernel is the step, the solve, or its adjoint.
`swe_step.launches`, `swe_solve.launches` and `swe_solve_vjp.launches` count
kernel launches, so a run can show that its path went through the kernel;
a launch captured into a CUDA graph counts once per replay of the graph
(`kernels.launches`).

On the CPU the plain versions run under `torch.no_grad()`. `swe_step` has
no autograd rule; `swe_solve`'s is `SweSolve`, on every device.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.swe.ref import (
    ARRIVAL_THRESH,
    G,
    H_DRY,
    checkpoint_every,
    swe_solve_ref,
    swe_solve_vjp_ref,
    swe_step_ref,
    swe_step_ref_into,
)

#: buoy rows one solve reduces: the model's two buoys (`kRows` in
#: csrc/swe_solve.cu)
N_ROWS = 2
#: cells of one lane `swe_solve` takes, at most: 2 per thread of a block,
#: the fine level's 2,048
MAX_CELLS = 2048
#: steps of one solve, at most: `arr` holds the step index in float32
MAX_STEPS = 2**24
#: cluster sizes the plan picks from, largest first: Hopper's portable sizes
PLAN_CLUSTERS = (8, 4, 2)
#: cells a block owns at least under the plan: one warp of cells
MIN_SLICE = 32
#: strip depths of the step kernel (cells a thread owns), deepest first
STRIP_DEPTHS = (8, 4, 2, 1)
#: threads an SM the step's plan keeps at least, where a shallower strip
#: gives them: on an H100 (132 SMs) the depth it picks was the fastest of
#: the four at every main-path shape (scripts/kernel_ab.py, PERF.md)
STRIP_THREADS_PER_SM = 384

_fn = None
_solve_fn = None
_vjp_fn = None
#: SMs of each CUDA device, read at its first step
_sm_counts: dict[int, int] = {}
_occupancy_fn = None
_vjp_occupancy_fn = None
#: the plan of each (device, C, N), computed at its first solve: a graph
#: captured with a plan replays it
_plans: dict[tuple[int, int, int], int] = {}
#: the adjoint's plan of each (device, C, N), as `_plans`
_vjp_plans: dict[tuple[int, int, int], int] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("swe_step").swe_step_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, hu, b
            ctypes.c_void_p, ctypes.c_void_p,  # h_out, hu_out
            ctypes.c_int, ctypes.c_int,  # C, N
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # dt_dx, g, h_dry
            ctypes.c_int,  # strip depth
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _solve_kernel():
    global _solve_fn
    if _solve_fn is None:
        fn = _build.load("swe_solve").swe_solve_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, hu, b
            ctypes.c_void_p,  # h0_rows
            ctypes.c_void_p, ctypes.c_void_p,  # mx, arr
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # C, N, n_steps
            ctypes.c_int, ctypes.c_int,  # buoy rows r0, r1
            ctypes.c_float, ctypes.c_float,  # dt_dx, g
            ctypes.c_float, ctypes.c_float,  # h_dry, arrival threshold
            ctypes.c_int,  # cluster size
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # checkpoints: ck, ck_mx, k
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _solve_fn = fn
    return _solve_fn


def _vjp_kernel():
    global _vjp_fn
    if _vjp_fn is None:
        fn = _build.load("swe_solve_vjp").swe_solve_vjp_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # b, h0_rows
            ctypes.c_void_p, ctypes.c_void_p,  # ck, ck_mx
            ctypes.c_void_p,  # cot_mx
            ctypes.c_void_p, ctypes.c_void_p,  # scratch: states, buoy values
            ctypes.c_void_p,  # scratch: the cotangents' exchange
            ctypes.c_void_p, ctypes.c_void_p,  # gh, ghu
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # C, N, n_steps, k
            ctypes.c_int, ctypes.c_int,  # buoy rows r0, r1
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # dt_dx, g, h_dry
            ctypes.c_int,  # cluster size
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _vjp_fn = fn
    return _vjp_fn


def _vjp_occupancy_kernel():
    global _vjp_occupancy_fn
    if _vjp_occupancy_fn is None:
        fn = _build.load("swe_solve_vjp").swe_solve_vjp_max_active_clusters
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _vjp_occupancy_fn = fn
    return _vjp_occupancy_fn


def _occupancy_kernel():
    global _occupancy_fn
    if _occupancy_fn is None:
        fn = _build.load("swe_solve").swe_solve_max_active_clusters
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _occupancy_fn = fn
    return _occupancy_fn


def _strip_plan(C: int, N: int, sm_count: int) -> int:
    """The strip depth of a [C, N] step on a card of `sm_count` SMs: the
    deepest of STRIP_DEPTHS whose ceil(C / T) x N threads still give every
    SM STRIP_THREADS_PER_SM; 1 if none does."""
    for depth in STRIP_DEPTHS:
        if -(-C // depth) * N >= STRIP_THREADS_PER_SM * sm_count:
            return depth
    return 1


def strip_plan(C: int, N: int) -> int:
    """The strip depth `swe_step` launches a [C, N] step with on the current
    CUDA device: `_strip_plan` on its SM count."""
    dev = torch.cuda.current_device()
    sm_count = _sm_counts.get(dev)
    if sm_count is None:
        sm_count = _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _strip_plan(C, N, sm_count)


def _check_strip(strip) -> int | None:
    """`strip=` of `swe_step`: None (the plan) or one of STRIP_DEPTHS."""
    if strip is None:
        return None
    if isinstance(strip, bool) or not isinstance(strip, int) or strip not in STRIP_DEPTHS:
        raise ValueError(f"swe_step: strip must be None or one of {STRIP_DEPTHS}, got {strip!r}")
    return strip


def _cluster_plan(C: int, N: int, sm_count: int, max_active_clusters) -> int:
    """The cluster size of a wave of N lanes of C cells on a card of
    `sm_count` SMs: 1 when the lanes alone fill the SMs, else the largest
    of PLAN_CLUSTERS that gives each of the N x cs blocks an SM of its own,
    leaves every block at least MIN_SLICE cells, and whose N clusters are
    all resident at once (`max_active_clusters(cs)`, the card's count for
    that size, >= N); 1 if none does."""
    if N >= sm_count:
        return 1
    for cs in PLAN_CLUSTERS:
        if (N * cs <= sm_count and C // cs >= MIN_SLICE
                and max_active_clusters(cs) >= N):
            return cs
    return 1


def _max_active(query, C: int, cs: int, fn: str) -> int:
    out = ctypes.c_int(0)
    err = query(C, cs, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{fn}: occupancy query for cluster {cs} at {C} cells "
                           f"failed, cudaError {err}")
    return out.value


def max_active_clusters(C: int, cs: int) -> int:
    """How many clusters of `cs` blocks of a C-cell solve the current CUDA
    device holds at once (cudaOccupancyMaxActiveClusters; at cs = 1 blocks
    a SM times the SMs)."""
    return _max_active(_occupancy_kernel(), C, cs, "swe_solve")


def vjp_max_active_clusters(C: int, cs: int) -> int:
    """`max_active_clusters` of the adjoint's kernel."""
    return _max_active(_vjp_occupancy_kernel(), C, cs, "swe_solve_vjp")


def _cached_plan(plans: dict, C: int, N: int, occupancy) -> int:
    """`_cluster_plan` of a [C, N] wave on the current CUDA device, its
    occupancy `occupancy(cs)`, cached in `plans` per (device, C, N)."""
    key = (torch.cuda.current_device(), C, N)
    cs = plans.get(key)
    if cs is None:
        sm_count = torch.cuda.get_device_properties(key[0]).multi_processor_count
        cs = plans[key] = _cluster_plan(C, N, sm_count, occupancy)
    return cs


def cluster_plan(C: int, N: int) -> int:
    """The cluster size `swe_solve` launches a [C, N] wave with on the
    current CUDA device: `_cluster_plan` on its SM count and occupancy,
    cached per (device, C, N). Fill it before capturing a graph (a warm-up
    solve does): the query is no stream work."""
    return _cached_plan(_plans, C, N, lambda cs: max_active_clusters(C, cs))


def vjp_cluster_plan(C: int, N: int) -> int:
    """The cluster size `swe_solve_vjp` launches the adjoint of a [C, N]
    wave with on the current CUDA device: `_cluster_plan` on its SM count
    and the adjoint's own occupancy, cached per (device, C, N) (a warm-up
    backward fills it before a graph is captured). Its slices are the
    solve's (`testing.slices`), each extended by `testing.vjp_ghost_cells`
    a side (`testing.vjp_extended_slices`)."""
    return _cached_plan(_vjp_plans, C, N, lambda cs: vjp_max_active_clusters(C, cs))


def _check_cluster(cluster, C: int, fn: str, most: int):
    """`cluster=` of `fn`: None (the plan) or a power of two in [1, most].
    `swe_solve` takes up to C (every block owns a cell), `swe_solve_vjp`
    up to C / 2 (every block owns two cells: a round of its cotangents'
    exchange is one reverse step shorter than its ghost width). Whether
    the card schedules it is the launch's answer."""
    if cluster is None:
        return None
    if isinstance(cluster, bool):
        raise TypeError(f"{fn}: cluster must be None or an int, got {cluster!r}")
    try:
        cluster = operator.index(cluster)
    except TypeError:
        raise TypeError(f"{fn}: cluster must be None or an int, got {cluster!r}") from None
    if cluster < 1 or cluster & (cluster - 1) or cluster > most:
        raise ValueError(f"{fn}: cluster {cluster} must be a power of two in "
                         f"[1, {most}] (C = {C} cells)")
    return cluster


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           fn: str = "swe_step", ref: str = "h"):
    """`t` is a contiguous float32 tensor of `shape` on `device`, where the
    call's tensor `ref` lies."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, {ref} is on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def swe_step(
    h: torch.Tensor,  # [C, N]
    hu: torch.Tensor,  # [C, N]
    b: torch.Tensor,  # [C] or [C, 1]
    *,
    dt_dx: float,
    g: float = G,
    h_dry: float = H_DRY,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
    strip: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused Rusanov flux + limiter + update step on a [cells, batch]
    block. `out=(h_new, hu_new)` writes into caller-owned buffers (the
    solver's ping-pong pair); they must not alias the inputs, since every
    cell reads its neighbours' old state. On the card each thread owns a
    strip of `strip` cells of one lane (None: `strip_plan`); every depth
    gives the same bits."""
    if b.dim() == 1:
        b = b[:, None]
    if h.dim() != 2 or h.shape[0] < 2:
        raise ValueError(f"swe_step: h must be [C >= 2, N], got {tuple(h.shape)}")
    C, N = h.shape
    device = h.device
    for name, t, shape in (("h", h, (C, N)), ("hu", hu, (C, N)), ("b", b, (C, 1))):
        _check(name, t, shape, device)
    if out is not None:
        for name, t in zip(("out[0]", "out[1]"), out):
            _check(name, t, (C, N), device)
        if {out[0].data_ptr(), out[1].data_ptr()} & {h.data_ptr(), hu.data_ptr()}:
            raise ValueError("swe_step: out= buffers must not alias h or hu")
    strip = _check_strip(strip)
    if device.type == "cpu":
        with torch.no_grad():
            if out is None:
                return swe_step_ref(h, hu, b, dt_dx, g=g, h_dry=h_dry)
            return swe_step_ref_into(h, hu, b, dt_dx=dt_dx, g=g, h_dry=h_dry, out=out)
    if device.type != "cuda":
        raise ValueError(f"swe_step: no kernel for device {device}")
    if C * N >= 2**31:
        raise ValueError(f"swe_step: [{C}, {N}] exceeds the kernel's int index range")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry point launches on the current device's context
        with torch.cuda.device(device):
            return swe_step(h, hu, b, dt_dx=dt_dx, g=g, h_dry=h_dry, out=out, strip=strip)
    depth = strip_plan(C, N) if strip is None else strip
    h_new, hu_new = out if out is not None else (torch.empty_like(h), torch.empty_like(hu))
    err = _kernel()(
        h.data_ptr(), hu.data_ptr(), b.data_ptr(),
        h_new.data_ptr(), hu_new.data_ptr(),
        C, N, float(dt_dx), float(g), float(h_dry), depth,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"swe_step: kernel launch failed (strip {depth}), cudaError {err}")
    launches.count(swe_step)
    return h_new, hu_new


#: kernel launches since the last reset (CPU calls never count; a captured
#: launch counts at each replay, `kernels.launches`)
swe_step.launches = 0


def _check_wave(C: int, device: torch.device, b, rows, n_steps, h0_rows, fn: str,
                ref: str = "h"):
    """The arguments of a wave of C cells on `device` (where the call's
    tensor `ref` lies) that the solve and its adjoint share: -> (b as
    [C, 1], rows as ints in [0, C), n_steps)."""
    if b.dim() == 1:
        b = b[:, None]
    rows = tuple(operator.index(r) for r in rows)
    if len(rows) != N_ROWS:
        raise ValueError(f"{fn}: {len(rows)} buoy rows, expected {N_ROWS}")
    if not all(0 <= r < C for r in rows):
        raise ValueError(f"{fn}: buoy rows {rows} must lie in [0, {C})")
    n_steps = operator.index(n_steps)
    if not 0 <= n_steps < MAX_STEPS:
        raise ValueError(f"{fn}: n_steps {n_steps} must lie in [0, 2**24): the "
                         "arrival step is kept as a float32")
    for name, t, shape in (("b", b, (C, 1)), ("h0_rows", h0_rows, (len(rows),))):
        _check(name, t, shape, device, fn, ref)
    return b, rows, n_steps


def _check_card(device: torch.device, C: int, N: int, fn: str) -> None:
    """What a solve kernel takes on top of `_check_wave`: a CUDA tensor of
    at most MAX_CELLS cells whose [C, N] the kernel's int index reaches."""
    if device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {device}")
    if C > MAX_CELLS:
        raise ValueError(f"{fn}: {C} cells, the kernel takes at most {MAX_CELLS}")
    if C * N >= 2**31:
        raise ValueError(f"{fn}: [{C}, {N}] exceeds the kernel's int index range")


def _solve(h, hu, b, dt_dx, n_steps, rows, h0_rows, cluster, keep: bool):
    """The checked solve on h's device: (mx, arr, ck, ck_mx). With `keep`,
    on the card, the same launch also writes the adjoint's checkpoints,
    ck [N, n_seg, 2, C] (lane-major) and ck_mx [n_seg, 2, N] every
    `checkpoint_every(n_steps)` steps (empty tensors otherwise)."""
    C, N = h.shape
    device = h.device
    if device.type == "cpu":
        with torch.no_grad():
            mx, arr = swe_solve_ref(h, hu, b, dt_dx=dt_dx, n_steps=n_steps, rows=rows,
                                    h0_rows=h0_rows)
        return mx, arr, h.new_empty(0), h.new_empty(0)
    _check_card(device, C, N, "swe_solve")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry point launches on the current device's context
        with torch.cuda.device(device):
            return _solve(h, hu, b, dt_dx, n_steps, rows, h0_rows, cluster, keep)
    cs = cluster_plan(C, N) if cluster is None else cluster
    mx, arr = h.new_empty((len(rows), N)), h.new_empty((len(rows), N))
    k = checkpoint_every(n_steps)
    n_seg = -(-n_steps // k) if keep else 0
    ck, ck_mx = h.new_empty((N, n_seg, 2, C)), h.new_empty((n_seg, len(rows), N))
    err = _solve_kernel()(
        h.data_ptr(), hu.data_ptr(), b.data_ptr(), h0_rows.data_ptr(),
        mx.data_ptr(), arr.data_ptr(), C, N, n_steps, *rows,
        float(dt_dx), G, H_DRY, ARRIVAL_THRESH, cs,
        ck.data_ptr() if n_seg else None, ck_mx.data_ptr() if n_seg else None, k,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"swe_solve: kernel launch failed (cluster {cs}), cudaError {err}")
    launches.count(swe_solve)
    return mx, arr, ck, ck_mx


class SweSolve(torch.autograd.Function):
    """`swe_solve` with its gradient in (h, hu), first order:
    `apply(h, hu, b, h0_rows, dt_dx, n_steps, rows, cluster)` -> (mx, arr,
    ck, ck_mx); only mx is differentiable (the arrival index is piecewise
    constant), ck and ck_mx are the adjoint's checkpoints (empty on the
    CPU). On the card the forward is the solve's one launch, keeping them,
    and the backward one launch of `swe_solve_vjp`; on the CPU the
    backward is `ref.swe_solve_vjp_ref`, which recomputes its own."""

    @staticmethod
    def forward(h, hu, b, h0_rows, dt_dx, n_steps, rows, cluster):
        return _solve(h, hu, b, dt_dx, n_steps, rows, h0_rows, cluster, keep=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, hu, b, h0_rows, dt_dx, n_steps, rows, _ = inputs
        _, arr, ck, ck_mx = output
        ctx.save_for_backward(h, hu, b, h0_rows, ck, ck_mx)
        ctx.dt_dx, ctx.n_steps, ctx.rows = dt_dx, n_steps, rows
        ctx.mark_non_differentiable(arr, ck, ck_mx)

    @staticmethod
    def backward(ctx, gmx, _garr, _gck, _gck_mx):
        """First order only (as `flash_attention`'s): the kernel fills fresh
        tensors that carry no graph, so a `create_graph=True` backward
        raises, on the CPU too."""
        if torch.is_grad_enabled() and type(ctx) is SweSolve._backward_cls:
            raise RuntimeError(
                "swe_solve: the adjoint is once-differentiable; a second derivative "
                "of a tsunami wave runs the plain differentiable solver "
                "(apps.tsunami._Sweep)")
        return SweSolve._first_order(ctx, gmx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def _first_order(ctx, gmx):
        h, hu, b, h0_rows, ck, ck_mx = ctx.saved_tensors
        kw = dict(dt_dx=ctx.dt_dx, n_steps=ctx.n_steps, rows=ctx.rows, h0_rows=h0_rows)
        gmx = gmx.to(h.dtype).contiguous()
        if h.device.type == "cpu":
            with torch.no_grad():
                gh, ghu = swe_solve_vjp_ref(h, hu, b, gmx, **kw)
        else:
            gh, ghu = swe_solve_vjp(b, ck, ck_mx, gmx, **kw)
        return gh, ghu, None, None, None, None, None, None


def swe_solve(
    h: torch.Tensor,  # [C, N]
    hu: torch.Tensor,  # [C, N]
    b: torch.Tensor,  # [C] or [C, 1]
    *,
    dt_dx: float,
    n_steps: int,
    rows,
    h0_rows: torch.Tensor,  # [2]
    cluster: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A whole wave: `n_steps` SWE steps from (h, hu) with the buoy
    reduction of `ref.swe_solve_ref` inside the time loop, for the two buoy
    `rows` (ints in [0, C)) with their depths at rest `h0_rows`. Returns
    (mx, arr), each [2, N] float32; h and hu are left as they are. On the
    card this is ONE kernel launch, whatever `n_steps` is, with each lane's
    column split over a cluster of `cluster` blocks (None: `cluster_plan`).
    A cluster size the card refuses raises; nothing retries at another.
    Differentiable: with grad enabled and h or hu requiring grad, the call
    goes through `SweSolve` (mx has a gradient, arr none)."""
    if h.dim() != 2 or h.shape[0] < 2 or h.shape[1] < 1:
        raise ValueError(f"swe_solve: h must be [C >= 2, N >= 1], got {tuple(h.shape)}")
    C, N = h.shape
    for name, t in (("h", h), ("hu", hu)):
        _check(name, t, (C, N), h.device, "swe_solve")
    b, rows, n_steps = _check_wave(C, h.device, b, rows, n_steps, h0_rows, "swe_solve")
    cluster = _check_cluster(cluster, C, "swe_solve", C)
    if torch.is_grad_enabled() and (h.requires_grad or hu.requires_grad):
        mx, arr, _, _ = SweSolve.apply(h, hu, b, h0_rows, float(dt_dx), n_steps, rows,
                                       cluster)
        return mx, arr
    mx, arr, _, _ = _solve(h, hu, b, dt_dx, n_steps, rows, h0_rows, cluster, keep=False)
    return mx, arr


#: kernel launches since the last reset (CPU calls never count; a captured
#: launch counts at each replay, `kernels.launches`)
swe_solve.launches = 0


def swe_solve_vjp(
    b: torch.Tensor,  # [C] or [C, 1]
    ck: torch.Tensor,  # [N, n_seg, 2, C]
    ck_mx: torch.Tensor,  # [n_seg, 2, N]
    cot_mx: torch.Tensor,  # [2, N]
    *,
    dt_dx: float,
    n_steps: int,
    rows,
    h0_rows: torch.Tensor,  # [2]
    cluster: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse mode of a wave on the card, ONE launch of
    csrc/swe_solve_vjp.cu: from the checkpoints `ck`, `ck_mx` that
    `swe_solve`'s checkpointing launch (`SweSolve`) kept every
    `ref.checkpoint_every(n_steps)` steps and the cotangent `cot_mx` of the
    running max, the cotangents (gh, ghu) [C, N] of the wave's initial
    state, with each lane's column split over a cluster of `cluster` blocks
    (None: `vjp_cluster_plan`; 1 or a power of two in [2, C / 2]); every
    size gives the same bits. A cluster size the card refuses raises;
    nothing retries at another. Launched on the current stream; its
    scratch ([N, k, 2, C] states, [N, k, 2, 2] buoy values and the
    cotangents' exchange [N, 2, 2, C]) comes from the torch allocator, so a
    CUDA graph can hold the launch. CUDA tensors only: its plain version is
    `ref.swe_solve_vjp_ref`, which takes the initial state instead."""
    if ck.dim() != 4 or ck.shape[0] < 1 or ck.shape[2] != 2 or ck.shape[3] < 2:
        raise ValueError(f"swe_solve_vjp: ck must be [N >= 1, n_seg, 2, C >= 2], got "
                         f"{tuple(ck.shape)}")
    N, n_seg, _, C = ck.shape
    device = ck.device
    b, rows, n_steps = _check_wave(C, device, b, rows, n_steps, h0_rows, "swe_solve_vjp",
                                   "ck")
    k = checkpoint_every(n_steps)
    if n_seg != -(-n_steps // k):
        raise ValueError(f"swe_solve_vjp: {n_seg} checkpoints, {n_steps} steps keep "
                         f"{-(-n_steps // k)} (every {k})")
    for name, t, shape in (("ck", ck, (N, n_seg, 2, C)), ("ck_mx", ck_mx, (n_seg, len(rows), N)),
                           ("cot_mx", cot_mx, (len(rows), N))):
        _check(name, t, shape, device, "swe_solve_vjp", "ck")
    cluster = _check_cluster(cluster, C, "swe_solve_vjp", max(1, C // 2))
    _check_card(device, C, N, "swe_solve_vjp")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry point launches on the current device's context
        with torch.cuda.device(device):
            return swe_solve_vjp(b, ck, ck_mx, cot_mx, dt_dx=dt_dx, n_steps=n_steps,
                                 rows=rows, h0_rows=h0_rows, cluster=cluster)
    cs = vjp_cluster_plan(C, N) if cluster is None else cluster
    gh, ghu = cot_mx.new_empty((C, N)), cot_mx.new_empty((C, N))
    scratch = cot_mx.new_empty((N, k, 2, C))
    buoys = cot_mx.new_empty((N, k, 2, len(rows)))
    exchange = cot_mx.new_empty((N, 2, 2, C))
    err = _vjp_kernel()(
        b.data_ptr(), h0_rows.data_ptr(), ck.data_ptr(), ck_mx.data_ptr(),
        cot_mx.data_ptr(), scratch.data_ptr(), buoys.data_ptr(), exchange.data_ptr(),
        gh.data_ptr(), ghu.data_ptr(), C, N, n_steps, k, *rows, float(dt_dx), G, H_DRY,
        cs, torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"swe_solve_vjp: kernel launch failed (cluster {cs}), "
                           f"cudaError {err}")
    launches.count(swe_solve_vjp)
    return gh, ghu


#: kernel launches since the last reset (a captured launch counts at each
#: replay, `kernels.launches`)
swe_solve_vjp.launches = 0
