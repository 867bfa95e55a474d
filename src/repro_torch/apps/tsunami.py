"""Tsunami source inversion (paper §4.3), in PyTorch — the forward path.

Port of `repro.apps.tsunami`: the 1-D shallow-water equations (Rusanov
finite volumes, hydrostatic reconstruction for a well-balanced bathymetry
source, wetting & drying via a depth threshold) on a 400 km
ocean-to-coast transect:
  * fine level: 2048 cells, fully-resolved bathymetry (shelf + ridge bumps),
  * coarse level: 512 cells, SMOOTHED bathymetry (paper's smoothed model),
  * source: initial free-surface displacement eta0 = A exp(-((x-x0)/25km)^2),
    theta = (x0 [km], A [m]) — the 2-d source parameterization.
Observables: arrival time + max wave height at two buoys (x = 150 km,
250 km) -> 4 outputs.

On the GPU a whole evaluate wave, every time step and the buoy reduction,
is ONE launch of the hand-written SWE solve kernel (`repro_torch.kernels.
swe.swe_solve`); on the CPU the same wave runs its plain PyTorch loop.

The reverse mode (VJP waves and the fused value-and-gradient wave) of a
float32 wave on the GPU is `solve_batch` under autograd: one launch of the
solve kernel that keeps a checkpoint every ~sqrt(n_steps) steps, and one
launch of its hand-written adjoint (`kernels.swe.SweSolve`). Everywhere
else (the CPU, and float64 on any device), and for the JVP and HVP waves
on every device, the derivative waves run the same step as PyTorch ops
under autograd, as the JAX package runs its scan body. The
differentiable step computes the plain step's values bit for bit, with
derivative rules that match JAX's at the kinks the solver sits on (u == 0
in still water, dry cells): a `where` absolute value (slope 1 at 0),
`torch.maximum` (slope 1/2 at a tie), and `_SqrtSafe`, a square root whose
slope is capped where a cell is dry. The time loop (`_Sweep`) keeps one
carry a step and recomputes each step from it in the reverse sweep (the
JAX package's `jax.checkpoint`), and on the GPU replays each step as one
captured CUDA graph.

`_simulate`/`observables` is the per-point time series, in the JAX
package's own operation order; `TsunamiModel.__call__` solves a point as
a wave of one instead (one kernel launch rather than ~9k steps of eager
ops), which agrees with `observables` up to float32 reassociation.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import torch

from repro_torch.analysis.races import named_lock
from repro_torch.core.device import CAPTURE_LOCK, resolve_device
from repro_torch.core.interface import Capabilities, Model, sens_fn_traceable
from repro_torch.kernels.swe import swe_solve, swe_solve_ref
from repro_torch.kernels.swe.ref import _SQRT2, ARRIVAL_THRESH, G, H_DRY, _pow4, _sq

L_DOMAIN = 400e3  # m
T_END = 2600.0  # s
BUOYS_KM = (150.0, 250.0)


def bathymetry(x: np.ndarray, smoothed: bool) -> np.ndarray:
    """Seafloor elevation b(x) [m]: -4000 m deep ocean, continental shelf at
    ~300 km, beach reaching +10 m at the coast. The fine level adds ridge
    bumps that the smoothed level filters out (paper's two bathymetries)."""
    xk = x / 1e3
    deep = -4000.0
    shelf = deep + (deep * -1 + -80.0) * _sigmoid((xk - 300.0) / 12.0)  # rise to -80
    beach = (10.0 - -80.0) * _sigmoid((xk - 385.0) / 4.0)
    b = shelf + beach
    if not smoothed:
        b = b + 60.0 * np.sin(xk / 7.0) * _sigmoid((xk - 120.0) / 30.0) * _sigmoid((280.0 - xk) / 30.0)
    return b


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-np.asarray(z, float)))


@lru_cache(maxsize=None)
def _bathymetry_cached(n_cells: int, smoothed: bool) -> np.ndarray:
    """b(x) on the n_cells grid, computed once per (n_cells, smoothed)."""
    dx = L_DOMAIN / n_cells
    x = (np.arange(n_cells) + 0.5) * dx
    return np.asarray(bathymetry(x, smoothed), np.float32)


@lru_cache(maxsize=None)
def _level_constants(
    n_cells: int, smoothed: bool, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cell centres x [C, 1], b [C, 1]): the level's constants on
    `device`, float32, copied there once per (n_cells, smoothed, device). A
    wave then makes no copy from the host, so a CUDA graph can hold it
    (`uq.fused`)."""
    dx = L_DOMAIN / n_cells
    x = torch.as_tensor(
        ((np.arange(n_cells) + 0.5) * dx).astype(np.float32), device=device
    )[:, None]
    b = torch.as_tensor(_bathymetry_cached(n_cells, smoothed), device=device)[:, None]
    return x, b.contiguous()


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with slope 1/2 at 0, as `jnp.maximum(x, 0.0)` has;
    `torch.clamp_min` computes the same values with slope 1 there."""
    return torch.maximum(x, x.new_zeros(()))


def level_grid(n_cells: int) -> tuple[float, int, tuple[int, ...]]:
    """(dt, n_steps, buoy rows) of the explicit solve on `n_cells` cells."""
    dx = L_DOMAIN / n_cells
    c_max = float(np.sqrt(G * 4100.0))
    dt = 0.3 * dx / c_max
    return dt, int(T_END / dt), tuple(int(bk * 1e3 / dx) for bk in BUOYS_KM)


def initial_state(
    thetas: torch.Tensor, n_cells: int, smoothed: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, 2] sources -> (h, hu: [C, N], b: [C, 1]) on thetas' device: b is
    float32, the state float32 or thetas' wider dtype. Differentiable in
    thetas."""
    x, b = _level_constants(n_cells, smoothed, thetas.device)
    h0s = torch.clamp_min(-b, 0.0)
    x0 = thetas[None, :, 0] * 1e3  # [1, N]
    amp = thetas[None, :, 1]
    z = (x - x0) / 25e3
    eta0 = amp * torch.exp(-(z * z))  # [C, N]
    h = _relu(h0s + eta0 * (h0s > H_DRY))
    return h.contiguous(), torch.zeros_like(h), b


def solve_batch(
    thetas: torch.Tensor, n_cells: int, smoothed: bool, *, step=None
) -> torch.Tensor:
    """[N, 2] -> [N, 4] float32: all N sources solved in lockstep on
    thetas' device, in the JAX package's `_solve_batch` layout (state
    [n_cells, N], batch last). The arrival-time / max-height reduction runs
    inside the time loop, so only [N, 4] leaves the device.

    By default the wave is `kernels.swe.swe_solve`: on the GPU one kernel
    launch for all the steps, and the model always takes it. With `step=`
    (the signature of `kernels.swe.swe_step`) the wave runs the per-step
    loop `kernels.swe.swe_solve_ref` instead: `swe_step_ref_into` is the
    plain path, `swe_step` one step-kernel launch per step. Those two hold
    the solve kernel against the plain version and the step kernel.

    The wave copies nothing from the host (the level's constants are made
    on the device once, `_level_constants`, and the buoy rows are read by
    integer indexing), so a CUDA graph can hold it:
    the fused samplers (`uq.fused`) capture S of them in one graph."""
    dt, n_steps, buoy_rows = level_grid(n_cells)
    dt_dx = dt / (L_DOMAIN / n_cells)
    h, hu, b = initial_state(thetas.to(torch.float32), n_cells, smoothed)
    # [2] depth at rest: integer indexing is a view, no index copied from the host
    h0s = torch.clamp_min(-b[:, 0], 0.0)
    h0_rows = torch.stack([h0s[r] for r in buoy_rows])
    kw = dict(dt_dx=dt_dx, n_steps=n_steps, rows=buoy_rows, h0_rows=h0_rows)
    if step is None:
        mx, arr = swe_solve(h, hu, b, **kw)
    else:
        mx, arr = swe_solve_ref(h, hu, b, step=step, **kw)
    return _observe(mx, arr, dt)


def _observe(mx: torch.Tensor, arr: torch.Tensor, dt: float) -> torch.Tensor:
    """(running max, arrival index: [2, N]) -> [N, 4] rows [a1, h1, a2, h2]."""
    N = mx.shape[1]
    arrival = torch.where(arr >= 0, arr * (dt / 60.0), T_END / 60.0)
    return torch.stack([arrival, mx], dim=2).transpose(0, 1).reshape(N, 4)


# -- the differentiable solver --------------------------------------------------


class _SqrtSafe(torch.autograd.Function):
    """sqrt with a capped derivative: the value is exactly `torch.sqrt`, the
    slope 0.5 / max(y, 1e-3) (`_sqrt_slope`), so derivatives through the
    Rusanov wave speeds stay finite where a cell is dry (sqrt'(0) = inf
    would turn the whole adjoint into NaN). The slope is computed from the
    output y, itself this function's value, so a reverse sweep over a
    tangent (the HVP) differentiates the capped rule again, as the JAX
    package's `custom_jvp` does."""

    @staticmethod
    def forward(x):
        return torch.sqrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _sqrt_slope(g, y)


def _sqrt_slope(t, y):
    """The tangent (or cotangent) t through `_SqrtSafe` at its value y."""
    return t * 0.5 / torch.maximum(y, y.new_full((), 1e-3))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with slope 1 at 0, as `jnp.abs` (torch.abs has slope 0 there)."""
    return torch.where(x >= 0, x, -x)


def _slope(x, y):
    """d max(x, y) / dx: 1, 0 or, at a tie, 1/2 (JAX's rule)."""
    return (x > y).to(x.dtype) + 0.5 * (x == y).to(x.dtype)


def _ad_step(h, hu, b, dt_dx: float, dh=None, dhu=None):
    """`kernels.swe.ref.swe_step_ref`, expression for expression (so the
    same values, bit for bit), out of place, with JAX's derivative rules at
    ties: `_relu` and `torch.maximum` where the plain step clamps (slope
    1/2 at a tie), `_abs` for `torch.abs`, `_SqrtSafe` for the wave speeds.
    -> (h, hu).

    Given tangents (dh, dhu), also their image under the step's
    linearization, -> (h, hu, dh, dhu): forward mode written out, with the
    JVP rules of the JAX primitives at the kinks. It is plain tensor
    arithmetic, so autograd differentiates it again for the HVP (the
    slopes at the kinks are piecewise constant, as JAX's selects are).
    `torch.func.jvp` of the primal step computes the same with more
    kernels a step (280 against 245; under the HVP's reverse sweep 1,062
    against 932), so its JVP and HVP waves run 15-39% longer on an H100,
    and its eager host work makes the CPU's waves 6-10x slower (PERF.md
    §6)."""
    zero = h.new_zeros(())
    bL, bR = b[:-1], b[1:]
    bstar = torch.maximum(bL, bR)
    h2 = h * h
    h4 = h2 * h2  # _pow4(h)
    h_dry = h.new_full((), H_DRY)
    hm = torch.maximum(h, h_dry)
    hm2 = hm * hm
    root = torch.sqrt(h4 + hm2 * hm2)
    u = _SQRT2 * h * hu / root  # desingularized velocity
    argL = h[:-1] + bL - bstar
    argR = h[1:] + bR - bstar
    hsL = _relu(argL)  # [C-1, N]
    hsR = _relu(argR)
    uL, uR = u[:-1], u[1:]
    mL, mR = hsL * uL, hsR * uR  # interface mass fluxes
    rL, rR = _SqrtSafe.apply(G * hsL), _SqrtSafe.apply(G * hsR)
    cL, cR = _abs(uL) + rL, _abs(uR) + rR
    a = torch.maximum(cL, cR)
    Fh = 0.5 * (mL + mR) - 0.5 * a * (hsR - hsL)
    Fq = 0.5 * ((mL * uL + 0.5 * G * hsL * hsL) + (mR * uR + 0.5 * G * hsR * hsR)) \
        - 0.5 * a * (mR - mL)
    A = Fq + 0.5 * G * (_sq(h[:-1]) - _sq(hsL))
    B = Fq + 0.5 * G * (_sq(h[1:]) - _sq(hsR))
    div_h = torch.cat([Fh[:1], Fh[1:] - Fh[:-1], -Fh[-1:]], 0)
    pL = 0.5 * G * _sq(h[:1])
    pR = 0.5 * G * _sq(h[-1:])
    div_hu = torch.cat([A[:1] - pL, A[1:] - B[:-1], pR - B[-1:]], 0)
    arg_h = h - dt_dx * div_h
    h_new = _relu(arg_h)
    wet = h_new > H_DRY
    hu_new = torch.where(wet, hu - dt_dx * div_hu, 0.0)
    if dh is None:
        return h_new, hu_new
    # the tangent, line by line
    dhm = dh * _slope(h, h_dry)
    droot = 0.5 * (2.0 * h2 * (2.0 * h * dh) + 2.0 * hm2 * (2.0 * hm * dhm)) / root
    du = (_SQRT2 * (dh * hu + h * dhu) - u * droot) / root
    dhsL = dh[:-1] * _slope(argL, zero)
    dhsR = dh[1:] * _slope(argR, zero)
    duL, duR = du[:-1], du[1:]
    dmL, dmR = dhsL * uL + hsL * duL, dhsR * uR + hsR * duR
    dcL = torch.where(uL >= 0, duL, -duL) + _sqrt_slope(G * dhsL, rL)
    dcR = torch.where(uR >= 0, duR, -duR) + _sqrt_slope(G * dhsR, rR)
    sa = _slope(cL, cR)
    da = dcL * sa + dcR * (1.0 - sa)
    dFh = 0.5 * (dmL + dmR) - 0.5 * (da * (hsR - hsL) + a * (dhsR - dhsL))
    dFq = 0.5 * ((dmL * uL + mL * duL + G * hsL * dhsL)
                 + (dmR * uR + mR * duR + G * hsR * dhsR)) \
        - 0.5 * (da * (mR - mL) + a * (dmR - dmL))
    dA = dFq + G * (h[:-1] * dh[:-1] - hsL * dhsL)
    dB = dFq + G * (h[1:] * dh[1:] - hsR * dhsR)
    ddiv_h = torch.cat([dFh[:1], dFh[1:] - dFh[:-1], -dFh[-1:]], 0)
    dpL = G * h[:1] * dh[:1]
    dpR = G * h[-1:] * dh[-1:]
    ddiv_hu = torch.cat([dA[:1] - dpL, dA[1:] - dB[:-1], dpR - dB[-1:]], 0)
    dh_new = (dh - dt_dx * ddiv_h) * _slope(arg_h, zero)
    dhu_new = torch.where(wet, dhu - dt_dx * ddiv_hu, 0.0)
    return h_new, hu_new, dh_new, dhu_new


def _ad_wave_step(h, hu, mx, *tangent, b, dt_dx, rows, h0_buoy):
    """One step of a wave with the running buoy max: (h, hu, mx) ->
    (h, hu, mx, eta at the buoys), or with tangents (dh, dhu, dmx) after mx
    also their images. `torch.maximum` splits the slope at a tie, as
    `jnp.maximum` does (still water ties the running max)."""
    if not tangent:
        h, hu = _ad_step(h, hu, b, dt_dx)
        eta_b = h.index_select(0, rows) - h0_buoy  # [R, N]
        return h, hu, torch.maximum(mx, eta_b), eta_b
    dh, dhu, dmx = tangent
    h, hu, dh, dhu = _ad_step(h, hu, b, dt_dx, dh, dhu)
    eta_b = h.index_select(0, rows) - h0_buoy
    s = _slope(mx, eta_b)
    dmx = dmx * s + dh.index_select(0, rows) * (1.0 - s)
    return h, hu, torch.maximum(mx, eta_b), eta_b, dh, dhu, dmx


def _replay(body, n: int, mutated) -> None:
    """Run `body()` n times. On a CUDA device the body is warmed up once on
    a side stream (what the warm-up changed in `mutated` is then put back),
    captured as ONE CUDA graph on that stream and the graph replayed n
    times: one launch a step instead of the step's hundreds of eager ops,
    each of which costs the host ~25 µs on an H100 machine (PERF.md §6).
    The replays run the captured kernels, so they compute what the eager
    loop computes, bit for bit. Elsewhere the body runs eagerly. The
    warm-up and the capture hold `CAPTURE_LOCK`: waves that other threads
    run at once (a server answers each request on its own thread) take
    turns to capture, then replay side by side."""
    if n == 0:
        return
    if not mutated[0].is_cuda:
        for _ in range(n):
            body()
        return
    graph = torch.cuda.CUDAGraph()
    with CAPTURE_LOCK:
        before = [t.clone() for t in mutated]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        for t, b in zip(mutated, before):
            t.copy_(b)
        # captured on the wave's own stream, and only this thread's unsafe
        # calls (a malloc, a synchronous copy) break the capture: the fabric
        # runs evaluate waves of the same model from other threads meanwhile
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            body()
    for _ in range(n):
        graph.replay()


class _Sweep:
    """The time loop of one differentiable wave, as the JAX package's
    `lax.scan` over `jax.checkpoint(step)` runs it. `forward` runs `step`
    (`_ad_wave_step`, with or without tangents) n_steps times on a carry
    kept in fixed buffers, with the arrival index, and with `keep` also
    each step's input carry (the remat: one carry a step, not every
    intermediate). `pull` sweeps cotangents of the last carry back to the
    first, recomputing each step from its kept input under autograd, and
    hands them to autograd for the rest of the way to theta. Both loops
    step through `_replay`: a CUDA graph on the card."""

    def __init__(self, step, carry0, n_steps: int, keep: bool):
        self.step, self.n_steps = step, n_steps
        self.carry = [c.detach().clone() for c in carry0]
        self.arr = self.carry[0].new_full((2, self.carry[0].shape[1]), -1.0)
        self.idx = torch.zeros(1, dtype=torch.long, device=self.carry[0].device)
        self.kept = [c.new_empty((n_steps, *c.shape)) for c in self.carry] if keep else None

    def forward(self, dt: float) -> torch.Tensor:
        """Run the wave; -> its observables [N, 4]."""
        carry, arr, idx, kept = self.carry, self.arr, self.idx, self.kept

        def body():
            if kept is not None:
                for k, c in zip(kept, carry):
                    k.index_copy_(0, idx, c.unsqueeze(0))
            h, hu, mx, eta_b, *tangent = self.step(*carry)
            for c, o in zip(carry, (h, hu, mx, *tangent)):
                c.copy_(o)
            # the arrival index: piecewise constant in theta, no derivative
            arr.copy_(torch.where((torch.abs(eta_b) > ARRIVAL_THRESH) & (arr < 0),
                                  idx.to(arr.dtype), arr))
            idx.add_(1)

        with torch.no_grad():
            _replay(body, self.n_steps, [*carry, arr, idx])
        return _observe(carry[2], arr, dt)

    def pull(self, cot_last, carry0, thetas) -> torch.Tensor:
        """sum(cot_last . last carry) differentiated in `thetas`, through
        every step (recomputed from its kept input) and `carry0`, the first
        carry as computed from thetas under autograd."""
        cot = [c.clone() for c in cot_last]
        kept, idx = self.kept, self.idx

        def body():
            idx.sub_(1)
            xs = [k.index_select(0, idx)[0].detach().requires_grad_() for k in kept]
            with torch.enable_grad():
                h, hu, mx, _, *tangent = self.step(*xs)
                grads = torch.autograd.grad((h, hu, mx, *tangent), xs, cot, allow_unused=True)
            for c, g in zip(cot, grads):
                if g is None:
                    c.zero_()
                else:
                    c.copy_(g)

        with torch.no_grad():
            _replay(body, self.n_steps, [*cot, idx])
        pairs = [(c, g) for c, g in zip(carry0, cot) if c.requires_grad]
        return torch.autograd.grad([c for c, _ in pairs], thetas, [g for _, g in pairs])[0]


#: `torch.func.jvp` enters a forward-AD level, which is process-wide state:
#: two threads inside it at once fail (a server answers each request on its
#: own thread), so the tangent waves take turns for their initial state
_JVP_LOCK = named_lock("tsunami.jvp")


def _wave_setup(thetas: torch.Tensor, n_cells: int, smoothed: bool, vecs=None):
    """(first carry, step, n_steps, dt) of a differentiable wave in thetas'
    dtype: the carry (h, hu, mx), with tangents `vecs` [N, 2] also
    (dh, dhu, dmx), computed from thetas under the caller's grad mode."""
    if vecs is None:
        h, hu, b = initial_state(thetas, n_cells, smoothed)
        tangent = ()
    else:
        init = partial(initial_state, n_cells=n_cells, smoothed=smoothed)
        with _JVP_LOCK:
            (h, hu, b), (dh, dhu, _) = torch.func.jvp(init, (thetas,),
                                                       (vecs.to(thetas.dtype),))
        tangent = (dh, dhu, h.new_zeros((2, h.shape[1])))
    dt, n_steps, buoy_rows = level_grid(n_cells)
    b = b.to(h.dtype)
    rows = torch.as_tensor(buoy_rows, device=h.device)
    step = partial(_ad_wave_step, b=b, dt_dx=dt / (L_DOMAIN / n_cells), rows=rows,
                   h0_buoy=torch.clamp_min(-b, 0.0).index_select(0, rows))
    mx = h.new_full((2, h.shape[1]), -torch.inf)
    return (h, hu, mx, *tangent), step, n_steps, dt


def _height_cotangent(carry, senss: torch.Tensor, at: int):
    """Cotangents of a last carry for sens . y: only the max-height channels
    [h1, h2] carry a derivative (the arrival times are piecewise constant in
    theta), and they are the running max at `carry[at]`."""
    cot = [torch.zeros_like(c) for c in carry]
    cot[at] = senss.to(cot[at])[:, 1::2].T.contiguous()
    return cot


def _reverse_mode(thetas: torch.Tensor, n_cells: int, smoothed: bool, senss_of):
    """([N, 4], [N, 2]): the wave y and senss_of(y)^T J per lane, in one
    forward and one reverse sweep. The lanes' Jacobians are block-diagonal,
    so the batch VJP is the per-lane VJP. A float32 wave on the GPU is
    `solve_batch` under autograd: the solve kernel's checkpointing launch
    and its adjoint's launch (`kernels.swe.SweSolve`), and nothing of
    `_Sweep`. Elsewhere (the CPU, float64) `_Sweep` keeps each step's
    input and sweeps back through `_ad_step`."""
    th = thetas.detach().requires_grad_()
    if not (th.is_cuda and th.dtype == torch.float32):
        return _sweep_reverse_mode(th, n_cells, smoothed, senss_of)
    with torch.enable_grad():
        y = solve_batch(th, n_cells, smoothed)
    cot = senss_of(y.detach()).to(y.dtype)
    (g,) = torch.autograd.grad(y, th, cot)
    return y.detach(), g


def _sweep_reverse_mode(thetas: torch.Tensor, n_cells: int, smoothed: bool, senss_of):
    """`_reverse_mode` through `_Sweep` on any device and dtype: the plain
    path the CPU and float64 waves take, and what the adjoint kernel is
    held to on the card (`kernels.swe.testing`)."""
    th = thetas.detach().requires_grad_()
    with torch.enable_grad():
        carry0, step, n_steps, dt = _wave_setup(th, n_cells, smoothed)
    sweep = _Sweep(step, carry0, n_steps, keep=True)
    y = sweep.forward(dt)
    return y, sweep.pull(_height_cotangent(sweep.carry, senss_of(y), 2), carry0, th)


def _vjp_batch(thetas: torch.Tensor, senss: torch.Tensor, n_cells: int, smoothed: bool):
    """[N, 2] x [N, 4] -> ([N, 4], [N, 2]): the wave and sens^T J per lane."""
    return _reverse_mode(thetas, n_cells, smoothed, lambda y: senss)


def _value_and_grad(thetas: torch.Tensor, n_cells: int, smoothed: bool, sens_fn):
    """[N, 2] -> ([N, 4], [N, 2]): the fused wave, `sens_fn` applied to each
    row of the wave's own output (under `torch.func.vmap`) between its
    forward and its reverse sweep."""
    return _reverse_mode(thetas, n_cells, smoothed, torch.func.vmap(sens_fn))


def _jvp_wave(thetas: torch.Tensor, vecs: torch.Tensor, n_cells: int, smoothed: bool):
    """[N, 2] x [N, 2] -> ([N, 4], J vec [N, 4]): forward mode, the tangent
    carried through the time loop beside the state, nothing kept."""
    with torch.no_grad():
        carry0, step, n_steps, dt = _wave_setup(thetas, n_cells, smoothed, vecs)
        sweep = _Sweep(step, carry0, n_steps, keep=False)
        y = sweep.forward(dt)
        dmx = sweep.carry[5]
        return y, torch.stack([torch.zeros_like(dmx), dmx], dim=2).transpose(0, 1).reshape(-1, 4)


def _jvp_batch(thetas: torch.Tensor, vecs: torch.Tensor, n_cells: int, smoothed: bool):
    """[N, 2] x [N, 2] -> [N, 4]: J vec per lane."""
    return _jvp_wave(thetas, vecs, n_cells, smoothed)[1]


def _hvp_batch(
    thetas: torch.Tensor, senss: torch.Tensor, vecs: torch.Tensor,
    n_cells: int, smoothed: bool,
):
    """[N, 2] x [N, 4] x [N, 2] -> [N, 2]: d/de [J(theta + e vec)^T sens]
    per lane, REVERSE-over-forward as in the JAX package: the tangent J vec
    rides the time loop forward (the kept carry doubles), then one reverse
    sweep differentiates sens . (J vec). Forward-over-reverse is the
    textbook order but gives NaN here: transposing the reverse sweep
    re-enters the dry kinks, where second-order tangents hit 0 * inf."""
    th = thetas.detach().requires_grad_()
    with torch.enable_grad():
        carry0, step, n_steps, dt = _wave_setup(th, n_cells, smoothed, vecs)
    sweep = _Sweep(step, carry0, n_steps, keep=True)
    sweep.forward(dt)
    return sweep.pull(_height_cotangent(sweep.carry, senss, 5), carry0, th)


# -- the per-point time series (the JAX package's `_simulate`) ------------------


def _simulate(theta: torch.Tensor, n_cells: int, smoothed: bool):
    """[2] source -> (eta series at the buoys [n_steps, 2], dt) on theta's
    device, in the per-point operation order of the JAX package's
    `_simulate` (the stacked interface flux `Fn`), not the wave's."""
    dt, n_steps, buoy_rows = level_grid(n_cells)
    dx = L_DOMAIN / n_cells
    device = theta.device
    x = torch.as_tensor(((np.arange(n_cells) + 0.5) * dx).astype(np.float32), device=device)
    b = torch.as_tensor(_bathymetry_cached(n_cells, smoothed), device=device)
    h0 = torch.clamp_min(-b, 0.0)
    z = (x - theta[0] * 1e3) / 25e3
    eta0 = theta[1] * torch.exp(-(z * z))
    h = torch.clamp_min(h0 + eta0 * (h0 > H_DRY), 0.0)
    hu = torch.zeros_like(h)
    rows = torch.as_tensor(buoy_rows, device=device)
    h0_buoy = h0.index_select(0, rows)
    bL, bR = b[:-1], b[1:]
    bstar = torch.maximum(bL, bR)
    zero = h.new_zeros(1)
    etas = []
    for _ in range(n_steps):
        u = _SQRT2 * h * hu / torch.sqrt(_pow4(h) + _pow4(torch.clamp_min(h, H_DRY)))
        hsL = torch.clamp_min(h[:-1] + bL - bstar, 0.0)
        hsR = torch.clamp_min(h[1:] + bR - bstar, 0.0)
        uL, uR = u[:-1], u[1:]
        qL = torch.stack([hsL, hsL * uL])
        qR = torch.stack([hsR, hsR * uR])
        FL = torch.stack([hsL * uL, hsL * uL * uL + 0.5 * G * hsL * hsL])
        FR = torch.stack([hsR * uR, hsR * uR * uR + 0.5 * G * hsR * hsR])
        a = torch.maximum(torch.abs(uL) + torch.sqrt(G * hsL),
                          torch.abs(uR) + torch.sqrt(G * hsR))
        Fn = 0.5 * (FL + FR) - 0.5 * a * (qR - qL)  # [2, C-1]
        corrL = 0.5 * G * (_sq(h[:-1]) - _sq(hsL))  # right face of the left cell
        corrR = 0.5 * G * (_sq(h[1:]) - _sq(hsR))  # left face of the right cell
        F_right_h = torch.cat([Fn[0], zero])
        F_left_h = torch.cat([zero, Fn[0]])
        F_right_hu = torch.cat([Fn[1] + corrL, 0.5 * G * _sq(h[-1:])])
        F_left_hu = torch.cat([0.5 * G * _sq(h[:1]), Fn[1] + corrR])
        h_new = h - dt / dx * (F_right_h - F_left_h)
        hu_new = hu - dt / dx * (F_right_hu - F_left_hu)
        h = torch.clamp_min(h_new, 0.0)
        hu = torch.where(h > H_DRY, hu_new, 0.0)
        etas.append(h.index_select(0, rows) - h0_buoy)
    return torch.stack(etas), dt


#: the JAX package's jitted per-point view; eager here
_solve = _simulate


def observables(theta, n_cells: int, smoothed: bool, device=None) -> np.ndarray:
    """[arrival_1 (min), height_1 (m), arrival_2, height_2] of one source
    from its time series, on `device` (default: the GPU)."""
    theta = torch.as_tensor(np.asarray(theta, np.float32), device=resolve_device(device))
    etas, dt = _solve(theta, n_cells, smoothed)
    etas = etas.cpu().numpy()
    out = []
    for bi in range(len(BUOYS_KM)):
        above = np.abs(etas[:, bi]) > ARRIVAL_THRESH
        arrival = (np.argmax(above) * float(dt) / 60.0) if above.any() else T_END / 60.0
        out.extend([arrival, float(etas[:, bi].max())])
    return np.asarray(out)


class TsunamiModel(Model):
    """UM-Bridge model: theta=(x0_km, amplitude_m) -> 4 observables.
    config: {"level": 0 (coarse/smoothed, default) | 1 (fully resolved)}.

    Runs on `device` (default: the GPU; raises if there is none). Native
    batched evaluate: a wave of N sources is solved as ONE lockstep wave of
    exactly N lanes on the device: on the GPU, one launch of the SWE solve
    kernel, one block a lane. Native batched gradient, apply_jacobian and
    apply_hessian, and the fused value-and-gradient wave gradient-based
    samplers ride, in chunks of at most `GRAD_CHUNK_MAX` lanes run one after
    another, unpadded: on the GPU a gradient or fused wave is one launch of
    the solve kernel and one of its adjoint a chunk, the JVP and HVP waves
    lockstep AD through the differentiable solver."""

    N_CELLS = {0: 512, 1: 2048}
    # lanes are independent and the solver keeps no trace cache, so a wave
    # runs at its own width: dispatcher-level pow2 padding would only add
    # wasted solves
    batch_bucket = False
    #: lanes of one derivative wave: the reverse sweep keeps every step's
    #: state (and the HVP its tangent too), so memory bounds the width
    GRAD_CHUNK_MAX = 16

    def __init__(self, device=None):
        super().__init__("forward")
        self.device = resolve_device(device)
        # the fabric dispatches waves from several threads at once
        self._lock = named_lock("tsunami.stats")
        self.stats = {0: 0, 1: 0}  # sources solved, per level
        self.waves = {0: 0, 1: 0}  # lockstep solves, per level

    def get_input_sizes(self, config=None):
        return [2]

    def get_output_sizes(self, config=None):
        return [4]

    def capabilities(self, config=None) -> Capabilities:
        return Capabilities(
            evaluate=True, evaluate_batch=True,
            gradient=True, gradient_batch=True,
            apply_jacobian=True, apply_jacobian_batch=True,
            apply_hessian=True, apply_hessian_batch=True,
        )

    def __call__(self, parameters, config=None):
        theta = np.asarray(parameters[0], float)
        return [list(map(float, self.evaluate_batch(theta[None, :], config)[0]))]

    def evaluate_batch(self, thetas, config=None) -> np.ndarray:
        """[N, 2] -> [N, 4] float64: one lockstep solve of the whole wave,
        N lanes, unpadded (the JAX package pads to bound its jit cache; the
        lanes are independent, so the values are the same bit for bit)."""
        level = int((config or {}).get("level", 0))
        n_cells, smoothed = self.N_CELLS[level], (level == 0)
        thetas = np.atleast_2d(np.asarray(thetas, np.float32))
        N = len(thetas)
        with self._lock:
            self.stats[level] += N
            self.waves[level] += 1
        out = solve_batch(torch.as_tensor(thetas, device=self.device), n_cells, smoothed)
        return out.cpu().numpy().astype(float)

    # -- batched derivative surface -------------------------------------------
    def _derivative_wave(self, wave, config, *arrays) -> tuple[np.ndarray, ...]:
        """Run `wave(*tensors, n_cells, smoothed)` (a tensor or a tuple of
        them per chunk) over float32 [N, .] arrays in chunks of at most
        `GRAD_CHUNK_MAX` lanes, one after another on the model's device;
        returns the float64 results, concatenated along the lanes."""
        level = int((config or {}).get("level", 0))
        n_cells, smoothed = self.N_CELLS[level], (level == 0)
        arrays = [np.atleast_2d(np.asarray(a, np.float32)) for a in arrays]
        N = len(arrays[0])
        with self._lock:
            self.stats[level] += N
        parts = []
        for lo in range(0, N, self.GRAD_CHUNK_MAX):
            chunk = [torch.as_tensor(a[lo:lo + self.GRAD_CHUNK_MAX], device=self.device)
                     for a in arrays]
            out = wave(*chunk, n_cells, smoothed)
            outs = out if isinstance(out, tuple) else (out,)
            parts.append([o.detach().cpu().numpy().astype(float) for o in outs])
        return tuple(np.concatenate(cols, axis=0) for cols in zip(*parts))

    def gradient(self, out_wrt, in_wrt, parameters, sens, config=None):
        theta = np.asarray(parameters[in_wrt], float)
        sens4 = np.zeros(4)
        sens4[:] = np.asarray(sens, float)  # single output block
        return self.gradient_batch(theta[None, :], sens4[None, :], config)[0].tolist()

    def gradient_batch(self, thetas, senss, config=None) -> np.ndarray:
        """[N, 2] x [N, 4] -> [N, 2]: lockstep reverse-mode waves."""
        return self._derivative_wave(_vjp_batch, config, thetas, senss)[1]

    def apply_jacobian(self, out_wrt, in_wrt, parameters, vec, config=None):
        theta = np.asarray(parameters[in_wrt], float)
        return self.apply_jacobian_batch(
            theta[None, :], np.asarray(vec, float)[None, :], config
        )[0].tolist()

    def apply_jacobian_batch(self, thetas, vecs, config=None) -> np.ndarray:
        """[N, 2] x [N, 2] -> [N, 4]: lockstep forward-mode (JVP) waves."""
        return self._derivative_wave(_jvp_batch, config, thetas, vecs)[0]

    def apply_hessian(self, out_wrt, in_wrt1, in_wrt2, parameters, sens, vec, config=None):
        theta = np.asarray(parameters[in_wrt1], float)
        sens4 = np.zeros(4)
        sens4[:] = np.asarray(sens, float)  # single output block
        return self.apply_hessian_batch(
            theta[None, :], sens4[None, :], np.asarray(vec, float)[None, :], config
        )[0].tolist()

    def apply_hessian_batch(self, thetas, senss, vecs, config=None) -> np.ndarray:
        """[N, 2] x [N, 4] x [N, 2] -> [N, 2]: lockstep HVP waves
        (reverse-over-forward through the differentiable solver)."""
        return self._derivative_wave(_hvp_batch, config, thetas, senss, vecs)[0]

    def value_and_gradient_batch(self, thetas, sens_fn, config=None):
        """Fused (ys, grads): ONE forward and ONE reverse sweep per chunk,
        `sens_fn` applied to the rows of the chunk's own output in between,
        when `sens_fn` runs on tensors under `torch.func.vmap` (probed
        abstractly up front, `sens_fn_traceable`); otherwise the two-wave
        default of the base class (an evaluate wave, then a gradient wave)."""
        if not sens_fn_traceable(sens_fn, 4, torch.float32, self.device):
            return super().value_and_gradient_batch(thetas, sens_fn, config)
        return self._derivative_wave(partial(_value_and_grad, sens_fn=sens_fn),
                                     config, thetas)


def make_logposts(model: TsunamiModel, data: np.ndarray, noise_sd, prior_bounds):
    """Per-level log-posteriors for MLDA. Gaussian likelihood on the 4
    observables; uniform prior box on (x0, A)."""
    noise_sd = np.asarray(noise_sd, float)
    (x_lo, x_hi), (a_lo, a_hi) = prior_bounds

    def make(level):
        def logpost(theta):
            x0, A = float(theta[0]), float(theta[1])
            if not (x_lo <= x0 <= x_hi and a_lo <= A <= a_hi):
                return -np.inf
            obs = np.asarray(model([list(theta)], {"level": level})[0])
            return float(-0.5 * np.sum(((obs - data) / noise_sd) ** 2))

        return logpost

    return make
