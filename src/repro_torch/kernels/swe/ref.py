"""Plain PyTorch version of the SWE step kernel.

One Rusanov / hydrostatic-reconstruction finite-volume step over a
``[cells, batch]`` state block, with the exact OPERATION ORDER of
`repro.kernels.swe.ref.swe_step_ref` in the JAX package: hydrostatic
reconstruction against the interface bathymetry (Audusse et al.,
well-balanced with wetting & drying), Rusanov flux, well-balanced momentum
corrections, reflective walls, positivity/dry-cell limiter. Integer powers
are written as products in the order `jax.lax.integer_pow` lowers them
(x**2 = x*x, x**4 = (x*x)*(x*x)), so on the CPU the two agree to rounding.

The CUDA kernels (`csrc/swe_step.cu`, one step, and `csrc/swe_solve.cu`, a
whole wave) repeat this arithmetic term by term; `swe_solve_ref` is the
whole wave's loop with the buoy reduction. `ops.swe_step` and
`ops.swe_solve` take these versions only for tensors on the CPU.
"""
from __future__ import annotations

import math

import torch

G = 9.81
H_DRY = 0.05
ARRIVAL_THRESH = 0.1  # |eta| [m] at a buoy that counts as the wave's arrival
_SQRT2 = math.sqrt(2.0)


def _sq(x: torch.Tensor) -> torch.Tensor:
    return x * x


def _pow4(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    return x2 * x2


def swe_step_ref(
    h: torch.Tensor,  # [C, N] water depth
    hu: torch.Tensor,  # [C, N] momentum
    b: torch.Tensor,  # [C, 1] bathymetry
    dt_dx: float,
    *,
    g: float = G,
    h_dry: float = H_DRY,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward-Euler SWE step: (h, hu) -> (h_new, hu_new)."""
    bL, bR = b[:-1], b[1:]
    bstar = torch.maximum(bL, bR)
    h4 = _pow4(h)
    # desingularized velocity (no division blow-up at the shoreline)
    u = _SQRT2 * h * hu / torch.sqrt(h4 + _pow4(torch.clamp_min(h, h_dry)))
    hsL = torch.clamp_min(h[:-1] + bL - bstar, 0.0)  # [C-1, N]
    hsR = torch.clamp_min(h[1:] + bR - bstar, 0.0)
    uL, uR = u[:-1], u[1:]
    mL, mR = hsL * uL, hsR * uR  # interface mass fluxes
    a = torch.maximum(
        torch.abs(uL) + torch.sqrt(g * hsL), torch.abs(uR) + torch.sqrt(g * hsR)
    )
    Fh = 0.5 * (mL + mR) - 0.5 * a * (hsR - hsL)
    Fq = 0.5 * ((mL * uL + 0.5 * g * hsL * hsL) + (mR * uR + 0.5 * g * hsR * hsR)) \
        - 0.5 * a * (mR - mL)
    # momentum flux + well-balanced interface correction, as seen from the
    # left cell (A) and from the right cell (B)
    A = Fq + 0.5 * g * (_sq(h[:-1]) - _sq(hsL))
    B = Fq + 0.5 * g * (_sq(h[1:]) - _sq(hsR))
    # flux divergence per cell; reflective walls (zero mass flux,
    # hydrostatic pressure g/2 h^2)
    div_h = torch.cat([Fh[:1], Fh[1:] - Fh[:-1], -Fh[-1:]], 0)
    pL = 0.5 * g * _sq(h[:1])
    pR = 0.5 * g * _sq(h[-1:])
    div_hu = torch.cat([A[:1] - pL, A[1:] - B[:-1], pR - B[-1:]], 0)
    h_new = torch.clamp_min(h - dt_dx * div_h, 0.0)
    hu_new = torch.where(h_new > h_dry, hu - dt_dx * div_hu, 0.0)
    return h_new, hu_new


def swe_step_ref_into(
    h: torch.Tensor,
    hu: torch.Tensor,
    b: torch.Tensor,
    *,
    dt_dx: float,
    g: float = G,
    h_dry: float = H_DRY,
    out: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """`swe_step_ref` with the kernel wrapper's signature: writes the step
    into `out=(h_new, hu_new)` and returns it. Passed to
    `apps.tsunami.solve_batch(step=...)`, it solves on the plain path."""
    h_new, hu_new = swe_step_ref(h, hu, b, dt_dx, g=g, h_dry=h_dry)
    out[0].copy_(h_new)
    out[1].copy_(hu_new)
    return out


def swe_solve_ref(
    h: torch.Tensor,  # [C, N] water depth
    hu: torch.Tensor,  # [C, N] momentum
    b: torch.Tensor,  # [C, 1] bathymetry
    *,
    dt_dx: float,
    n_steps: int,
    rows,
    h0_rows: torch.Tensor,  # [R] depth at rest of each buoy row
    step=swe_step_ref_into,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`n_steps` SWE steps of a wave with the buoy reduction inside the time
    loop: returns (mx, arr), each [R, N] for the R buoy `rows`: the largest
    free surface eta = h[row] - h0 over the steps (NaN propagates, as in
    `torch.maximum`) and the index of the first step whose |eta| exceeds
    `ARRIVAL_THRESH` (-1 if none), as float32. The inputs are left as they are.

    `step` is the SWE step with the signature of `ops.swe_step`; the default
    is the plain version, and `ops.swe_step` runs the loop one kernel launch
    per step. Nothing in the loop waits for the device."""
    N = h.shape[1]
    rows = torch.as_tensor(rows, device=h.device)
    h0_buoy = h0_rows.reshape(-1, 1)  # [R, 1]
    mx = torch.full((len(rows), N), -torch.inf, device=h.device)
    arr = torch.full((len(rows), N), -1.0, device=h.device)
    # two state pairs ping-pong: each step writes the spare pair IN PLACE
    # (no per-step allocation) and the pairs swap roles
    h, hu = h.clone(), hu.clone()
    h_nxt, hu_nxt = torch.empty_like(h), torch.empty_like(hu)
    for i in range(n_steps):
        step(h, hu, b, dt_dx=dt_dx, out=(h_nxt, hu_nxt))
        h, h_nxt, hu, hu_nxt = h_nxt, h, hu_nxt, hu
        eta_b = h.index_select(0, rows) - h0_buoy  # [R, N]
        torch.maximum(mx, eta_b, out=mx)
        arr.masked_fill_((torch.abs(eta_b) > ARRIVAL_THRESH) & (arr < 0), float(i))
    return mx, arr


# -- the adjoint ------------------------------------------------------------------


def checkpoint_every(n_steps: int) -> int:
    """k, the steps between two checkpoints of a differentiated wave: the
    ceiling of sqrt(n_steps) (1 for n_steps <= 1). The checkpoints and one
    segment's recomputed steps then each hold ~sqrt(n_steps) states."""
    return max(1, math.isqrt(max(n_steps, 1) - 1) + 1)


def _tie(x: torch.Tensor, y, g: torch.Tensor) -> torch.Tensor:
    """g times d max(x, y) / dx: g where x > y, g / 2 at a tie, 0 below (the
    rule of `torch.maximum` and `jnp.maximum`), as a select, so an infinite
    or NaN g where the slope is 0 gives 0."""
    return torch.where(x > y, g, torch.where(x == y, 0.5 * g, torch.zeros_like(g)))


def _abs_vjp(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g times d|u|/du with slope 1 at u == 0 (`jnp.abs`'s rule)."""
    return torch.where(u >= 0, g, -g)


def _sqrt_vjp(r: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g times the capped slope of a wave speed's square root r:
    0.5 / max(r, 1e-3), finite where a face is dry (`apps.tsunami._SqrtSafe`)."""
    return g * 0.5 / torch.clamp_min(r, 1e-3)


def swe_step_vjp_ref(
    h: torch.Tensor,  # [C, N] the step's input depth
    hu: torch.Tensor,  # [C, N] and momentum
    b: torch.Tensor,  # [C, 1]
    dt_dx: float,
    gh_new: torch.Tensor,  # [C, N] cotangent of the step's output depth
    ghu_new: torch.Tensor,  # [C, N] and momentum
    *,
    g: float = G,
    h_dry: float = H_DRY,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The transpose of one step's linearization at (h, hu): (gh, ghu), the
    cotangents of the step's input, derived by hand from `swe_step_ref`,
    in the expression order of csrc/swe_solve_vjp.cu, in h's dtype. The
    rules at the kinks are those of `apps.tsunami._ad_step` (the JAX
    package's): slope 1/2 at a tie of a maximum (`max(x, 0)`, `max(h,
    h_dry)`, the wave speed), slope 1 of |u| at u == 0, the square root of
    a wave speed with slope 0.5 / max(sqrt, 1e-3), and the `wet` mask as a
    select."""
    # the forward step, as `swe_step_ref` computes it, keeping what the
    # adjoint reads
    bL, bR = b[:-1], b[1:]
    bstar = torch.maximum(bL, bR)
    h2 = h * h
    hm = torch.clamp_min(h, h_dry)
    hm2 = hm * hm
    root = torch.sqrt(h2 * h2 + hm2 * hm2)
    u = _SQRT2 * h * hu / root
    hL, hR = h[:-1], h[1:]
    argL = hL + bL - bstar
    argR = hR + bR - bstar
    hsL = torch.clamp_min(argL, 0.0)
    hsR = torch.clamp_min(argR, 0.0)
    uL, uR = u[:-1], u[1:]
    mL, mR = hsL * uL, hsR * uR
    rL, rR = torch.sqrt(g * hsL), torch.sqrt(g * hsR)
    cL, cR = torch.abs(uL) + rL, torch.abs(uR) + rR
    a = torch.maximum(cL, cR)
    Fh = 0.5 * (mL + mR) - 0.5 * a * (hsR - hsL)
    Fq = 0.5 * ((mL * uL + 0.5 * g * hsL * hsL) + (mR * uR + 0.5 * g * hsR * hsR)) \
        - 0.5 * a * (mR - mL)
    A = Fq + 0.5 * g * (_sq(hL) - _sq(hsL))
    B = Fq + 0.5 * g * (_sq(hR) - _sq(hsR))
    div_h = torch.cat([Fh[:1], Fh[1:] - Fh[:-1], -Fh[-1:]], 0)
    div_hu = torch.cat([A[:1] - 0.5 * g * _sq(h[:1]), A[1:] - B[:-1],
                        0.5 * g * _sq(h[-1:]) - B[-1:]], 0)
    arg_h = h - dt_dx * div_h
    wet = torch.clamp_min(arg_h, 0.0) > h_dry
    # the update: h_new = max(arg_h, 0), hu_new = wet ? hu - dt_dx div_hu : 0
    g_arg = _tie(arg_h, 0.0, gh_new)
    g_hun = torch.where(wet, ghu_new, torch.zeros_like(ghu_new))
    gdiv_h = -dt_dx * g_arg
    gdiv_hu = -dt_dx * g_hun
    # the divergences' transpose: each face's Fh, A (seen from its left
    # cell) and B (from its right cell)
    gFh = gdiv_h[:-1] - gdiv_h[1:]
    gA = gdiv_hu[:-1]
    gB = -gdiv_hu[1:]
    # each face's adjoint, into its left cell (ghL, guL) and right (ghR, guR)
    gFq = gA + gB
    ghL = g * hL * gA
    ghR = g * hR * gB
    ghsL = -(g * hsL * gA)
    ghsR = -(g * hsR * gB)
    ga = -0.5 * gFh * (hsR - hsL)
    gmL = 0.5 * gFh
    gmR = 0.5 * gFh
    ghsR = ghsR - 0.5 * a * gFh
    ghsL = ghsL + 0.5 * a * gFh
    hq = 0.5 * gFq
    gmL = gmL + hq * uL + 0.5 * a * gFq
    gmR = gmR + hq * uR - 0.5 * a * gFq
    guL = hq * mL
    guR = hq * mR
    ghsL = ghsL + hq * g * hsL
    ghsR = ghsR + hq * g * hsR
    ga = ga - 0.5 * gFq * (mR - mL)
    ghsL = ghsL + gmL * uL
    guL = guL + gmL * hsL
    ghsR = ghsR + gmR * uR
    guR = guR + gmR * hsR
    gcL = _tie(cL, cR, ga)
    gcR = _tie(cR, cL, ga)
    guL = guL + _abs_vjp(uL, gcL)
    guR = guR + _abs_vjp(uR, gcR)
    ghsL = ghsL + g * _sqrt_vjp(rL, gcL)
    ghsR = ghsR + g * _sqrt_vjp(rR, gcR)
    ghL = ghL + _tie(argL, 0.0, ghsL)
    ghR = ghR + _tie(argR, 0.0, ghsR)
    # each cell: the update's own term, its left face's (as that face's
    # right cell), its right face's, the walls' pressure
    gh = g_arg.clone()
    gh[1:] += ghR
    gh[:-1] += ghL
    gh[:1] += g * h[:1] * -gdiv_hu[:1]
    gh[-1:] += g * h[-1:] * gdiv_hu[-1:]
    gu = torch.zeros_like(h)
    gu[1:] = guR
    gu[:-1] += guL
    # the velocity u = sqrt2 h hu / sqrt(h^4 + max(h, h_dry)^4)
    gnum = gu / root
    groot = -(gu * u) / root
    ghu = g_hun + gnum * (_SQRT2 * h)
    gh = gh + gnum * hu * _SQRT2
    gsq = groot * 0.5 / root
    gh = gh + 2.0 * (2.0 * (gsq * h2) * h)
    ghm = 2.0 * (2.0 * (gsq * hm2) * hm)
    gh = gh + _tie(h, h_dry, ghm)
    return gh, ghu


def _buoy_vjp(gh, gmx, mx_before, eta, rows) -> torch.Tensor:
    """The running max mx' = max(mx, eta) at the buoy rows, transposed: adds
    each row's share of gmx (the cotangent of mx') to gh's row, in place,
    and returns mx's share (`torch.maximum`'s rule: 1/2 each at a tie)."""
    for r, row in enumerate(rows):
        gh[row] += _tie(eta[r], mx_before[r], gmx[r])
    return _tie(mx_before, eta, gmx)


def swe_solve_vjp_ref(
    h0: torch.Tensor,  # [C, N] the wave's initial depth
    hu0: torch.Tensor,  # [C, N] and momentum
    b: torch.Tensor,  # [C, 1]
    cot_mx: torch.Tensor,  # [R, N] cotangent of the running max
    *,
    dt_dx: float,
    n_steps: int,
    rows,
    h0_rows: torch.Tensor,  # [R]
    k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse mode of `swe_solve_ref`'s running max `mx` [R, N]: the
    cotangents (gh0, ghu0) of the initial state for the cotangent `cot_mx`
    of mx, in h0's dtype. The arrival index is piecewise constant and has
    no derivative. A forward keeps (h, hu, mx) every `k` steps (None:
    `checkpoint_every(n_steps)`); then the segments, last to first, are
    recomputed from their checkpoint and swept back step by step
    (`swe_step_vjp_ref`), the running max's reverse at the buoy rows first
    (`_buoy_vjp`). The plain version of csrc/swe_solve_vjp.cu, in its
    order."""
    k = checkpoint_every(n_steps) if k is None else int(k)
    if k < 1:
        raise ValueError(f"swe_solve_vjp_ref: k must be >= 1, got {k}")
    rows = [int(r) for r in rows]
    h0_buoy = h0_rows.to(h0.dtype).reshape(-1, 1)
    rows_t = torch.as_tensor(rows, device=h0.device)

    def step(h, hu, mx):
        h, hu = swe_step_ref(h, hu, b, dt_dx)
        eta = h.index_select(0, rows_t) - h0_buoy
        return h, hu, torch.maximum(mx, eta), eta

    checkpoints = []
    h, hu = h0, hu0
    mx = h0.new_full((len(rows), h0.shape[1]), -torch.inf)
    for s in range(n_steps):
        if s % k == 0:
            checkpoints.append((h, hu, mx))
        h, hu, mx, _ = step(h, hu, mx)
    gh, ghu = torch.zeros_like(h0), torch.zeros_like(hu0)
    gmx = cot_mx.to(h0.dtype).clone()
    for seg in range(len(checkpoints) - 1, -1, -1):
        h, hu, mx = checkpoints[seg]
        inputs = []
        for _ in range(seg * k, min(seg * k + k, n_steps)):
            h_in, hu_in, mx_in = h, hu, mx
            h, hu, mx, eta = step(h, hu, mx)
            inputs.append((h_in, hu_in, mx_in, eta))
        for h_in, hu_in, mx_in, eta in reversed(inputs):
            gh = gh.clone()
            gmx = _buoy_vjp(gh, gmx, mx_in, eta, rows)
            gh, ghu = swe_step_vjp_ref(h_in, hu_in, b, dt_dx, gh, ghu)
    return gh, ghu
