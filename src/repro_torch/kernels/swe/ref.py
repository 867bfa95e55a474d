"""Plain PyTorch version of the SWE step kernel.

One Rusanov / hydrostatic-reconstruction finite-volume step over a
``[cells, batch]`` state block, with the exact OPERATION ORDER of
`repro.kernels.swe.ref.swe_step_ref` in the JAX package: hydrostatic
reconstruction against the interface bathymetry (Audusse et al.,
well-balanced with wetting & drying), Rusanov flux, well-balanced momentum
corrections, reflective walls, positivity/dry-cell limiter. Integer powers
are written as products in the order `jax.lax.integer_pow` lowers them
(x**2 = x*x, x**4 = (x*x)*(x*x)), so on the CPU the two agree to rounding.

The CUDA kernel (`csrc/swe_step.cu`) repeats this arithmetic term by term;
`ops.swe_step` takes this version only for tensors on the CPU.
"""
from __future__ import annotations

import math

import torch

G = 9.81
H_DRY = 0.05
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
