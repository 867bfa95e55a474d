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

On the GPU a whole wave, every time step and the buoy reduction, is ONE
launch of the hand-written SWE solve kernel (`repro_torch.kernels.swe.
swe_solve`); on the CPU the same wave runs its plain PyTorch loop. The
per-point time-series path (`_simulate`/`observables` in the JAX package)
and the derivative surface are not ported yet (ROADMAP queue 1, items 3 and
6): a point is solved as a wave of one.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.analysis.races import named_lock
from repro_torch.core.device import resolve_device
from repro_torch.core.interface import Capabilities, Model, next_pow2, pad_to_bucket
from repro_torch.kernels.swe import swe_solve, swe_solve_ref
from repro_torch.kernels.swe.ref import G, H_DRY

L_DOMAIN = 400e3  # m
T_END = 2600.0  # s
BUOYS_KM = (150.0, 250.0)

#: smallest wave the solver runs: waves are padded to next_pow2(max(N, 4))
_WAVE_MIN = 4


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


def level_grid(n_cells: int) -> tuple[float, int, tuple[int, ...]]:
    """(dt, n_steps, buoy rows) of the explicit solve on `n_cells` cells."""
    dx = L_DOMAIN / n_cells
    c_max = float(np.sqrt(G * 4100.0))
    dt = 0.3 * dx / c_max
    return dt, int(T_END / dt), tuple(int(bk * 1e3 / dx) for bk in BUOYS_KM)


def initial_state(
    thetas: torch.Tensor, n_cells: int, smoothed: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, 2] sources -> (h, hu: [C, N], b: [C, 1]) float32 on thetas' device."""
    device = thetas.device
    dx = L_DOMAIN / n_cells
    x = torch.as_tensor(
        ((np.arange(n_cells) + 0.5) * dx).astype(np.float32), device=device
    )[:, None]
    b = torch.as_tensor(_bathymetry_cached(n_cells, smoothed), device=device)[:, None]
    h0s = torch.clamp_min(-b, 0.0)
    x0 = thetas[None, :, 0] * 1e3  # [1, N]
    amp = thetas[None, :, 1]
    z = (x - x0) / 25e3
    eta0 = amp * torch.exp(-(z * z))  # [C, N]
    h = torch.clamp_min(h0s + eta0 * (h0s > H_DRY), 0.0)
    return h.contiguous(), torch.zeros_like(h), b.contiguous()


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
    the solve kernel against the plain version and the step kernel."""
    dt, n_steps, buoy_rows = level_grid(n_cells)
    dt_dx = dt / (L_DOMAIN / n_cells)
    h, hu, b = initial_state(thetas.to(torch.float32), n_cells, smoothed)
    N = h.shape[1]
    h0_rows = torch.clamp_min(-b, 0.0)[list(buoy_rows), 0]  # [2] depth at rest
    kw = dict(dt_dx=dt_dx, n_steps=n_steps, rows=buoy_rows, h0_rows=h0_rows)
    if step is None:
        mx, arr = swe_solve(h, hu, b, **kw)
    else:
        mx, arr = swe_solve_ref(h, hu, b, step=step, **kw)
    arrival = torch.where(arr >= 0, arr * (dt / 60.0), T_END / 60.0)
    # [2, N] obs pairs -> [N, 4] rows [a1, h1, a2, h2]
    return torch.stack([arrival, mx], dim=2).transpose(0, 1).reshape(N, 4)


class TsunamiModel(Model):
    """UM-Bridge model: theta=(x0_km, amplitude_m) -> 4 observables.
    config: {"level": 0 (coarse/smoothed, default) | 1 (fully resolved)}.

    Runs on `device` (default: the GPU; raises if there is none). Native
    batched evaluate: a wave of N sources is padded to a power of two and
    solved as ONE lockstep wave on the device: on the GPU, one launch of the
    SWE solve kernel."""

    N_CELLS = {0: 512, 1: 2048}
    # pads internally (see evaluate_batch) — dispatcher-level pow2 padding
    # would only add wasted solves on top
    batch_bucket = False

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
        # the derivative surface is ROADMAP queue 1, item 6
        return Capabilities(evaluate=True, evaluate_batch=True)

    def __call__(self, parameters, config=None):
        theta = np.asarray(parameters[0], float)
        return [list(map(float, self.evaluate_batch(theta[None, :], config)[0]))]

    def evaluate_batch(self, thetas, config=None) -> np.ndarray:
        """[N, 2] -> [N, 4] float64: one lockstep solve of the whole wave,
        padded to next_pow2(max(N, 4)) lanes by repeating the last source."""
        level = int((config or {}).get("level", 0))
        n_cells, smoothed = self.N_CELLS[level], (level == 0)
        thetas = np.atleast_2d(np.asarray(thetas, np.float32))
        N = len(thetas)
        with self._lock:
            self.stats[level] += N
            self.waves[level] += 1
        padded, _ = pad_to_bucket(thetas, next_pow2(max(N, _WAVE_MIN)))
        out = solve_batch(torch.as_tensor(padded, device=self.device), n_cells, smoothed)
        return out.cpu().numpy().astype(float)[:N]


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
