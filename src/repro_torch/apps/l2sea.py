"""L2-Sea analogue (paper §4.1), in PyTorch: resistance-to-advancement
R_T(Froude, Draft).

Port of `repro.apps.l2sea`. The original L2-Sea model (Pellegrini et al.
2022) is a Fortran potential-flow solver for the DTMB 5415 hull; its
UM-Bridge container exposes 16 inputs (the first two being Froude number F
and draft D) and a `fidelity` config (1-7). This analogue reproduces the
interface and the response-surface character:
  * wave-making resistance with the classic hull-interference oscillation in
    1/F^2 (Havelock form), growing steeply with F,
  * wetted-surface / displacement effect of draft (D is negative: deeper
    draft -> more resistance),
  * `fidelity` controls a grid-refinement bias + cost, matching the paper's
    multi-fidelity setup (fidelity 7 coarsest ... 1 finest).
Outputs: [R_T] (kN). Inputs: 16 (14 hull-shape parameters fixed at 0, as in
the paper's snippet `inputs = @(y) [y' zeros(1,14)]`).

`L2SeaModel` is a `TorchModel`: all eight operations come from `resistance`
through `torch.func`, in float32, on the GPU unless `device="cpu"` is
passed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.interface import TorchModel

FROUDE_RANGE = (0.25, 0.41)
DRAFT_RANGE = (-6.776, -5.544)


def resistance(theta: torch.Tensor, fidelity: int = 7) -> torch.Tensor:
    """theta: [16] (F, D, 14 shape params). Returns [1] = R_T in kN, in
    theta's dtype."""
    F = theta[0]
    D = theta[1]
    shape_params = theta[2:]
    # draft factor: wetted surface ~ displacement^(2/3); D in [-6.776,-5.544]
    depth = -D / 6.16  # ~1 at nominal draft
    wetted = depth ** (2.0 / 3.0)
    # ITTC-style frictional part (weak F dependence)
    Rf = 18.0 * wetted * F**1.8
    # wave resistance: steep growth + hull interference oscillation in 1/F^2
    hump = torch.sin(0.65 / torch.clamp_min(F**2, 1e-3) + 0.4)
    Rw = 420.0 * wetted * F**4 * (1.0 + 0.35 * hump) / (1.0 + torch.exp(-(F - 0.31) / 0.02))
    # shape parameters perturb the hull (inactive in the paper's study)
    Rs = 0.5 * torch.sum(shape_params**2)
    # fidelity bias: coarser grids over-predict resistance (Richardson-like),
    # computed in theta's dtype as the JAX package computes it in float32
    fid = torch.tensor(float(fidelity), dtype=theta.dtype, device=theta.device)
    bias = 1.0 + 0.015 * (fid - 1.0)
    return torch.atleast_1d((Rf + Rw + Rs) * bias)


class L2SeaModel(TorchModel):
    """UM-Bridge model 'forward' with the original's config keys. Every
    wave (and every point call) sleeps `eval_cost_s` once, the emulated
    solver latency of the paper's cluster."""

    def __init__(self, eval_cost_s: float = 0.0, *, device=None):
        super().__init__(
            resistance,
            n_inputs=16,
            n_outputs=1,
            name="forward",
            config_keys=("fidelity",),
            defaults={"fidelity": 7},
            device=device,
        )
        self.eval_cost_s = eval_cost_s  # simulate the ~30s/eval of the paper

    def _cost(self):
        if self.eval_cost_s:
            time.sleep(self.eval_cost_s)

    def __call__(self, parameters, config=None):
        self._cost()
        return super().__call__(parameters, config)

    def evaluate_batch(self, thetas, config=None):
        # a whole wave costs ONE solver latency: the paper's cluster runs
        # its model instances concurrently, so wall time per wave is the
        # per-instance cost, not N x it (vs N sleeps on the per-point path)
        self._cost()
        return super().evaluate_batch(thetas, config)

    def gradient_batch(self, thetas, senss, config=None):
        # derivative waves pay the same one-latency-per-wave cost model:
        # the adjoint solve runs on the same (emulated) cluster instance
        self._cost()
        return super().gradient_batch(thetas, senss, config)

    def apply_jacobian_batch(self, thetas, vecs, config=None):
        self._cost()
        return super().apply_jacobian_batch(thetas, vecs, config)

    def value_and_gradient_batch(self, thetas, sens_fn, config=None):
        self._cost()
        return super().value_and_gradient_batch(thetas, sens_fn, config)


def make_inputs(y: np.ndarray) -> np.ndarray:
    """SGMK-snippet analogue: pad the 2 active params with 14 zeros."""
    y = np.atleast_2d(y)
    return np.concatenate([y, np.zeros((len(y), 14))], axis=1)
