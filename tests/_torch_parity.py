"""Shared helpers of the PyTorch-port parity tests (`test_torch_*.py`).

Inputs are built with numpy and handed to both packages, so the JAX
reference and the port see the same numbers; the SWE cases themselves live
in `repro_torch.kernels.swe.testing`, which chip_smoke.py uses too. Whether
a GPU is present is decided inside a test (`cuda_or_skip`), never at import
time, so every xdist worker collects the same tests.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import pytest
import torch

# single-step bounds of the port's plain version against the JAX oracle:
# the JAX package's own kernel-vs-oracle tolerances (tests/test_kernels.py);
# the slack covers FMA contraction and the rounding of sqrt and division on
# another compiler
STEP_TOL_H = dict(rtol=1e-4, atol=1e-6)
STEP_TOL_HU = dict(rtol=1e-4, atol=1e-4)

# Full-solve bounds: the ones the JAX package holds its own two orderings of
# this solver to (tests/test_batch_native.py). The plain step agrees with
# the JAX oracle to within about one ulp, but XLA also contracts
# multiply-adds inside the jitted scan, and float32 drift over 2,224 / 8,899
# nonlinear steps turns those ulps into the deviations
# tests/test_torch_tsunami.py prints (`-s`) on `SOLVE_THETAS`: coarse 0.019
# min (one step) / 1.0e-3, fine 0.024 min / 8.2e-3 (arrival / max height,
# PERF.md). The coarse height bound is tightened to 5e-3 (5x the
# measurement); the fine level keeps the reference's bounds, since its
# arrival deviation is already half of 0.05 min.
SOLVE_TOL = {0: dict(arrival=0.05, height_rtol=5e-3),
             1: dict(arrival=0.05, height_rtol=5e-2)}
#: the four sources those deviations were measured on: (x0 [km], A [m])
_RNG = np.random.default_rng(42)
SOLVE_THETAS = np.stack(
    [_RNG.uniform(40.0, 140.0, 4), _RNG.uniform(0.8, 3.5, 4)], axis=1
).astype(np.float32)
#: bound on a fitted GP's predictive mean and sd against another fit of the
#: same data (the JAX package's, or the port's on another device), in units
#: of y's standard deviation. Two float32 Adam trajectories drift apart:
#: measured against the JAX package (CPU, tests/test_torch_gp.py's four
#: sets) up to 6.4e-4 for the mean and 3.8e-4 for the sd, with the
#: hyperparameters up to 4.2e-3 apart. chip_smoke.py holds the card's fit
#: to the CPU's with the same bound.
FIT_TOL = 2e-3
#: relative bound of an unpadded LM wave against the padded wave of the same
#: points: the GEMMs of another row count may block, and so sum, differently
UNPADDED_RTOL = 1e-6


def grid_wave_unpadded_vs_padded(pm, level: int = 2):
    """The level-`level` sparse grid of `pm` (an `LMUQModel`) over
    [0.7, 1.3]^2 through `EvaluationFabric(ModelBackend(pm))`, and the same
    points as one wave padded to the next power of two by repeating the
    last point, as the JAX package pads: (grid values, padded wave's values
    of the real points, the fabric's backend telemetry)."""
    from repro_torch.core.fabric import EvaluationFabric, ModelBackend
    from repro_torch.core.interface import next_pow2, pad_to_bucket
    from repro_torch.uq import sparse_grid as sg

    reduced = sg.reduce_sparse_grid(
        sg.smolyak_grid(2, level, [sg.knots_uniform_leja(0.7, 1.3)] * 2))
    fabric = EvaluationFabric(ModelBackend(pm))
    try:
        got = sg.evaluate_on_sparse_grid(fabric, reduced)
        backend = fabric.telemetry()["backend"]
    finally:
        fabric.shutdown()
    n = len(reduced.points)
    padded, _ = pad_to_bucket(np.asarray(reduced.points, float), next_pow2(n))
    return got, pm.evaluate_batch(padded)[:n], backend


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


@contextmanager
def serving(serve_models, *models):
    """Serve `models` with `serve_models` (either package's) on a free port
    (the server binds port 0 and the bound port is read back, so files that
    run side by side never collide); yields the server's URL."""
    server, _ = serve_models(list(models), 0, background=True)
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
