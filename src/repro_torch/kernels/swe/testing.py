"""Inputs and the check that hold the SWE step kernel against its plain
version. `chip_smoke.py` and the port's tests both use them, so the card and
the test suite run the same cases against the same bound.

The bound is bit equality. The kernel repeats the plain version's
operations term by term and in the same order. It is compiled with
`-fmad=false`, so no multiply-add is contracted, and it uses IEEE division
and square root. The plain version runs one PyTorch operation per kernel.
Nothing can therefore round differently, and on an H100 every case and
shape has measured 0 ulp (PERF.md). A looser bound would be blind where it
matters: at the main path's ~4,000 m depths one float32 ulp of `h` is
2.4e-4 m, which is more than a mass flux that is 1% wrong moves `h` in one
step. Only an exact comparison sees such a fault there
(tests/test_torch_swe.py checks that it does).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.tsunami import L_DOMAIN, initial_state, level_grid
from repro_torch.convert import swe_state_from_numpy
from repro_torch.kernels.swe.ref import swe_step_ref

#: the `_swe_state` cases of the JAX package's tests/test_kernels.py
SWE_KINDS = ("lake_at_rest", "dam_break", "dry_bed", "moving")
#: dt/dx of one step of those cases
CASE_DT_DX = 0.02
#: [cells, lanes] of the steps the main path runs: both published levels,
#: waves of the campaign's 16 chains, the narrower waves left after cache
#: hits, and 64 lanes
MAIN_PATH_SHAPES = tuple((C, N) for C in (512, 2048) for N in (4, 8, 16, 64))
#: every case of the check, by name
CASES = (*SWE_KINDS, *(f"main_{C}x{N}" for C, N in MAIN_PATH_SHAPES))
#: the §4.3 campaign's uniform prior box: x0 [km], amplitude [m]
SOURCE_BOX = ((30.0, 150.0), (0.5, 4.0))


def swe_state(kind: str, C: int = 48, N: int = 32):
    """[cells, batch] float32 numpy states that exercise the limiter
    branches: the `_swe_state` cases of the JAX package's tests."""
    x = np.linspace(0.0, 1.0, C)[:, None]
    batch = 1.0 + 0.1 * np.arange(N)[None, :] / N
    b = 0.1 * np.sin(3 * np.pi * x[:, 0])[:, None]  # [C, 1] bathymetry
    if kind == "lake_at_rest":
        h = np.maximum(0.8 - b, 0.0) * np.ones((1, N))
        hu = np.zeros((C, N))
    elif kind == "dam_break":
        h = np.where(x < 0.5, 1.2, 0.4) * batch
        hu = np.zeros((C, N))
    elif kind == "dry_bed":
        h = np.where(x < 0.5, 0.6 * batch, 1e-4)
        hu = np.where(x < 0.5, 0.05 * batch, 0.0)
    elif kind == "moving":
        h = 0.7 + 0.2 * np.sin(2 * np.pi * x) * batch
        hu = 0.1 * np.cos(2 * np.pi * x) * batch
    else:
        raise ValueError(f"unknown SWE case {kind!r}; expected one of {SWE_KINDS}")
    return (np.asarray(h, np.float32), np.asarray(hu, np.float32),
            np.asarray(b, np.float32))


def sources(n: int, seed: int) -> np.ndarray:
    """[n, 2] float32 tsunami sources drawn uniformly from the prior box."""
    rng = np.random.default_rng(seed)
    (x_lo, x_hi), (a_lo, a_hi) = SOURCE_BOX
    return np.stack(
        [rng.uniform(x_lo, x_hi, n), rng.uniform(a_lo, a_hi, n)], axis=1
    ).astype(np.float32)


def main_path_state(n_cells: int, N: int, device) -> tuple:
    """(h, hu, b, dt_dx) of N real sources on the published `n_cells` grid,
    20 plain steps in, so that `hu` is non-zero wherever the wave is."""
    device = torch.device(device)
    h, hu, b = initial_state(
        torch.as_tensor(sources(N, 7), device=device), n_cells,
        smoothed=(n_cells == 512),
    )
    dt_dx = level_grid(n_cells)[0] / (L_DOMAIN / n_cells)
    for _ in range(20):
        h, hu = swe_step_ref(h, hu, b, dt_dx)
    return h.contiguous(), hu.contiguous(), b, dt_dx


def case_inputs(case: str, device) -> tuple:
    """(h, hu, b, dt_dx) of one entry of `CASES` on `device`."""
    if case.startswith("main_"):
        C, N = (int(v) for v in case[len("main_"):].split("x"))
        return main_path_state(C, N, device)
    return (*swe_state_from_numpy(*swe_state(case), device), CASE_DT_DX)


def step_errors(got: torch.Tensor, want: torch.Tensor, old: torch.Tensor) -> dict:
    """How far the float32 step result `got` lies from `want`: the largest
    absolute and relative errors, the largest in units of the float32
    spacing at the larger of the old and the new value, and the step's own
    largest change |want - old|, which puts the error in scale."""
    scale = torch.maximum(old.abs(), want.abs()).float()
    spacing = (torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale).double()
    err = (got.double() - want.double()).abs()
    return {
        "max_abs": float(err.max()),
        "max_rel": float((err / want.double().abs().clamp_min(1e-30)).max()),
        "max_ulp": float((err / spacing).max()),
        "max_change": float((want.double() - old.double()).abs().max()),
    }


def assert_step_equal(got: tuple, want: tuple, old: tuple, what: str) -> dict:
    """Hold one step's `got = (h_new, hu_new)` to `want` bit for bit; `old`
    is the step's input `(h, hu)`. Returns `step_errors` for h and hu and
    raises AssertionError, naming the array, if either differs."""
    report = {}
    for key, g, w, o in zip(("h", "hu"), got, want, old):
        report[key] = step_errors(g, w, o)
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(
                f"{what}, {key}: the kernel differs from the plain version: "
                f"{report[key]}"
            )
    return report
