"""Plain Monte Carlo estimation through a (pooled) model."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MCResult:
    mean: np.ndarray
    std: np.ndarray
    std_error: np.ndarray
    n: int
    samples: np.ndarray


def monte_carlo(f, sampler, n: int, rng: np.random.Generator | None = None, batch: int = 0) -> MCResult:
    """f: [N,d] -> [N,m] batched model (e.g. ModelPool); sampler(rng, n) -> [n,d]."""
    rng = rng or np.random.default_rng(0)
    thetas = np.atleast_2d(sampler(rng, n))
    if batch:
        outs = [np.atleast_2d(f(thetas[i : i + batch])) for i in range(0, n, batch)]
        ys = np.concatenate(outs, axis=0)
    else:
        ys = np.atleast_2d(np.asarray(f(thetas)))
    if ys.shape[0] != n:
        ys = ys.T
    return MCResult(
        ys.mean(axis=0), ys.std(axis=0, ddof=1), ys.std(axis=0, ddof=1) / np.sqrt(n), n, ys
    )
