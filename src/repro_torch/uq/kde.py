"""Gaussian kernel density estimation (Matlab ksdensity analogue, §4.1).

Supports 'positive' support via log transform — the paper's
    ksdensity(evals, 'support','positive', 'Bandwidth',0.1)
call maps to  kde(evals, support="positive", bandwidth=0.1).
"""
from __future__ import annotations

import numpy as np


def silverman_bandwidth(x: np.ndarray) -> float:
    n = len(x)
    sig = min(np.std(x, ddof=1), (np.percentile(x, 75) - np.percentile(x, 25)) / 1.349)
    return 0.9 * sig * n ** (-1 / 5)


def kde(
    samples: np.ndarray,
    points: np.ndarray | None = None,
    bandwidth: float | None = None,
    support: str = "unbounded",
    n_points: int = 200,
):
    """Returns (pdf_values, points)."""
    x = np.asarray(samples, float).ravel()
    if support == "positive":
        assert np.all(x > 0), "positive support requires positive samples"
        y = np.log(x)
    else:
        y = x
    h = bandwidth if bandwidth is not None else silverman_bandwidth(y)
    if points is None:
        lo, hi = y.min() - 3 * h, y.max() + 3 * h
        q = np.linspace(lo, hi, n_points)
    else:
        points = np.asarray(points, float).ravel()
        q = np.log(points) if support == "positive" else points
    z = (q[:, None] - y[None, :]) / h
    dens = np.exp(-0.5 * z**2).sum(axis=1) / (len(y) * h * np.sqrt(2 * np.pi))
    if support == "positive":
        pts = np.exp(q)
        dens = dens / pts  # Jacobian of the log transform
    else:
        pts = q
    return dens, pts
