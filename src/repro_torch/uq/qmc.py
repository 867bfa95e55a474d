"""Sobol' sequences + QMC cubature (QMCPy's CubQMCSobolG analogue, §4.2).

Direction numbers: new-joe-kuo-6 table (Joe & Kuo 2008), first 21 dimensions
(enough for the paper's applications: 3-d defect UQ, 16-d L2-Sea inputs).
Randomization: digital (XOR) scrambling; replications give the CI used by
the doubling cubature.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# (s, a, [m_1..m_s]) for dimensions 2..21 (dim 1 uses the van der Corput base-2
# sequence). Source: new-joe-kuo-6.21201, Joe & Kuo (2008).
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
    (5, 11, [1, 1, 5, 1, 1]),
    (5, 13, [1, 1, 1, 3, 11]),
    (5, 14, [1, 3, 5, 5, 31]),
    (6, 1, [1, 3, 3, 9, 7, 49]),
    (6, 13, [1, 1, 1, 15, 21, 21]),
    (6, 16, [1, 3, 1, 13, 27, 49]),
    (6, 19, [1, 1, 1, 15, 7, 5]),
    (6, 22, [1, 3, 1, 15, 13, 25]),
    (6, 25, [1, 1, 5, 5, 19, 61]),
    (7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (7, 4, [1, 3, 7, 13, 13, 15, 69]),
]

MAX_DIM = len(_JOE_KUO) + 1
_NBITS = 30


def _direction_numbers(dim: int) -> np.ndarray:
    """V[dim, _NBITS] direction integers (scaled by 2^_NBITS)."""
    assert 1 <= dim <= MAX_DIM, f"sobol dims <= {MAX_DIM}"
    V = np.zeros((dim, _NBITS), dtype=np.int64)
    # first dimension: van der Corput
    for i in range(_NBITS):
        V[0, i] = 1 << (_NBITS - 1 - i)
    for d in range(1, dim):
        s, a, m = _JOE_KUO[d - 1]
        m = list(m)
        for i in range(min(s, _NBITS)):
            V[d, i] = m[i] << (_NBITS - 1 - i)
        for i in range(s, _NBITS):
            v = V[d, i - s] ^ (V[d, i - s] >> s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    v ^= V[d, i - k]
            V[d, i] = v
    return V


def sobol(n: int, dim: int, scramble_seed: int | None = None, skip: int = 0) -> np.ndarray:
    """First n points (after `skip`) of the Sobol' sequence in [0,1)^dim.
    Gray-code order; optional digital scramble (XOR with a random shift)."""
    V = _direction_numbers(dim)
    total = n + skip
    x = np.zeros(dim, dtype=np.int64)
    out = np.empty((total, dim), dtype=np.int64)
    for i in range(total):
        out[i] = x
        c = (~np.uint64(i) & np.uint64(i + 1)).item().bit_length() - 1  # rightmost zero bit of i
        c = min(c, _NBITS - 1)
        x = x ^ V[:, c]
    pts = out[skip:]
    if scramble_seed is not None:
        rng = np.random.default_rng(scramble_seed)
        shift = rng.integers(0, 1 << _NBITS, size=dim, dtype=np.int64)
        pts = pts ^ shift
    return (pts.astype(np.float64) + 0.5 * (scramble_seed is None)) / (1 << _NBITS)


@dataclass
class CubatureResult:
    mean: np.ndarray
    std_error: np.ndarray
    n_evals: int
    converged: bool
    history: list


def _as_batched(f, config: dict | None):
    """Accept an `EvaluationFabric` (or anything exposing `evaluate_batch`)
    wherever a bare batched callable was accepted."""
    if hasattr(f, "evaluate_batch"):
        return lambda X: f.evaluate_batch(X, config)
    return f


def cub_qmc_sobol(
    f,
    dim: int,
    abs_tol: float = 1e-3,
    n_init: int = 64,
    n_max: int = 2**16,
    replications: int = 8,
    seed: int = 7,
    config: dict | None = None,
) -> CubatureResult:
    """Doubling Sobol' cubature of E[f(U)] with replicated scrambles
    (CubQMCSobolG-style): doubles N until the replication CI < abs_tol.
    `f` maps [N, dim] -> [N, m] (batched — a callable, pool or
    `EvaluationFabric`; `config` is forwarded to a fabric).

    Each doubling evaluates ONLY the new half of every replication (the
    Sobol' sequence is extended via `skip` and the per-replication sums are
    reused) — model evaluations are the expensive resource, and recomputing
    the first n points on every doubling would exactly double their count.

    The stopping rule is the CI across replication means, so at least two
    replications are required: with one, the ddof=1 std is NaN and the
    driver would silently burn evaluations all the way to `n_max` with
    `se=NaN` in the result. Rejected up front instead.
    """
    if replications < 2:
        raise ValueError(
            f"replications must be >= 2 (got {replications}): the stopping "
            "criterion is the standard error ACROSS replication means"
        )
    eval_fn = _as_batched(f, config)
    n = n_init
    n_done = 0  # points already evaluated per replication
    sums = None  # [R, m] running sum of f over each replication's points
    history = []
    while True:
        for r in range(replications):
            u = sobol(n - n_done, dim, scramble_seed=seed + r, skip=n_done)
            y = np.atleast_2d(np.asarray(eval_fn(u)))
            # eval_fn contract is [N, dim] -> [N, m]. np.atleast_2d turns an
            # m-output 1-D return for a single point into [1, m] and a
            # scalar-output [N] return into [1, N]; only that second,
            # unambiguous case is transposed. Anything else is a genuine
            # contract violation — raising beats silently mangling outputs
            # (the old `if rows != N: y = y.T` heuristic flipped [N, m]
            # results whenever it happened that m == N).
            n_new = n - n_done
            if y.shape[0] != n_new:
                if y.shape == (1, n_new):
                    y = y.T
                else:
                    raise ValueError(
                        f"eval_fn returned shape {y.shape} for {n_new} "
                        f"points; expected [{n_new}, m]"
                    )
            if sums is None:
                sums = np.zeros((replications, y.shape[1]))
            sums[r] += y.sum(axis=0)
        n_done = n
        vals = sums / n  # [R, m] replication means
        mean = vals.mean(axis=0)
        se = vals.std(axis=0, ddof=1) / np.sqrt(replications)
        history.append((n * replications, mean.copy(), se.copy()))
        if np.all(se * 2.58 < abs_tol):  # 99% CI
            return CubatureResult(mean, se, n * replications, True, history)
        if n * 2 > n_max:
            return CubatureResult(mean, se, n * replications, False, history)
        n *= 2
