"""Variance-based global sensitivity: Sobol' first/total-order indices.

Saltelli-style pick-freeze estimation riding the repo's doubling QMC
driver: one `(2*dim)`-dimensional scrambled Sobol' stream supplies the
(A, B) sample-pair matrices, each cubature point expands into the
`dim + 2` pick-freeze design rows (A, B, and AB_i — A with column i
replaced from B) which are evaluated in ONE batched wave, and
`cub_qmc_sobol` doubles N until the replication CIs on every estimated
moment (mean, second moment, and the per-input variance contributions)
drop below `abs_tol`. Estimators (Saltelli et al. 2010 / Jansen 1999):

    V_i = E[ f(B) (f(AB_i) - f(A)) ]          (first order, S_i = V_i / V)
    T_i = E[ (f(A) - f(AB_i))^2 ] / 2         (total order, ST_i = T_i / V)

Model evaluations are the expensive resource: the doubling reuses every
previously-evaluated point (the driver extends the Sobol' stream in
place), and the `dim + 2` design rows per point ride one wave through a
fabric's cache/router instead of `dim + 2` round-trips.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.uq.qmc import MAX_DIM, CubatureResult, cub_qmc_sobol


@dataclass
class SobolResult:
    first: np.ndarray  # [dim] first-order indices S_i
    total: np.ndarray  # [dim] total-order indices ST_i
    mean: float  # E[f]
    variance: float  # Var[f]
    n_evals: int  # model evaluations (all pick-freeze rows)
    converged: bool
    cubature: CubatureResult  # raw moment estimates + per-doubling history


def sobol_indices(
    f,
    dim: int,
    *,
    transform=None,
    qoi=None,
    abs_tol: float = 1e-3,
    n_init: int = 64,
    n_max: int = 2**14,
    replications: int = 8,
    seed: int = 7,
    config: dict | None = None,
) -> SobolResult:
    """First/total-order Sobol' indices of a scalar QoI of `f` over the
    unit hypercube `[0,1)^dim` (use `transform(u) -> theta` to map onto
    the model's parameter box).

    `f` is anything `cub_qmc_sobol` accepts — a batched `[N, d] -> [N, m]`
    callable, a pool, or an `EvaluationFabric` (`config` forwarded); `qoi`
    reduces an output row to the scalar under study (default: first
    output). Needs `2*dim` Sobol' dimensions, so `dim <= {half_max}`.
    Convergence (`abs_tol`, via the replication CI) is on the RAW moment
    estimates; the indices are smooth functions of those moments, so their
    error is of the same order once the variance is not tiny.
    """
    if not (1 <= dim and 2 * dim <= MAX_DIM):
        raise ValueError(
            f"sobol_indices needs 2*dim <= {MAX_DIM} sequence dimensions "
            f"(got dim={dim})"
        )
    if hasattr(f, "evaluate_batch"):
        fabric = f

        def eval_rows(X):
            return np.atleast_2d(np.asarray(fabric.evaluate_batch(X, config), float))
    else:
        def eval_rows(X):
            return np.atleast_2d(np.asarray(f(X), float))

    if qoi is None:
        def qoi(row):  # noqa: ANN001
            return row[0]
    counter = {"evals": 0}

    def integrand(u: np.ndarray) -> np.ndarray:
        """[N, 2*dim] cubature points -> [N, 2*dim + 2] moment rows."""
        u = np.atleast_2d(u)
        N = len(u)
        A, B = u[:, :dim], u[:, dim:]
        # pick-freeze design: A, B, then AB_i for each input — stacked into
        # ONE [(dim + 2) * N, dim] wave (never dim + 2 separate dispatches)
        blocks = [A, B]
        for i in range(dim):
            ABi = A.copy()
            ABi[:, i] = B[:, i]
            blocks.append(ABi)
        X = np.concatenate(blocks, axis=0)
        if transform is not None:
            X = np.atleast_2d(np.asarray(transform(X), float))
        ys = eval_rows(X)
        counter["evals"] += len(X)
        q = np.asarray([float(qoi(row)) for row in ys])
        fA, fB = q[:N], q[N : 2 * N]
        out = np.empty((N, 2 * dim + 2))
        out[:, 0] = fA
        out[:, 1] = fA * fA
        for i in range(dim):
            fABi = q[(2 + i) * N : (3 + i) * N]
            out[:, 2 + i] = fB * (fABi - fA)  # -> V_i
            out[:, 2 + dim + i] = 0.5 * (fA - fABi) ** 2  # -> T_i
        return out

    cub = cub_qmc_sobol(
        integrand, 2 * dim, abs_tol=abs_tol, n_init=n_init, n_max=n_max,
        replications=replications, seed=seed,
    )
    mean = float(cub.mean[0])
    variance = float(cub.mean[1] - mean * mean)
    V_i = np.asarray(cub.mean[2 : 2 + dim])
    T_i = np.asarray(cub.mean[2 + dim : 2 + 2 * dim])
    if variance <= 0:
        raise ValueError(
            f"estimated output variance is {variance:.3e} <= 0 — the QoI "
            "is (numerically) constant, Sobol' indices are undefined"
        )
    return SobolResult(
        first=V_i / variance,
        total=T_i / variance,
        mean=mean,
        variance=variance,
        n_evals=counter["evals"],
        converged=cub.converged,
        cubature=cub,
    )


sobol_indices.__doc__ = sobol_indices.__doc__.format(half_max=MAX_DIM // 2)
