"""Smolyak sparse grids (the paper's SGMK analogue, §4.1).

Implements the SGMK workflow used in the L2-Sea application:
  knots_triangular_leja / knots_beta_leja / knots_uniform_leja / knots_cc
      -> nested 1-D node families (weighted Leja sequences computed by the
         classic greedy max-product rule; Clenshaw-Curtis for reference)
  smolyak_grid(N, w, knot_fns)       -> combination-technique tensor grids
  reduce_sparse_grid(S)              -> deduplicated evaluation points
  evaluate_on_sparse_grid(f, Sr, old) -> model evals with NESTED REUSE
      (only new points are evaluated — the paper's 36/121/256 progression)
  interpolate_on_sparse_grid(S, Sr, vals, x) -> barycentric tensor interpolation
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from itertools import product as iproduct
from typing import Callable, Sequence

import numpy as np

from repro_torch.uq.distributions import Beta, Distribution, Normal, Triangular, Uniform

# ---------------------------------------------------------------------------
# 1-D nested knot families
# ---------------------------------------------------------------------------


def leja_sequence(weight_fn: Callable, lo: float, hi: float, n: int, n_grid: int = 4001) -> np.ndarray:
    """Weighted Leja points: x_{k+1} = argmax_x sqrt(w(x)) prod_j |x - x_j|.
    Greedy on a fine candidate grid; log-domain for stability. Nested by
    construction (SGMK's *_leja knot families)."""
    xs = np.linspace(lo, hi, n_grid)
    w = np.asarray(weight_fn(xs), float)
    w = np.clip(w, 1e-300, None)
    logw = 0.5 * np.log(w)
    # start at the weighted "center of mass" argmax of the weight
    pts = [xs[int(np.argmax(logw))]]
    logprod = np.log(np.abs(xs - pts[0]) + 1e-300)
    while len(pts) < n:
        score = logw + logprod
        k = int(np.argmax(score))
        pts.append(xs[k])
        logprod += np.log(np.abs(xs - xs[k]) + 1e-300)
    return np.array(pts)


def lev2knots_leja(level: int) -> int:
    """SGMK 'lev2knots_2step' growth for Leja: m(i) = 2i - 1."""
    return 2 * level - 1


def lev2knots_cc(level: int) -> int:
    """Clenshaw-Curtis doubling: m(1)=1, m(i)=2^(i-1)+1."""
    return 1 if level == 1 else 2 ** (level - 1) + 1


def make_leja_knots(dist: Distribution, n_max: int = 64) -> Callable[[int], np.ndarray]:
    lo, hi = dist.support()
    seq = leja_sequence(dist.pdf, lo, hi, n_max)

    def knots(n: int) -> np.ndarray:
        assert n <= n_max
        return seq[:n]

    return knots


def knots_triangular_leja(a: float, b: float, n_max: int = 64):
    return make_leja_knots(Triangular(a, b), n_max)


def knots_beta_leja(alpha: float, beta: float, a: float, b: float, n_max: int = 64):
    return make_leja_knots(Beta(alpha, beta, a, b), n_max)


def knots_uniform_leja(a: float, b: float, n_max: int = 64):
    return make_leja_knots(Uniform(a, b), n_max)


def knots_normal_leja(mu: float, sigma: float, n_max: int = 64):
    return make_leja_knots(Normal(mu, sigma), n_max)


def knots_cc(a: float, b: float) -> Callable[[int], np.ndarray]:
    def knots(n: int) -> np.ndarray:
        if n == 1:
            return np.array([(a + b) / 2])
        k = np.arange(n)
        x = np.cos(np.pi * k / (n - 1))[::-1]
        return (a + b) / 2 + (b - a) / 2 * x

    return knots


# ---------------------------------------------------------------------------
# Smolyak construction (combination technique)
# ---------------------------------------------------------------------------


@dataclass
class TensorGrid:
    levels: tuple[int, ...]
    coeff: int
    knots: list[np.ndarray]  # per-dim 1-D nodes
    points: np.ndarray  # [n_pts, d] cartesian product
    idx_in_reduced: np.ndarray | None = None


@dataclass
class SparseGrid:
    dim: int
    w: int
    tensor_grids: list[TensorGrid]
    knot_fns: list[Callable]
    lev2knots: Callable


@dataclass
class ReducedGrid:
    points: np.ndarray  # [n, d] unique evaluation points


def _total_degree_set(dim: int, w: int):
    """{i in N^dim, i_j >= 1 : sum(i_j - 1) <= w}"""

    def rec(prefix, remaining, dims_left):
        if dims_left == 1:
            for k in range(remaining + 1):
                yield (*prefix, k + 1)
            return
        for k in range(remaining + 1):
            yield from rec((*prefix, k + 1), remaining - k, dims_left - 1)

    yield from rec((), w, dim)


def smolyak_grid(
    dim: int,
    w: int,
    knot_fns: Sequence[Callable],
    lev2knots: Callable = lev2knots_leja,
) -> SparseGrid:
    idx_set = set(_total_degree_set(dim, w))
    grids = []
    for idx in sorted(idx_set):
        # combination coefficient: sum over binary e with idx+e in set
        coeff = 0
        for e in iproduct((0, 1), repeat=dim):
            if tuple(i + ei for i, ei in zip(idx, e)) in idx_set:
                coeff += (-1) ** sum(e)
        if coeff == 0:
            continue
        knots = [np.asarray(knot_fns[j](lev2knots(idx[j]))) for j in range(dim)]
        mesh = np.meshgrid(*knots, indexing="ij")
        pts = np.stack([m.ravel() for m in mesh], axis=1)
        grids.append(TensorGrid(idx, coeff, knots, pts))
    return SparseGrid(dim, w, grids, list(knot_fns), lev2knots)


def reduce_sparse_grid(S: SparseGrid, tol: float = 1e-12) -> ReducedGrid:
    """Unique points across tensor grids; fills idx_in_reduced per grid."""
    all_pts = np.concatenate([g.points for g in S.tensor_grids], axis=0)
    # quantize for tolerance-robust dedup
    scale = np.maximum(np.abs(all_pts).max(axis=0), 1.0)
    keys = np.round(all_pts / scale / tol).astype(np.int64)
    _, uniq_idx, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    reduced = all_pts[uniq_idx]
    ofs = 0
    for g in S.tensor_grids:
        n = len(g.points)
        g.idx_in_reduced = inverse[ofs : ofs + n]
        ofs += n
    return ReducedGrid(reduced)


def evaluate_on_sparse_grid(
    f: Callable,
    Sr: ReducedGrid,
    previous: tuple[ReducedGrid, np.ndarray] | None = None,
    tol: float = 1e-12,
    config: dict | None = None,
) -> np.ndarray:
    """Evaluate f (batched: [N,d] -> [N,m]) on the reduced points, reusing
    evaluations from a previous (nested) grid — SGMK's recycling feature.
    `f` may be a bare callable, a pool, or an `EvaluationFabric` (anything
    exposing `evaluate_batch`; `config` is forwarded to it)."""
    if hasattr(f, "evaluate_batch"):
        fab = f
        f = lambda X: fab.evaluate_batch(X, config)
    pts = Sr.points
    if previous is None:
        return np.atleast_2d(np.asarray(f(pts)))
    old_grid, old_vals = previous
    old_vals = np.atleast_2d(np.asarray(old_vals))
    scale = np.maximum(
        np.maximum(np.abs(pts).max(axis=0), np.abs(old_grid.points).max(axis=0)), 1.0
    )
    old_keys = {tuple(k) for k in np.round(old_grid.points / scale / tol).astype(np.int64)}
    key_to_old = {
        tuple(k): i
        for i, k in enumerate(np.round(old_grid.points / scale / tol).astype(np.int64))
    }
    keys = np.round(pts / scale / tol).astype(np.int64)
    new_mask = np.array([tuple(k) not in old_keys for k in keys])
    m = old_vals.shape[1]
    vals = np.empty((len(pts), m))
    if new_mask.any():
        vals[new_mask] = np.atleast_2d(np.asarray(f(pts[new_mask])))
    for i, k in enumerate(keys):
        if not new_mask[i]:
            vals[i] = old_vals[key_to_old[tuple(k)]]
    return vals


def _barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    n = len(nodes)
    w = np.ones(n)
    for j in range(n):
        diff = nodes[j] - np.delete(nodes, j)
        w[j] = 1.0 / np.prod(diff)
    return w


def _lagrange_basis(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """[Nq, m] Lagrange basis values via barycentric form."""
    if len(nodes) == 1:
        return np.ones((len(x), 1))
    w = _barycentric_weights(nodes)
    diff = x[:, None] - nodes[None, :]  # [Nq, m]
    exact = np.isclose(diff, 0.0, atol=1e-14)
    diff = np.where(exact, 1.0, diff)
    terms = w[None, :] / diff
    denom = terms.sum(axis=1, keepdims=True)
    basis = terms / denom
    # exact hits: basis = one-hot
    hit_rows = exact.any(axis=1)
    basis[hit_rows] = exact[hit_rows].astype(float)
    return basis


def interpolate_on_sparse_grid(
    S: SparseGrid, Sr: ReducedGrid, values: np.ndarray, x: np.ndarray
) -> np.ndarray:
    """Evaluate the sparse-grid surrogate at query points x [Nq, d].
    values: [n_reduced, m] model outputs on the reduced grid."""
    values = np.atleast_2d(np.asarray(values))
    if values.shape[0] != len(Sr.points):
        values = values.T
    x = np.atleast_2d(np.asarray(x, float))
    Nq, m = len(x), values.shape[1]
    out = np.zeros((Nq, m))
    for g in S.tensor_grids:
        shape = tuple(len(k) for k in g.knots)
        vals = values[g.idx_in_reduced].reshape(*shape, m)  # tensor values
        # contract dim-by-dim with 1-D Lagrange bases
        cur = vals  # [m1, ..., md, m]
        for j in range(S.dim):
            basis = _lagrange_basis(g.knots[j], x[:, j])  # [Nq, mj]
            # cur: [mj, rest..., m] (+ leading Nq after first contraction)
            if j == 0:
                cur = np.tensordot(basis, cur, axes=(1, 0))  # [Nq, rest..., m]
            else:
                cur = np.einsum("qj,qj...->q...", basis, cur)
        out += g.coeff * cur
    return out
