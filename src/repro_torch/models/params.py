"""Declarative parameter trees (counterpart of `repro.models.params`).

Modules *declare* parameters (shape, initializer) as a nested dict/list of
`ParamDecl`; `materialize` turns a declaration tree into tensors and
`count_params` counts it without allocating. `stack(tree, n)` prepends a
layer dimension to every leaf. `tree_leaves`, `tree_leaves_with_path` and
`tree_map` walk any tree of parameters, gradients or moments in
`jax.tree.flatten`'s order (dict keys sorted), which the optimizer's sums
and the checkpoint format follow.

Each declaration carries the JAX package's `PartitionSpec` (the layout on a
device mesh: FSDP over 'data', TP and EP over 'model'). Three more
interpreters read it: `specs(tree)` (the spec tree), `abstract(tree, dtype)`
(meta tensors of each leaf's shape and dtype: the dry run's stand-ins,
which allocate nothing) and `shard(params, spec_tree, ctx)` (full weights,
identical on every rank, as DTensors on the mesh).

The initial distributions are the JAX package's, but torch's generator
draws other numbers than `jax.random`: the parity tests carry weights across
with `repro_torch.convert.lm_params_from_numpy`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import P, sanitized_shardings
from repro_torch.types import dtype_of


@dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    spec: P = P()
    init: str = "normal"  # normal | zeros | ones | embed | a_log | dt_bias
    scale: float | None = None  # stddev for normal; None -> 1/sqrt(fan_in)
    dtype: str | None = None  # override the model param dtype (e.g. float32)
    fan_in_axis: int = -2  # axis used for default fan-in scaling


def _uniform(shape, gen: torch.Generator, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return u * (hi - lo) + lo


def _normal(shape, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def _init_leaf(decl: ParamDecl, gen: torch.Generator, default_dtype: torch.dtype) -> torch.Tensor:
    dtype = dtype_of(decl.dtype) if decl.dtype else default_dtype
    shape, device = decl.shape, gen.device
    if decl.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if decl.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if decl.init == "a_log":  # mamba: A in [1, 16), stored as log
        return torch.log(_uniform(shape, gen, 1.0, 16.0)).to(dtype)
    if decl.init == "dt_bias":  # mamba: inverse-softplus of dt ~ U[1e-3, 1e-1]
        dt = torch.exp(
            _uniform(shape, gen) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)
        )
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if decl.init == "embed":
        return (_normal(shape, gen) * 0.02).to(dtype)
    # normal with fan-in scaling
    if decl.scale is not None:
        std = decl.scale
    elif len(shape) == 1:
        std = 0.02
    else:
        std = 1.0 / math.sqrt(shape[decl.fan_in_axis])
    return (_normal(shape, gen) * std).to(dtype)


def walk(tree: Any, fn: Callable[[ParamDecl, str], Any], path: str = "") -> Any:
    """Map `fn(leaf, path)` over every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: walk(v, fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [walk(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, path)


def materialize(tree: Any, gen: torch.Generator, dtype: torch.dtype) -> Any:
    """Tensors for every declaration, on `gen.device`, drawn from `gen` in
    the tree's (deterministic) order: the same seed gives the same weights."""
    return walk(tree, lambda d, _p: _init_leaf(d, gen, dtype))


def abstract(tree: Any, dtype: torch.dtype) -> Any:
    """Meta tensors of every declaration's shape and dtype (the JAX
    package's `ShapeDtypeStruct`s): nothing is allocated."""
    return walk(tree, lambda d, _p: torch.empty(
        d.shape, dtype=dtype_of(d.dtype) if d.dtype else dtype, device="meta"))


def specs(tree: Any) -> Any:
    """The `PartitionSpec` of every declaration."""
    return walk(tree, lambda d, _p: d.spec)


def shard(params: Any, spec_tree: Any, ctx) -> Any:
    """`params`, the full weights, the same on every rank of `ctx`'s mesh,
    as DTensors placed by `spec_tree` (`sanitized_shardings`: a mesh axis
    that does not divide a dimension replicates it). Each rank keeps its
    own shard of each leaf (`Sharding.from_full`), so nothing is sent."""
    shardings = sanitized_shardings(ctx, params, spec_tree)
    return tree_map(lambda p, sh: sh.from_full(p), params, shardings)


def stack(tree: Any, n: int) -> Any:
    """Prepend a layer dimension of size n to every leaf declaration, left
    unsharded (the fan-in axis is counted from the end, so it is
    unchanged)."""
    return walk(tree, lambda d, _p: replace(d, shape=(n, *d.shape), spec=P(None, *d.spec)))


def count_params(tree: Any) -> int:
    total = 0

    def f(d: ParamDecl, _p: str):
        nonlocal total
        total += math.prod(d.shape)

    walk(tree, f)
    return total


def tree_leaves_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in `jax.tree.flatten` order: dict keys sorted, lists
    and tuples in order, None an empty subtree; a path is the keys and
    indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves_with_path(tree[key], (*path, key))]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree) for x in tree_leaves_with_path(sub, (*path, i))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """A tree of `fn(leaf, *leaves of rest at the same place)`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)
