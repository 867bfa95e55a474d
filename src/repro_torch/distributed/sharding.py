"""Logical-axis sharding rules and mesh utilities (counterpart of
`repro.distributed.sharding`), over a `torch.distributed.DeviceMesh`.

Logical axes used across the model code:
  batch   -> ('pod', 'data')  (or ('data',) on a single-pod mesh)
  fsdp    -> 'data'           (params ZeRO-3 sharded *within* a pod; replicated
                               across pods so the only cross-pod traffic is the
                               gradient all-reduce)
  tp      -> 'model'          (tensor parallel / expert parallel / seq-parallel)
  seq     -> 'model'          (decode-time KV sequence sharding)
  (None)  -> replicated

A `ShardingCtx` bundles the mesh with resolver helpers so model code never
hard-codes mesh axis names (the same code runs on a 1x1 test mesh, the 16x16
single-pod mesh and the 2x16x16 multi-pod mesh).

PyTorch's SPMD idiom is one process per rank (`launch.mesh` builds the mesh
and its process group): the UQ driver runs replicated on every rank, a wave
or a chain ensemble is split over the batch axes (`ShardingCtx.rows`: each
rank its contiguous rows), each rank runs its rows with the model's one
batched program, and `ShardingCtx.gather_rows` hands every rank the whole
result, so every rank's driver sees the same numbers and makes the same
decisions. That holds only while every rank issues the same waves in the
same order: a replicated driver does; waves formed by timing (per-point
submits batched by a linger window) are not the same on every rank.

A `PartitionSpec` (`P`) is the JAX package's: per tensor dimension, the mesh
axis or tuple of axes that shards it, or None. A `Sharding` pairs one with
the mesh and gives DTensor's per-mesh-dimension placements (`Shard(dim)` or
`Replicate()`). The arithmetic (`logical_to_mesh`, `sanitize_spec`,
`shard_size_bytes`, `row_shard`, `local_shard`) needs only the axis names
and sizes, so it runs on an `AbstractMesh` without a process group.

`torch.distributed.tensor` is imported where a placement or a DTensor is
made (it takes over a second to import, and every port module that reaches
the checkpoint would pay it).

`shard_map_compat` has no counterpart: PyTorch's is
`torch.distributed.tensor.experimental.local_map`, which runs a function on
each rank's local shards of DTensors and wraps its results back as
DTensors. The LM runs its hand-written kernels (flash attention, the SSD)
and the MoE's expert dispatch that way (`models/attention.py`,
`models/ssm.py`, `models/moe.py`; `ShardingCtx.local_map`); everything else
on a mesh is DTensor's own sharding propagation, with the parameters placed
by their `PartitionSpec`s and the activations by `ShardingCtx.constrain`.
"""
from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.races import named_lock


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh axis name, a tuple of them, or None
    (replicated); trailing dimensions not listed are replicated. As the
    JAX package's, a tuple of one axis is that axis and an empty one None."""

    def __new__(cls, *parts):
        def canonical(p):
            if isinstance(p, tuple) and len(p) <= 1:
                return p[0] if p else None
            return p

        return super().__new__(cls, (canonical(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or ranks: the mesh of the
    sharding arithmetic (a `DeviceMesh` has the same two attributes)."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def logical_to_mesh(mesh) -> dict[str, Any]:
    axes = mesh.mesh_dim_names
    has_pod = "pod" in axes
    return {
        "batch": ("pod", "data") if has_pod else ("data",),
        "fsdp": "data",
        "tp": "model",
        "seq": "model",
        "expert": "model",
        None: None,
    }


def _names(entry) -> tuple:
    """A spec entry's mesh axes: () for None, else a tuple of names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _itemsize(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def placements_of(spec: P, mesh_dim_names: Sequence[str]) -> tuple:
    """DTensor placements, one per mesh dimension: `Shard(i)` where the
    spec shards tensor dimension i over that mesh axis, else `Replicate()`.
    A tensor dimension sharded over several axes lists them in mesh order
    (DTensor splits over mesh dimensions left to right)."""
    from torch.distributed.tensor import Replicate, Shard

    owner: dict[str, int] = {}
    for i, entry in enumerate(spec):
        names = _names(entry)
        order = [mesh_dim_names.index(n) for n in names if n in mesh_dim_names]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of the mesh's "
                             f"order {tuple(mesh_dim_names)}")
        for n in names:
            if n in owner:
                raise ValueError(f"mesh axis {n!r} shards two dimensions of {spec!r}")
            owner[n] = i
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in mesh_dim_names)


def row_shard(n: int, index: int, parts: int) -> slice:
    """The contiguous rows of part `index` of `n` rows split in `parts`
    equal parts (`n` a multiple of `parts`)."""
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal parts")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def local_shard(full, spec: P, axis_sizes: dict, coordinate: dict):
    """The shard of `full` (a tensor or array) at mesh `coordinate` (axis
    name -> index) under `spec`: each sharded dimension cut into equal
    contiguous parts, indexed by the coordinate over its axes (the first
    axis the slowest), as DTensor lays a `Shard` out."""
    index = [slice(None)] * len(full.shape)
    for i, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        part, parts = 0, 1
        for n in names:
            part = part * axis_sizes.get(n, 1) + coordinate.get(n, 0)
            parts *= axis_sizes.get(n, 1)
        index[i] = row_shard(full.shape[i], part, parts)
    return full[tuple(index)]


@dataclass(frozen=True)
class Sharding:
    """A `PartitionSpec` on a mesh (the counterpart of `NamedSharding`)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, self.mesh.mesh_dim_names)

    def from_full(self, full: torch.Tensor):
        """A DTensor of `full` with these placements on the mesh's device
        (a rank's card is its current device), from this rank's own shard
        of it: every rank holds the full tensor, so nothing is sent. The
        shard is a copy: an in-place update of the DTensor (an optimizer
        step) leaves `full` as it was."""
        from torch.distributed.tensor import DTensor

        names = self.mesh.mesh_dim_names
        coord = dict(zip(names, self.mesh.get_coordinate()))
        full = full.to(self.mesh.device_type)
        local = local_shard(full, self.spec, dict(zip(names, self.mesh.shape)), coord)
        return DTensor.from_local(local.clone(memory_format=torch.contiguous_format), self.mesh,
                                  self.placements, run_check=False, shape=full.shape,
                                  stride=full.stride())


@dataclass(frozen=True)
class ShardingCtx:
    mesh: Any  # a DeviceMesh, or an AbstractMesh for the arithmetic alone

    @cached_property
    def rules(self) -> dict[str, Any]:
        return logical_to_mesh(self.mesh)

    @cached_property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def n_data(self) -> int:
        n = self.axis_sizes.get("data", 1)
        n *= self.axis_sizes.get("pod", 1)
        return n

    @property
    def n_model(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def batch_axes(self):
        return self.rules["batch"]

    def spec(self, *logical: str | None) -> P:
        """Translate logical axis names into a PartitionSpec."""
        return P(*(self.rules.get(l, None) for l in logical))

    def sharding(self, *logical: str | None) -> Sharding:
        return Sharding(self.mesh, self.spec(*logical))

    def constrain(self, x, *logical: str | None):
        """A DTensor redistributed to the logical axes' placements, an axis
        that does not divide its dimension left out (`sanitize_spec`: every
        rank keeps shards of one shape, where the JAX package pads); a
        plain tensor as it is (the JAX package's constraint is a no-op
        off-mesh)."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return redistribute(x, self.placements(self.spec(*logical), x.shape))
        return x

    def replicated(self) -> Sharding:
        return Sharding(self.mesh, P())

    def gather_fsdp(self, tree):
        """Every DTensor of `tree` all-gathered over the FSDP axis ('data'),
        its other placements kept (TP and EP over 'model'): the ZeRO-3
        gather of a layer's weights as the layer starts, whose backward
        reduce-scatters their gradients. Plain tensors pass as they are. (On
        a `gloo` mesh on the card the gather is a sum: `launch.mesh.
        make_mesh` installs `sum_gloo_cuda_gathers`.)"""
        from torch.distributed.tensor import DTensor, Replicate

        names = self.mesh.mesh_dim_names
        fsdp = self.rules["fsdp"]

        def gather(t):
            if not isinstance(t, DTensor):
                return t
            placements = [Replicate() if n == fsdp else p for n, p in zip(names, t.placements)]
            return t.redistribute(t.device_mesh, placements)

        return _tree_map(gather, tree)

    def replicate_by_sum(self, t, axis: str):
        """The DTensor `t` replicated over mesh axis `axis` (its other
        placements kept) by a zero-padded sum, an all-reduce, where it is
        sharded there: never an all-gather, on any backend (flash decoding
        issues all-reduces only). A plain tensor passes as it is."""
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(t, DTensor):
            return t
        i = self.mesh.mesh_dim_names.index(axis)
        if not t.placements[i].is_shard():
            return t
        t = self._padded_shard(t, i)
        return t.redistribute(t.device_mesh, [Replicate() if j == i else p
                                              for j, p in enumerate(t.placements)])

    def _padded_shard(self, t, i: int):
        """`t`, sharded along some dim over mesh dim `i`, as a partial sum
        over that mesh dim: each rank's shard in its place in zeros of the
        size gathered over `i` (its other placements kept)."""
        from torch.distributed.tensor import Partial

        dim = t.placements[i].dim
        n, at = self.mesh.shape[i], self.mesh.get_coordinate()[i]

        def pad(local):
            full = local.new_zeros(local.shape[:dim] + (local.shape[dim] * n,)
                                   + local.shape[dim + 1:])
            full.narrow(dim, at * local.shape[dim], local.shape[dim]).copy_(local)
            return full

        placements = tuple(t.placements)
        out = placements[:i] + (Partial(),) + placements[i + 1:]
        return self.local_map(pad, out, (placements,))(t)

    def fence(self, t, *logical: str | None):
        """A DTensor constrained to the logical axes' placements, and its
        gradient constrained to them on the way back (an identity on each
        rank's local shard, `local_map`). DTensor's propagation picks the
        backward's placements itself, and where it picks a strided shard
        its redistribution planning takes minutes; a fence keeps the
        backward on the forward's layout."""
        spec = sanitize_spec(self.spec(*logical), t.shape, self)
        return self.local_map(lambda x: x, spec, (spec,))(t)

    def put(self, t: torch.Tensor, *logical: str | None):
        """`t`, the same full tensor on every rank, as a DTensor placed by the
        logical axes (an axis that does not divide its dimension
        replicates it: a ragged batch runs whole on every rank); a DTensor
        as it is."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            return t
        return Sharding(self.mesh, sanitize_spec(self.spec(*logical), t.shape, self)).from_full(t)

    def placements(self, spec: P, shape: Sequence[int]) -> tuple:
        """DTensor placements of `spec` on this mesh, sanitized for `shape`."""
        return placements_of(sanitize_spec(spec, shape, self), self.mesh.mesh_dim_names)

    def local_map(self, fn, out_specs, in_specs, in_grad_specs=None):
        """`fn` run on each rank's local shards (PyTorch's `local_map`, the
        JAX package's `shard_map`): `in_specs` and `out_specs` are
        `PartitionSpec`s of the arguments and results (None for a
        non-tensor argument; a tuple of DTensor placements where a spec
        cannot say it, e.g. a result that is a partial sum over an axis),
        sanitized for their shapes by the caller; DTensor arguments are
        redistributed to them first. `fn` sees plain tensors and returns
        plain tensors, which come back as DTensors. `in_grad_specs` give
        the placements of the arguments' gradients where they differ from
        the arguments' own (an argument replicated over an axis whose
        ranks each use a part of it has a gradient that is a partial sum
        over that axis). PyTorch's `local_map` does the same, but its
        inputs' and results' backward rules build some gradients off the
        autograd graph, so reverse over reverse through it was wrong; this
        one runs on `_ToLocal` and `_FromLocal`, which are twice
        differentiable."""
        from torch.distributed.tensor import Placement

        names = self.mesh.mesh_dim_names

        def place(spec):
            if spec is None or not isinstance(spec, P):
                return spec
            return tuple(placements_of(spec, names))

        single = isinstance(out_specs, P) or all(isinstance(s, Placement) for s in out_specs)
        outs = (place(out_specs),) if single else tuple(place(s) for s in out_specs)
        ins = tuple(place(s) for s in in_specs)
        grads = ins if in_grad_specs is None else tuple(place(s) for s in in_grad_specs)

        def run(*args):
            if not any(is_dtensor(a) for a in args):
                return fn(*args)
            local = [_ToLocal.apply(a if tuple(a.placements) == spec else redistribute(a, spec),
                                    grad) if is_dtensor(a) else a
                     for a, spec, grad in zip(args, ins, grads, strict=True)]
            out = fn(*local)
            results = (out,) if single else out
            placed = tuple(_FromLocal.apply(r, self.mesh, p)
                           for r, p in zip(results, outs, strict=True))
            return placed[0] if single else placed

        return run

    def partial_over(self, spec: P, *axes: str) -> tuple:
        """The placements of `spec` with each mesh axis of `axes` that the
        spec leaves replicated made a partial sum instead."""
        from torch.distributed.tensor import Partial

        placed = placements_of(spec, self.mesh.mesh_dim_names)
        return tuple(Partial() if name in axes and p.is_replicate() else p
                     for name, p in zip(self.mesh.mesh_dim_names, placed))

    # -- the replicated driver's waves ------------------------------------------
    @cached_property
    def coordinate(self) -> dict[str, int]:
        """This rank's index along each mesh axis."""
        names = self.mesh.mesh_dim_names
        if isinstance(self.mesh, AbstractMesh):
            if int(np.prod(self.mesh.shape)) != 1:
                raise ValueError(f"an AbstractMesh of shape {self.mesh.shape} has no ranks: "
                                 "build a DeviceMesh (launch.mesh.make_mesh)")
            return dict.fromkeys(names, 0)
        return dict(zip(names, self.mesh.get_coordinate()))

    @property
    def batch_index(self) -> int:
        """This rank's index over the batch axes, the first the slowest."""
        index = 0
        for n in self.batch_axes:
            index = index * self.axis_sizes.get(n, 1) + self.coordinate.get(n, 0)
        return index

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a wave of `n` (a multiple of
        `n_data`); ranks that differ only off the batch axes share them."""
        return row_shard(n, self.batch_index, self.n_data)

    @cached_property
    def _gather_order(self) -> list[int]:
        """The ranks whose rows make up a gathered wave, in row order: for
        each batch index, the rank at index 0 of every other axis."""
        ranks = self.mesh.mesh.cpu().numpy()
        names = self.mesh.mesh_dim_names
        index = tuple(slice(None) if n in self.batch_axes else 0 for n in names)
        return [int(r) for r in ranks[index].reshape(-1)]

    @cached_property
    def _collective_lock(self):
        # the fabric's collector thread and direct calls may both run waves
        return named_lock("sharding.gather_rows")

    def gather_rows(self, local: np.ndarray) -> np.ndarray:
        """Every rank's `rows` of a wave, concatenated in row order on every
        rank. The arrays are host arrays (a wave's outputs, a block's
        samples), as the JAX package's `np.asarray` brings them to the host:
        a `gloo` group gathers them on the host; an NCCL group, which has
        only device collectives, through the rank's card."""
        if self.n_data == 1:
            return local
        if dist.get_world_size() != self.mesh.size():
            raise ValueError(f"the mesh has {self.mesh.size()} ranks, the process group "
                             f"{dist.get_world_size()}")
        backend = str(dist.get_backend())
        on = torch.device("cpu") if "gloo" in backend else torch.device(
            "cuda", torch.cuda.current_device())
        t = torch.from_numpy(np.ascontiguousarray(local)).to(on)
        with self._collective_lock:
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, t)
        return np.concatenate([parts[r].cpu().numpy() for r in self._gather_order], axis=0)


#: gathers of CUDA tensors over a `gloo` group that `sum_gloo_cuda_gathers`
#: turned into zero-padded sums (every one DTensor asked for, by its
#: redistribution or otherwise)
GATHERS_BY_SUM = {"n": 0}
#: the device types whose gathers `sum_gloo_cuda_gathers` replaces (the CPU
#: tests add "cpu" to run the card's path on `gloo` CPU ranks)
SUM_GATHER_DEVICES = {"cuda"}
_REAL_GATHERS: dict = {}


# DTensor's own autograd rules for `redistribute`, `to_local` and
# `from_local` compute their gradients off the autograd graph: torch 2.11
# builds the first two's with the DTensor constructor, and every version
# redistributes a `from_local` result's gradient of other placements on its
# local tensor. A first backward with `create_graph=True` (the Hessian
# action's reverse over reverse) then cut every path through a constraint,
# a `local_map` or a partial sum's reduction, even on a 1x1 mesh. The three
# rules below compute the same values, and each one's backward is made of
# these rules again, so it is differentiable once more.


def _grad_placements(placements) -> tuple:
    """The placements of a gradient of a DTensor so placed, as DTensor's
    own rules choose them: a partial sum's gradient is replicated."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in placements)


def redistribute(t, placements):
    """The DTensor `t` redistributed to `placements` (DTensor's
    `redistribute`), twice differentiable. Where `t` is so placed already
    it is still a node of the graph, as DTensor's is: its backward brings
    the gradient back to `t`'s placements (a constraint's fence)."""
    return _Redistribute.apply(t, tuple(placements))


class _Redistribute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = tuple(t.placements)
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        # DTensor's rule: a gradient that is sharded or replicated where the
        # input was a partial sum stays replicated
        from torch.distributed.tensor import Replicate

        back = tuple(Replicate() if want.is_partial() and not have.is_partial() else want
                     for have, want in zip(g.placements, ctx.placements))
        return redistribute(g, back), None


class _ToLocal(torch.autograd.Function):
    """A DTensor's local shard, its gradient a DTensor placed by
    `grad_placements` (None: `_grad_placements` of its own)."""

    @staticmethod
    def forward(ctx, t, grad_placements):
        ctx.mesh, ctx.placements, ctx.shape = t.device_mesh, tuple(t.placements), t.shape
        ctx.grad_placements = grad_placements or _grad_placements(t.placements)
        local = t.to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        from torch.distributed.tensor._utils import compute_global_tensor_info

        _, stride = compute_global_tensor_info(g, ctx.mesh, ctx.placements)
        return _FromLocal.apply(g, ctx.mesh, ctx.grad_placements, ctx.shape,
                                tuple(stride)), None


class _FromLocal(torch.autograd.Function):
    """Each rank's `local` tensor as one DTensor placed by `placements`
    (`DTensor.from_local` without a check; `shape` and `stride` its global
    ones where the shards are not even); its gradient is first
    redistributed to `_grad_placements`, then each rank's shard."""

    @staticmethod
    def forward(ctx, local, mesh, placements, shape=None, stride=None):
        from torch.distributed.tensor import DTensor

        ctx.grad_placements = _grad_placements(placements)
        return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                                  stride=stride)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None, None, None
        if tuple(g.placements) != ctx.grad_placements:
            g = redistribute(g, ctx.grad_placements)
        return _ToLocal.apply(g, None), None, None, None, None


def sum_gloo_cuda_gathers() -> None:
    """Make every functional all-gather of a CUDA tensor over one dimension
    of a `gloo` mesh a sum (an all-reduce) of each rank's part put in its
    place in zeros: PyTorch's functional all-gather crashes there (a
    segmentation fault in its wait, two ranks on one card, torch 2.11),
    while its all-reduce works. DTensor issues its gathers through
    `torch.distributed._functional_collectives` (`all_gather_tensor`;
    `all_gather_single` in newer releases), wherever
    its sharding propagation picks one (a backward's products, a
    redistribution to `Replicate`), so the gathers are replaced there: a
    CPU tensor, another group or another backend takes the real gather.
    The sum of one value and zeros is that value (a -0.0 becomes +0.0).
    `launch.mesh.make_mesh` calls this for a `gloo` mesh on the card;
    `restore_gathers` undoes it. Each replaced gather counts in
    `GATHERS_BY_SUM`."""
    import torch.distributed._functional_collectives as funcol

    for name in ("all_gather_tensor", "all_gather_single"):
        real = getattr(funcol, name, None)
        if real is None or name in _REAL_GATHERS:
            continue
        _REAL_GATHERS[name] = real
        setattr(funcol, name, _gather_by_sum(real))


def restore_gathers() -> None:
    """Undo `sum_gloo_cuda_gathers`."""
    import torch.distributed._functional_collectives as funcol

    for name, real in _REAL_GATHERS.items():
        setattr(funcol, name, real)
    _REAL_GATHERS.clear()


def _gather_by_sum(real):
    import torch.distributed._functional_collectives as funcol

    def gather(self, gather_dim: int, group, tag: str = ""):
        mesh, dim = group if isinstance(group, tuple) and len(group) == 2 else (None, None)
        if (mesh is None or self.device.type not in SUM_GATHER_DEVICES
                or "gloo" not in str(dist.get_backend(mesh.get_group(dim)))):
            return real(self, gather_dim, group, tag)
        n, at = mesh.size(dim), mesh.get_local_rank(dim)
        k = self.shape[gather_dim]
        shape = list(self.shape)
        shape[gather_dim] = k * n
        full = self.new_zeros(shape)
        full.narrow(gather_dim, at * k, k).copy_(self)
        GATHERS_BY_SUM["n"] += 1
        return funcol.all_reduce(full, "sum", group)

    return gather


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (without importing `torch.distributed.tensor`:
    where it was never imported, no DTensor exists)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def all_reduce_mesh(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`x`, a plain tensor on every rank of `mesh`, reduced in place by `op`
    over the whole mesh: one all-reduce a mesh dimension of more than one
    rank, in turn (a sum or a max over the dimensions in turn is the sum or
    max over the mesh)."""
    for i, n in enumerate(mesh.shape):
        if n > 1:
            dist.all_reduce(x, op=op, group=mesh.get_group(i))
    return x


def assemble(t) -> torch.Tensor:
    """The whole value of the DTensor `t` as a plain tensor on every rank of
    its mesh (on the rank's device), with all-reduces only: each rank puts
    its shard at its place in zeros of the full shape (of the ranks that
    hold the same replica, only the one at index 0 of each replicating mesh
    dimension), and the ranks sum those, as integers of the same width (a
    bfloat16 or float16 tensor as float32 first, which holds it exactly), so
    the sum of one value and zeros is that value's bits, -0.0 and NaN's
    included. A partial sum is reduced first (at its own precision). Used
    where an all-gather cannot run (`gloo` on CUDA tensors, see
    `sum_gloo_cuda_gathers`) and by the checkpoint's snapshot."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    t = reduce_partial(t)
    local = t.to_local()
    mesh = t.device_mesh
    if local.dtype in (torch.bfloat16, torch.float16):
        local = local.float()
    if mesh.size() == 1:
        return local
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, t.placements)
    full = torch.zeros(t.shape, dtype=local.dtype, device=local.device)
    owner = all(c == 0 for c, p in zip(mesh.get_coordinate(), t.placements) if p.is_replicate())
    if owner and local.numel():
        full[tuple(slice(o, o + n) for o, n in zip(offset, shape))] = local
    all_reduce_mesh(_as_integers(full), mesh)
    return full


def _as_integers(t: torch.Tensor) -> torch.Tensor:
    """`t`'s storage as integers of its element's width (a view), for an
    exact sum of one value and zeros; integer tensors as they are."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    if not t.is_floating_point():
        return t
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])


def reduce_partial(t):
    """A DTensor that is a partial sum over some mesh axes, reduced over
    them (an all-reduce); anything else as it is. Called right where the
    partial value is made: DTensor's masked partial of a gather over a
    sharded dimension must be reduced before the result is reshaped."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return redistribute(t, [Replicate() if p.is_partial() else p for p in t.placements])
    return t


def on_mesh(ctx: ShardingCtx | None):
    """The scope of a step on `ctx`'s mesh: plain tensors made inside it
    (positions, masks, a theta that requires grad) meet the DTensors as
    replicated (`implicit_replication`); without a ctx, nothing. Run a
    backward inside it too: it meets the plain tensors its forward saved.
    Scopes nest (PyTorch's own `implicit_replication` clears the flag on
    leaving an inner scope; this one restores what it found)."""
    if ctx is None:
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def make_test_mesh(data: int = 1, model: int = 1, pod: int | None = None, **kw):
    """Small mesh over the process group's ranks (the CPU tests: `gloo`
    ranks, `backend="gloo", device="cpu"`); `kw` as `launch.mesh.make_mesh`."""
    from repro_torch.launch.mesh import make_mesh

    if pod is None:
        return make_mesh((data, model), ("data", "model"), **kw)
    return make_mesh((pod, data, model), ("pod", "data", "model"), **kw)


def _child(node, key):
    return None if node is None else node[key]


def _tree_map(fn, tree, *rest, is_leaf=lambda x: False):
    """`fn` over the leaves of `tree` (dicts, lists, tuples) and the
    matching nodes of `rest` (None under a None node); None stays None."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v, *(_child(r, k) for r in rest), is_leaf=is_leaf))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(_child(r, i) for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_shardings(ctx: ShardingCtx, spec_tree):
    """Map a tree of PartitionSpecs to Shardings."""
    return _tree_map(lambda s: Sharding(ctx.mesh, s), spec_tree,
                     is_leaf=lambda x: isinstance(x, P))


def chain_carry_shardings(ctx: ShardingCtx, carry: dict, K: int) -> dict:
    """Mesh shardings for a fused-sampler carry (`uq.fused`): leaves with a
    leading chain axis of length `K` shard over the logical batch axes, the
    same discipline the evaluate path applies to its [N, d] waves, while
    scalars (step size, step counter) replicate. Keyed by the carry dict's
    own structure so RWM ({xs, lps, acc}) and MALA ({... gs, eps, i}) both
    resolve without a per-sampler spec table."""
    batch = ctx.sharding("batch")
    rep = ctx.replicated()
    return {
        k: batch if (hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == K)
        else rep
        for k, v in carry.items()
    }


def sanitize_spec(spec: P, shape: Sequence[int], ctx: ShardingCtx) -> P:
    """Drop mesh axes that do not divide the corresponding dimension
    (e.g. kv_heads=8 cannot shard over model=16 -> replicate)."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(ax)
            continue
        prod = 1
        for name in _names(ax):
            prod *= ctx.axis_sizes.get(name, 1)
        out.append(ax if shape[i] % prod == 0 else None)
    return P(*out)


def sanitized_shardings(ctx: ShardingCtx, abstract_tree, spec_tree):
    """Shardings with per-leaf divisibility sanitization; a None spec stays
    None (a leaf restored without a mesh)."""

    def f(a, s):
        return None if s is None else Sharding(ctx.mesh, sanitize_spec(s, a.shape, ctx))

    return _tree_map(f, abstract_tree, spec_tree)


def shard_size_bytes(shape: Sequence[int], dtype, spec: P, ctx: ShardingCtx) -> int:
    """Per-device bytes of an array with the given spec (for napkin math)."""
    size = _itemsize(dtype)
    for dim in shape:
        size *= dim
    denom = 1
    for ax in spec:
        for name in _names(ax):
            denom *= ctx.axis_sizes.get(name, 1)
    return int(size // max(denom, 1))
