"""Op-stream cost analysis of a traced step (counterpart of
`repro.launch.hlo_analysis`).

The JAX package compiles a cell and parses the post-SPMD HLO text. The port
has no HLO: it records the stream of ATen operations that one rank
dispatches while it runs the cell (`OpRecorder`, a `TorchDispatchMode`),
on meta tensors over a fake process group in the dry run
(`launch/dryrun.py`), and `analyze` reduces that stream to the reference's
keys:

* ``flops``: the matrix products' flops (PyTorch's own flop formulas,
  `torch.utils.flop_counter.flop_registry`: mm, bmm, addmm, baddbmm,
  convolutions, SDPA), as the reference counts dot and convolution flops.
  They are counted on each op's LOCAL shapes: the recorder lets a DTensor's
  own dispatch run first and sees the rank's local operations it issues.
  (`FlopCounterMode` over a DTensor step counts the global flops, every
  rank's work at once.)
* ``bytes_accessed``: each operation's operand and result bytes, views and
  bookkeeping left out. This is an UNFUSED upper bound: the reference counts
  XLA's fusion boundaries, and eager PyTorch fuses nothing.
* ``collective_per_device_bytes`` and ``collective_counts``: the functional
  collectives DTensor issues (`_c10d_functional.*`, DTensor's
  `shard_dim_alltoall`), each priced by the reference's ring model
  (`ring_bytes`) at its group size. They are the collectives DTensor
  chooses for the placements, not the ones XLA's SPMD partitioner would.

The stream is one rank's view. On a uniform mesh every rank runs the same
shapes; a batch that the batch axes do not divide is replicated (every rank
runs all of it), so that holds there too.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional collective (op name) -> ring-model class
_COLLECTIVE_OF = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

#: operations that move no data of their own
_NO_BYTES = {"detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided",
             "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel"}


def ring_bytes(op: str, result_bytes: float, n: int) -> float:
    """Per-device link bytes of one collective of class `op` whose result
    has `result_bytes` bytes, over a group of `n` ranks (the reference's
    ring model, `repro/launch/hlo_analysis.py::_collective_bytes`):
    all-gather (n-1)/n of the gathered result, reduce-scatter (n-1) times
    the scattered result, all-reduce 2(n-1)/n of it (reduce-scatter then
    all-gather), all-to-all (n-1)/n, a permute the whole result."""
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return result_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return result_bytes * (n - 1)
    if op == "all-reduce":
        return 2 * result_bytes * (n - 1) / n
    if op == "all-to-all":
        return result_bytes * (n - 1) / n
    if op == "collective-permute":
        return result_bytes
    raise ValueError(f"not a collective class: {op!r}")


@dataclass
class Op:
    """One recorded operation: its name, matmul flops, operand + result
    bytes, and for a collective its class, result bytes and group size."""

    name: str
    flops: float
    bytes: float
    shape: str
    collective: str | None = None
    result_bytes: float = 0.0
    group: int = 1


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group_size(args, kwargs) -> int:
    """The group size a functional collective names: its `group_size`
    argument where it has one, else its group's size."""
    import torch.distributed.distributed_c10d as c10d

    names = [a for a in args if isinstance(a, str)]
    if names:  # the group's name is the last string (a reduce op comes first)
        return c10d._resolve_process_group(names[-1]).size()
    ints = [a for a in args[1:] if isinstance(a, int)]
    if ints:
        return ints[-1]
    raise ValueError("a collective without a group")


class OpRecorder(TorchDispatchMode):
    """Records every ATen operation on plain (or meta) tensors. An operation
    on DTensors is handed back (NotImplemented), so that DTensor's own
    dispatch runs it; the local operations and collectives that dispatch
    issues come back here with the rank's local shapes. Operations on fake
    tensors run unrecorded."""

    def __init__(self):
        super().__init__()
        self.ops: list[Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and not _is_fake(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not any(_is_fake(t) for t in types):
            # DTensor's sharding propagation runs ops on fake tensors to
            # learn their output shapes: not work the rank does
            self.ops.append(_record(func, args, kwargs, out))
        return out


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return issubclass(t, FakeTensor)


def _record(func, args, kwargs, out) -> Op:
    from torch.utils.flop_counter import flop_registry

    name = func.__name__.split(".")[0]
    packet = func.overloadpacket
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    shape = "x".join(str(s) for s in outs[0].shape) if outs else ""
    flops = float(flop_registry[packet](*args, **kwargs, out_val=out)) \
        if packet in flop_registry else 0.0
    coll = _COLLECTIVE_OF.get(name)
    if coll is not None:
        res = float(sum(_nbytes(t) for t in outs))
        return Op(name, 0.0, 0.0, shape, coll, res, _group_size(args, kwargs))
    moved = 0.0
    if name not in _NO_BYTES and not func.is_view:
        moved = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
    return Op(name, flops, moved, shape)


def analyze(trace: list[Op], n_devices: int) -> dict:
    """The reference's totals of one rank's recorded stream: flops, bytes
    accessed, ring-model link bytes and counts per collective class.
    `n_devices` is kept for the reference's signature (each op carries its
    own group size)."""
    coll = dict.fromkeys(COLLECTIVES, 0.0)
    counts = dict.fromkeys(COLLECTIVES, 0)
    for op in trace:
        if op.collective is not None and op.group > 1:
            coll[op.collective] += ring_bytes(op.collective, op.result_bytes, op.group)
            counts[op.collective] += 1
    return {
        "flops": sum(op.flops for op in trace),
        "bytes_accessed": sum(op.bytes for op in trace),
        "collective_per_device_bytes": {k: int(v) for k, v in coll.items()},
        "collective_counts": counts,
        "ops": len(trace),
    }


def top_contributors(trace: list[Op], n_devices: int, kind: str = "bytes", k: int = 12):
    """The largest per-operation contributors (value, multiplicity 1, op,
    result shape), as the reference lists them: the dry run's profiler."""
    rows = []
    for op in trace:
        if kind == "flops" and op.flops:
            rows.append((op.flops, 1, op.name, op.shape))
        elif kind == "collective" and op.collective and op.group > 1:
            rows.append((ring_bytes(op.collective, op.result_bytes, op.group), 1,
                         op.name, op.shape))
        elif kind == "bytes" and op.bytes:
            rows.append((op.bytes, 1, op.name, op.shape))
    rows.sort(key=lambda r: r[0], reverse=True)
    return rows[:k]
