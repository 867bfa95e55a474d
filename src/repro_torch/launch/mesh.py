"""Mesh construction (counterpart of `repro.launch.mesh`), over
`torch.distributed`: one process per rank, a `DeviceMesh` with named axes.

`make_production_mesh` and `make_mesh` are FUNCTIONS (not module-level
constants), so importing this module never touches the process group.

The ranks come from one of three places:

* `torchrun --nproc-per-node N` on a multi-GPU node: its environment
  (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`);
* the caller: `rank=`, `world_size=` and `store=`, a
  `torch.distributed.FileStore` in a fresh directory (the CPU tests' `gloo`
  ranks, and two ranks on one card), never a fixed TCP port;
* neither: a world of one, over an in-process `HashStore`.

The backend is the caller's: `backend="nccl"` (the default, the card's)
or `backend="gloo"` by name (the CPU tests; two ranks on one card, which
NCCL refuses). A group that is already up with another backend raises.
Rank r's device is ``cuda:(local_rank % device_count)``, and the CPU only
when the caller passes ``device="cpu"``. A `gloo` mesh on the card has its
functional all-gathers made sums (`distributed.sharding.
sum_gloo_cuda_gathers`: PyTorch's crash there) until `destroy_ranks`.
"""
from __future__ import annotations

import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import restore_gathers, sum_gloo_cuda_gathers

#: a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 600.0


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` (raises
    without a GPU), or the CPU when `device` says so."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def init_ranks(backend: str, *, rank: int | None = None, world_size: int | None = None,
               store=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start the default process group with `backend`: from `store`,
    `rank` and `world_size` when given, else from torchrun's environment,
    else as a world of one."""
    timeout = timedelta(seconds=timeout_s)
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("a store= needs rank= and world_size=")
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timeout)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    elif world_size in (None, 1):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        raise ValueError(f"{world_size} ranks need a store= (a FileStore in a fresh "
                         "directory) or torchrun's environment")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, backend: str = "nccl",
              device=None, rank: int | None = None, world_size: int | None = None,
              store=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> DeviceMesh:
    """A `DeviceMesh` of `shape` with axis names `axes` over every rank of
    the default process group, which this starts (`init_ranks`) unless it
    is up already, with the same `backend`. On the card each rank's
    current device becomes `rank_device()` first."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if dist.is_initialized():
        if str(dist.get_backend()) != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                             f"the mesh asks for {backend!r}")
    else:
        init_ranks(backend, rank=rank, world_size=n if world_size is None else world_size,
                   store=store, timeout_s=timeout_s)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process group has "
                         f"{dist.get_world_size()}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "gloo":  # its all-gathers of CUDA tensors crash: sums instead
            sum_gloo_cuda_gathers()
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, **kw) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model). `kw` as `make_mesh`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, **kw)


def destroy_ranks() -> None:
    """Tear the default process group down (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    restore_gathers()
