"""Int8 error-feedback gradient compression (port of
`repro.optim.compression`).

On a mesh the gradient all-reduce crosses slow links; int8 quantization
cuts those bytes 4x against float32. Error feedback keeps the quantization
unbiased over time: each step's residual is added to the next step's
gradient before it is quantized (Seide et al. 2014; Karimireddy et al.
2019). As in the JAX package (`launch/train.py`, `--grad-compression
int8_ef`), the compression changes what the optimizer sees; the gradient's
all-reduce itself stays at full precision, as XLA's partitioner does it in
the JAX package, so there is no int8 collective.
`torch.round` rounds half to even, as `jnp.round` does, so the two packages
agree bit for bit.

On a mesh the gradients and error states are DTensors placed as their
parameters: a gradient that is still a partial sum is reduced first (the
full-precision all-reduce), each leaf's scale comes from the GLOBAL
`max|g + e|` (each rank's local maximum, then an all-reduce of the maximum
over the mesh: the value the JAX package's global arrays give), and the
rest is elementwise on each rank's shard, so a mesh of any shape gives one
process's numbers bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import all_reduce_mesh, is_dtensor, reduce_partial
from repro_torch.models.params import tree_map


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns (q, scale). `amax`: max|x| where
    x is a shard of a larger tensor (default: x's own)."""
    amax = (torch.max(torch.abs(x)) if amax is None else amax) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_with_feedback(grad, err_state):
    """Tree-wise int8 EF compression. Returns (decompressed grads, new
    error state): the grads are what the optimizer sees (the quantized
    values, in each gradient's dtype), and the residual (float32) is
    carried to the next step."""
    errs = {}

    def leaf(g, e):
        if is_dtensor(g):
            deq, errs[id(g)] = _sharded_leaf(g, e)
            return deq
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        errs[id(g)] = g32 - deq
        return deq.to(g.dtype)

    grads = tree_map(leaf, grad, err_state)
    return grads, tree_map(lambda g: errs[id(g)], grad)


def _sharded_leaf(g, e):
    """(what the optimizer sees, the new error state) of a DTensor gradient
    `g` and error state `e` (placed as its parameter): the same arithmetic
    on each rank's shard, at the global maximum."""
    from torch.distributed.tensor import DTensor

    g = reduce_partial(g)
    e = e.redistribute(g.device_mesh, g.placements)
    g32 = g.to_local().to(torch.float32) + e.to_local()
    amax = torch.max(torch.abs(g32)) if g32.numel() else g32.new_zeros(())
    all_reduce_mesh(amax, g.device_mesh, dist.ReduceOp.MAX)
    q, s = quantize_int8(g32, amax)
    deq = dequantize_int8(q, s)

    def placed(local):
        return DTensor.from_local(local, g.device_mesh, g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())

    return placed(deq.to(g.dtype)), placed(g32 - deq)


def init_error_state(params):
    """Zero float32 residuals shaped (and on a mesh placed) as the
    parameters."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                               memory_format=torch.contiguous_format), params)
