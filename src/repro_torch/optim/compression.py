"""Int8 error-feedback gradient compression (port of
`repro.optim.compression`).

On a mesh the gradient all-reduce crosses slow links; int8 quantization
cuts those bytes 4x against float32. Error feedback keeps the quantization
unbiased over time: each step's residual is added to the next step's
gradient before it is quantized (Seide et al. 2014; Karimireddy et al.
2019). `launch/train.py` has no all-reduce yet (its loop on a mesh is
ROADMAP queue 1, item 14d), so here the compression changes only what the
optimizer sees, as the JAX package's does on one device (`launch/train.py`,
`--grad-compression int8_ef`).
`torch.round` rounds half to even, as `jnp.round` does, so the two packages
agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
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
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        errs[id(g)] = g32 - deq
        return deq.to(g.dtype)

    grads = tree_map(leaf, grad, err_state)
    return grads, tree_map(lambda g: errs[id(g)], grad)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
