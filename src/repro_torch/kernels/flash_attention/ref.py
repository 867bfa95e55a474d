"""Plain PyTorch version of the flash-attention kernel (counterpart of the
oracle `repro.kernels.flash_attention.ref.attention_ref`, the same
operations in the same order). `ops.flash_attention` takes it for CPU
tensors, and `chip_smoke.py` holds the CUDA kernel against it."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """``q [B, nq, Sq, hd]``, ``k, v [B, nkv, Sk, hd]`` (GQA: q head h reads
    kv head h // (nq / nkv)) -> ``[B, nq, Sq, hd]`` in q's dtype. Scores in
    float32 over sqrt(hd), or times `scale` where one is given; the causal
    mask is ``tril(k=Sk-Sq)`` (bottom-right aligned, as the JAX oracle's)."""
    nq, Sq, hd = q.shape[1], q.shape[2], q.shape[3]
    nkv, Sk = k.shape[1], k.shape[2]
    group = nq // nkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / math.sqrt(hd) if scale is None else s * scale
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
