"""Plain PyTorch versions of the flash-attention kernels (the forward is the
counterpart of the oracle `repro.kernels.flash_attention.ref.attention_ref`,
the same operations in the same order). `ops.flash_attention` takes them for
CPU tensors, and `chip_smoke.py` holds the CUDA kernels against them:
`attention_ref` and `attention_lse_ref` the forward kernels,
`attention_bwd_ref` the backward kernels (`csrc/flash_attention_bwd_wgmma.cu`
for bf16, `csrc/flash_attention_bwd_3xbf16.cu` for float32), which have no
counterpart in the JAX package (its `pallas_call` has no gradient), and
`bwd_split_ref` and `bwd_stats_ref` the float32 backward's first kernel,
which splits q, k, v and dO into bf16 parts and writes the rows' statistics."""
from __future__ import annotations

import math

import torch

#: the rows of the backward's statistics per (b, q head): Sq rounded up to
#: this, as both backward libraries' ROW_PAD
BWD_ROW_PAD = 128


def _scores(q, k, causal: bool, scale: float | None, acc: torch.dtype = torch.float32):
    """Scores ``[B, nq, Sq, Sk]`` in `acc` of q against k repeated over the
    GQA group, divided by sqrt(hd) or times `scale` where one is given,
    masked with -inf where causal (``tril(k=Sk-Sq)``, bottom-right aligned,
    as the JAX oracle's)."""
    nq, Sq, hd = q.shape[1], q.shape[2], q.shape[3]
    nkv, Sk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(nq // nkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc))
    s = s / math.sqrt(hd) if scale is None else s * scale
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _softmax_v(s, v, q):
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(s.dtype)).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """``q [B, nq, Sq, hd]``, ``k, v [B, nkv, Sk, hd]`` (GQA: q head h reads
    kv head h // (nq / nkv)) -> ``[B, nq, Sq, hd]`` in q's dtype. Scores in
    float32 over sqrt(hd), or times `scale` where one is given; the causal
    mask is ``tril(k=Sk-Sq)`` (bottom-right aligned, as the JAX oracle's)."""
    return _softmax_v(_scores(q, k, causal, scale), v, q)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale: float | None = None):
    """`attention_ref`'s output (the same bits, for float32 and bf16 inputs)
    and each row's log-sum-exp of the scaled, masked scores ``[B, nq,
    Sq]``: what the forward kernels write for the backward. float64 inputs
    are computed in float64 (`attention_ref` computes in float32, as the JAX
    oracle does); the log-sum-exp is float32 otherwise."""
    s = _scores(q, k, causal, scale, torch.promote_types(q.dtype, torch.float32))
    return _softmax_v(s, v, q), torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True, scale: float | None = None):
    """The gradient of `attention_ref` with respect to q, k and v, from the
    forward's output o and log-sum-exp `lse` ``[B, nq, Sq]`` and the output
    gradient `do` (q's shape): the backward kernel's arithmetic in tensor
    ops, in float32 (float64 for float64 inputs)::

        P  = exp(scores - lse)            D  = rowsum(do * o)
        dV = P^T do                       dS = P * (do v^T - D)
        dK = scale dS^T q                 dQ = scale dS k

    summed over each kv head's GQA group. In bf16, P and dS are rounded to
    bf16 before their products, as the kernel rounds them. Returns (dq, dk,
    dv) in the dtypes of q, k and v."""
    B, nq, Sq, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    group = nq // nkv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    acc = torch.promote_types(q.dtype, torch.float32)
    kr = k.repeat_interleave(group, dim=1).to(acc)
    vr = v.repeat_interleave(group, dim=1).to(acc)
    p = torch.exp(_scores(q, k, causal, scale, acc) - lse.to(acc)[..., None])
    dof = do.to(acc)
    dsum = (dof * o.to(acc)).sum(-1)
    # the products' operands as the kernel rounds them (a no-op in float32)
    p_op = p.to(q.dtype).to(acc)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_op, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - dsum[..., None])
    ds_op = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_op, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_op, q.to(acc)) * scale
    dk = dk.reshape(B, nkv, group, Sk, hd).sum(2)
    dv = dv.reshape(B, nkv, group, Sk, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_split_ref(x: torch.Tensor):
    """The bf16 parts (hi, lo) of a float32 tensor that the float32
    backward's first kernel writes for q, k, v and dO: hi = bf16(x), lo =
    bf16(x - hi), both rounded to nearest even. x - hi is exact in float32,
    so hi + lo is within 2^-17 |x| of x (hi alone within 2^-8 |x|); each
    product of the kernel is lo*hi + hi*lo + hi*hi of its operands' parts
    (3xBF16)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def bwd_stats_ref(o, do, lse) -> torch.Tensor:
    """The rows' statistics both backward libraries' first kernel writes,
    float32 ``[2, B, nq, Sq_pad]`` (Sq rounded up to `BWD_ROW_PAD`): [0] the
    forward's log-sum-exp in log2 units, +inf past Sq (P = 0 on a padding
    row), [1] D = rowsum(do * o) in float32, 0 past Sq."""
    B, nq, Sq = lse.shape
    pad = -Sq % BWD_ROW_PAD
    lse2 = torch.nn.functional.pad(lse.float() * math.log2(math.e), (0, pad),
                                   value=float("inf"))
    dsum = torch.nn.functional.pad((do.float() * o.float()).sum(-1), (0, pad))
    return torch.stack([lse2, dsum])
