"""GQA self-attention with qk-norm for train and prefill (counterpart of
`repro.models.attention`).

Two paths compute the same function, selected by `cfg.attn_impl`:

* `"kernel"` (the port's default) passes q, k and v to the hand-written
  flash kernels, `kernels.flash_attention`, as ``[B, n, S, hd]`` views of
  the model's ``[B, S, n, hd]`` tensors (read through strides, no copy). The
  JAX package documents this path as `attn_impl="pallas"`
  (`models/attention.py:6`) but its transformer never takes it (ROADMAP
  queue 3); the port wires it, and the parity tests hold it to the JAX
  package's function.
* `"plain"` is `_grouped_attention`, the JAX package's XLA path in torch
  ops: scores in float32 over q chunks of `cfg.q_chunk` rows, with
  `cfg.causal_skip` cutting each chunk's KV to its causal prefix.

The decode step, cross-attention and MLA raise `NotImplementedError`
(ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, rmsnorm_scaleless
from repro_torch.models.params import ParamDecl
from repro_torch.types import ModelConfig

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 13)"


def decl_attention(cfg: ModelConfig, cross: bool = False) -> dict:
    if cfg.attn_type == "mla" and not cross:
        raise NotImplementedError(f"MLA attention {_NOT_PORTED}")
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    decls = {
        "wq": ParamDecl((d, nq, hd)),
        "wk": ParamDecl((d, nkv, hd)),
        "wv": ParamDecl((d, nkv, hd)),
        "wo": ParamDecl((nq, hd, d), fan_in_axis=-3),
    }
    if cfg.use_bias:
        decls["bq"] = ParamDecl((nq, hd), init="zeros")
        decls["bk"] = ParamDecl((nkv, hd), init="zeros")
        decls["bv"] = ParamDecl((nkv, hd), init="zeros")
    if cfg.qk_norm and not cross:
        decls["q_norm"] = ParamDecl((hd,), init="ones", dtype="float32")
        decls["k_norm"] = ParamDecl((hd,), init="ones", dtype="float32")
    return decls


def _grouped_attention(
    q: torch.Tensor,  # [B, Sq, nq, hd]
    k: torch.Tensor,  # [B, Sk, nkv, hdk]
    v: torch.Tensor,  # [B, Sk, nkv, hdv]
    *,
    scale: float,
    causal: bool,
    q_chunk: int = 1024,
    causal_skip: bool = False,
) -> torch.Tensor:
    """The plain path: scores in float32 (the JAX package's
    `preferred_element_type`), softmax, probabilities cast to v's dtype.
    Rows are independent, so the JAX package's zero-padded last chunk is a
    shorter last chunk here. The decode-only arguments (`q_offset`,
    `kv_len`) come with the decode step."""
    B, Sq, nq, _ = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, nkv, nq // nkv, q.shape[-1])
    k32 = k.to(torch.float32)

    def attend(q_blk, blk_offset: int, hi: int):
        # q_blk: [B, qc, nkv, g, hd] against the first `hi` keys
        s = torch.einsum("bqkgh,bskh->bkgqs", q_blk.to(torch.float32), k32[:, :hi]) * scale
        qc = q_blk.shape[1]
        if causal:
            cols = torch.arange(hi, device=q.device)
            rows = blk_offset + torch.arange(qc, device=q.device)
            s = s.masked_fill(~(cols[None, :] <= rows[:, None]), float("-inf"))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bkgqs,bskh->bqkgh", p, v[:, :hi])

    if Sq <= q_chunk:
        out = attend(qg, 0, Sk)
    else:
        skip = causal_skip and causal and Sq == Sk
        if skip and Sq % q_chunk:
            raise ValueError(f"causal_skip needs Sq={Sq} to be a multiple of q_chunk={q_chunk}")
        outs = []
        for i in range(0, Sq, q_chunk):
            q_blk = qg[:, i:i + q_chunk]
            # causal_skip: blocks strictly above the diagonal are never computed
            hi = i + q_chunk if skip else Sk
            outs.append(attend(q_blk, i, hi))
        out = torch.cat(outs, dim=1)
    return out.reshape(B, Sq, nq, -1)


def _project_qkv(cfg: ModelConfig, params: dict, xq: torch.Tensor, xkv: torch.Tensor):
    q = torch.einsum("bsd,dnh->bsnh", xq, params["wq"])
    k = torch.einsum("bsd,dnh->bsnh", xkv, params["wk"])
    v = torch.einsum("bsd,dnh->bsnh", xkv, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if "q_norm" in params:
        q = rmsnorm_scaleless(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm_scaleless(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def gqa_full(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    want_cache: bool = False,
    cache_len: int | None = None,
):
    """Train / prefill self-attention. Returns (out, cache | None); the
    cache is ``{"k", "v"}`` of ``[B, cache_len or S, nkv, hd]``, zero-padded
    past S."""
    q, k, v = _project_qkv(cfg, params, x, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "kernel":
        # [B, S, n, hd] read through strides; o comes back in q's memory
        # order, so `out` is a contiguous [B, S, nq, hd] for the einsum below
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=True).transpose(1, 2)
    else:
        out = _grouped_attention(
            q, k, v, scale=1.0 / math.sqrt(cfg.head_dim), causal=True, q_chunk=cfg.q_chunk,
            causal_skip=cfg.causal_skip,
        )
    out = torch.einsum("bsnh,nhd->bsd", out, params["wo"])
    cache = None
    if want_cache:
        pad = (cache_len or x.shape[1]) - x.shape[1]
        cache = {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
                 "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}
    return out, cache


def gqa_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, cache: dict, pos, ctx=None):
    raise NotImplementedError(f"the one-token GQA decode step {_NOT_PORTED}")


def cross_attention(cfg: ModelConfig, params: dict, x: torch.Tensor, *, ctx_kv=None, ctx=None):
    raise NotImplementedError(f"cross-attention {_NOT_PORTED}")
