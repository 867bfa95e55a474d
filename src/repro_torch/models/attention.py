"""Attention (counterpart of `repro.models.attention`): GQA self-attention
with qk-norm, MLA (multi-head latent attention, whose cache holds the
latent) and cross-attention against context embeddings, for train and
prefill, and the one-token decode steps `gqa_decode` and `mla_decode` (the
absorbed form).

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

MLA's q.k width (nope + rope, 96 in minicpm3-4b) and v width (64) are no
head dim the kernels are built for: its kernel path zero-pads q and k and
v to the next one (128) and passes the scale 1/sqrt(nope + rope). Zero
columns add exact zeros to every product, so that is the same function.
Cross-attention runs the kernel non-causal with Sq != Sk.

A decode step attends one query row per sequence on the plain path, as the
JAX package's decode does (XLA, outside any Pallas kernel): it launches no
kernel. It writes its token's row into the caller's cache IN PLACE, where
the JAX package returns a new cache: a functional copy would move the whole
cache a token (ROADMAP queue 3, "Known differences, by design"). On a mesh
the row is written on the rank that owns it (`_write_row`).

Where the cache is split over its rows on 'model' (`cache_decl`: kv heads
that do not divide 'model', and MLA's latent always), a decode step attends
without gathering the cache: flash decoding, as the JAX package's
`gqa_decode` docstring describes it (`_flash_decode`). Each 'model' rank
scores its own rows of [0, pos] and keeps the row max m; the ranks take the
max M by an all-reduce; each rank's sum l and product o of e^(s − M) with
its rows of v are summed by all-reduces, and the output is o / l. A rank
holding no row ≤ pos adds zeros. The query is replicated over 'model' by a
zero-padded sum (`ShardingCtx.replicate_by_sum`), so the step issues
all-reduces only: they run where an all-gather cannot (`gloo` on CUDA
tensors, two ranks on one card).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import P, is_dtensor
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.models.layers import apply_rope, project_in, project_out, rmsnorm_scaleless
from repro_torch.models.params import ParamDecl
from repro_torch.types import ModelConfig

def decl_attention(cfg: ModelConfig, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.attn_type == "mla" and not cross:
        qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return {
            "wq_a": ParamDecl((d, cfg.q_lora_rank), P("data", None)),
            "q_a_norm": ParamDecl((cfg.q_lora_rank,), P(None), init="ones", dtype="float32"),
            "wq_b": ParamDecl((cfg.q_lora_rank, nq, qk_head), P(None, "model", None)),
            "wkv_a": ParamDecl((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), P("data", None)),
            "kv_a_norm": ParamDecl((cfg.kv_lora_rank,), P(None), init="ones", dtype="float32"),
            "wkv_b": ParamDecl((cfg.kv_lora_rank, nq, cfg.qk_nope_head_dim + cfg.v_head_dim),
                               P(None, "model", None)),
            "wo": ParamDecl((nq, cfg.v_head_dim, d), P("model", None, "data"), fan_in_axis=-3),
        }
    decls = {
        "wq": ParamDecl((d, nq, hd), P("data", "model", None)),
        "wk": ParamDecl((d, nkv, hd), P("data", "model", None)),
        "wv": ParamDecl((d, nkv, hd), P("data", "model", None)),
        "wo": ParamDecl((nq, hd, d), P("model", None, "data"), fan_in_axis=-3),
    }
    if cfg.use_bias:
        decls["bq"] = ParamDecl((nq, hd), P("model", None), init="zeros")
        decls["bk"] = ParamDecl((nkv, hd), P("model", None), init="zeros")
        decls["bv"] = ParamDecl((nkv, hd), P("model", None), init="zeros")
    if cfg.qk_norm and not cross:
        decls["q_norm"] = ParamDecl((hd,), P(None), init="ones", dtype="float32")
        decls["k_norm"] = ParamDecl((hd,), P(None), init="ones", dtype="float32")
    return decls


def _grouped_attention(
    q: torch.Tensor,  # [B, Sq, nq, hd]
    k: torch.Tensor,  # [B, Sk, nkv, hdk]
    v: torch.Tensor,  # [B, Sk, nkv, hdv]
    *,
    scale: float,
    causal: bool,
    q_offset: int = 0,
    kv_len: int | None = None,
    q_chunk: int = 1024,
    causal_skip: bool = False,
) -> torch.Tensor:
    """The plain path: scores in float32 (the JAX package's
    `preferred_element_type`), softmax, probabilities cast to v's dtype.
    Rows are independent, so the JAX package's zero-padded last chunk is a
    shorter last chunk here. `q_offset` is the position of q's first row in
    the causal mask; `kv_len` the valid prefix of k and v (a decode step's
    cache): the JAX package masks the columns past it, which add exact
    zeros, so only the prefix is read here."""
    if kv_len is not None:
        causal_skip = False  # as in the JAX package: the skip needs the whole KV
        k, v = k[:, :kv_len], v[:, :kv_len]
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
            rows = q_offset + blk_offset + torch.arange(qc, device=q.device)
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


def _project_qkv(cfg: ModelConfig, params: dict, xq: torch.Tensor, xkv: torch.Tensor,
                 ctx=None):
    q = project_in(xq, params["wq"], ctx)
    k = project_in(xkv, params["wk"], ctx)
    v = project_in(xkv, params["wv"], ctx)
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
    ctx=None,
):
    """Train / prefill self-attention. Returns (out, cache | None); the
    cache is ``{"k", "v"}`` of ``[B, cache_len or S, nkv, hd]``, zero-padded
    past S. `ctx`: the mesh the DTensors are on (`_attend`)."""
    q, k, v = _project_qkv(cfg, params, x, x, ctx)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(cfg, q, k, v, causal=True, ctx=ctx)
    out = project_out(out, params["wo"], ctx)
    cache = None
    if want_cache:
        cache = {"k": _pad_seq(k, cache_len), "v": _pad_seq(v, cache_len)}
    return out, cache


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, scale: float | None = None, ctx=None) -> torch.Tensor:
    """``[B, Sq, nq, dqk]`` q against ``[B, Sk, nkv, dqk]`` k and
    ``[B, Sk, nkv, dv]`` v -> ``[B, Sq, nq, dv]`` at `scale` (None:
    1/sqrt(dqk)), on the path `cfg.attn_impl` names. The kernel path hands
    the flash kernel the ``[B, n, S, hd]`` views of these tensors (read
    through strides; o comes back in q's memory order, a contiguous
    ``[B, Sq, nq, hd]``); where dqk and dv differ, or are no head dim the
    kernels are built for, q, k and v are zero-padded to the next one, and
    o's first dv columns kept. On a mesh (`ctx`, DTensor q, k and v) either
    path runs on each rank's local shard (`_attend_local`)."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if ctx is not None:
        return _attend_local(cfg, q, k, v, causal=causal, scale=scale, ctx=ctx)
    if cfg.attn_impl != "kernel":
        return _grouped_attention(q, k, v, scale=1.0 / math.sqrt(dqk) if scale is None else scale,
                                  causal=causal, q_chunk=cfg.q_chunk,
                                  causal_skip=cfg.causal_skip)
    if dqk != dv or dqk not in HEAD_DIMS:
        hd = min((h for h in HEAD_DIMS if h >= max(dqk, dv)), default=None)
        if hd is None:
            raise ValueError(f"attention: head dims {dqk} and {dv} exceed the kernels' "
                             f"largest, {HEAD_DIMS[-1]}")
        q, k, v = (torch.nn.functional.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v))
        scale = 1.0 / math.sqrt(dqk) if scale is None else scale
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, scale=scale).transpose(1, 2)
    return out[..., :dv]


def _kv_heads_of(nq: int, nkv: int, n_model: int, m: int) -> slice:
    """The kv heads that model rank `m`'s q heads attend to, where the q
    heads are split over `n_model` ranks and the kv heads replicated: the
    group of q head i is i // (nq / nkv), and the slice keeps that pairing
    on the rank (the kernel pairs local q head i with local kv head
    i // (local nq / local nkv)). Raises where no slice can (a rank's q
    heads spanning part of a group)."""
    qloc, g = nq // n_model, nq // nkv
    if g % qloc and (qloc % g or (m * qloc) % g):
        raise ValueError(f"{nq} q heads over {n_model} ranks split the groups of {nkv} kv "
                         "heads unevenly")
    return slice(m * qloc // g, ((m + 1) * qloc - 1) // g + 1)


def _attend_local(cfg: ModelConfig, q, k, v, *, causal: bool, scale: float | None, ctx,
                  fn=None):
    """Attention on a mesh: on each rank's local shard, by `local_map`, the
    flash kernel (forward and backward, through its autograd Function) or
    the plain path. The plain path runs here too, not as DTensor
    operations: its einsums merge the batch and head dimensions, which
    DTensor then shards over several mesh axes at once (a strided shard),
    whose redistribution it plans slowly and, on the dry run's meta
    tensors, not at all. Batch is placed over the batch axes where B
    divides, the q heads over 'model' where they divide, the kv heads too
    where they divide; where they do not (`sanitize_spec`), the kv heads
    are replicated and each rank takes the kv heads of its own q heads
    (`_kv_heads_of`), whose gradient is then a partial sum over 'model'.
    `fn(q, k, v)` replaces `_attend` as the local computation (a decode
    step's attention over the cache)."""
    B, nq, nkv = q.shape[0], q.shape[2], k.shape[2]
    bat = ctx.batch_axes if B % ctx.n_data == 0 else None
    heads = "model" if nq % ctx.n_model == 0 else None
    kv_heads = "model" if heads and nkv % ctx.n_model == 0 else None
    q_spec, kv_spec = P(bat, None, heads, None), P(bat, None, kv_heads, None)
    pick = slice(None)
    if heads and not kv_heads:
        pick = _kv_heads_of(nq, nkv, ctx.n_model, ctx.coordinate["model"])
    kv_grad = ctx.partial_over(kv_spec, "model") if pick != slice(None) else kv_spec

    def local(ql, kl, vl):
        if fn is not None:
            return fn(ql, kl[:, :, pick], vl[:, :, pick])
        return _attend(cfg, ql, kl[:, :, pick], vl[:, :, pick], causal=causal, scale=scale)

    return ctx.local_map(local, q_spec, (q_spec, kv_spec, kv_spec),
                         in_grad_specs=(q_spec, kv_grad, kv_grad))(q, k, v)


def _pad_seq(t: torch.Tensor, cache_len: int | None) -> torch.Tensor:
    """``[B, S, ...]`` zero-padded to ``cache_len`` rows along S. A DTensor
    (its rows not sharded) is padded on each rank's shard and keeps its
    placements: DTensor's own pad gives a spec that has lost a mesh
    dimension in torch 2.11, which the caches' stacking then refuses."""
    widths = (0, 0) * (t.dim() - 2) + (0, (cache_len or t.shape[1]) - t.shape[1])
    if not is_dtensor(t):
        return torch.nn.functional.pad(t, widths)
    from torch.distributed.tensor import DTensor

    if any(p.is_shard() and p.dim == 1 for p in t.placements):
        raise ValueError(f"a prefill's rows are sharded ({t.placements}): no cache to pad")
    local = torch.nn.functional.pad(t.to_local(), widths)
    shape = torch.Size((t.shape[0], cache_len or t.shape[1], *t.shape[2:]))
    return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _decode_positions(x: torch.Tensor, pos: int) -> torch.Tensor:
    """``[B, 1]`` of `pos` on x's device (a fill, no host sync)."""
    return torch.full((x.shape[0], 1), pos, dtype=torch.long, device=x.device)


def gqa_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, cache: dict, pos: int,
               ctx=None):
    """One token's self-attention: x ``[B, 1, d]`` at position `pos` (a
    Python int, the same for every sequence) against the cache ``{"k",
    "v"}`` of ``[B, cache_len, nkv, hd]``. q, k and v are projected,
    qk-normed and rotated at `pos`; k and v are written into the cache's
    row `pos` in place, and the first pos + 1 rows are attended, non-causal,
    on the plain path. Returns (out ``[B, 1, d]``, cache), the cache the
    same dict of the same tensors. With `ctx` and `cfg.decode_seq_shard_kv`
    the cache read is constrained to (batch, seq) as the JAX package's
    is; without a ctx the flag is ignored, as the JAX package ignores it. A
    cache split over its rows on 'model' is attended by flash decoding
    (`_flash_decode`), never gathered."""
    q, k, v = _project_qkv(cfg, params, x, x, ctx)
    positions = _decode_positions(x, pos)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    _write_row(cache["k"], k[:, 0], pos)
    _write_row(cache["v"], v[:, 0], pos)
    kc, vc = cache["k"], cache["v"]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(ql, kl, vl):
        return _grouped_attention(ql, kl, vl, scale=scale, causal=False, kv_len=pos + 1,
                                  q_chunk=cfg.q_chunk)

    if ctx is None:
        out = attend(q, kc, vc)
    elif _rows_split(kc, ctx):
        out = _flash_decode(ctx, (q,), (kc, vc), pos, _gqa_scores(scale), 5, _gqa_weigh)
    else:
        if cfg.decode_seq_shard_kv:
            kc = ctx.constrain(kc, "batch", "seq", None, None)
            vc = ctx.constrain(vc, "batch", "seq", None, None)
        out = _attend_local(cfg, q, kc, vc, causal=False, scale=None, ctx=ctx, fn=attend)
    return project_out(out, params["wo"], ctx), cache


def _write_row(cache: torch.Tensor, row: torch.Tensor, pos: int) -> None:
    """``cache[:, pos] = row`` in place (`cache` ``[B, S, ...]``, `row`
    ``[B, ...]``). A DTensor cache is written on each rank's local shard,
    by the ranks that hold row `pos` (all of them unless the rows are
    split), `row` placed as the cache is but for the row dimension: no
    collective where they already agree."""
    if not is_dtensor(cache):
        cache[:, pos] = row
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def of_row(p):
        if not p.is_shard():
            return p
        return Replicate() if p.dim == 1 else Shard(p.dim - 1 if p.dim > 1 else 0)

    mesh = cache.device_mesh
    if is_dtensor(row):
        row = row.redistribute(mesh, [of_row(p) for p in cache.placements]).to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)
    if offset[1] <= pos < offset[1] + shape[1]:
        cache.to_local()[:, pos - offset[1]] = row


def _rows_split(cache, ctx) -> bool:
    """Whether a decode cache ``[B, S, ...]`` is split over its rows (dim
    1) on a 'model' axis of more than one rank."""
    if ctx is None or ctx.n_model == 1 or not is_dtensor(cache):
        return False
    p = cache.placements[ctx.mesh.mesh_dim_names.index("model")]
    return p.is_shard() and p.dim == 1


def _gqa_scores(scale: float):
    def scores(q, k):
        # q [B, 1, nq, hd] against this rank's rows k [B, Sl, nkv, hd] -> [B, nkv, g, 1, Sl]
        B, _, nq, hd = q.shape
        qg = q.reshape(B, 1, k.shape[2], nq // k.shape[2], hd).to(torch.float32)
        return torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32)) * scale

    return scores


def _gqa_weigh(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # p [B, nkv, g, 1, Sl] with v [B, Sl, nkv, hd] -> [B, 1, nq, hd], float32
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(o.shape[0], 1, -1, o.shape[-1])


def _flash_decode(ctx, qs: tuple, kvs: tuple, pos: int, scores, s_rank: int,
                  weigh) -> torch.Tensor:
    """Flash decoding over a cache split over its rows on 'model' (module
    docstring). `qs`: the step's query tensors ``[B, 1, heads, ...]``
    (DTensors, replicated over 'model' here by a zero-padded sum); `kvs`:
    the cache leaves ``[B, S, ...]``, rows over 'model', the LAST the
    values. `scores(*q_locals, *kv_locals[:-1])` gives float32 scores
    ``[B, ..., 1, Sl]`` of `s_rank` dims over this rank's Sl rows, the
    heads in their flattened order; `weigh(p, v_local)` the float32
    product of weights p (the scores' shape) with this rank's values,
    ``[B, 1, heads, dv]``. Returns the output ``[B, 1, heads, dv]`` in the
    values' dtype, replicated over 'model'."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = ctx.mesh.mesh_dim_names
    B, S = kvs[0].shape[0], kvs[0].shape[1]
    bat = ctx.batch_axes if B % ctx.n_data == 0 else None
    qs = tuple(ctx.replicate_by_sum(q, "model") for q in qs)
    q_specs = tuple(P(bat, *(None,) * (q.dim() - 1)) for q in qs)
    kv_specs = tuple(P(bat, "model", *(None,) * (t.dim() - 2)) for t in kvs)
    lo = ctx.coordinate["model"] * (S // ctx.n_model)

    def placed(over_model) -> tuple:
        """Batch (dim 0) over the batch axes, `over_model` over 'model'."""
        return tuple(over_model if n == "model" else Shard(0) if bat and n in bat
                     else Replicate() for n in names)

    def local_scores(*parts):
        s = scores(*parts)
        rows = lo + torch.arange(s.shape[-1], device=s.device)
        s = s.masked_fill(rows > pos, float("-inf"))  # a rank past pos: all -inf
        return s, torch.amax(s, dim=-1, keepdim=True)

    s, m = ctx.local_map(local_scores, (placed(Shard(s_rank - 1)), placed(Partial("max"))),
                         (*q_specs, *kv_specs[:-1]))(*qs, *kvs[:-1])
    m = m.redistribute(m.device_mesh, placed(Replicate()))  # the max over the ranks

    def local_sums(s, m, v):
        m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)  # -inf - -inf
        p = torch.exp(s - m)
        l = torch.sum(p, dim=-1).reshape(p.shape[0], -1)[:, None, :, None]
        return l, weigh(p, v)

    total = placed(Partial())
    l, o = ctx.local_map(local_sums, (total, total),
                         (placed(Shard(s_rank - 1)), placed(Replicate()), kv_specs[-1]))(
        s, m, kvs[-1])
    l = l.redistribute(l.device_mesh, placed(Replicate()))
    o = o.redistribute(o.device_mesh, placed(Replicate()))
    return (o / l).to(kvs[-1].dtype)


def cross_attention(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                    ctx_kv: dict | None = None, ctx: torch.Tensor | None = None,
                    decode: bool = False, shard_ctx=None):
    """Cross-attention of x ``[B, S, d]`` against context embeddings ``ctx``
    ``[B, Sk, d]`` (k and v projected here) or a precomputed ``ctx_kv``
    ``{"k", "v"}`` of ``[B, Sk, nkv, hd]``: full (non-causal) attention, no
    RoPE, no qk-norm. `decode` takes the plain path whatever
    `cfg.attn_impl` says, as every decode step does. `shard_ctx` is the
    mesh of DTensor inputs (`_attend`). Returns (out, ctx_kv)."""
    q = project_in(x, params["wq"], shard_ctx)
    if ctx_kv is None:
        if ctx is None:
            raise ValueError("cross_attention needs the context embeddings or ctx_kv")
        ctx_kv = {"k": project_in(ctx, params["wk"], shard_ctx),
                  "v": project_in(ctx, params["wv"], shard_ctx)}
    if decode:
        out = _grouped_attention(q, ctx_kv["k"], ctx_kv["v"], causal=False,
                                 scale=1.0 / math.sqrt(cfg.head_dim), q_chunk=cfg.q_chunk)
    else:
        out = _attend(cfg, q, ctx_kv["k"], ctx_kv["v"], causal=False, ctx=shard_ctx)
    out = project_out(out, params["wo"], shard_ctx)
    return out, ctx_kv


def _mla_q(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor, ctx=None):
    cq = rmsnorm_scaleless(x @ params["wq_a"], params["q_a_norm"], cfg.norm_eps)
    q = project_in(cq, params["wq_b"], ctx)
    q_nope, q_pe = torch.split(q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _mla_latent(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor):
    c_kv, k_pe = torch.split(x @ params["wkv_a"], [cfg.kv_lora_rank, cfg.qk_rope_head_dim],
                             dim=-1)
    c_kv = rmsnorm_scaleless(c_kv, params["kv_a_norm"], cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def mla_full(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    want_cache: bool = False,
    cache_len: int | None = None,
    ctx=None,
):
    """Naive (uncompressed) MLA for train/prefill: k and v expanded from the
    latent per head, k's rope part shared by the heads; scale
    1/sqrt(nope + rope). Returns (out, cache | None); the cache holds the
    latent, ``{"c_kv": [B, cache_len or S, kv_lora], "k_pe": [B, cache_len
    or S, rope]}``, zero-padded past S."""
    q_nope, q_pe = _mla_q(cfg, params, x, positions, ctx)
    c_kv, k_pe = _mla_latent(cfg, params, x, positions)
    kv = project_in(c_kv, params["wkv_b"], ctx)
    k_nope, v = torch.split(kv, [cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(*k_nope.shape[:3], cfg.qk_rope_head_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    out = _attend(cfg, q, k, v, scale=scale, causal=True, ctx=ctx)
    out = project_out(out, params["wo"], ctx)
    cache = None
    if want_cache:
        cache = {"c_kv": _pad_seq(c_kv, cache_len), "k_pe": _pad_seq(k_pe, cache_len)}
    return out, cache


def mla_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, cache: dict, pos: int,
               ctx=None):
    """One token's MLA in the absorbed form (DeepSeek-V2): x ``[B, 1, d]``
    at position `pos` against the latent cache ``{"c_kv": [B, cache_len,
    kv_lora], "k_pe": [B, cache_len, rope]}`` that `mla_full` writes. The
    token's latent and rotated k_pe are written into row `pos` in place;
    W_UK and W_UV (slices of `wkv_b`) are folded into the query and the
    output, so the scores are ``q_lat·c_kvᵀ + q_pe·k_peᵀ`` over the first
    pos + 1 rows, in float32, at 1/sqrt(nope + rope), and the
    probabilities are cast to x's dtype before ``p·c_kv``, as in the JAX
    package. Returns (out ``[B, 1, d]``, cache). On a mesh (`ctx`) the
    scores, softmax and ``p·c_kv`` run on each rank's local shard
    (`local_map`: batch over the batch axes, heads over 'model'), as the
    prefill's attention does; where the latent cache is split over its
    rows on 'model' (`cache_decl` splits it so wherever S divides), by
    flash decoding (`_flash_decode`), the cache never gathered."""
    positions = _decode_positions(x, pos)
    q_nope, q_pe = _mla_q(cfg, params, x, positions, ctx)
    c_kv_new, k_pe_new = _mla_latent(cfg, params, x, positions)
    _write_row(cache["c_kv"], c_kv_new[:, 0], pos)
    _write_row(cache["k_pe"], k_pe_new[:, 0], pos)
    w_uk, w_uv = torch.split(params["wkv_b"], [cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
    q_lat = torch.einsum("bqnh,lnh->bqnl", q_nope, w_uk)

    def scores(q_lat, q_pe, c_kv, k_pe):
        s = torch.einsum("bqnl,bsl->bnqs", q_lat.float(), c_kv.float())
        s = s + torch.einsum("bqnr,bsr->bnqs", q_pe.float(), k_pe.float())
        return s / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)

    def latent(q_lat, q_pe, c_kv, k_pe):
        p = torch.softmax(scores(q_lat, q_pe, c_kv, k_pe), dim=-1).to(x.dtype)
        return torch.einsum("bnqs,bsl->bqnl", p, c_kv)

    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    if _rows_split(c_kv, ctx):
        ctx_lat = _flash_decode(ctx, (q_lat, q_pe), (c_kv, k_pe, c_kv), pos, scores, 4,
                                lambda p, c: torch.einsum("bnqs,bsl->bqnl", p, c.float()))
    elif ctx is None:
        ctx_lat = latent(q_lat, q_pe, c_kv[:, :pos + 1], k_pe[:, :pos + 1])
    else:
        c_kv, k_pe = c_kv[:, :pos + 1], k_pe[:, :pos + 1]
        bat = ctx.batch_axes if x.shape[0] % ctx.n_data == 0 else None
        heads = "model" if cfg.n_heads % ctx.n_model == 0 else None
        q_spec, c_spec = P(bat, None, heads, None), P(bat, None, None)
        c_grad = ctx.partial_over(c_spec, "model") if heads else c_spec
        ctx_lat = ctx.local_map(latent, q_spec, (q_spec, q_spec, c_spec, c_spec),
                                in_grad_specs=(q_spec, q_spec, c_grad, c_grad))(
            q_lat, q_pe, c_kv, k_pe)
    out_v = torch.einsum("bqnl,lnv->bqnv", ctx_lat, w_uv)
    return project_out(out_v, params["wo"], ctx), cache
