"""Shared layers: RMSNorm, RoPE, the SwiGLU MLP, embeddings and the LM head
(counterpart of `repro.models.layers`; plain PyTorch, as the reference is
plain jnp: the norms do not call the RMSNorm kernel, as the JAX package's
do not)."""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import P
from repro_torch.models.params import ParamDecl
from repro_torch.types import ModelConfig


def decl_rmsnorm(dim: int) -> dict:
    return {"scale": ParamDecl((dim,), P(None), init="ones", dtype="float32")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rmsnorm_scaleless(x, params["scale"], eps)


def rmsnorm_scaleless(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with an explicit scale array (also the gated-norm variant),
    reduced in float32, returned in x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, n_heads, head_dim]; positions: [..., S] (broadcastable).
    Rotates in float32 and returns x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def decl_mlp(d_model: int, d_ff: int, use_bias: bool = False) -> dict:
    decls = {
        "w_gate": ParamDecl((d_model, d_ff), P("data", "model")),
        "w_up": ParamDecl((d_model, d_ff), P("data", "model")),
        "w_down": ParamDecl((d_ff, d_model), P("model", "data")),
    }
    if use_bias:
        decls["b_gate"] = ParamDecl((d_ff,), P("model"), init="zeros")
        decls["b_up"] = ParamDecl((d_ff,), P("model"), init="zeros")
        decls["b_down"] = ParamDecl((d_model,), P(None), init="zeros")
    return decls


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) * (x W_up)) W_down, with optional biases."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    if "b_gate" in params:
        g = g + params["b_gate"]
        u = u + params["b_up"]
    y = (torch.nn.functional.silu(g) * u) @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return y


def project_in(x: torch.Tensor, w: torch.Tensor, ctx=None) -> torch.Tensor:
    """``[B, S, d] x [d, n, h] -> [B, S, n, h]`` (the einsum
    "bsd,dnh->bsnh") as one matrix product with w's heads flattened.

    On a mesh (`ctx`, DTensors) the flattening and the split of the heads
    back out run on each rank's local shards (`local_map`), with the heads
    over 'model' where they divide: DTensor's own view rules cannot split a
    flattened dimension that it sharded where the heads do not divide, and
    the einsum's reshapes give it strided shards that it propagates
    slowly, and under the dry run's meta tensors not at all."""
    d, n, h = w.shape
    if ctx is None:
        return (x @ w.reshape(d, n * h)).unflatten(-1, (n, h))
    y = x @ _flat_heads(ctx, w, 1)
    bat, heads, n_loc = _heads_on(ctx, x.shape[0], n)
    return ctx.local_map(lambda yl: yl.unflatten(-1, (n_loc, h)), P(bat, None, heads, None),
                         (P(bat, None, heads),))(y)


def project_out(o: torch.Tensor, w: torch.Tensor, ctx=None) -> torch.Tensor:
    """``[B, S, n, h] x [n, h, d] -> [B, S, d]`` (the einsum
    "bsnh,nhd->bsd") as one matrix product (`project_in`)."""
    n, h, d = w.shape
    if ctx is None:
        return o.flatten(-2) @ w.reshape(n * h, d)
    bat, heads, _ = _heads_on(ctx, o.shape[0], n)
    o = ctx.local_map(lambda ol: ol.flatten(-2), P(bat, None, heads),
                      (P(bat, None, heads, None),))(o)
    return o @ _flat_heads(ctx, w, 0)


def _heads_on(ctx, B: int, n: int):
    """(batch axes or None, 'model' or None, heads per rank) of a
    ``[B, S, n, h]`` activation on the mesh."""
    bat = ctx.batch_axes if B % ctx.n_data == 0 else None
    if n % ctx.n_model:
        return bat, None, n
    return bat, "model", n // ctx.n_model


def _flat_heads(ctx, w, dim: int):
    """The DTensor weight `w` with dims `dim` and `dim + 1` (heads and head
    width) flattened on each rank's shard, its placements kept (the heads
    lead the flattened dimension, so a shard of the heads is a shard of
    it)."""
    from torch.distributed.tensor import Shard

    def merged(p):
        if not p.is_shard() or p.dim < dim:
            return p
        if p.dim == dim + 1:
            raise ValueError("a weight sharded along its head width")
        return Shard(p.dim) if p.dim == dim else Shard(p.dim - 1)

    placements = tuple(w.placements)
    return ctx.local_map(lambda wl: wl.flatten(dim, dim + 1), tuple(merged(p) for p in placements),
                         (placements,))(w)


def decl_embed(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    decls = {"embedding": ParamDecl((v, cfg.d_model), P("model", "data"),
                                         init="embed")}
    if not cfg.tie_embeddings:
        decls["head"] = ParamDecl((cfg.d_model, v), P("data", "model"))
    return decls


def embed_tokens(params: dict, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
    """The embedding rows of `tokens`. On a mesh the lookup runs on each
    rank's local shards (`local_map`), and the table's gradient is each
    batch rank's partial sum over its own rows (DTensor's own lookup
    gathers the table, and its `index_put` backward fails to propagate in
    torch 2.11). Where the 'model' axis shards the vocabulary, each rank
    looks its own rows up (the others zero) and the rows are a partial sum
    over 'model' (Megatron's vocabulary-parallel embedding)."""
    table = params["embedding"]
    if ctx is None:
        return table[tokens]
    bat = ctx.batch_axes if tokens.shape[0] % ctx.n_data == 0 else None
    if ctx.n_model == 1 or table.shape[0] % ctx.n_model:
        whole = P(None, None)
        table_grad = ctx.partial_over(whole, *ctx.batch_axes) if bat else whole
        return ctx.local_map(lambda tok, tab: tab[tok], P(bat, None, None), (P(bat, None), whole),
                             in_grad_specs=(P(bat, None), table_grad))(tokens, table)
    v0 = ctx.coordinate["model"] * (table.shape[0] // ctx.n_model)

    def local(tok, tab):
        rel = tok - v0
        hit = (rel >= 0) & (rel < tab.shape[0])
        return tab[rel.clamp(0, tab.shape[0] - 1)] * hit[..., None].to(tab.dtype)

    # the table's gradient: each batch rank's rows a partial sum over the batch axes
    table_grad = ctx.partial_over(P("model", None), *ctx.batch_axes) if bat else P("model", None)
    return ctx.local_map(local, ctx.partial_over(P(bat, None, None), "model"),
                         (P(bat, None), P("model", None)),
                         in_grad_specs=(P(bat, None), table_grad))(tokens, table)


def lm_head(params: dict, x: torch.Tensor, embed_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Logits of hidden states x. A tied head reads the embedding table; with
    `embed_scale` (a scalar) it reads the table scaled as the embedding was,
    `table * embed_scale` in the parameter dtype, as the JAX package's
    `LMUQModel` scales the one table both use. An untied head is not scaled."""
    if "head" in params:
        return x @ params["head"]
    table = params["embedding"]
    if embed_scale is not None:
        table = table * embed_scale.to(table.dtype)
    return x @ table.T.to(x.dtype)
