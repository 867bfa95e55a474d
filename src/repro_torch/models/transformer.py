"""Decoder stack assembly (counterpart of `repro.models.transformer`).

A config is compiled to a list of *groups* of identically-shaped units,
whose parameters are stacked with a leading layer dimension:

  dense/audio : [dense x L]
  moe         : [dense x first_k_dense] + [moe x (L - first_k_dense)]
  ssm         : [ssm x L]
  hybrid      : [ssm x rem] + [(ssm x (period-1) + SHARED attn block) x n]
  vlm         : [(self x (period-1) + cross) x n]

(zamba2: the hybrid group's attention block has ONE set of weights,
`params["shared"]`, applied at every invocation, each with its own cache;
llama-3.2-vision: a cross-attention unit every `cross_attn_period` layers,
against the context embeddings projected by `params["ctx_proj"]`.)

The JAX package scans over the stacked units; here a Python loop runs the
layers in order on one device (no sharding context). Every group kind is
ported for `mode="train"` and `"prefill"`; the prefill caches are stacked
as the JAX package's scans stack them. The decode step raises
`NotImplementedError` (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.flash_attention.ops import KERNEL_OF
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    decl_embed,
    decl_mlp,
    decl_rmsnorm,
    embed_tokens,
    lm_head,
    mlp,
    rmsnorm,
)
from repro_torch.models.moe import decl_moe, moe_block
from repro_torch.models.params import ParamDecl, stack, walk
from repro_torch.types import ModelConfig, dtype_of

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 13)"


@dataclass(frozen=True)
class Group:
    kind: str  # dense | moe | ssm | hybrid | vlm
    count: int


def make_groups(cfg: ModelConfig) -> list[Group]:
    L = cfg.n_layers
    if cfg.family in ("dense", "audio"):
        return [Group("dense", L)]
    if cfg.family == "moe":
        gs = []
        if cfg.first_k_dense:
            gs.append(Group("dense", cfg.first_k_dense))
        gs.append(Group("moe", L - cfg.first_k_dense))
        return gs
    if cfg.family == "ssm":
        return [Group("ssm", L)]
    if cfg.family == "hybrid":
        p = cfg.hybrid_period
        n, rem = divmod(L, p)
        gs = []
        if rem:
            gs.append(Group("ssm", rem))
        gs.append(Group("hybrid", n))
        return gs
    if cfg.family == "vlm":
        p = cfg.cross_attn_period
        if L % p:
            raise ValueError("vlm layer count must divide cross_attn_period")
        return [Group("vlm", L // p)]
    raise ValueError(cfg.family)


def kernel_launches(cfg: ModelConfig) -> dict[str, int]:
    """Kernel launches of one forward on the kernel path, by kernel: one SSD
    chunk scan per ssm unit (`ssd`), and one flash attention per attention,
    self, shared or cross, on the kernel of the activation dtype
    (`flash_attention_wgmma` for bf16, `flash_attention` for float32). The
    MoE's GEMMs are library products."""
    ssm = attn = 0
    for g in make_groups(cfg):
        if g.kind in ("dense", "moe"):
            attn += g.count
        elif g.kind == "ssm":
            ssm += g.count
        elif g.kind == "hybrid":
            ssm += g.count * (cfg.hybrid_period - 1)
            attn += g.count
        else:  # vlm
            attn += g.count * cfg.cross_attn_period
    flash = KERNEL_OF[dtype_of(cfg.act_dtype)]
    return {name: n for name, n in (("ssd", ssm), (flash, attn)) if n}


def _decl_dense_unit(cfg: ModelConfig, moe: bool = False) -> dict:
    decls = {
        "ln1": decl_rmsnorm(cfg.d_model),
        "attn": attn_mod.decl_attention(cfg),
        "ln2": decl_rmsnorm(cfg.d_model),
    }
    if moe:
        decls["moe"] = decl_moe(cfg)
    else:
        decls["mlp"] = decl_mlp(cfg.d_model, cfg.d_ff, cfg.use_bias)
    return decls


def _decl_ssm_unit(cfg: ModelConfig) -> dict:
    return {"ln": decl_rmsnorm(cfg.d_model), "ssm": ssm_mod.decl_ssm(cfg)}


def _decl_cross_unit(cfg: ModelConfig) -> dict:
    return {
        "ln1": decl_rmsnorm(cfg.d_model),
        "xattn": attn_mod.decl_attention(cfg, cross=True),
        "ln2": decl_rmsnorm(cfg.d_model),
        "mlp": decl_mlp(cfg.d_model, cfg.d_ff, cfg.use_bias),
    }


def decl_group_unit(cfg: ModelConfig, kind: str) -> dict:
    if kind == "dense":
        return _decl_dense_unit(cfg, moe=False)
    if kind == "moe":
        return _decl_dense_unit(cfg, moe=True)
    if kind == "ssm":
        return _decl_ssm_unit(cfg)
    if kind == "hybrid":
        return {"ssm": stack(_decl_ssm_unit(cfg), cfg.hybrid_period - 1)}
    if kind == "vlm":
        return {
            "self": stack(_decl_dense_unit(cfg), cfg.cross_attn_period - 1),
            "cross": _decl_cross_unit(cfg),
        }
    raise ValueError(kind)


def decl_model(cfg: ModelConfig) -> dict:
    decls: dict = {"embed": decl_embed(cfg)}
    if cfg.family == "vlm":
        decls["ctx_proj"] = ParamDecl((cfg.d_ctx or cfg.d_model, cfg.d_model))
    decls["groups"] = [
        stack(decl_group_unit(cfg, g.kind), g.count) for g in make_groups(cfg)
    ]
    if cfg.family == "hybrid":
        decls["shared"] = _decl_dense_unit(cfg, moe=False)
    decls["final_norm"] = decl_rmsnorm(cfg.d_model)
    return decls


def _dense_unit(cfg: ModelConfig, params: dict, x: torch.Tensor, *, positions, mode: str,
                cache_len: int | None, is_moe: bool = False, points: int = 1):
    """Attention (GQA or MLA) and an MLP or MoE: (x, {"attn": cache} or None,
    aux)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    full = attn_mod.mla_full if cfg.attn_type == "mla" else attn_mod.gqa_full
    a, new_attn = full(cfg, params["attn"], h, positions=positions,
                       want_cache=(mode == "prefill"), cache_len=cache_len)
    x = x + a
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if is_moe:
        m, aux = moe_block(cfg, params["moe"], h2, points=points)
    else:
        m, aux = mlp(params["mlp"], h2), None
    x = x + m
    return x, ({"attn": new_attn} if new_attn is not None else None), aux


def _ssm_unit(cfg: ModelConfig, params: dict, x: torch.Tensor, *, mode: str, use_kernel: bool):
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    s, new_ssm = ssm_mod.ssm_block(
        cfg, params["ssm"], h, cache=None, want_cache=(mode == "prefill"),
        use_kernel=use_kernel,
    )
    return x + s, ({"ssm": new_ssm} if new_ssm is not None else None)


def _cross_unit(cfg: ModelConfig, params: dict, x: torch.Tensor, *, mode: str,
                ctx_embed: torch.Tensor):
    """Cross-attention against the projected context, then the MLP: (x,
    the context's {"k", "v"} in prefill, else None)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a, ctx_kv = attn_mod.cross_attention(cfg, params["xattn"], h, ctx=ctx_embed)
    x = x + a
    x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, (ctx_kv if mode == "prefill" else None)


def _layer(tree, i: int):
    """Unit i of a tree stacked along its leading dim."""
    return walk(tree, lambda t, _path: t[i])


def _stacked(trees: list):
    """Trees of equal structure -> one tree, each leaf stacked along a new
    leading dim (the JAX package's scan outputs)."""
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    ctx_embed: torch.Tensor | None = None,
    mode: str = "train",
    cache_len: int | None = None,
    skip_head: bool = False,
    embed_scale: torch.Tensor | None = None,
    points: int = 1,
):
    """Returns (logits | hidden states if skip_head, new caches | None, aux).

    `embed_scale` [B] multiplies each sequence's gathered embedding rows
    (in the parameter dtype), which is the same multiply as scaling the
    whole table for that sequence; a tied head then reads that sequence's
    scaled table too. `ctx_embed` ``[B, n_ctx_tokens, d_ctx]`` are the vlm
    family's context embeddings. `points` says the B sequences are that
    many UQ points of equal size, which the MoE routes one by one
    (`models/moe.py`); aux is the sum of the MoE layers' load-balance
    losses. `cache_len` pads the prefill attention caches. `cfg.attn_impl`
    picks the kernel or the plain path of the SSD ("kernel": the CUDA
    kernel, "plain": `ssd_scan`) and of attention ("kernel": the flash
    kernel, "plain": `_grouped_attention`); see `types.ModelConfig.attn_impl`."""
    if mode not in ("train", "prefill"):
        raise NotImplementedError(f"forward mode {mode!r} {_NOT_PORTED}")
    if cfg.attn_impl not in ("kernel", "plain"):
        raise ValueError(f"attn_impl must be 'kernel' or 'plain', got {cfg.attn_impl!r}")
    use_kernel = cfg.attn_impl == "kernel"
    B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    if embed_scale is not None:
        x = x * embed_scale.to(x.dtype)[:, None, None]
    x = x.to(dtype_of(cfg.act_dtype))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    if cfg.family == "vlm":
        if ctx_embed is None:
            raise ValueError("the vlm family's forward needs ctx_embed")
        proj = params["ctx_proj"]
        dt = torch.promote_types(ctx_embed.dtype, proj.dtype)
        ctx_embed = (ctx_embed.to(dt) @ proj.to(dt)).to(x.dtype)
    dense = dict(positions=positions, mode=mode, cache_len=cache_len)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for gi, group in enumerate(make_groups(cfg)):
        gparams = params["groups"][gi]
        unit_caches = []
        for layer in range(group.count):
            p = _layer(gparams, layer)
            if group.kind in ("dense", "moe"):
                x, nc, a = _dense_unit(cfg, p, x, is_moe=group.kind == "moe", points=points,
                                       **dense)
                if a is not None:
                    aux = aux + a
            elif group.kind == "ssm":
                x, nc = _ssm_unit(cfg, p, x, mode=mode, use_kernel=use_kernel)
            elif group.kind == "hybrid":
                inner = []
                for i in range(cfg.hybrid_period - 1):
                    x, c = _ssm_unit(cfg, _layer(p["ssm"], i), x, mode=mode,
                                     use_kernel=use_kernel)
                    inner.append(c)
                x, c_attn, _ = _dense_unit(cfg, params["shared"], x, **dense)
                nc = ({"ssm": _stacked(inner)["ssm"], "attn": c_attn["attn"]}
                      if mode == "prefill" else None)
            else:  # vlm
                inner = []
                for i in range(cfg.cross_attn_period - 1):
                    x, c, _ = _dense_unit(cfg, _layer(p["self"], i), x, **dense)
                    inner.append(c)
                x, c_cross = _cross_unit(cfg, p["cross"], x, mode=mode, ctx_embed=ctx_embed)
                nc = ({"self": _stacked(inner)["attn"], "cross": c_cross}
                      if mode == "prefill" else None)
            unit_caches.append(nc)
        if mode == "prefill":
            new_caches.append(_stacked(unit_caches))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    caches = new_caches if mode == "prefill" else None
    if skip_head:
        return x, caches, aux
    if embed_scale is None or "head" in params["embed"]:
        return lm_head(params["embed"], x), caches, aux
    # tied: each sequence's logits read its own scaled table
    logits = torch.cat([lm_head(params["embed"], x[i:i + 1], embed_scale[i]) for i in range(B)])
    return logits, caches, aux
