"""Decoder stack assembly (counterpart of `repro.models.transformer`).

A config is compiled to a list of *groups* of identically-shaped units,
whose parameters are stacked with a leading layer dimension:

  dense/audio : [dense x L]
  moe         : [dense x first_k_dense] + [moe x (L - first_k_dense)]
  ssm         : [ssm x L]
  hybrid      : [ssm x rem] + [(ssm x (period-1) + SHARED attn block) x n]
  vlm         : [(self x (period-1) + cross) x n]

The JAX package scans over the stacked units; here a Python loop runs the
layers in order on one device (no sharding context). The `ssm` and `dense`
groups (without MoE) are ported for `mode="train"` and `"prefill"`; the
other group kinds and the decode step raise `NotImplementedError` (ROADMAP
queue 1, item 13).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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
from repro_torch.models.params import stack, walk
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


def _decl_dense_unit(cfg: ModelConfig) -> dict:
    return {
        "ln1": decl_rmsnorm(cfg.d_model),
        "attn": attn_mod.decl_attention(cfg),
        "ln2": decl_rmsnorm(cfg.d_model),
        "mlp": decl_mlp(cfg.d_model, cfg.d_ff, cfg.use_bias),
    }


def _decl_ssm_unit(cfg: ModelConfig) -> dict:
    return {"ln": decl_rmsnorm(cfg.d_model), "ssm": ssm_mod.decl_ssm(cfg)}


def decl_group_unit(cfg: ModelConfig, kind: str) -> dict:
    if kind == "dense":
        return _decl_dense_unit(cfg)
    if kind == "ssm":
        return _decl_ssm_unit(cfg)
    raise NotImplementedError(f"the {kind!r} group {_NOT_PORTED}")


def decl_model(cfg: ModelConfig) -> dict:
    decls: dict = {"embed": decl_embed(cfg)}
    decls["groups"] = [
        stack(decl_group_unit(cfg, g.kind), g.count) for g in make_groups(cfg)
    ]
    decls["final_norm"] = decl_rmsnorm(cfg.d_model)
    return decls


def _dense_unit(cfg: ModelConfig, params: dict, x: torch.Tensor, *, positions, mode: str,
                cache_len: int | None):
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a, new_attn = attn_mod.gqa_full(
        cfg, params["attn"], h, positions=positions, want_cache=(mode == "prefill"),
        cache_len=cache_len,
    )
    x = x + a
    x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, ({"attn": new_attn} if new_attn is not None else None)


def _ssm_unit(cfg: ModelConfig, params: dict, x: torch.Tensor, *, mode: str, use_kernel: bool):
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    s, new_ssm = ssm_mod.ssm_block(
        cfg, params["ssm"], h, cache=None, want_cache=(mode == "prefill"),
        use_kernel=use_kernel,
    )
    return x + s, ({"ssm": new_ssm} if new_ssm is not None else None)


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    mode: str = "train",
    cache_len: int | None = None,
    skip_head: bool = False,
    embed_scale: torch.Tensor | None = None,
):
    """Returns (logits | hidden states if skip_head, new caches | None, aux).

    `embed_scale` [B] multiplies each sequence's gathered embedding rows
    (in the parameter dtype), which is the same multiply as scaling the
    whole table for that sequence; a tied head then reads that sequence's
    scaled table too. `cache_len` pads the prefill K/V caches of the dense
    group. `cfg.attn_impl` picks the kernel or the plain path of the SSD
    ("kernel": the CUDA kernel, "plain": `ssd_scan`) and of attention
    ("kernel": the flash kernel, "plain": `_grouped_attention`); see
    `types.ModelConfig.attn_impl`."""
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
    new_caches = []
    for gi, group in enumerate(make_groups(cfg)):
        if group.kind not in ("dense", "ssm"):
            raise NotImplementedError(f"the {group.kind!r} group {_NOT_PORTED}")
        gparams = params["groups"][gi]
        layer_caches = []
        for layer in range(group.count):
            p = walk(gparams, lambda t, _path, _l=layer: t[_l])
            if group.kind == "dense":
                x, nc = _dense_unit(cfg, p, x, positions=positions, mode=mode,
                                    cache_len=cache_len)
            else:
                x, nc = _ssm_unit(cfg, p, x, mode=mode, use_kernel=use_kernel)
            layer_caches.append(nc)
        if mode == "prefill":
            # stacked like the JAX package's scan outputs: [L, ...] per leaf
            unit = "attn" if group.kind == "dense" else "ssm"
            new_caches.append({unit: {
                k: torch.stack([c[unit][k] for c in layer_caches]) for k in layer_caches[0][unit]
            }})
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    caches = new_caches if mode == "prefill" else None
    if skip_head:
        return x, caches, aux
    if embed_scale is None or "head" in params["embed"]:
        return lm_head(params["embed"], x), caches, aux
    # tied: each sequence's logits read its own scaled table
    logits = torch.cat([lm_head(params["embed"], x[i:i + 1], embed_scale[i]) for i in range(B)])
    return logits, caches, aux
