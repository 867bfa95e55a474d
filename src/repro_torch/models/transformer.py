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
layers in order on one device (no sharding context). Every group kind runs
`mode="train"`, `"prefill"` and `"decode"`. Caches mirror the group
structure with stacked leading dims, as the JAX package's scans stack them
(`cache_decl`): prefill creates them; decode reads them and writes its
token's rows into them IN PLACE, through per-layer views of the stacked
tensors, and returns the same tree (the JAX package returns a new one).

Rematerialization (`cfg.remat`, the JAX package's `_maybe_remat`): in
train mode with grad enabled and parameters that require it, each unit of
the loop (a layer; a hybrid group's period-1 ssm units and its shared
block; a vlm group's self units and its cross unit), the body the JAX
package scans and checkpoints, runs under
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: `"full"`
keeps only the unit's input and recomputes the rest in the backward;
`"dots"` also keeps the outputs of the matrix products (`mm`/`bmm`/`addmm`,
the counterpart of `jax.checkpoint_policies.dots_saveable`); `"none"`
keeps everything. A recompute runs the unit's forward again, kernels
included: on the kernel path a layer's flash attention launches twice a
training step (forward, recompute) beside its backward. The same holds
for a derivative wave of `apps/lm_model.py::LMUQModel`, where only theta
requires grad and it reaches the stack through `embed_scale`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import (
    AbstractMesh,
    P,
    ShardingCtx,
    on_mesh,
    placements_of,
)
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
from repro_torch.models.params import ParamDecl, stack, tree_leaves, walk
from repro_torch.types import ModelConfig, dtype_of

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


#: the products `remat="dots"` keeps (jax.checkpoint_policies.dots_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig, fn, mode: str, params, x: torch.Tensor):
    """`fn` under the checkpoint `cfg.remat` names, in train mode with grad
    enabled and a parameter or the stack's input `x` that requires it (a
    training step; a derivative wave of `LMUQModel`, whose theta reaches
    the stack through the embedding scale); else `fn` itself (an evaluation
    keeps every activation it makes anyway)."""
    if (mode != "train" or cfg.remat == "none" or not torch.is_grad_enabled()
            or not (x.requires_grad or any(t.requires_grad for t in tree_leaves(params)))):
        return fn
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {cfg.remat!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False)


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
        decls["ctx_proj"] = ParamDecl((cfg.d_ctx or cfg.d_model, cfg.d_model), P(None, "data"))
    decls["groups"] = [
        stack(decl_group_unit(cfg, g.kind), g.count) for g in make_groups(cfg)
    ]
    if cfg.family == "hybrid":
        decls["shared"] = _decl_dense_unit(cfg, moe=False)
    decls["final_norm"] = decl_rmsnorm(cfg.d_model)
    return decls


#: the sharding arithmetic's context when the caller gives none: one device
ONE_DEVICE = ShardingCtx(AbstractMesh((1, 1), ("data", "model")))


@dataclass(frozen=True)
class CacheDecl:
    """One cache leaf: its shape and dtype (the JAX package's
    `ShapeDtypeStruct`) and its `PartitionSpec` on the mesh it was declared
    for."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: P = P()


def _batch_ax(ctx: ShardingCtx, B: int):
    """The batch axes where they divide B, else None (replicated): a ragged
    batch runs whole on every rank."""
    return ctx.rules["batch"] if B % ctx.n_data == 0 else None


def constrain_act(cfg: ModelConfig, ctx: ShardingCtx | None, x, mode: str):
    """Residual-stream sharding between blocks. Baseline: batch only.
    seq_shard_activations (train) / context_parallel (prefill) additionally
    shard the SEQ dim over 'model' (Megatron SP / context parallelism). A
    plain tensor (no mesh) passes as it is."""
    if ctx is None:
        return x
    sp = (cfg.seq_shard_activations and mode == "train") or (
        cfg.context_parallel and mode == "prefill"
    )
    if sp and x.ndim == 3 and x.shape[1] % max(ctx.n_model, 1) == 0:
        return ctx.constrain(x, "batch", "seq", None)
    return ctx.constrain(x, "batch", None, None)


def _attn_cache_decl(cfg: ModelConfig, B: int, S: int, ctx: ShardingCtx,
                     lead: tuple[int, ...]) -> dict:
    dt = dtype_of(cfg.act_dtype)
    bat = _batch_ax(ctx, B)
    nm = ctx.n_model
    lead_sp = (None,) * len(lead)
    if cfg.attn_type == "mla":
        seq_ax = "model" if S % nm == 0 else None
        return {"c_kv": CacheDecl((*lead, B, S, cfg.kv_lora_rank), dt,
                                  P(*lead_sp, bat, seq_ax, None)),
                "k_pe": CacheDecl((*lead, B, S, cfg.qk_rope_head_dim), dt,
                                  P(*lead_sp, bat, seq_ax, None))}
    kv_ax = "model" if cfg.n_kv_heads % nm == 0 else None
    seq_ax = "model" if (kv_ax is None and S % nm == 0) else None
    kv = CacheDecl((*lead, B, S, cfg.n_kv_heads, cfg.head_dim), dt,
                   P(*lead_sp, bat, seq_ax, kv_ax, None))
    return {"k": kv, "v": kv}


def _ssm_cache_decl(cfg: ModelConfig, B: int, ctx: ShardingCtx, lead: tuple[int, ...]) -> dict:
    g, r = cfg.ssm_ngroups, cfg.ssm_nheads // cfg.ssm_ngroups
    bat = _batch_ax(ctx, B)
    nm = ctx.n_model
    cdim = ssm_mod.conv_dim(cfg)
    lead_sp = (None,) * len(lead)
    return {
        "conv": CacheDecl((*lead, B, cfg.ssm_conv - 1, cdim), dtype_of(cfg.act_dtype),
                          P(*lead_sp, bat, None, "model" if cdim % nm == 0 else None)),
        "state": CacheDecl((*lead, B, g, r, cfg.ssm_state, cfg.ssm_headdim), torch.float32,
                           P(*lead_sp, bat, None, "model" if r % nm == 0 else None, None, None)),
    }


def cache_decl(cfg: ModelConfig, B: int, S: int, ctx: ShardingCtx | None = None) -> list:
    """The caches of B sequences of `S` rows, one tree a group, as the JAX
    package declares them (`repro/models/transformer.py::cache_decl`):
    ``{"attn": {k, v}}`` (MLA: ``{c_kv, k_pe}``) of a dense or moe group,
    ``{"ssm": {conv, state}}``, a hybrid group's ssm ``[n, period-1, ...]``
    and its shared block's ``attn [n, ...]``, a vlm group's ``self [n,
    period-1, ...]`` and ``cross [n, B, n_ctx_tokens, nkv, hd]``. Every
    leaf in the activation dtype but the SSM state (float32). Allocates
    nothing.

    Each leaf's spec is the JAX package's on `ctx`'s mesh (default: one
    device): batch over the batch axes where B divides; kv heads over
    'model' where they divide, else the sequence; MLA's latent by sequence;
    the SSM's conv channels and heads per group over 'model'."""
    ctx = ONE_DEVICE if ctx is None else ctx
    decls = []
    for g in make_groups(cfg):
        n = g.count
        if g.kind in ("dense", "moe"):
            decls.append({"attn": _attn_cache_decl(cfg, B, S, ctx, (n,))})
        elif g.kind == "ssm":
            decls.append({"ssm": _ssm_cache_decl(cfg, B, ctx, (n,))})
        elif g.kind == "hybrid":
            decls.append({"ssm": _ssm_cache_decl(cfg, B, ctx, (n, cfg.hybrid_period - 1)),
                          "attn": _attn_cache_decl(cfg, B, S, ctx, (n,))})
        else:  # vlm
            kv_ax = "model" if cfg.n_kv_heads % ctx.n_model == 0 else None
            kv = CacheDecl((n, B, cfg.n_ctx_tokens, cfg.n_kv_heads, cfg.head_dim),
                           dtype_of(cfg.act_dtype), P(None, _batch_ax(ctx, B), None, kv_ax, None))
            decls.append({"self": _attn_cache_decl(cfg, B, S, ctx,
                                                   (n, cfg.cross_attn_period - 1)),
                          "cross": {"k": kv, "v": kv}})
    return decls


def cache_specs(decls: list) -> list:
    """The `PartitionSpec` tree of a `cache_decl` tree."""
    return walk(decls, lambda d, _p: d.spec)


def init_cache(cfg: ModelConfig, B: int, S: int, device=None,
               ctx: ShardingCtx | None = None) -> list:
    """Zero caches of `cache_decl(cfg, B, S)` on `device` (default: the
    GPU; raises if there is none). On `ctx`'s mesh each leaf is a DTensor
    placed by `cache_decl(cfg, B, S, ctx)`'s spec, each rank holding its
    shard on its current device (`device` then only says which kind, the
    card by default)."""
    device = resolve_device(device)
    if ctx is None:
        return walk(cache_decl(cfg, B, S),
                    lambda d, _p: torch.zeros(d.shape, dtype=d.dtype, device=device))
    from torch.distributed.tensor import zeros

    if device.type != ctx.mesh.device_type:
        raise ValueError(f"the mesh is on {ctx.mesh.device_type}, the cache asked for {device}")
    names = ctx.mesh.mesh_dim_names
    return walk(cache_decl(cfg, B, S, ctx),
                lambda d, _p: zeros(d.shape, dtype=d.dtype, device_mesh=ctx.mesh,
                                    placements=placements_of(d.spec, names)))


def place_caches(cfg: ModelConfig, caches: list, B: int, S: int, ctx: ShardingCtx) -> list:
    """Caches of `cache_decl`'s structure (a prefill's DTensors) placed by
    `cache_decl(cfg, B, S, ctx)`'s specs: where the rows are split over
    'model', each rank keeps its rows of a cache it holds whole (a local
    slice, no collective)."""
    names = ctx.mesh.mesh_dim_names
    specs = cache_specs(cache_decl(cfg, B, S, ctx))

    def place(t, spec):
        return t.redistribute(t.device_mesh, placements_of(spec, names))

    return _zip_walk(place, caches, specs)


def _zip_walk(fn, tree, specs):
    """`fn(leaf, spec)` over a cache tree and its spec tree (lists and
    dicts; a spec is a tuple, so it is met as a leaf)."""
    if isinstance(tree, dict):
        return {k: _zip_walk(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_walk(fn, v, sp) for v, sp in zip(tree, specs)]
    return fn(tree, specs)


def _dense_unit(cfg: ModelConfig, params: dict, x: torch.Tensor, *, positions, mode: str,
                cache_len: int | None, cache: dict | None = None, pos: int | None = None,
                is_moe: bool = False, points: int = 1, ctx: ShardingCtx | None = None):
    """Attention (GQA or MLA) and an MLP or MoE: (x, {"attn": cache} or None,
    aux). In decode, `cache` is this unit's {"attn": ...}, updated in
    place at row `pos`. On a mesh the residual stream is constrained after
    each block, as the JAX package's is."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        step = attn_mod.mla_decode if cfg.attn_type == "mla" else attn_mod.gqa_decode
        a, new_attn = step(cfg, params["attn"], h, cache["attn"], pos, ctx=ctx)
    else:
        full = attn_mod.mla_full if cfg.attn_type == "mla" else attn_mod.gqa_full
        a, new_attn = full(cfg, params["attn"], h, positions=positions,
                           want_cache=(mode == "prefill"), cache_len=cache_len, ctx=ctx)
    x = constrain_act(cfg, ctx, x + a, mode)
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if is_moe:
        m, aux = moe_block(cfg, params["moe"], h2, points=points, ctx=ctx)
    else:
        m, aux = mlp(params["mlp"], h2), None
    x = constrain_act(cfg, ctx, x + m, mode)
    return x, ({"attn": new_attn} if new_attn is not None else None), aux


def _ssm_unit(cfg: ModelConfig, params: dict, x: torch.Tensor, *, mode: str, use_kernel: bool,
              cache: dict | None = None, ctx: ShardingCtx | None = None):
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    if mode == "decode":
        s, new_ssm = ssm_mod.ssm_decode(cfg, params["ssm"], h, cache["ssm"])
    else:
        s, new_ssm = ssm_mod.ssm_block(
            cfg, params["ssm"], h, cache=None, want_cache=(mode == "prefill"),
            use_kernel=use_kernel, ctx=ctx,
        )
    return constrain_act(cfg, ctx, x + s, mode), ({"ssm": new_ssm} if new_ssm is not None else None)


def _cross_unit(cfg: ModelConfig, params: dict, x: torch.Tensor, *, mode: str,
                ctx_embed: torch.Tensor | None, cache: dict | None = None,
                ctx: ShardingCtx | None = None):
    """Cross-attention against the projected context (in decode: the
    cached {"k", "v"}, which passes through unchanged), then the MLP: (x,
    the context's {"k", "v"} in prefill, else None)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        a, ctx_kv = attn_mod.cross_attention(cfg, params["xattn"], h, ctx_kv=cache, decode=True)
    else:
        a, ctx_kv = attn_mod.cross_attention(cfg, params["xattn"], h, ctx=ctx_embed, shard_ctx=ctx)
    x = x + a
    x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return constrain_act(cfg, ctx, x, mode), (ctx_kv if mode == "prefill" else None)


def _layer(tree, i: int):
    """Unit i of a tree stacked along its leading dim."""
    return walk(tree, lambda t, _path: t[i])


def _stacked(trees: list):
    """Trees of equal structure -> one tree, each leaf stacked along a new
    leading dim (the JAX package's scan outputs)."""
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unit(cfg: ModelConfig, kind: str, x: torch.Tensor, p: dict, c, *, dense: dict,
          use_kernel: bool, points: int, ctx_embed, shared):
    """One unit of a group of `kind` (the body the JAX package scans): its
    parameters `p`, its cache `c` in decode (else None). Returns (x, its
    new cache in prefill or None, the MoE's aux loss or None). On a mesh it
    enters `on_mesh` itself: a remat recompute runs it again in the
    backward, outside the forward's scope."""
    with on_mesh(dense["ctx"]):
        return _unit_body(cfg, kind, x, p, c, dense=dense, use_kernel=use_kernel,
                          points=points, ctx_embed=ctx_embed, shared=shared)


def _unit_body(cfg: ModelConfig, kind: str, x: torch.Tensor, p: dict, c, *, dense: dict,
               use_kernel: bool, points: int, ctx_embed, shared):
    mode, ctx = dense["mode"], dense["ctx"]
    if ctx is not None:  # FSDP: the unit's weights gathered over 'data' as it starts
        p, shared = ctx.gather_fsdp(p), ctx.gather_fsdp(shared)
    decode = mode == "decode"
    if kind in ("dense", "moe"):
        return _dense_unit(cfg, p, x, is_moe=kind == "moe", points=points, cache=c, **dense)
    if kind == "ssm":
        x, nc = _ssm_unit(cfg, p, x, mode=mode, use_kernel=use_kernel, cache=c, ctx=ctx)
        return x, nc, None
    if kind == "hybrid":
        inner = []
        for i in range(cfg.hybrid_period - 1):
            ci = {"ssm": _layer(c["ssm"], i)} if decode else None
            x, ci = _ssm_unit(cfg, _layer(p["ssm"], i), x, mode=mode, use_kernel=use_kernel,
                              cache=ci, ctx=ctx)
            inner.append(ci)
        x, c_attn, _ = _dense_unit(cfg, shared, x, cache={"attn": c["attn"]} if decode else None,
                                   **dense)
        nc = ({"ssm": _stacked(inner)["ssm"], "attn": c_attn["attn"]}
              if mode == "prefill" else None)
        return x, nc, None
    # vlm
    inner = []
    for i in range(cfg.cross_attn_period - 1):
        ci = {"attn": _layer(c["self"], i)} if decode else None
        x, ci, _ = _dense_unit(cfg, _layer(p["self"], i), x, cache=ci, **dense)
        inner.append(ci)
    x, c_cross = _cross_unit(cfg, p["cross"], x, mode=mode, ctx_embed=ctx_embed,
                             cache=c["cross"] if decode else None, ctx=ctx)
    nc = {"self": _stacked(inner)["attn"], "cross": c_cross} if mode == "prefill" else None
    return x, nc, None


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    ctx_embed: torch.Tensor | None = None,
    mode: str = "train",
    cache: list | None = None,
    pos: int | None = None,
    cache_len: int | None = None,
    skip_head: bool = False,
    embed_scale: torch.Tensor | None = None,
    points: int = 1,
    ctx: ShardingCtx | None = None,
):
    """Returns (logits | hidden states if skip_head, caches | None, aux).

    `mode` is "train" (no cache), "prefill" (returns new caches, the
    attention caches zero-padded to `cache_len` rows) or "decode": `tokens`
    ``[B, 1]`` at position `pos` (a Python int, the same for every
    sequence; attention reads the first pos + 1 rows), against `cache`, a
    tree of `cache_decl`'s structure (a prefill's, or `init_cache`'s),
    whose rows `pos` (and SSM windows and states) are written in place; the
    same tree is returned. A decode step runs plain PyTorch whatever
    `cfg.attn_impl` says, as the JAX package's is plain XLA, and launches no
    kernel; the vlm cross caches pass through unchanged.

    `embed_scale` [B] multiplies each sequence's gathered embedding rows
    (in the parameter dtype), which is the same multiply as scaling the
    whole table for that sequence; a tied head then reads that sequence's
    scaled table too. `ctx_embed` ``[B, n_ctx_tokens, d_ctx]`` are the vlm
    family's context embeddings. `points` says the B sequences are that
    many UQ points of equal size, which the MoE routes one by one
    (`models/moe.py`); aux is the sum of the MoE layers' load-balance
    losses. The JAX package's decode has neither `embed_scale` nor
    `points`: decode raises unless both are at their defaults.
    `cfg.attn_impl` picks the kernel or the plain path of the SSD
    ("kernel": the CUDA kernel, "plain": `ssd_scan`) and of attention
    ("kernel": the flash kernel, "plain": `_grouped_attention`); see
    `types.ModelConfig.attn_impl`.

    `ctx` (a `ShardingCtx`) runs the step on its mesh: `params` are then
    DTensors (`models.model.shard_params`); tokens and `ctx_embed`, full
    tensors the same on every rank or DTensors, are placed over the batch
    axes where B divides (else replicated), `embed_scale` is met as
    replicated; the
    residual stream is constrained after the embedding and after every
    block (`constrain_act`) and the logits to (batch, -, tp), as the JAX
    package constrains them; the kernels run on each rank's local shards
    (`local_map`). The results are DTensors."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    if cfg.attn_impl not in ("kernel", "plain"):
        raise ValueError(f"attn_impl must be 'kernel' or 'plain', got {cfg.attn_impl!r}")
    decode = mode == "decode"
    if decode and (cache is None or pos is None):
        raise ValueError("decode needs the cache and pos")
    if decode and (embed_scale is not None or points != 1):
        raise ValueError("decode takes neither embed_scale nor points (the JAX package's "
                         "decode step has neither)")
    if ctx is not None:
        # embed_scale stays a plain tensor, met as replicated (`on_mesh`): a
        # theta that requires grad then gets every rank's part of its gradient
        tokens = ctx.put(tokens, "batch", None)
        if ctx_embed is not None:
            ctx_embed = ctx.put(ctx_embed, "batch", None, None)
    with on_mesh(ctx):
        return _forward(cfg, params, tokens, ctx_embed=ctx_embed, mode=mode, cache=cache,
                        pos=pos, cache_len=cache_len, skip_head=skip_head,
                        embed_scale=embed_scale, points=points, ctx=ctx)


def _forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, ctx_embed, mode: str,
             cache, pos, cache_len, skip_head: bool, embed_scale, points: int, ctx):
    decode = mode == "decode"
    use_kernel = cfg.attn_impl == "kernel"
    B, S = tokens.shape
    if ctx is not None:  # the top-level weights gathered over 'data' (FSDP)
        params = dict(params, **ctx.gather_fsdp({k: params[k] for k in params
                                                 if k not in ("groups", "shared")}))
    x = embed_tokens(params["embed"], tokens, ctx)
    if embed_scale is not None:
        x = x * embed_scale.to(x.dtype)[:, None, None]
    x = constrain_act(cfg, ctx, x.to(dtype_of(cfg.act_dtype)), mode)
    positions = None if decode else torch.arange(S, device=tokens.device).expand(B, S)
    if cfg.family == "vlm" and not decode:
        if ctx_embed is None:
            raise ValueError("the vlm family's forward needs ctx_embed")
        proj = params["ctx_proj"]
        dt = torch.promote_types(ctx_embed.dtype, proj.dtype)
        ctx_embed = (ctx_embed.to(dt) @ proj.to(dt)).to(x.dtype)
    dense = dict(positions=positions, mode=mode, cache_len=cache_len, pos=pos, ctx=ctx)
    unit_kw = dict(dense=dense, use_kernel=use_kernel, points=points, ctx_embed=ctx_embed,
                   shared=params.get("shared"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for gi, group in enumerate(make_groups(cfg)):
        gparams = params["groups"][gi]
        unit_caches = []
        run = _maybe_remat(cfg, functools.partial(_unit, cfg, group.kind, **unit_kw), mode,
                           params, x)
        for layer in range(group.count):
            c = _layer(cache[gi], layer) if decode else None  # views: written in place
            x, nc, a = run(x, _layer(gparams, layer), c)
            if a is not None:
                aux = aux + a
            unit_caches.append(nc)
        if mode == "prefill":
            new_caches.append(_stacked(unit_caches))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    caches = new_caches if mode == "prefill" else cache if decode else None
    if skip_head:
        return x, caches, aux
    if embed_scale is None or "head" in params["embed"]:
        logits = lm_head(params["embed"], x)
    else:
        # tied: each sequence's logits read its own scaled table
        logits = torch.cat([lm_head(params["embed"], x[i:i + 1], embed_scale[i])
                            for i in range(B)])
    if ctx is not None:
        logits = ctx.constrain(logits, "batch", None, "tp")
    return logits, caches, aux
