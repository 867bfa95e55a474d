"""LM top level: init, parameter count, the loss and `train_step`, NLL and
the serving steps `prefill_step`/`decode_step` (counterpart of
`repro.models.model`), and the dry run's stand-ins: `abstract_params`,
`param_specs` and `batch_specs` (meta tensors and their `PartitionSpec`s).

Every step function takes `ctx=None`, a `distributed.sharding.ShardingCtx`:
with one, the parameters are DTensors on its mesh (`params.shard`, placed
by `param_specs`), the inputs are made DTensors placed by `batch_specs`,
and the forward constrains its activations as the JAX package's does
(`transformer.forward`); without one, everything runs on one device as
before.

`train_step` takes the gradient with `torch.autograd` where the JAX package
takes `jax.value_and_grad`, and updates the parameters and moments in place
(`optim.adamw.adamw_update`). On the kernel path (`cfg.attn_impl`) the
attention's gradient is the flash backward kernel; the SSD kernel has no
backward yet (ROADMAP queue 1, item 13e) and raises under autograd, so the
ssm and hybrid families train with `attn_impl="plain"`.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import P, ShardingCtx, on_mesh, reduce_partial
from repro_torch.models import params as pm
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models import transformer
from repro_torch.models.layers import lm_head
from repro_torch.optim.adamw import adamw_update
from repro_torch.types import ModelConfig, ShapeConfig, TrainConfig, dtype_of


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random weights of `cfg`, drawn from `gen` on `gen.device`."""
    return pm.materialize(transformer.decl_model(cfg), gen, dtype_of(cfg.param_dtype))


def abstract_params(cfg: ModelConfig):
    """Meta tensors of every parameter's shape and dtype (nothing allocated)."""
    return pm.abstract(transformer.decl_model(cfg), dtype_of(cfg.param_dtype))


def param_specs(cfg: ModelConfig):
    """The `PartitionSpec` of every parameter (FSDP over 'data', TP and EP
    over 'model'), as the JAX package declares them."""
    return pm.specs(transformer.decl_model(cfg))


def shard_params(cfg: ModelConfig, params, ctx: ShardingCtx):
    """Full weights, the same on every rank, as DTensors by `param_specs`."""
    return pm.shard(params, param_specs(cfg), ctx)


def n_params(cfg: ModelConfig) -> int:
    return pm.count_params(transformer.decl_model(cfg))


def mask_padded_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Padded-vocab logits must not leak probability mass."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    idx = torch.arange(cfg.padded_vocab, device=logits.device)
    return logits.masked_fill(idx >= cfg.vocab_size, -1e9)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the last dim, as ATen computes it (the max
    subtracted before the exps and added after the log, an infinite max
    added as 0), written out: on a mesh that shards the last dim (the
    vocabulary over 'model') DTensor then reduces with a max and a sum,
    two all-reduces, where its rule for `torch.logsumexp` gathers the whole
    dim first."""
    m = torch.amax(x, dim=-1, keepdim=True)
    m = m.masked_fill(m.abs() == float("inf"), 0.0)
    return torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m[..., 0]


def _token_nll(cfg: ModelConfig, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = mask_padded_logits(cfg, logits.float())
    logz = logsumexp(logits)
    tgt = reduce_partial(torch.gather(logits, -1, targets[..., None]))[..., 0]
    return logz - tgt


def _chunked_nll(cfg: ModelConfig, params, hidden: torch.Tensor, targets: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """LM head + cross-entropy over sequence chunks of `chunk` rows: the
    ``[B, S, V]`` logits are never held whole; each chunk's are recomputed
    in the backward (a checkpoint per chunk, the JAX package's
    `jax.checkpoint` scan body). Returns the mean NLL over B * S."""
    B, S, _ = hidden.shape

    def body(h_c, t_c):
        return torch.sum(_token_nll(cfg, lm_head(params["embed"], h_c), t_c))

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, chunk):
        h_c, t_c = hidden[:, c:c + chunk], targets[:, c:c + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(body, h_c, t_c, use_reentrant=False)
        else:
            total = total + body(h_c, t_c)
    return total / (B * S)


def _placed(batch: dict, ctx: ShardingCtx | None) -> dict:
    """The batch's tensors as DTensors over the batch axes (`ctx.put`), or
    as they are without a mesh."""
    if ctx is None:
        return batch
    return {k: ctx.put(v, "batch", *(None,) * (v.dim() - 1)) for k, v in batch.items()}


def loss_fn(cfg: ModelConfig, params, batch, ctx: ShardingCtx | None = None):
    """(total loss, {"nll", "aux"}): the mean token NLL (over `batch["mask"]`
    where given) plus `cfg.router_aux_weight` times the MoE layers'
    load-balance loss; with `cfg.loss_chunk` dividing S and no mask, the NLL
    is taken chunk by chunk (`_chunked_nll`). On `ctx`'s mesh the batch is
    placed over the batch axes and the results are DTensors."""
    batch = _placed(batch, ctx)
    with on_mesh(ctx):
        return _loss(cfg, params, batch, ctx)


def _loss(cfg: ModelConfig, params, batch, ctx):
    S = batch["tokens"].shape[1]
    if cfg.loss_chunk and S % cfg.loss_chunk == 0 and "mask" not in batch:
        hidden, _, aux = transformer.forward(cfg, params, batch["tokens"],
                                             ctx_embed=batch.get("ctx_embed"), mode="train",
                                             skip_head=True, ctx=ctx)
        nll = _chunked_nll(cfg, params, hidden, batch["targets"], cfg.loss_chunk)
        total = nll + cfg.router_aux_weight * aux
        return total, {"nll": nll, "aux": aux}
    logits, _, aux = transformer.forward(cfg, params, batch["tokens"],
                                         ctx_embed=batch.get("ctx_embed"), mode="train",
                                         ctx=ctx)
    nll = _token_nll(cfg, logits, batch["targets"])
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    nll = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = nll + cfg.router_aux_weight * aux
    return total, {"nll": nll, "aux": aux}


def loss_and_grads(cfg: ModelConfig, params, batch, ctx: ShardingCtx | None = None):
    """(loss, metrics, grads): `loss_fn` and its gradient with respect to
    every parameter leaf, a tree of `params`' structure (zeros for a leaf
    the loss does not reach, as `jax.grad` gives; on a mesh, DTensors
    placed as their parameters). The parameters' own `requires_grad` flags
    are as they were on return."""
    leaves = tree_leaves(params)
    flags = [leaf.requires_grad for leaf in leaves]
    try:
        for leaf in leaves:
            leaf.requires_grad_(True)
        with torch.enable_grad(), on_mesh(ctx):  # the backward meets plain saved tensors
            loss, metrics = loss_fn(cfg, params, batch, ctx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    finally:
        for leaf, flag in zip(leaves, flags):
            leaf.requires_grad_(flag)
    by_id = {id(leaf): g for leaf, g in zip(leaves, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda leaf: by_id[id(leaf)], params)


def train_step(cfg: ModelConfig, tc: TrainConfig, params, opt_state, batch,
               ctx: ShardingCtx | None = None):
    """One AdamW step on `batch`: returns (params, opt_state, metrics), the
    trees updated in place; metrics are `nll`, `aux`, `loss`, `grad_norm`
    and `lr`, 0-d tensors. On `ctx`'s mesh the parameters and moments are
    DTensors (`shard_params`, `adamw_init`), the gradient's global norm is
    taken over every shard, and the metrics are replicated DTensors."""
    loss, metrics, grads = loss_and_grads(cfg, params, batch, ctx)
    with on_mesh(ctx):
        params, opt_state, opt_stats = adamw_update(params, grads, opt_state, tc)
    return params, opt_state, dict(metrics, loss=loss, **opt_stats)


def eval_nll(cfg: ModelConfig, params, batch, ctx: ShardingCtx | None = None) -> torch.Tensor:
    """Per-sequence mean NLL [B] (the vlm family reads `batch["ctx_embed"]`;
    on `ctx`'s mesh a DTensor over the batch axes)."""
    batch = _placed(batch, ctx)
    with on_mesh(ctx):
        logits, _, _ = transformer.forward(cfg, params, batch["tokens"],
                                           ctx_embed=batch.get("ctx_embed"), mode="train",
                                           ctx=ctx)
        return _token_nll(cfg, logits, batch["targets"]).mean(dim=-1)


def prefill_step(cfg: ModelConfig, params, tokens: torch.Tensor, ctx_embed=None,
                 cache_len: int | None = None, ctx: ShardingCtx | None = None):
    """The full-sequence forward over `tokens` ``[B, S]`` that builds the
    caches (attention caches zero-padded to `cache_len` rows, default S):
    returns (last logits ``[B, V]``, caches). The head runs on the last
    position only, where the JAX package builds ``[B, S, V]`` and keeps the
    last row: the head is per row, so the numbers are the same, and at B =
    82, S = 2,016 and a 153,600-token vocabulary ``[B, S, V]`` would be ~51
    GB in bf16. On `ctx`'s mesh the caches are DTensors placed as
    `cache_decl(cfg, B, cache_len, ctx)` declares them (`init_cache(...,
    ctx=)` makes the same placements), which `decode_step(..., ctx=)`
    takes."""
    cache_len = cache_len or tokens.shape[1]
    hidden, cache, _ = transformer.forward(cfg, params, tokens, ctx_embed=ctx_embed,
                                           mode="prefill", cache_len=cache_len,
                                           skip_head=True, ctx=ctx)
    with on_mesh(ctx):
        logits = lm_head(params["embed"], hidden[:, -1:])[:, 0]
        if ctx is not None:
            logits = ctx.constrain(logits, "batch", "tp")
            cache = transformer.place_caches(cfg, cache, tokens.shape[0], cache_len, ctx)
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, token: torch.Tensor, pos: int,
                ctx: ShardingCtx | None = None):
    """One token ``[B, 1]`` at position `pos` (a Python int) against a
    filled cache: returns (logits ``[B, V]``, cache). The cache's rows
    `pos` (and SSM windows and states) are written in place and the same
    tree is returned (`transformer.forward`, mode "decode"); no host sync.
    On `ctx`'s mesh the cache is `prefill_step`'s or `init_cache`'s DTensors
    (row `pos` written on the ranks that hold it; a cache split over its
    rows attended by flash decoding, `models.attention`)."""
    logits, cache, _ = transformer.forward(cfg, params, token, mode="decode", cache=cache,
                                           pos=pos, ctx=ctx)
    return logits[:, -1], cache


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardingCtx):
    """(abstract inputs, partition specs) of one dry-run cell, as the JAX
    package declares them: meta tensors (int64 tokens, the port's index
    dtype, where the JAX package's are int32) and their specs, batch over
    the batch axes where the global batch divides."""
    B, S = shape.global_batch, shape.seq_len
    bat = ctx.rules["batch"] if B % ctx.n_data == 0 else None
    tok = torch.empty((B, S), dtype=torch.long, device="meta")
    if shape.kind in ("train", "prefill"):
        abstract = {"tokens": tok}
        specs = {"tokens": P(bat, None)}
        if shape.kind == "train":
            abstract["targets"] = torch.empty((B, S), dtype=torch.long, device="meta")
            specs["targets"] = P(bat, None)
        if cfg.family == "vlm":
            abstract["ctx_embed"] = torch.empty((B, cfg.n_ctx_tokens, cfg.d_ctx or cfg.d_model),
                                                dtype=dtype_of(cfg.act_dtype), device="meta")
            specs["ctx_embed"] = P(bat, None, None)
        return abstract, specs
    if shape.kind == "decode":
        decls = transformer.cache_decl(cfg, B, S, ctx)
        abstract = {
            "token": torch.empty((B, 1), dtype=torch.long, device="meta"),
            "cache": pm.walk(decls, lambda d, _p: torch.empty(d.shape, dtype=d.dtype,
                                                               device="meta")),
            "pos": torch.empty((), dtype=torch.long, device="meta"),
        }
        specs = {"token": P(bat, None), "cache": transformer.cache_specs(decls), "pos": P()}
        return abstract, specs
    raise ValueError(shape.kind)


def make_synth_batch(cfg: ModelConfig, B: int, S: int, gen: torch.Generator) -> dict:
    """Small concrete batch: random tokens, targets = tokens shifted by one;
    for the vlm family also ``ctx_embed [B, n_ctx_tokens, d_ctx]``, standard
    normals in the activation dtype times 0.02 (the stubbed frontend's
    patch embeddings)."""
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=gen.device)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "vlm":
        shape = (B, cfg.n_ctx_tokens, cfg.d_ctx or cfg.d_model)
        batch["ctx_embed"] = torch.randn(shape, generator=gen, device=gen.device).to(
            dtype_of(cfg.act_dtype)) * 0.02
    return batch
