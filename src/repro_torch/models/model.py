"""LM top level: init, parameter count, the loss and `train_step`, NLL and
the serving steps `prefill_step`/`decode_step` (counterpart of
`repro.models.model`). The dry-run input specs, built on the JAX package's
mesh, wait for ROADMAP queue 1 item 14c.

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

from repro_torch.models import params as pm
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models import transformer
from repro_torch.models.layers import lm_head
from repro_torch.optim.adamw import adamw_update
from repro_torch.types import ModelConfig, TrainConfig, dtype_of


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random weights of `cfg`, drawn from `gen` on `gen.device`."""
    return pm.materialize(transformer.decl_model(cfg), gen, dtype_of(cfg.param_dtype))


def n_params(cfg: ModelConfig) -> int:
    return pm.count_params(transformer.decl_model(cfg))


def mask_padded_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Padded-vocab logits must not leak probability mass."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    idx = torch.arange(cfg.padded_vocab, device=logits.device)
    return logits.masked_fill(idx >= cfg.vocab_size, -1e9)


def _token_nll(cfg: ModelConfig, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = mask_padded_logits(cfg, logits.float())
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
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


def loss_fn(cfg: ModelConfig, params, batch):
    """(total loss, {"nll", "aux"}): the mean token NLL (over `batch["mask"]`
    where given) plus `cfg.router_aux_weight` times the MoE layers'
    load-balance loss; with `cfg.loss_chunk` dividing S and no mask, the NLL
    is taken chunk by chunk (`_chunked_nll`)."""
    S = batch["tokens"].shape[1]
    if cfg.loss_chunk and S % cfg.loss_chunk == 0 and "mask" not in batch:
        hidden, _, aux = transformer.forward(cfg, params, batch["tokens"],
                                             ctx_embed=batch.get("ctx_embed"), mode="train",
                                             skip_head=True)
        nll = _chunked_nll(cfg, params, hidden, batch["targets"], cfg.loss_chunk)
        total = nll + cfg.router_aux_weight * aux
        return total, {"nll": nll, "aux": aux}
    logits, _, aux = transformer.forward(cfg, params, batch["tokens"],
                                         ctx_embed=batch.get("ctx_embed"), mode="train")
    nll = _token_nll(cfg, logits, batch["targets"])
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    nll = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = nll + cfg.router_aux_weight * aux
    return total, {"nll": nll, "aux": aux}


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads): `loss_fn` and its gradient with respect to
    every parameter leaf, a tree of `params`' structure (zeros for a leaf
    the loss does not reach, as `jax.grad` gives). The parameters' own
    `requires_grad` flags are as they were on return."""
    leaves = tree_leaves(params)
    flags = [leaf.requires_grad for leaf in leaves]
    try:
        for leaf in leaves:
            leaf.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    finally:
        for leaf, flag in zip(leaves, flags):
            leaf.requires_grad_(flag)
    by_id = {id(leaf): g for leaf, g in zip(leaves, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda leaf: by_id[id(leaf)], params)


def train_step(cfg: ModelConfig, tc: TrainConfig, params, opt_state, batch):
    """One AdamW step on `batch`: returns (params, opt_state, metrics), the
    trees updated in place; metrics are `nll`, `aux`, `loss`, `grad_norm`
    and `lr`, 0-d tensors."""
    loss, metrics, grads = loss_and_grads(cfg, params, batch)
    params, opt_state, opt_stats = adamw_update(params, grads, opt_state, tc)
    return params, opt_state, dict(metrics, loss=loss, **opt_stats)


def eval_nll(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Per-sequence mean NLL [B] (the vlm family reads `batch["ctx_embed"]`)."""
    logits, _, _ = transformer.forward(cfg, params, batch["tokens"],
                                       ctx_embed=batch.get("ctx_embed"), mode="train")
    return _token_nll(cfg, logits, batch["targets"]).mean(dim=-1)


def prefill_step(cfg: ModelConfig, params, tokens: torch.Tensor, ctx_embed=None,
                 cache_len: int | None = None):
    """The full-sequence forward over `tokens` ``[B, S]`` that builds the
    caches (attention caches zero-padded to `cache_len` rows, default S):
    returns (last logits ``[B, V]``, caches). The head runs on the last
    position only, where the JAX package builds ``[B, S, V]`` and keeps the
    last row: the head is per row, so the numbers are the same, and at B =
    82, S = 2,016 and a 153,600-token vocabulary ``[B, S, V]`` would be ~51
    GB in bf16."""
    hidden, cache, _ = transformer.forward(cfg, params, tokens, ctx_embed=ctx_embed,
                                           mode="prefill", cache_len=cache_len or tokens.shape[1],
                                           skip_head=True)
    return lm_head(params["embed"], hidden[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, token: torch.Tensor, pos: int):
    """One token ``[B, 1]`` at position `pos` (a Python int) against a
    filled cache: returns (logits ``[B, V]``, cache). The cache's rows
    `pos` (and SSM windows and states) are written in place and the same
    tree is returned (`transformer.forward`, mode "decode"); no host sync."""
    logits, cache, _ = transformer.forward(cfg, params, token, mode="decode", cache=cache,
                                           pos=pos)
    return logits[:, -1], cache


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
