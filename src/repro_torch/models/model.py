"""LM top level: init, parameter count, NLL and the serving steps
`prefill_step`/`decode_step` (counterpart of `repro.models.model`). The
train step waits for ROADMAP queue 1 item 13c; the dry-run input specs,
built on the JAX package's mesh, for item 14."""
from __future__ import annotations

import torch

from repro_torch.models import params as pm
from repro_torch.models import transformer
from repro_torch.models.layers import lm_head
from repro_torch.types import ModelConfig, dtype_of


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
