"""Deterministic synthetic LM data (port of `repro.data.pipeline`).

  * deterministic: `batch(step)` is a pure function of (seed, step, shard):
    each draws from its own `torch.Generator`, seeded from those three
    through `numpy.random.SeedSequence`, so a restart or a replay after a
    fault sees the same tokens (the JAX package folds them into a threefry
    key);
  * sharded placement (`ctx=`): as the JAX package's `batch()` does, every
    rank builds the GLOBAL batch exactly as without a mesh and keeps its
    rows as a DTensor over the batch axes (`ShardingCtx.put`), so the token
    stream is the same on every mesh shape and an elastic restart replays it
    exactly (`synth_batch_fn`'s `shard`/`n_shards` draw a shard on its own,
    as the JAX package's do; neither package's loop uses them);
  * a Zipf-like marginal over the vocabulary (inverse CDF of a uniform,
    rank = floor(u^(-1/(alpha-1))) - 1) under a Markov backbone (with
    probability 0.7 a token is (previous * 31 + 7) % vocab), so the loss has
    structure to learn.

Threefry and Philox streams never match, so the token streams equal the JAX
package's in law; the formulas equal its formulas exactly on the same
uniforms (`tests/test_torch_data.py`). Tokens and targets are int64 (the
index type of `torch.nn.functional.embedding`; the JAX package's are
int32).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.types import ModelConfig, dtype_of

#: probability that a token follows the Markov map of its predecessor
MARKOV_P = 0.7
#: the Zipf exponent of the marginal
ALPHA = 1.1


def _generator(device: torch.device, *words: int) -> torch.Generator:
    """A generator on `device` seeded from the words (63 bits of a
    SeedSequence's state)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def _uniform(shape, gen: torch.Generator, minval: float = 0.0) -> torch.Tensor:
    """float32 uniforms in [minval, 1), as `jax.random.uniform(..., minval, 1.0)`."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return torch.clamp(u * (1.0 - minval) + minval, min=minval)


def zipf_from_uniform(u: torch.Tensor, vocab: int, alpha: float = ALPHA) -> torch.Tensor:
    """Zipf via inverse CDF on a uniform sample (rank ~ u^(-1/(alpha-1))),
    clipped to the vocabulary; float32 arithmetic, int64 ranks."""
    ranks = torch.floor(u ** (-1.0 / (alpha - 1.0))) - 1.0
    return torch.clamp(ranks, 0, vocab - 1).to(torch.int64)


def markov_mix(base: torch.Tensor, u: torch.Tensor, vocab: int) -> torch.Tensor:
    """Where u < 0.7 a token becomes (previous token * 31 + 7) % vocab (the
    previous of the first is the row's last, as `jnp.roll` gives)."""
    return torch.where(u < MARKOV_P, (torch.roll(base, 1, dims=1) * 31 + 7) % vocab, base)


def synth_batch_fn(cfg: ModelConfig, seed: int, B: int, S: int, device=None):
    """Returns make(step, shard=0, n_shards=1) -> {"tokens", "targets"}
    ``[B / n_shards, S]`` on `device` (default: the card), deterministic in
    (seed, step, shard)."""
    vocab = cfg.vocab_size
    device = resolve_device(device)

    def make(step: int, shard: int = 0, n_shards: int = 1) -> dict:
        gen = _generator(device, seed, step, shard)
        b_local = B // n_shards
        base = zipf_from_uniform(_uniform((b_local, S + 1), gen, 1e-6), vocab)
        mixed = markov_mix(base, _uniform(base.shape, gen), vocab)
        return {"tokens": mixed[:, :S], "targets": mixed[:, 1:]}

    return make


class SyntheticLMData:
    """Batches of `global_batch` sequences of `seq_len` tokens on `device`
    (default: the card); the vlm family's batches also hold ``ctx_embed
    [B, n_ctx_tokens, d_ctx]``, standard normals times 0.02 in the
    activation dtype (the stubbed frontend's patch embeddings). With `ctx`
    (a `ShardingCtx`; `device` is then the rank's) every leaf is a DTensor
    over the batch axes (`ctx_embed` over ("batch", None, None)), each rank
    holding its rows of the same global batch."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int, seed: int = 0,
                 device=None, ctx=None):
        self.cfg = cfg
        self.B = global_batch
        self.S = seq_len
        self.seed = seed
        self.ctx = ctx
        self.device = resolve_device(device)
        self._fn = synth_batch_fn(cfg, seed, global_batch, seq_len, self.device)

    def batch(self, step: int) -> dict:
        out = self._fn(step)
        if self.cfg.family == "vlm":
            gen = _generator(self.device, self.seed + 999, step)
            d_ctx = self.cfg.d_ctx or self.cfg.d_model
            ce = torch.randn((self.B, self.cfg.n_ctx_tokens, d_ctx), generator=gen,
                             device=self.device, dtype=torch.float32) * 0.02
            out["ctx_embed"] = ce.to(dtype_of(self.cfg.act_dtype))
        if self.ctx is not None:
            out = {k: self.ctx.put(v, "batch", *(None,) * (v.dim() - 1)) for k, v in out.items()}
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
