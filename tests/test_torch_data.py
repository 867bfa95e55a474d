"""PyTorch port: the synthetic LM data (`repro_torch.data.pipeline`)
against the JAX package's (`repro.data.pipeline`).

Threefry and Philox streams never match, so the two are held:

* in formula, exactly: the JAX package's `_zipf_tokens` and `synth_batch_fn`
  run with `jax.random.uniform` replaced by the same numpy uniforms the
  port's `zipf_from_uniform` and `markov_mix` take give the same tokens and
  targets;
* in law: over many steps, each package's tokens against analytic values
  of three features (the clipped top rank vocab-1, the ranks below 8, and
  a token being the Markov map (prev * 31 + 7) % vocab of its predecessor,
  which the 0.7 mix sets), within `tests/_stat_harness.py`'s
  Monte-Carlo-error bounds (z = 5 on the pooled ESS);
* and the port is deterministic: a batch is a function of (seed, step),
  the same across instances and call orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro_torch.configs import get_config
from repro_torch.data import pipeline

from _stat_harness import assert_moments

ARCH = "qwen3-0.6b"  # reduced: a 512-token vocabulary
B, S = 4, 64


def _f(x, vocab):
    return (x * 31 + 7) % vocab


def _uniforms(shape, seed, minval=0.0):
    u = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return np.maximum(u * np.float32(1.0 - minval) + np.float32(minval),
                      np.float32(minval)).astype(np.float32)


def test_zipf_formula_exact(monkeypatch):
    vocab = 512
    u = _uniforms((B, S + 1), 0, 1e-6)
    u[0, :3] = [1e-6, 0.999999, 0.5]
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    want = np.asarray(jax_pipeline._zipf_tokens(jax.random.key(0), u.shape, vocab))
    got = pipeline.zipf_from_uniform(torch.from_numpy(u), vocab)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == vocab - 1  # both clips are met


def test_batch_formula_exact(monkeypatch):
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    vocab = cfg.vocab_size
    draws = [_uniforms((B, S + 1), 1, 1e-6), _uniforms((B, S + 1), 2)]
    calls = iter(draws)
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(next(calls)))
    want = jax_pipeline.synth_batch_fn(jcfg, 0, B, S)(3)
    base = pipeline.zipf_from_uniform(torch.from_numpy(draws[0]), vocab)
    mixed = pipeline.markov_mix(base, torch.from_numpy(draws[1]), vocab)
    np.testing.assert_array_equal(mixed[:, :S].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(mixed[:, 1:].numpy(), np.asarray(want["targets"]))


def test_deterministic_in_seed_and_step():
    cfg = get_config(ARCH, reduced=True)
    a = pipeline.SyntheticLMData(cfg, B, S, seed=5, device="cpu")
    b = pipeline.SyntheticLMData(cfg, B, S, seed=5, device="cpu")
    first = a.batch(3)
    b.batch(0), b.batch(7)  # other steps in between
    for k in ("tokens", "targets"):
        assert first[k].dtype == torch.int64 and tuple(first[k].shape) == (B, S)
        torch.testing.assert_close(first[k], b.batch(3)[k], rtol=0, atol=0)
        torch.testing.assert_close(first[k], a.batch(3)[k], rtol=0, atol=0)
    torch.testing.assert_close(first["tokens"][:, 1:], first["targets"][:, :-1], rtol=0, atol=0)
    assert not torch.equal(first["tokens"], a.batch(4)["tokens"])
    other = pipeline.SyntheticLMData(cfg, B, S, seed=6, device="cpu").batch(3)
    assert not torch.equal(first["tokens"], other["tokens"])
    # sharded construction: a shard's rows are drawn on their own
    fn = pipeline.synth_batch_fn(cfg, 5, B, S, device="cpu")
    assert tuple(fn(3, shard=1, n_shards=2)["tokens"].shape) == (B // 2, S)


def test_vlm_ctx_embed_deterministic():
    cfg = get_config("llama-3.2-vision-90b", reduced=True)
    a = pipeline.SyntheticLMData(cfg, 2, 16, seed=0, device="cpu").batch(1)
    b = pipeline.SyntheticLMData(cfg, 2, 16, seed=0, device="cpu").batch(1)
    ce = a["ctx_embed"]
    assert tuple(ce.shape) == (2, cfg.n_ctx_tokens, cfg.d_ctx or cfg.d_model)
    torch.testing.assert_close(ce, b["ctx_embed"], rtol=0, atol=0)
    assert 0.01 < float(ce.float().std()) < 0.03  # standard normals times 0.02


def _analytic(vocab: int) -> np.ndarray:
    """Means of the three features: P(tok = vocab-1), P(tok < 8) and
    P(tok_t = f(tok_{t-1})), from the base law p(r) = (r+1)^-0.1 -
    (r+2)^-0.1 (r < vocab-1), p(vocab-1) = vocab^-0.1, and the mix."""
    r = np.arange(vocab, dtype=np.float64)
    p = (r + 1) ** -0.1 - (r + 2) ** -0.1
    p[-1] = vocab ** -0.1
    inv = np.empty(vocab, int)
    inv[_f(np.arange(vocab), vocab)] = np.arange(vocab)  # f is a bijection (31 odd)
    marg = 0.3 * p + 0.7 * p[inv]
    c1 = float(np.sum(p * p[_f(np.arange(vocab), vocab)]))
    c2 = float(np.sum(p * p[_f(_f(np.arange(vocab), vocab), vocab)]))
    return np.array([marg[-1], marg[:8].sum(), 0.21 + 0.58 * c1 + 0.21 * c2])


def _features(tokens: np.ndarray, vocab: int) -> np.ndarray:
    """[rows, S-1, 3]: the features at positions 1.. of each row."""
    t = tokens[:, 1:]
    return np.stack([t == vocab - 1, t < 8, t == _f(tokens[:, :-1], vocab)], -1).astype(float)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_marginal_and_mix_in_law(package):
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    vocab, rows, seq, steps = cfg.vocab_size, 16, 256, 8
    if package == "port":
        data = pipeline.SyntheticLMData(cfg, rows, seq, seed=11, device="cpu")
        toks = [data.batch(s)["tokens"].numpy() for s in range(steps)]
    else:
        fn = jax_pipeline.synth_batch_fn(jcfg, 11, rows, seq)
        toks = [np.asarray(fn(s)["tokens"]) for s in range(steps)]
    feats = _features(np.concatenate(toks), vocab)
    mean = _analytic(vocab)
    report = assert_moments(feats, mean, mean * (1 - mean), burn_frac=0.0, z=5.0,
                            label=f"{package} synthetic tokens")
    print(f"{package}: features {np.round(report['mean'], 4)} vs {np.round(mean, 4)}")
