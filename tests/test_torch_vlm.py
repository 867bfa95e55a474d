"""PyTorch port: the vlm family (llama-3.2-vision-90b: self-attention
layers with a cross-attention layer every `cross_attn_period` layers
against the stubbed frontend's context embeddings) against the JAX package,
with the weights carried across: `cross_attention` (from the raw context
and from a precomputed ctx_kv), the forward's logits and prefill caches
(self K/V and the context's K/V), `eval_nll` with `ctx_embed`, `LMUQModel`
over a batch that carries the context, and a level-2 grid through the
fabric, on both attention paths. The kernel path runs cross-attention
through the flash kernel non-causal with Sq != Sk (on the CPU: its plain
version). Bounds: `_torch_zoo`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import UNPADDED_RTOL
from _torch_zoo import (
    IMPLS,
    NLL_RTOL,
    SEQ,
    THETAS,
    assert_carried,
    assert_forward_matches,
    carry,
    jax_grid,
    jax_lm_model,
    jax_outputs,
    port_grid,
    port_lm_model,
    port_outputs,
    rel,
)
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro_torch.apps.lm_model import LMUQModel
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention, model, transformer

ARCH = "llama-3.2-vision-90b"


def test_full_parameter_count():
    assert model.n_params(get_config(ARCH)) == 87_689_863_168
    assert model.n_params(get_config(ARCH)) == jax_model.n_params(jax_get_config(ARCH))
    # the depth chip_smoke.py runs at full width: 8 self and 2 cross layers
    assert model.n_params(get_config(ARCH).replace(n_layers=10)) == 10_680_967_168


@pytest.fixture(scope="module")
def carried():
    return carry(ARCH)


@pytest.fixture(scope="module")
def jax_out(carried, ctx11):
    return jax_outputs(carried, ctx11)


def test_carried_weights_keep_values_and_dtypes(carried):
    # embedding, head, ctx_proj, final norm; per vlm unit a self unit (2
    # norms, 4 attention, 3 MLP) and a cross unit (the same, no qk-norm)
    assert_carried(carried, 4 + 9 + 9)
    assert tuple(carried.params["ctx_proj"].shape) == (32, 128)
    assert tuple(carried.params["groups"][0]["self"]["attn"]["wq"].shape) == (2, 1, 128, 4, 32)
    assert tuple(carried.params["groups"][0]["cross"]["xattn"]["wk"].shape) == (2, 128, 2, 32)


def test_synth_batch_draws_the_context_from_the_generator():
    cfg = get_config(ARCH, reduced=True)
    a = model.make_synth_batch(cfg, 2, 8, torch.Generator().manual_seed(5))
    b = model.make_synth_batch(cfg, 2, 8, torch.Generator().manual_seed(5))
    assert a["ctx_embed"].shape == (2, cfg.n_ctx_tokens, cfg.d_ctx)
    assert a["ctx_embed"].dtype == torch.float32
    torch.testing.assert_close(a["ctx_embed"], b["ctx_embed"], rtol=0, atol=0)
    assert 0.01 < float(a["ctx_embed"].std()) < 0.03
    full = get_config(ARCH)
    assert (full.n_ctx_tokens, full.d_ctx, full.act_dtype) == (1601, 1280, "bfloat16")


class _Calls:
    """Records each flash-attention call: q's and k's shapes and causal."""

    def __init__(self, monkeypatch):
        self.calls = []

        def recording(q, k, v, *, causal=True, scale=None):
            self.calls.append((tuple(q.shape), tuple(k.shape), causal))
            return flash_attention(q, k, v, causal=causal, scale=scale)

        monkeypatch.setattr(attention, "flash_attention", recording)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_cross_attention_matches_jax(carried, monkeypatch, impl):
    c = carried
    cfg = c.cfg.replace(attn_impl=impl)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], c.jparams["groups"][0]["cross"]["xattn"])  # unit 1
    p = {k: v[1] for k, v in c.params["groups"][0]["cross"]["xattn"].items()}
    want, jkv = jax_attention.cross_attention(c.jcfg, jp, jnp.asarray(x), ctx=jnp.asarray(ctx))
    calls = _Calls(monkeypatch)
    got, kv = attention.cross_attention(cfg, p, torch.from_numpy(x), ctx=torch.from_numpy(ctx))
    again, kv2 = attention.cross_attention(cfg, p, torch.from_numpy(x), ctx_kv=kv)
    print(f"{impl}: cross_attention rel err {rel(got, want):.3g}, k {rel(kv['k'], jkv['k']):.3g}")
    assert rel(got, want) < 1e-5
    for key in ("k", "v"):
        assert kv[key].shape == jkv[key].shape == (2, cfg.n_ctx_tokens, cfg.n_kv_heads, 32)
        assert rel(kv[key], jkv[key]) < 1e-5
    assert kv2 is kv
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    if impl == "kernel":  # full attention, 128 queries against 16 context tokens
        assert calls.calls == [((2, 4, SEQ, 32), (2, 2, 16, 32), False)] * 2
    with pytest.raises(ValueError, match="context"):
        attention.cross_attention(cfg, p, torch.from_numpy(x))


@pytest.mark.parametrize("impl", list(IMPLS))
def test_forward_matches_jax(carried, jax_out, monkeypatch, impl):
    calls = _Calls(monkeypatch)
    before = flash_attention.launches
    got = port_outputs(carried, impl)
    assert flash_attention.launches == before  # the CPU takes the plain versions
    assert_forward_matches(got, jax_out, ARCH, impl)
    # caches: the self units' K/V [n, p-1, B, cache_len, nkv, hd] and the
    # context's K/V [n, B, n_ctx_tokens, nkv, hd]
    assert tuple(got["caches"][0]["self"]["k"].shape) == (2, 1, 2, 160, 2, 32)
    assert tuple(got["caches"][0]["cross"]["v"].shape) == (2, 2, 16, 2, 32)
    if impl == "kernel":  # per forward (3 of them): 2 causal self, 2 full cross
        assert sorted(c[2] for c in calls.calls) == [False] * 6 + [True] * 6


def test_forward_needs_the_context(carried):
    with pytest.raises(ValueError, match="ctx_embed"):
        transformer.forward(carried.cfg, carried.params, torch.tensor(carried.batch["tokens"]))


@pytest.fixture(scope="module")
def jm(carried):
    return jax_lm_model(carried)


@pytest.fixture(scope="module", params=list(IMPLS))
def pm(request, carried, jm):
    return port_lm_model(carried, jm, request.param)


@pytest.fixture(scope="module")
def jax_grid_values(jm):
    return jax_grid(jm)


def test_lm_uq_nll_matches_jax(pm, jm):
    assert pm.batch["ctx_embed"].shape == (2, 16, 32)
    np.testing.assert_array_equal(pm.batch["ctx_embed"].numpy(), np.asarray(jm.batch["ctx_embed"]))
    want = np.array([jm([list(t)])[0][0] for t in THETAS])
    got = np.array([pm([list(t)])[0][0] for t in THETAS])
    print(f"{pm.cfg.attn_impl}: NLL {got}, rel err {np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
    wave = pm.evaluate_batch(THETAS)[:, 0]
    np.testing.assert_allclose(wave, got, rtol=UNPADDED_RTOL)


def test_sparse_grid_through_the_fabric_matches_jax(pm, jax_grid_values):
    jSr, want = jax_grid_values
    got, backend = port_grid(pm, jSr)
    assert backend["native_batches"] == 1 and backend["padded"] == 0
    print(f"{pm.cfg.attn_impl}: {len(jSr.points)} points, rel err "
          f"{np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_synthetic_model_cuts_depth_and_keeps_widths():
    m = LMUQModel(ARCH, reduced=True, device="cpu", batch=2, seq=16, n_layers=2)
    assert m.cfg.n_layers == 2 and m.cfg.d_model == 128
    assert m.batch["ctx_embed"].shape == (2, 16, 32)
    out = m.evaluate_batch(THETAS[:2])
    assert out.shape == (2, 1) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="cross_attn_period"):
        LMUQModel(ARCH, reduced=True, device="cpu", n_layers=3)
