"""PyTorch port: multi-head latent attention (minicpm3-4b, dense family with
MLA) against the JAX package, with the weights carried across: `mla_full`
and its latent prefill cache, the forward's logits and caches, `eval_nll`,
`LMUQModel` and a level-2 grid through the fabric, on both attention paths.

MLA's q.k width (nope + rope) and v width are no head dim the flash
kernels are built for: the kernel path zero-pads q, k and v to the next one
(128 at full width, 32 in the reduced config) and passes the scale
1/sqrt(nope + rope); on the CPU the wrapper runs its plain version at that
scale. Bounds: `_torch_zoo`.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import (
    IMPLS,
    LOGITS_RTOL,
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
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention, model

ARCH = "minicpm3-4b"


def test_full_parameter_count():
    assert model.n_params(get_config(ARCH)) == 4_263_336_448
    assert model.n_params(get_config(ARCH)) == jax_model.n_params(jax_get_config(ARCH))


@pytest.fixture(scope="module")
def carried():
    return carry(ARCH)


@pytest.fixture(scope="module")
def jax_out(carried, ctx11):
    return jax_outputs(carried, ctx11)


def test_carried_weights_keep_values_and_dtypes(carried):
    # embedding, head, final norm; per unit 2 norms, 7 MLA leaves, 3 MLP
    assert_carried(carried, 3 + 12)
    attn = carried.params["groups"][0]["attn"]
    assert sorted(attn) == ["kv_a_norm", "q_a_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    full = attention.decl_attention(get_config(ARCH))
    assert full["q_a_norm"].dtype == full["kv_a_norm"].dtype == "float32"
    assert full["wq_b"].shape == (768, 40, 96) and full["wkv_b"].shape == (256, 40, 128)


class _Calls:
    """Records each flash-attention call of the model: q's shape, causal,
    scale."""

    def __init__(self, monkeypatch):
        self.calls = []

        def recording(q, k, v, *, causal=True, scale=None):
            self.calls.append((tuple(q.shape), tuple(v.shape), causal, scale))
            return flash_attention(q, k, v, causal=causal, scale=scale)

        monkeypatch.setattr(attention, "flash_attention", recording)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_mla_full_matches_jax(carried, monkeypatch, impl):
    c = carried
    cfg = c.cfg.replace(attn_impl=impl)
    x = np.random.default_rng(3).standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(SEQ), (2, SEQ))
    jp = jax.tree.map(lambda a: a[1], c.jparams["groups"][0]["attn"])  # layer 1
    p = {k: v[1] for k, v in c.params["groups"][0]["attn"].items()}
    want, jcache = jax_attention.mla_full(c.jcfg, jp, jnp.asarray(x),
                                          positions=jnp.asarray(positions), want_cache=True,
                                          cache_len=SEQ + 32)
    calls = _Calls(monkeypatch)
    got, cache = attention.mla_full(cfg, p, torch.from_numpy(x),
                                    positions=torch.from_numpy(positions.copy()),
                                    want_cache=True, cache_len=SEQ + 32)
    print(f"{impl}: mla_full rel err {rel(got, want):.3g}, "
          f"c_kv {rel(cache['c_kv'], jcache['c_kv']):.3g}, "
          f"k_pe {rel(cache['k_pe'], jcache['k_pe']):.3g}")
    assert rel(got, want) < 1e-5
    for key, width in (("c_kv", cfg.kv_lora_rank), ("k_pe", cfg.qk_rope_head_dim)):
        assert cache[key].shape == jcache[key].shape == (2, SEQ + 32, width)
        assert rel(cache[key], jcache[key]) < 1e-5
        assert not cache[key][:, SEQ:].any()  # zero-padded past S
    if impl == "kernel":
        # q.k over 16 + 8 = 24 columns, v over 16: padded to hd 32
        assert calls.calls == [((2, 4, SEQ, 32), (2, 4, SEQ, 32), True, 1 / math.sqrt(24))]
    else:
        assert calls.calls == []


def test_kernel_path_pads_the_published_widths_to_128(monkeypatch):
    """minicpm3-4b's own widths (q.k 96, v 64) at a small size: the kernel
    path hands the wrapper hd 128 at scale 1/sqrt(96), keeps 64 columns of
    o, and gives the plain path's attention."""
    cfg = get_config(ARCH, reduced=True).replace(q_chunk=1024)
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((1, 48, 3, 96)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, 48, 3, 64)).astype(np.float32))
    calls = _Calls(monkeypatch)
    got = attention._attend(cfg.replace(attn_impl="kernel"), q, k, v, causal=True,
                            scale=1 / math.sqrt(96))
    want = attention._attend(cfg.replace(attn_impl="plain"), q, k, v, causal=True,
                             scale=1 / math.sqrt(96))
    assert calls.calls == [((1, 3, 48, 128), (1, 3, 48, 128), True, 1 / math.sqrt(96))]
    assert got.shape == want.shape == (1, 48, 3, 64)
    print(f"padded kernel path vs plain: rel err {rel(got, want):.3g}")
    assert rel(got, want) < 1e-6


@pytest.mark.parametrize("impl", list(IMPLS))
def test_forward_matches_jax(carried, jax_out, impl):
    before = flash_attention.launches
    got = port_outputs(carried, impl)
    assert flash_attention.launches == before  # the CPU takes the plain versions
    assert_forward_matches(got, jax_out, ARCH, impl)
    assert LOGITS_RTOL[ARCH] == NLL_RTOL  # MLA keeps the dense family's bound


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
    want = np.array([jm([list(t)])[0][0] for t in THETAS])
    got = np.array([pm([list(t)])[0][0] for t in THETAS])
    print(f"{pm.cfg.attn_impl}: NLL {got}, rel err {np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_sparse_grid_through_the_fabric_matches_jax(pm, jax_grid_values):
    jSr, want = jax_grid_values
    got, backend = port_grid(pm, jSr)
    assert backend["native_batches"] == 1 and backend["padded"] == 0
    print(f"{pm.cfg.attn_impl}: {len(jSr.points)} points, rel err "
          f"{np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
