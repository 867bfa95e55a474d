"""PyTorch port: the moe family (deepseek-moe-16b; kimi-k2-1t-a32b's count)
against the JAX package, with the weights carried across: the router, the
capacity-gather block (`models/moe.py`, held to the JAX package's
`moe_block` under its 1x1 mesh), the forward's logits, aux and prefill
caches, `eval_nll`, `LMUQModel` and a level-2 grid through the fabric, on
both attention paths. The MoE's GEMMs are library products on every
device; the kernel path runs the flash kernel (on the CPU: its plain
version).

The port runs a wave of K points as one forward over K·B sequences and
routes each point on its own (`points=K`), as the JAX package's vmap does:
in a case where the capacity really drops tokens, a 3-point wave equals the
three one-point calls and the JAX package's wave. Bounds: `_torch_zoo`.
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
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import model, moe, transformer

ARCH = "deepseek-moe-16b"
KIMI = "kimi-k2-1t-a32b"
#: a capacity factor under which the reduced model's dispatch drops pairs:
#: a point's 256 tokens choose 2 of 8 experts, 64 pairs per expert on
#: average, and each expert gets 64 slots, so any expert above the mean drops
DROP_FACTOR = 1.0


@pytest.mark.parametrize("arch,count", [(ARCH, 16_375_728_128),
                                        (KIMI, 1_028_298_994_688)])
def test_full_parameter_count(arch, count):
    assert model.n_params(get_config(arch)) == count
    assert model.n_params(get_config(arch)) == jax_model.n_params(jax_get_config(arch))


@pytest.fixture(scope="module")
def carried():
    return carry(ARCH)


@pytest.fixture(scope="module")
def jax_out(carried, ctx11):
    return jax_outputs(carried, ctx11)


def test_carried_weights_keep_values_and_dtypes(carried):
    # embedding, head, final norm; per dense unit 2 norms, 4 attention, 3
    # MLP; per MoE unit 2 norms, 4 attention, router, 3 stacked experts and
    # a shared MLP of 3 (the router in float32)
    assert_carried(carried, 3 + 9 + 13)
    router = carried.params["groups"][1]["moe"]["router"]
    assert router.dtype == torch.float32 and tuple(router.shape) == (2, 128, 8)
    assert tuple(carried.params["groups"][1]["moe"]["w_gate"].shape) == (2, 8, 128, 64)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _moe_input(c, seed=0):
    return np.random.default_rng(seed).standard_normal((2, 64, c.cfg.d_model)).astype(np.float32)


def test_router_topk_matches_jax(carried):
    c = carried
    x = _moe_input(c)
    jw, jidx, jaux = jax_moe.router_topk(c.jcfg, _layer(c.jparams["groups"][1]["moe"], 0),
                                         jnp.asarray(x))
    w, idx, aux = moe.router_topk(c.cfg, _layer(c.params["groups"][1]["moe"], 0),
                                  torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    print(f"router: weights max |diff| {np.abs(w.numpy() - np.asarray(jw)).max():.3g}, "
          f"aux {float(aux)} vs {float(jaux)}")
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert w.dtype == torch.float32 and idx.shape == (2, 64, 2)


class _CountDrops:
    """Wraps `moe.dispatch` to count the (token, choice) pairs it drops."""

    def __init__(self, monkeypatch):
        self.dropped = 0
        self.calls = 0
        real = moe.dispatch

        def counting(idx, n_experts, points, capacity):
            tok, pos = real(idx, n_experts, points, capacity)
            self.dropped += int((pos < 0).sum())
            self.calls += 1
            return tok, pos

        monkeypatch.setattr(moe, "dispatch", counting)


@pytest.mark.parametrize("capacity", [None, 12])
def test_moe_block_matches_jax(carried, mesh11, monkeypatch, capacity):
    """The block at one layer's weights under the JAX package's 1x1 mesh:
    at the default capacity (40 slots) and at 12, where it drops pairs."""
    c = carried
    x = _moe_input(c, seed=1)
    with mesh11:
        want, jaux = jax_moe.moe_block(c.jcfg, _layer(c.jparams["groups"][1]["moe"], 1),
                                       jnp.asarray(x), mesh11, capacity=capacity)
    drops = _CountDrops(monkeypatch)
    got, aux = moe.moe_block(c.cfg, _layer(c.params["groups"][1]["moe"], 1),
                             torch.from_numpy(x), capacity=capacity)
    print(f"moe_block capacity={capacity}: rel err {rel(got, want):.3g}, "
          f"{drops.dropped} pairs dropped")
    assert rel(got, want) < 1e-6
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if capacity == 12:
        assert drops.dropped > 0


def _dispatch_by_hand(idx, E, P, C):
    """The plan with Python loops: per (expert, point), the pairs in flat
    order, the first C kept."""
    T, k = idx.shape
    tok = np.zeros(E * P * C, np.int64)
    pos = -np.ones((T, k), np.int64)
    per_point = T // P
    for e in range(E):
        for p in range(P):
            c = 0
            for t in range(p * per_point, (p + 1) * per_point):
                for j in range(k):
                    if idx[t, j] == e:
                        if c < C:
                            tok[(e * P + p) * C + c] = t
                            pos[t, j] = (e * P + p) * C + c
                        c += 1
    return tok, pos


@pytest.mark.parametrize("points", [1, 3])
def test_dispatch_plan_is_stable_per_point_and_capped(points):
    rng = np.random.default_rng(points)
    E, k, T, C = 5, 2, 30 * points, 9
    idx = np.stack([rng.choice(E, k, replace=False, p=[.4, .3, .1, .1, .1]) for _ in range(T)])
    tok, pos = moe.dispatch(torch.from_numpy(idx), E, points, C)
    want_tok, want_pos = _dispatch_by_hand(idx, E, points, C)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert (want_pos < 0).any()  # expert 0 takes ~24 pairs a point for 9 slots


@pytest.mark.parametrize("impl", list(IMPLS))
def test_forward_matches_jax(carried, jax_out, impl):
    before = flash_attention.launches
    got = port_outputs(carried, impl)
    assert flash_attention.launches == before  # the CPU takes the plain versions
    assert_forward_matches(got, jax_out, ARCH, impl)
    # caches stacked as the JAX scans stack them: [L, B, cache_len, nkv, hd]
    assert tuple(got["caches"][1]["attn"]["k"].shape) == (2, 2, 160, 4, 32)


@pytest.fixture(scope="module")
def kimi(ctx11):
    c = carry(KIMI)
    return c, jax_outputs(c, ctx11)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_kimi_forward_matches_jax(kimi, impl):
    """kimi-k2-1t-a32b's reduced config: 1 dense and 2 MoE layers of 8
    experts, top-2, 1 shared expert, GQA 4 over 2 kv heads."""
    c, want = kimi
    assert (c.cfg.n_experts, c.cfg.top_k, c.cfg.n_shared_experts, c.cfg.n_kv_heads) == (8, 2, 1, 2)
    assert_forward_matches(port_outputs(c, impl), want, KIMI, impl)


@pytest.fixture(scope="module")
def dropping():
    """The reduced model at DROP_FACTOR in both packages, its JAX model, and
    the JAX wave of THETAS (one vmapped call)."""
    c = carry(ARCH, capacity_factor=DROP_FACTOR)
    jm = jax_lm_model(c, capacity_factor=DROP_FACTOR)
    return c, port_lm_model(c, jm, "kernel"), jm, jm.evaluate_batch(THETAS)


def test_wave_with_dropped_tokens_equals_per_point_calls_and_jax(dropping, monkeypatch):
    """Capacity drops pairs in this case. Each point of a 3-point wave is
    routed on its own, as the JAX package's vmap routes it: the wave equals
    the three one-point calls within UNPADDED_RTOL, and the JAX wave within
    NLL_RTOL. Routed over the whole wave at one capacity, it would not."""
    c, pm, _, jwave = dropping
    drops = _CountDrops(monkeypatch)
    wave = pm.evaluate_batch(THETAS)
    wave_drops = drops.dropped
    single = np.array([pm.evaluate_batch(t[None])[0] for t in THETAS])
    print(f"dropped pairs in the wave: {wave_drops}; wave vs per point "
          f"{np.abs(wave / single - 1).max():.3g}, vs JAX {np.abs(wave / jwave - 1).max():.3g}")
    assert wave_drops > 0
    assert drops.dropped == 2 * wave_drops  # the same drops, point by point
    np.testing.assert_allclose(wave, single, rtol=UNPADDED_RTOL)
    np.testing.assert_allclose(wave, jwave, rtol=NLL_RTOL)
    # one dispatch over the whole wave (points not told apart, one capacity
    # for all) routes and drops across points: another function
    monkeypatch.setattr(transformer, "moe_block",
                        lambda cfg, p, x, points=1, ctx=None: moe.moe_block(cfg, p, x))
    mixed = pm.evaluate_batch(THETAS)
    print(f"routed over the whole wave: vs per point {np.abs(mixed / single - 1).max():.3g}")
    assert np.abs(mixed / single - 1).max() > 100 * UNPADDED_RTOL


@pytest.fixture(scope="module")
def jm(carried):
    return jax_lm_model(carried)


@pytest.fixture(scope="module", params=list(IMPLS))
def pair(request, carried, jm):
    return port_lm_model(carried, jm, request.param), jm


@pytest.fixture(scope="module")
def jax_grid_values(jm):
    return jax_grid(jm)


def test_lm_uq_nll_matches_jax(pair):
    pm, jm = pair
    want = np.array([jm([list(t)])[0][0] for t in THETAS])
    got = np.array([pm([list(t)])[0][0] for t in THETAS])
    print(f"{pm.cfg.attn_impl}: NLL {got}, rel err {np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_sparse_grid_through_the_fabric_matches_jax(pair, jax_grid_values):
    pm, _ = pair
    jSr, want = jax_grid_values
    got, backend = port_grid(pm, jSr)
    assert backend["native_batches"] == 1 and backend["padded"] == 0
    print(f"{pm.cfg.attn_impl}: {len(jSr.points)} points, rel err "
          f"{np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_model_pool_runs_the_moe_wave(pair):
    """`ModelPool(lm)` over the MoE model: one call of its batched program,
    the values of the model's own wave."""
    pm, _ = pair
    pool = ModelPool(pm)
    np.testing.assert_array_equal(pool.evaluate(THETAS), pm.evaluate_batch(THETAS))
    assert pool.stats["batches"] == 1 and pool.stats["padded"] == 0
