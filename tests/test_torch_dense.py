"""PyTorch port: the dense family's forward (qwen3-0.6b, the model
`examples/serve_uq.py` serves) against the JAX package, with the weights
carried across (`convert.lm_params_from_numpy`).

The port's `attn_impl="kernel"` runs `kernels.flash_attention` (on the CPU:
its plain version `attention_ref`); `"plain"` runs `_grouped_attention`,
the JAX package's XLA path in torch ops. The JAX transformer has one
attention path (its `"pallas"` never reaches the flash kernel, ROADMAP
queue 3), so both port paths are held to it, at seq 128: above the
reduced config's q_chunk of 64, so the chunked path runs, with
`causal_skip` off and on. Everything runs in float32 (the reduced config),
so the bounds are float32 reordering bounds; the measured errors print
with -s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.lm_model as jax_lm
from _torch_parity import UNPADDED_RTOL, grid_wave_unpadded_vs_padded
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro.models import transformer as jax_transformer
from repro.uq import sparse_grid as jax_sg
from repro_torch.apps.lm_model import LMUQModel
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.fabric import EvaluationFabric, ModelBackend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention, model, transformer
from repro_torch.models.layers import lm_head
from repro_torch.uq import sparse_grid as sg

ARCH = "qwen3-0.6b"
SEQ = 128
#: relative bound on logits and block outputs (max error over max value):
#: float32 products and softmaxes summed in another order; measured ~1e-6
REL_TOL = 1e-5
#: relative bound on the NLL, as for mamba2 (tests/test_torch_lm.py)
NLL_RTOL = 1e-5
IMPLS = ["kernel", "plain"]
#: theta_0 = 0.7 and 1.3 move the tied head: the repaired scale shows there
THETAS = np.array([[1.0, 1.0], [0.7, 1.0], [1.3, 1.0], [0.8, 1.2], [1.25, 0.75]])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_full_qwen3_parameter_count():
    # counted from the declarations, nothing allocated
    cfg = get_config(ARCH)
    assert model.n_params(cfg) == 597_753_856
    assert model.n_params(cfg) == jax_model.n_params(jax_get_config(ARCH))
    assert cfg.padded_vocab == 153_600 and cfg.tie_embeddings


@pytest.fixture(scope="module")
def carried():
    """The JAX package's reduced qwen3 weights and a [2, 128] synthetic
    batch, and the same weights in the port."""
    jcfg = jax_get_config(ARCH, reduced=True)
    jparams = jax_model.init_params(jcfg, jax.random.key(0))
    batch = jax.tree.map(np.asarray, jax_model.make_synth_batch(jcfg, 2, SEQ, jax.random.key(1)))
    params = lm_params_from_numpy(get_config(ARCH, True), jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, batch, params


def test_carried_weights_keep_values_and_dtypes(carried):
    _, jparams, _, params = carried
    jleaves = jax.tree.leaves(jparams)
    leaves = jax.tree.leaves(params)
    # embedding (tied: no head), 11 per dense unit, final norm
    assert len(leaves) == len(jleaves) == 13
    assert "head" not in params["embed"]
    for t, j in zip(leaves, jleaves):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("causal_skip", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_gqa_full_matches_jax(carried, impl, causal_skip):
    jcfg, jparams, _, params = carried
    cfg = get_config(ARCH, True).replace(attn_impl=impl, causal_skip=causal_skip)
    x = np.random.default_rng(3).standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(SEQ), (2, SEQ))
    jp = jax.tree.map(lambda a: a[1], jparams["groups"][0]["attn"])  # layer 1
    p = {k: v[1] for k, v in params["groups"][0]["attn"].items()}
    want, jcache = jax_attention.gqa_full(jcfg.replace(causal_skip=causal_skip), jp,
                                          jnp.asarray(x), positions=jnp.asarray(positions),
                                          want_cache=True, cache_len=SEQ + 32)
    before = flash_attention.launches
    got, cache = attention.gqa_full(cfg, p, torch.from_numpy(x),
                                    positions=torch.from_numpy(positions.copy()),
                                    want_cache=True, cache_len=SEQ + 32)
    assert flash_attention.launches == before  # the CPU takes the plain versions
    print(f"{impl}, causal_skip={causal_skip}: attention rel err {_rel(got, want):.3g}")
    assert _rel(got, want) < REL_TOL
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape == (2, SEQ + 32, cfg.n_kv_heads, cfg.head_dim)
        assert _rel(cache[key], jcache[key]) < REL_TOL
        assert not cache[key][:, SEQ:].any()  # zero-padded past S


@pytest.mark.parametrize("causal_skip", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(carried, ctx11, impl, causal_skip):
    jcfg, jparams, batch, params = carried
    jcfg = jcfg.replace(causal_skip=causal_skip)
    cfg = get_config(ARCH, True).replace(attn_impl=impl, causal_skip=causal_skip)
    tokens = batch["tokens"]
    with ctx11.mesh:
        want, _, _ = jax_transformer.forward(jcfg, ctx11, jparams, jnp.asarray(tokens),
                                             mode="train")
        _, jcaches, _ = jax_transformer.forward(jcfg, ctx11, jparams, jnp.asarray(tokens),
                                                mode="prefill", cache_len=SEQ + 32)
        jnll = jax_model.eval_nll(jcfg, ctx11, jparams,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    got, _, _ = transformer.forward(cfg, params, torch.tensor(tokens), mode="train")
    _, caches, _ = transformer.forward(cfg, params, torch.tensor(tokens), mode="prefill",
                                       cache_len=SEQ + 32)
    print(f"{impl}, causal_skip={causal_skip}: logits rel err {_rel(got, want):.3g}")
    assert got.shape == want.shape == (2, SEQ, cfg.padded_vocab)
    assert _rel(got, want) < REL_TOL
    for key in ("k", "v"):  # stacked [L, B, cache_len, nkv, hd]
        assert caches[0]["attn"][key].shape == jcaches[0]["attn"][key].shape
        assert _rel(caches[0]["attn"][key], jcaches[0]["attn"][key]) < REL_TOL
    nll = model.eval_nll(cfg, params, {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=NLL_RTOL)


@pytest.mark.parametrize("scale", [0.7, 1.3])
def test_tied_head_reads_the_scaled_table(carried, ctx11, scale):
    """forward(embed_scale=...) on a tied config: each sequence's logits
    read its own scaled table, as the JAX package's forward does on the
    scaled table, and unlike the unscaled head (off by far more than the
    bound)."""
    jcfg, jparams, batch, params = carried
    cfg = get_config(ARCH, True)
    jscaled = dict(jparams, embed={"embedding": jparams["embed"]["embedding"] * scale})
    with ctx11.mesh:
        want, _, _ = jax_transformer.forward(jcfg, ctx11, jscaled, jnp.asarray(batch["tokens"]))
    tokens = torch.tensor(batch["tokens"])
    scales = torch.full((2,), scale)
    got, _, _ = transformer.forward(cfg, params, tokens, embed_scale=scales)
    hidden, _, _ = transformer.forward(cfg, params, tokens, embed_scale=scales, skip_head=True)
    unscaled = lm_head(params["embed"], hidden)
    print(f"theta_0={scale}: rel err {_rel(got, want):.3g}, unscaled head {_rel(unscaled, want):.3g}")
    assert _rel(got, want) < REL_TOL
    assert _rel(unscaled, want) > 100 * REL_TOL


@pytest.fixture(scope="module", params=IMPLS)
def lm_pair(request, carried):
    """(port LMUQModel on one attention path, JAX LMUQModel) on the same
    weights and batch."""
    _, jparams, batch, params = carried
    jm = jax_lm.LMUQModel(ARCH, reduced=True, batch=2, seq=SEQ)
    for t, j in zip(jax.tree.leaves(params), jax.tree.leaves(jm.params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))  # seed 0 in both
    np.testing.assert_array_equal(batch["tokens"], np.asarray(jm.batch["tokens"]))
    pm = LMUQModel(ARCH, reduced=True, device="cpu", params=params, batch=batch)
    pm.cfg = pm.cfg.replace(attn_impl=request.param)
    return pm, jm


def test_lm_uq_nll_matches_jax(lm_pair):
    """Including theta_0 = 0.7 and 1.3, where the tied head must read the
    scaled table: the unscaled head is off by ~1e-3 relative there."""
    pm, jm = lm_pair
    want = np.array([jm([list(t)])[0][0] for t in THETAS])
    got = np.array([pm([list(t)])[0][0] for t in THETAS])
    print(f"{pm.cfg.attn_impl}: NLL {got}, rel err {np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
    # what an unscaled tied head gives at theta_0 = 0.7 and 1.3 is far off
    wave = pm.evaluate_batch(THETAS[1:3])[:, 0]
    np.testing.assert_allclose(wave, want[1:3], rtol=NLL_RTOL)
    tokens, targets = pm.batch["tokens"], pm.batch["targets"]
    for t, w in zip(THETAS[1:3], want[1:3]):
        hidden, _, _ = transformer.forward(pm.cfg, pm.params, tokens, skip_head=True,
                                           embed_scale=torch.full((2,), float(t[0])))
        logits = model.mask_padded_logits(pm.cfg, lm_head(pm.params["embed"], hidden))
        nll = float((torch.logsumexp(logits, -1)
                     - torch.gather(logits, -1, targets[..., None])[..., 0]).mean())
        assert abs(nll / w - 1) > 30 * NLL_RTOL, (t, nll, w)


def test_sparse_grid_through_the_fabric_matches_jax(lm_pair):
    """The serving flow's first step at level 2: the port's grid through
    `EvaluationFabric(ModelBackend(LMUQModel))`, one unpadded wave, against the
    JAX package's grid evaluated by its LMUQModel."""
    pm, jm = lm_pair
    jknots = [jax_sg.knots_uniform_leja(0.7, 1.3)] * 2
    jS = jax_sg.smolyak_grid(2, 2, jknots)
    jSr = jax_sg.reduce_sparse_grid(jS)
    want = jax_sg.evaluate_on_sparse_grid(jm, jSr)
    S = sg.smolyak_grid(2, 2, [sg.knots_uniform_leja(0.7, 1.3)] * 2)
    Sr = sg.reduce_sparse_grid(S)
    np.testing.assert_array_equal(Sr.points, jSr.points)
    fabric = EvaluationFabric(ModelBackend(pm))
    try:
        got = sg.evaluate_on_sparse_grid(fabric, Sr)
        tel = fabric.telemetry()
    finally:
        fabric.shutdown()
    assert tel["backend"]["native_batches"] == 1  # one forward for the grid
    print(f"{pm.cfg.attn_impl}: {len(Sr.points)} points, rel err "
          f"{np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_grid_wave_runs_unpadded(lm_pair):
    """The level-2 grid's 13 points run as ONE 13-point wave: the fabric
    pads nothing (the port has no trace cache to bound), and the values
    equal those of the same points in a wave padded to 16, within
    `UNPADDED_RTOL`."""
    pm, _ = lm_pair
    got, padded, backend = grid_wave_unpadded_vs_padded(pm)
    assert got.shape == (13, 1)
    assert backend["native_batches"] == 1 and backend["native_points"] == 13
    assert backend["padded"] == 0
    print(f"{pm.cfg.attn_impl}: unpadded vs padded max rel diff "
          f"{np.abs(got / padded - 1).max():.3g}")
    np.testing.assert_allclose(got, padded, rtol=UNPADDED_RTOL)
