"""PyTorch port: the LM forward path of the `ssm` family against the JAX
package, with the weights carried across (`convert.lm_params_from_numpy`).

The port's `attn_impl="kernel"` runs `kernels.ssd.ssd` (on the CPU: its plain
chunked version) where the JAX package's `"pallas"` runs its Pallas kernel
(interpret mode on the CPU); the port's `"plain"` runs `ssd_scan` where the
JAX package's `"xla"` does. Both pairs are compared. Everything runs in
float32 (the reduced config), so the bounds are float32 reordering bounds;
the measured errors print with -s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.lm_model as jax_lm
from _torch_parity import UNPADDED_RTOL, grid_wave_unpadded_vs_padded
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro.uq import sparse_grid as jax_sg
from repro_torch.apps.lm_model import LMUQModel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.fabric import EvaluationFabric, ModelBackend
from repro_torch.kernels.ssd import ssd
from repro_torch.models import model, ssm, transformer
from repro_torch.uq import sparse_grid as sg

ARCH = "mamba2-1.3b"
#: relative bound on logits and block outputs (max error over max value):
#: float32 matrix products and scans summed in another order; measured
#: ~1e-6 on the CPU
REL_TOL = 1e-5
#: relative bound on the NLL, the issue's 1e-5; measured <= 1.5e-7 (about
#: one float32 ulp of the mean)
NLL_RTOL = 1e-5
#: (port attn_impl, JAX attn_impl): the kernel path and the plain path
IMPLS = [("kernel", "pallas"), ("plain", "xla")]
THETAS = np.array([[1.0, 1.0], [0.8, 1.2], [1.25, 0.75], [1.1, 0.9], [0.7, 1.3]])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", JAX_ARCH_IDS)
def test_configs_match_jax(name, reduced):
    """Every field equal, except `attn_impl`: the port names its SSD path
    "kernel" | "plain" (default "kernel"), the JAX package "pallas" | "xla"
    (default "xla")."""
    assert ARCH_IDS == JAX_ARCH_IDS
    ours = dataclasses.asdict(get_config(name, reduced))
    theirs = dataclasses.asdict(jax_get_config(name, reduced))
    assert ours.pop("attn_impl") == "kernel" and theirs.pop("attn_impl") == "xla"
    assert ours == theirs
    cfg, jcfg = get_config(name, reduced), jax_get_config(name, reduced)
    for prop in ("head_dim", "padded_vocab", "d_inner", "ssm_nheads", "sub_quadratic"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.param_count() == jcfg.param_count()


def test_full_mamba2_parameter_count():
    # counted from the declarations, nothing allocated
    assert model.n_params(get_config(ARCH)) == 1_450_482_688
    assert model.n_params(get_config(ARCH)) == jax_model.n_params(jax_get_config(ARCH))


@pytest.fixture(scope="module")
def carried():
    """The JAX package's reduced mamba2 weights and synthetic batch, and the
    same weights in the port."""
    jcfg = jax_get_config(ARCH, reduced=True)
    jparams = jax_model.init_params(jcfg, jax.random.key(0))
    batch = jax.tree.map(np.asarray, jax_model.make_synth_batch(jcfg, 2, 64, jax.random.key(1)))
    params = lm_params_from_numpy(get_config(ARCH, True), jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, batch, params


def test_carried_weights_keep_values_and_dtypes(carried):
    jcfg, jparams, _, params = carried
    jleaves = jax.tree.leaves(jparams)
    leaves = jax.tree.leaves(params)  # torch tensors are leaves of the same dict tree
    assert len(leaves) == len(jleaves) == 12  # embedding, head, 9 per ssm unit, final norm
    for t, j in zip(leaves, jleaves):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    bad = jax.tree.map(np.asarray, jparams)
    bad["embed"]["head"] = bad["embed"]["head"][:, :-1]
    with pytest.raises(ValueError, match="embed/head"):
        lm_params_from_numpy(get_config(ARCH, True), bad, "cpu")


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_ssm_block_matches_jax(carried, impl, jimpl):
    jcfg, jparams, _, params = carried
    cfg = get_config(ARCH, True)
    x = np.random.default_rng(2).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["groups"][0]["ssm"])  # layer 1
    p = {k: v[1] for k, v in params["groups"][0]["ssm"].items()}
    want, jcache = jax_ssm.ssm_block(jcfg, jp, jnp.asarray(x), want_cache=True,
                                     use_kernel=jimpl == "pallas")
    got, cache = ssm.ssm_block(cfg, p, torch.from_numpy(x), want_cache=True,
                               use_kernel=impl == "kernel")
    print(f"{impl}: block rel err {_rel(got, want):.3g}, "
          f"state {_rel(cache['state'], jcache['state']):.3g}")
    assert _rel(got, want) < REL_TOL
    assert _rel(cache["state"], jcache["state"]) < REL_TOL
    assert _rel(cache["conv"], jcache["conv"]) < REL_TOL  # the in_proj output's tail


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_forward_matches_jax(carried, ctx11, impl, jimpl):
    jcfg, jparams, batch, params = carried
    cfg = get_config(ARCH, True).replace(attn_impl=impl)
    tokens = batch["tokens"]
    with ctx11.mesh:
        want, _, _ = jax_transformer.forward(jcfg.replace(attn_impl=jimpl), ctx11, jparams,
                                             jnp.asarray(tokens), mode="train")
        _, jcaches, _ = jax_transformer.forward(jcfg.replace(attn_impl=jimpl), ctx11, jparams,
                                                jnp.asarray(tokens), mode="prefill", cache_len=64)
    before = ssd.launches
    got, _, _ = transformer.forward(cfg, params, torch.tensor(tokens), mode="train")
    _, caches, _ = transformer.forward(cfg, params, torch.tensor(tokens), mode="prefill")
    assert ssd.launches == before  # the CPU takes the plain versions
    print(f"{impl}: logits rel err {_rel(got, want):.3g}")
    assert got.shape == want.shape == (2, 64, cfg.padded_vocab)
    assert _rel(got, want) < REL_TOL
    state, jstate = caches[0]["ssm"]["state"], jcaches[0]["ssm"]["state"]
    assert state.shape == jstate.shape  # [L, B, g, r, N, P]
    assert _rel(state, jstate) < REL_TOL
    # per-sequence NLL through the port's eval_nll against the JAX one
    nll = model.eval_nll(cfg, params, {k: torch.tensor(v) for k, v in batch.items()})
    with ctx11.mesh:
        jnll = jax_model.eval_nll(jcfg.replace(attn_impl=jimpl), ctx11, jparams,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=NLL_RTOL)


@pytest.fixture(scope="module", params=IMPLS, ids=[i for i, _ in IMPLS])
def lm_pair(request, carried):
    """(port LMUQModel, JAX LMUQModel) on the same weights and batch."""
    impl, jimpl = request.param
    _, jparams, batch, params = carried
    with pytest.MonkeyPatch.context() as mp:
        # the JAX wrapper reads its config through get_config; this selects
        # its SSD path without touching the package
        mp.setattr(jax_lm, "get_config",
                   lambda arch, reduced: jax_get_config(arch, reduced).replace(attn_impl=jimpl))
        jm = jax_lm.LMUQModel(ARCH, reduced=True, batch=2, seq=64)
    for t, j in zip(jax.tree.leaves(params), jax.tree.leaves(jm.params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))  # seed 0 in both
    np.testing.assert_array_equal(batch["tokens"], np.asarray(jm.batch["tokens"]))
    pm = LMUQModel(ARCH, reduced=True, device="cpu", params=params, batch=batch)
    pm.cfg = pm.cfg.replace(attn_impl=impl)
    return pm, jm


def test_lm_uq_nll_matches_jax(lm_pair):
    pm, jm = lm_pair
    want = np.array([jm([list(t)])[0][0] for t in THETAS])
    got = np.array([pm([list(t)])[0][0] for t in THETAS])
    print(f"{pm.cfg.attn_impl}: NLL {got}, rel err {np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
    assert pm.capabilities().to_json() == jm.capabilities().to_json()  # all eight


def test_wave_equals_per_point_calls(lm_pair):
    """One forward over the wave's [K*B, S] tokens gives each point's NLL:
    the same per-row arithmetic as K separate forwards (equal on the CPU)."""
    pm, _ = lm_pair
    wave = pm.evaluate_batch(THETAS)
    single = np.array([pm.evaluate_batch(t[None])[0] for t in THETAS])
    assert wave.shape == (len(THETAS), 1)
    print(f"{pm.cfg.attn_impl}: wave vs per point max |diff| {np.abs(wave - single).max():.3g}")
    np.testing.assert_allclose(wave, single, rtol=1e-6)


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
    assert tel["backend"]["padded"] == 0  # one 13-point wave, not a 16-point one
    print(f"{pm.cfg.attn_impl}: {len(Sr.points)} points, rel err "
          f"{np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
    # and the surrogate built on it agrees at off-grid points
    x = np.random.default_rng(0).uniform(0.75, 1.25, (64, 2))
    np.testing.assert_allclose(sg.interpolate_on_sparse_grid(S, Sr, got, x),
                               jax_sg.interpolate_on_sparse_grid(jS, jSr, want, x),
                               rtol=NLL_RTOL)


def test_lm_model_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMUQModel(ARCH)


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
