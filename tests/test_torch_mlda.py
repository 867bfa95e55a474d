"""PyTorch port: the host samplers and the slice as a whole. `ensemble_mlda`
is host numpy code in both packages, so with the same inputs and the same
numpy `rng` the two must take identical steps; the tsunami campaign then
runs end to end through each package's fabric and model."""
from functools import partial

import numpy as np
import pytest
import torch

import repro.apps.tsunami as jax_tsunami
import repro.core.fabric as jax_fabric
import repro.uq.mlda as jax_mlda
import repro_torch.apps.tsunami as tsunami
import repro_torch.core.fabric as fabric
import repro_torch.uq.fused as fused
import repro_torch.uq.mcmc as mcmc
import repro_torch.uq.mlda as mlda
from _torch_mesh import one_rank_mesh

# the solves here run [cells, 4] states, far below the size where torch's
# intra-op threads pay; one thread keeps the xdist workers from
# oversubscribing the cores they share with the JAX tests
torch.set_num_threads(1)

MU = np.array([0.5, -0.3])
SIG = np.array([0.8, 0.5])


def _gaussian_levels():
    """Batched level log-posteriors: a coarse Gaussian slightly off the fine
    one, as an MLDA hierarchy has."""

    def level(shift, scale):
        def lp(X):
            X = np.atleast_2d(X)
            return -0.5 * np.sum(((X - MU - shift) / (SIG * scale)) ** 2, axis=1)

        return lp

    return [level(0.1, 1.2), level(0.0, 1.0)]


@pytest.mark.parametrize("adaptive", [False, True])
def test_ensemble_mlda_exact_parity_with_jax_package(adaptive):
    x0s = np.random.default_rng(5).standard_normal((8, 2))
    kw = dict(n_samples=40, subsampling=[3], prop_cov=np.diag([0.6, 0.4]) ** 2,
              adaptive=adaptive, adapt_start=10)
    got = mlda.ensemble_mlda(_gaussian_levels(), x0s, rng=np.random.default_rng(9), **kw)
    want = jax_mlda.ensemble_mlda(_gaussian_levels(), x0s, rng=np.random.default_rng(9), **kw)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.n_waves == want.n_waves
    assert got.evals_per_level == want.evals_per_level
    assert got.accept_rates == want.accept_rates
    if adaptive:
        np.testing.assert_array_equal(got.proposal_cov, want.proposal_cov)


def test_fused_paths_name_their_roadmap_item():
    """The fused samplers run (tests/test_torch_fused.py), on a device mesh
    too (`ctx=`: here the 1x1 CPU mesh of this process, where 2 chains are
    not padded and the run is the run without a mesh, bit for bit; across
    ranks: tests/test_torch_mesh.py). Fused MALA runs over the tsunami,
    whose drift is the SWE solve's autograd rule (`kernels.swe.SweSolve`,
    formerly ROADMAP queue 1, item 7b): finite samples, an acceptance in
    (0, 1] (tests/test_torch_swe_vjp.py holds it to its per-step reference
    and its gradient to the JAX package's)."""
    x0s = np.array([[84.0, 2.3], [97.0, 2.7]])
    target = fused.gaussian_likelihood_target(
        partial(tsunami.solve_batch, n_cells=64, smoothed=True),
        np.zeros(4), np.ones(4))

    def rwm(ctx):
        return mcmc.ensemble_random_walk_metropolis(
            target, x0s, 2, np.eye(2), np.random.default_rng(0),
            fused_steps=2, fused_key=torch.Generator().manual_seed(0), ctx=ctx)

    with one_rank_mesh() as ctx:
        got = rwm(ctx)
    want = rwm(None)
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.logposts, want.logposts)
    mala = mcmc.ensemble_mala(target, x0s, 2, 0.5, np.random.default_rng(0),
                              fused_steps=2, fused_key=torch.Generator().manual_seed(0))
    assert mala.samples.shape == (2, 2, 2) and np.isfinite(mala.samples).all()
    assert np.isfinite(mala.logposts).all()
    assert np.all((mala.accept_rates > 0) & (mala.accept_rates <= 1))


# -- the slice as a whole: the §4.3 campaign through fabric and model ---------

TRUE_THETA = np.array([90.0, 2.5])
PRIOR = ((30.0, 150.0), (0.5, 4.0))
NOISE_SD = np.array([0.5, 0.05, 0.5, 0.05])


def _campaign(pkg_mlda, pkg_fabric, model, data):
    def logprior(theta):
        ok = PRIOR[0][0] <= theta[0] <= PRIOR[0][1] and PRIOR[1][0] <= theta[1] <= PRIOR[1][1]
        return 0.0 if ok else -np.inf

    def loglik(obs):
        return float(-0.5 * np.sum(((np.asarray(obs) - data) / NOISE_SD) ** 2))

    fab = pkg_fabric.EvaluationFabric(pkg_fabric.ModelBackend(model), cache_size=8192)
    try:
        return pkg_mlda.ensemble_mlda(
            None, np.array([[84.0, 2.3], [97.0, 2.7]]), 2, [2],
            np.diag([8.0**2, 0.25**2]), np.random.default_rng(501),
            fabric=fab, level_configs=[{"level": 0}, {"level": 1}],
            loglik=loglik, logprior=logprior,
        )
    finally:
        fab.shutdown()


def test_tsunami_campaign_matches_jax_package():
    """K=2 chains, 2 fine samples, subsampling 2: both packages, the same
    synthetic data, the same numpy rng. The two solvers' observables agree
    within the bounds test_torch_tsunami.py holds them to, far inside the
    margins of these accept decisions, so the chains take the same steps and
    the samples agree exactly."""
    jax_model = jax_tsunami.TsunamiModel()
    data = jax_model.evaluate_batch(TRUE_THETA[None, :], {"level": 1})[0]
    data = data + np.random.default_rng(3).standard_normal(4) * NOISE_SD * 0.5
    port_model = tsunami.TsunamiModel(device="cpu")
    got = _campaign(mlda, fabric, port_model, data)
    want = _campaign(jax_mlda, jax_fabric, jax_model, data)
    assert np.isfinite(got.samples).all() and got.samples.shape == (2, 2, 2)
    np.testing.assert_allclose(got.samples, want.samples, atol=1e-6)
    assert got.n_waves == want.n_waves
    assert got.evals_per_level == want.evals_per_level
    assert got.accept_rates == want.accept_rates
    assert port_model.stats[1] > 0 and port_model.stats[0] > 0
    # both levels made accept decisions that moved a chain
    assert min(got.accept_rates) > 0
