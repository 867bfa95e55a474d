"""PyTorch port: the second-order posterior previews (`uq/inference.py`) and
the gradient-informed MLDA campaign, against the JAX package on the CPU.
The drivers are host numpy code in both packages; what differs is the
model below them. So the linear-Gaussian cases (a `TorchModel` against a
`JAXModel`) must agree to rounding, and the small tsunami runs each
package's own solver and derivative waves through each package's fabric
with the same numpy rng."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.tsunami as jax_tsunami
import repro.core.fabric as jax_fabric
import repro.uq.inference as jax_inference
import repro.uq.mlda as jax_mlda
import repro_torch.apps.tsunami as tsunami
import repro_torch.core.fabric as fabric
import repro_torch.uq.inference as inference
import repro_torch.uq.mlda as mlda
from repro.core.interface import JAXModel
from repro.core.interface import Model as JaxModel
from repro_torch.core.interface import Model, TorchModel, UnsupportedCapability

torch.set_num_threads(1)

# linear-Gaussian ground truth (tests/test_inference.py): y ~ N(A theta,
# Gamma), theta ~ N(mu0, Sigma0)
A = np.array([[1.0, 0.5, 0.0], [0.0, 1.0, -1.0], [2.0, 0.0, 1.0], [0.5, 0.5, 0.5]])
D, M = 3, 4
GAMMA = np.diag([0.5, 0.3, 0.2, 0.4])
MU0 = np.array([0.5, -1.0, 0.25])
SIGMA0 = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]])
Y_OBS = np.array([1.0, -0.5, 2.0, 0.3])


def _exact_posterior():
    Ginv, P0 = np.linalg.inv(GAMMA), np.linalg.inv(SIGMA0)
    cov = np.linalg.inv(A.T @ Ginv @ A + P0)
    return cov @ (A.T @ Ginv @ Y_OBS + P0 @ MU0), cov


def _linear_torch_model():
    A_t = torch.as_tensor(A, dtype=torch.float32)
    return TorchModel(lambda th: A_t @ th, D, M, name="lin", device="cpu")


@pytest.mark.parametrize("curvature", ["full", "gn"])
def test_laplace_preview_exact_on_linear_gaussian(curvature):
    """The JAX package's linear-Gaussian check on the port: the first Newton
    step lands on the exact posterior, in the same wave economics."""
    mean_ref, cov_ref = _exact_posterior()
    with fabric.EvaluationFabric(fabric.ModelBackend(_linear_torch_model()),
                                 cache_size=0) as fab:
        res = inference.laplace_preview(
            fab, Y_OBS, GAMMA, MU0, SIGMA0, curvature=curvature, n_ensemble=3,
            n_iters=10, rng=np.random.default_rng(0))
        pc = fab.telemetry()["per_capability"]
    assert res.method == "laplace" and res.converged
    np.testing.assert_allclose(res.mean, mean_ref, atol=1e-4)
    np.testing.assert_allclose(res.cov, cov_ref, rtol=1e-4, atol=1e-6)
    # wave economics: fused value+grad, JVP probes and (full only) HVP
    # probes, and not one evaluate dispatch
    waves = {op: pc.get(op, {"waves": 0})["waves"]
             for op in ("value_and_gradient", "apply_jacobian", "apply_hessian", "evaluate")}
    assert sum(waves.values()) == res.waves and waves["evaluate"] == 0
    assert (waves["apply_hessian"] > 0) == (curvature == "full")


class _EvalOnlyLinear(Model):
    def get_input_sizes(self, c=None):
        return [D]

    def get_output_sizes(self, c=None):
        return [M]

    def supports_evaluate(self):
        return True

    def evaluate_batch(self, thetas, config=None):
        return np.atleast_2d(thetas) @ A.T


class _JaxEvalOnlyLinear(JaxModel):
    get_input_sizes = _EvalOnlyLinear.get_input_sizes
    get_output_sizes = _EvalOnlyLinear.get_output_sizes
    supports_evaluate = _EvalOnlyLinear.supports_evaluate
    evaluate_batch = _EvalOnlyLinear.evaluate_batch


def test_posterior_preview_negotiates_and_matches_jax_package():
    """Laplace on a derivative-capable backend, EKI on an evaluate-only
    one; each equal to the JAX package's run on the same inputs and rng."""
    jax_model = JAXModel(lambda th: jnp.asarray(A) @ th, D, M, name="lin")
    with fabric.EvaluationFabric(fabric.ModelBackend(_linear_torch_model()), cache_size=0) as fab, \
            jax_fabric.EvaluationFabric(jax_fabric.ModelBackend(jax_model), cache_size=0) as jfab:
        got = inference.posterior_preview(fab, Y_OBS, GAMMA, MU0, SIGMA0,
                                          rng=np.random.default_rng(4))
        want = jax_inference.posterior_preview(jfab, Y_OBS, GAMMA, MU0, SIGMA0,
                                               rng=np.random.default_rng(4))
    assert got.method == want.method == "laplace"
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.cov, want.cov, rtol=1e-4, atol=1e-6)
    with fabric.EvaluationFabric(fabric.ModelBackend(_EvalOnlyLinear()), cache_size=0) as fab:
        with pytest.raises(UnsupportedCapability):
            fab.gradient_batch(np.zeros((1, D)), np.ones((1, M)))
        got = inference.posterior_preview(fab, Y_OBS, GAMMA, MU0, SIGMA0,
                                          rng=np.random.default_rng(5), eki_ensemble=2000)
    # the same evaluate-only model in the JAX package: the same numpy code
    with jax_fabric.EvaluationFabric(jax_fabric.ModelBackend(_JaxEvalOnlyLinear()),
                                     cache_size=0) as jfab:
        want = jax_inference.posterior_preview(jfab, Y_OBS, GAMMA, MU0, SIGMA0,
                                               rng=np.random.default_rng(5), eki_ensemble=2000)
    assert got.method == want.method == "eki"
    np.testing.assert_array_equal(got.mean, want.mean)
    np.testing.assert_allclose(got.mean, _exact_posterior()[0], atol=0.12)


# -- the small tsunami through each package's fabric --------------------------

TRUE_THETA = np.array([90.0, 2.5])
NOISE_SD = np.array([0.5, 0.05, 0.5, 0.05])
PRIOR = ((30.0, 150.0), (0.5, 4.0))


class SmallModel(tsunami.TsunamiModel):
    N_CELLS = {0: 64, 1: 128}


class SmallJaxModel(jax_tsunami.TsunamiModel):
    N_CELLS = {0: 64, 1: 128}


def _data():
    y = SmallJaxModel().evaluate_batch(TRUE_THETA[None, :], {"level": 1})[0]
    return y + np.random.default_rng(3).standard_normal(4) * NOISE_SD


#: bound of the port's tsunami previews against the JAX package's: the MAP
#: search is a deterministic function of the two solvers' float32 waves,
#: which differ by the amounts `test_torch_tsunami_grad.py` bounds (first
#: order <= 1.25e-3 of the largest entry; a float32 HVP up to 8.1e-2 from
#: the exact one in both packages). Measured on these inputs: the MAP 2.1e-4
#: ("gn") and 4.5e-4 ("full") relative, the covariance 2.7e-3 and 5.6e-2
#: (the "full" one carries the HVP term); the bounds are about 4x those
LAPLACE_TOL = {"gn": dict(map_rtol=2e-3, cov_rtol=1e-2),
               "full": dict(map_rtol=2e-3, cov_rtol=2e-1)}
#: the EKI ensemble after two tempered steps of evaluate waves (measured:
#: 1.75e-4 relative; the solvers' heights differ by up to 1e-3, SOLVE_TOL)
EKI_RTOL = 1e-3
#: the MALA campaign's samples: the proposals' drift reads the two solvers'
#: gradients (measured: 2.3e-4 relative, in 2 of 32 entries; the others
#: equal). Those differences also flip 2 of the 48 coarse MALA accept
#: decisions (rate 0.833 against 0.792); the bound allows 3, and the fine
#: level's decisions must all agree
MALA_RTOL = 1e-3
MALA_COARSE_DECISIONS = 4 * 4 * 3  # chains x fine samples x subchain steps


@pytest.mark.parametrize("curvature", ["gn", "full"])
def test_tsunami_laplace_preview_matches_jax_package(curvature):
    data = _data()
    kw = dict(curvature=curvature, n_ensemble=3, n_iters=3, config={"level": 0})
    start, prior_cov = TRUE_THETA + [5.0, -0.3], np.diag([100.0, 0.25])
    with fabric.EvaluationFabric(fabric.ModelBackend(SmallModel(device="cpu")),
                                 cache_size=0) as fab:
        got = inference.laplace_preview(fab, data, np.diag(NOISE_SD**2), start, prior_cov,
                                        rng=np.random.default_rng(0), **kw)
        pc = fab.telemetry()["per_capability"]
    with jax_fabric.EvaluationFabric(jax_fabric.ModelBackend(SmallJaxModel()),
                                     cache_size=0) as jfab:
        want = jax_inference.laplace_preview(jfab, data, np.diag(NOISE_SD**2), start,
                                             prior_cov, rng=np.random.default_rng(0), **kw)
    assert np.isfinite(got.mean).all() and np.all(np.linalg.eigvalsh(got.cov) > 0)
    rel_map = np.max(np.abs(got.mean - want.mean) / np.abs(want.mean))
    rel_cov = np.max(np.abs(got.cov - want.cov)) / np.max(np.abs(want.cov))
    print(f"{curvature}: MAP {rel_map:.3g}, covariance {rel_cov:.3g} relative")
    assert rel_map <= LAPLACE_TOL[curvature]["map_rtol"]
    assert rel_cov <= LAPLACE_TOL[curvature]["cov_rtol"]
    assert got.waves == want.waves and got.n_iters == want.n_iters
    assert ("apply_hessian" in pc) == (curvature == "full")


def test_tsunami_eki_matches_jax_package():
    """EKI is evaluate waves only: the port's kernel path (the plain loop
    here) against the JAX solver, the same perturbations from the same rng."""
    data = _data()
    kw = dict(n_ensemble=16, n_iters=2, config={"level": 0})
    prior_cov = np.diag([100.0, 0.25])
    with fabric.EvaluationFabric(fabric.ModelBackend(SmallModel(device="cpu")),
                                 cache_size=0) as fab:
        got = inference.ensemble_kalman_inversion(fab, data, np.diag(NOISE_SD**2), TRUE_THETA,
                                                  prior_cov, rng=np.random.default_rng(1), **kw)
    with jax_fabric.EvaluationFabric(jax_fabric.ModelBackend(SmallJaxModel()),
                                     cache_size=0) as jfab:
        want = jax_inference.ensemble_kalman_inversion(
            jfab, data, np.diag(NOISE_SD**2), TRUE_THETA, prior_cov,
            rng=np.random.default_rng(1), **kw)
    rel = np.max(np.abs(got.thetas - want.thetas) / np.abs(want.thetas))
    print(f"EKI ensemble: {rel:.3g} relative")
    assert rel <= EKI_RTOL and got.waves == want.waves


# -- gradient-informed MLDA -----------------------------------------------------

MU = np.array([0.5, -0.3])
SIG = np.array([0.8, 0.5])


def _gaussian_levels():
    def level(shift, scale):
        def lp(X):
            X = np.atleast_2d(X)
            return -0.5 * np.sum(((X - MU - shift) / (SIG * scale)) ** 2, axis=1)

        return lp

    def coarse_vg(X):
        X = np.atleast_2d(X)
        z = (X - MU - 0.1) / (SIG * 1.2)
        return -0.5 * np.sum(z**2, axis=1), -z / (SIG * 1.2)

    return [level(0.1, 1.2), level(0.0, 1.0)], coarse_vg


def test_mala_mlda_exact_parity_with_jax_package():
    """coarse_sampler="mala" is host code in both packages: the same
    batched value-and-gradient and the same numpy rng give the same chains."""
    x0s = np.random.default_rng(5).standard_normal((8, 2))
    levels, vg = _gaussian_levels()
    kw = dict(n_samples=30, subsampling=[3], prop_cov=np.diag([0.6, 0.4]) ** 2,
              coarse_sampler="mala", coarse_value_grad=vg, mala_step=0.8)
    got = mlda.ensemble_mlda(levels, x0s, rng=np.random.default_rng(9), **kw)
    want = jax_mlda.ensemble_mlda(levels, x0s, rng=np.random.default_rng(9), **kw)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.n_waves == want.n_waves and got.evals_per_level == want.evals_per_level
    assert got.accept_rates == want.accept_rates


def _mala_campaign(pkg_mlda, pkg_fabric, model, data, grad_loglik):
    def logprior(th):
        return 0.0 if all(lo <= t <= hi for t, (lo, hi) in zip(th, PRIOR)) else -np.inf

    def loglik(y):
        return -0.5 * float(np.sum(((np.asarray(y) - data) / NOISE_SD) ** 2))

    fab = pkg_fabric.EvaluationFabric(pkg_fabric.ModelBackend(model), cache_size=4096)
    try:
        res = pkg_mlda.ensemble_mlda(
            None, TRUE_THETA + np.random.default_rng(2).standard_normal((4, 2)) * [4.0, 0.15],
            4, [3], np.diag([4.0, 0.01]), np.random.default_rng(42), fabric=fab,
            loglik=loglik, logprior=logprior, level_configs=[{"level": 0}, {"level": 1}],
            coarse_sampler="mala", mala_step=1.0, grad_loglik=grad_loglik,
            grad_logprior=lambda th: np.zeros(2))
        return res, fab.telemetry()["per_capability"]
    finally:
        fab.shutdown()


def test_tsunami_mala_campaign_matches_jax_package():
    """K = 4 chains, 4 fine samples, 3 MALA steps a subchain on the small
    tsunami: each package's model, fabric and traceable grad_loglik, the
    same numpy rng. The two solvers' values and gradients agree far inside
    these accept decisions' margins, so the chains take the same steps."""
    data = _data()
    data_t = torch.as_tensor(data, dtype=torch.float32)
    var_t = torch.as_tensor(NOISE_SD**2, dtype=torch.float32)
    port = SmallModel(device="cpu")
    got, pc = _mala_campaign(mlda, fabric, port, data, lambda y: -(y - data_t) / var_t)
    want, _ = _mala_campaign(jax_mlda, jax_fabric, SmallJaxModel(), data,
                             lambda y: -(y - data) / NOISE_SD**2)
    assert np.isfinite(got.samples).all() and got.samples.shape == (4, 4, 2)
    np.testing.assert_allclose(got.samples, want.samples, rtol=MALA_RTOL)
    flipped = abs(got.accept_rates[0] - want.accept_rates[0]) * MALA_COARSE_DECISIONS
    assert flipped <= 3 + 1e-9, flipped
    assert got.accept_rates[1] == want.accept_rates[1]
    assert got.n_waves == want.n_waves and got.evals_per_level == want.evals_per_level
    # level 0 rode fused value-and-gradient waves only: no coarse evaluate
    # wave reached the model, every fine one did
    assert pc["value_and_gradient"]["waves"] > 0
    assert port.waves[0] == 0 and port.waves[1] > 0
