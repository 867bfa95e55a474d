"""PyTorch port: the numpy half of `uq/` (`qmc`, `sensitivity`, `kde`). The
port's modules are copies of the JAX package's, so every result here is
held to the reference's bit for bit (`assert_array_equal`), besides the
reference's own checks (tests/test_uq.py), which run on the port."""
import numpy as np
import pytest

import repro.core.fabric as jax_fabric
import repro.uq.kde as jax_kde
import repro.uq.qmc as jax_qmc
import repro.uq.sensitivity as jax_sensitivity
import repro_torch.core.fabric as fabric
from repro_torch.uq.kde import kde, silverman_bandwidth
from repro_torch.uq.qmc import cub_qmc_sobol, sobol
from repro_torch.uq.sensitivity import sobol_indices


def _same_cubature(got, want):
    np.testing.assert_array_equal(got.mean, want.mean)
    np.testing.assert_array_equal(got.std_error, want.std_error)
    assert got.n_evals == want.n_evals and got.converged == want.converged
    assert len(got.history) == len(want.history)
    for (n_g, m_g, s_g), (n_w, m_w, s_w) in zip(got.history, want.history):
        assert n_g == n_w
        np.testing.assert_array_equal(m_g, m_w)
        np.testing.assert_array_equal(s_g, s_w)


# -- Sobol' -------------------------------------------------------------------


@pytest.mark.parametrize("dim", [1, 2, 5, 13, 21])
@pytest.mark.parametrize("scramble_seed, skip", [(None, 0), (None, 37), (3, 0), (42, 128)])
def test_sobol_equals_the_reference_bit_for_bit(dim, scramble_seed, skip):
    got = sobol(128, dim, scramble_seed=scramble_seed, skip=skip)
    want = jax_qmc.sobol(128, dim, scramble_seed=scramble_seed, skip=skip)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_sobol_matches_scipy():
    from scipy.stats import qmc as sq

    for d in (1, 2, 5, 13, 21):
        ref = sq.Sobol(d, scramble=False).random(128)
        assert np.max(np.abs(sobol(128, d) - ref)) < 1e-8


def test_sobol_stratification_and_scrambled_uniformity():
    pts = sobol(16, 5)
    for j in range(5):
        assert sorted(np.floor(pts[:, j] * 16).astype(int)) == list(range(16))
    pts = sobol(256, 3, scramble_seed=42)
    assert np.all((pts >= 0) & (pts < 1)) and abs(pts.mean() - 0.5) < 0.02


# -- cubature -----------------------------------------------------------------


def _sines(u):
    return np.sin(2 * np.pi * u).sum(1, keepdims=True) + 1.0


@pytest.mark.parametrize("f, dim, kw", [
    (_sines, 4, dict(abs_tol=5e-4)),
    (lambda u: u.sum(1), 2, dict(abs_tol=1e-2)),  # scalar [N] rows
    (lambda u: np.stack([u[:, 0] ** 2, np.cos(u[:, 1])], 1), 3,
     dict(abs_tol=1e-9, n_init=32, n_max=256, replications=4, seed=11)),  # stops at n_max
])
def test_cubature_equals_the_reference(f, dim, kw):
    got = cub_qmc_sobol(f, dim, **kw)
    _same_cubature(got, jax_qmc.cub_qmc_sobol(f, dim, **kw))
    if dim == 4:
        assert got.converged and abs(got.mean[0] - 1.0) < 5e-3


def test_cubature_through_each_fabric_is_one_wave_per_replication_and_doubling():
    """The same integrand behind each package's fabric: equal results, equal
    evaluation counts, and one wave per (replication, doubling)."""
    out = {}
    for name, pkg in (("port", fabric), ("jax", jax_fabric)):
        with pkg.EvaluationFabric(pkg.CallableBackend(_sines), cache_size=0) as fab:
            cub = cub_qmc_sobol if name == "port" else jax_qmc.cub_qmc_sobol
            res = cub(fab, 4, abs_tol=5e-4, replications=4)
            out[name] = (res, fab.telemetry()["waves"])
    (got, waves), (want, jax_waves) = out["port"], out["jax"]
    _same_cubature(got, want)
    assert waves == jax_waves == 4 * len(got.history)


def test_cubature_rejects_single_replication_and_bad_shapes():
    with pytest.raises(ValueError, match="replications"):
        cub_qmc_sobol(lambda u: u.sum(1, keepdims=True), 2, replications=1)
    with pytest.raises(ValueError, match="expected"):
        cub_qmc_sobol(lambda u: np.ones((7, 2)), 2)


# -- Sobol' sensitivity indices -----------------------------------------------


def _ishigami(U, a=7.0, b=0.1):
    X = np.pi * (2.0 * np.asarray(U) - 1.0)
    y = np.sin(X[:, 0]) + a * np.sin(X[:, 1]) ** 2 + b * X[:, 2] ** 4 * np.sin(X[:, 0])
    return y[:, None]


def test_sobol_indices_ishigami_equal_the_reference_and_the_closed_form():
    kw = dict(abs_tol=5e-3, n_max=2**13, seed=11)
    got = sobol_indices(_ishigami, 3, **kw)
    want = jax_sensitivity.sobol_indices(_ishigami, 3, **kw)
    for field in ("first", "total", "mean", "variance", "n_evals", "converged"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    _same_cubature(got.cubature, want.cubature)
    a, b = 7.0, 0.1
    V = a**2 / 8 + b * np.pi**4 / 5 + b**2 * np.pi**8 / 18 + 0.5
    V1, V2, T3 = 0.5 * (1 + b * np.pi**4 / 5) ** 2, a**2 / 8, 8 * b**2 * np.pi**8 / 225
    np.testing.assert_allclose(got.variance, V, rtol=0.02)
    np.testing.assert_allclose(got.first, [V1 / V, V2 / V, 0.0], atol=0.02)
    np.testing.assert_allclose(got.total, [(V1 + T3) / V, V2 / V, T3 / V], atol=0.02)
    assert got.n_evals == 5 * got.cubature.n_evals


def test_sobol_indices_one_wave_per_doubling_through_each_fabric():
    """The (dim + 2) pick-freeze blocks of a doubling ride ONE wave of the
    port's fabric, as of the reference's, and the indices are equal."""
    def g(U):
        U = np.atleast_2d(U)
        return U[:, :1] + 2.0 * U[:, 1:2] ** 2

    kw = dict(dim=2, abs_tol=5e-3, n_init=64, n_max=2**10, replications=4, seed=3)
    out = {}
    for pkg, sens in ((fabric, sobol_indices), (jax_fabric, jax_sensitivity.sobol_indices)):
        with pkg.EvaluationFabric(pkg.CallableBackend(g), cache_size=0) as fab:
            out[pkg] = (sens(f=fab, **kw), fab.telemetry()["waves"])
    (res, waves), (want, jax_waves) = out[fabric], out[jax_fabric]
    np.testing.assert_array_equal(res.first, want.first)
    np.testing.assert_array_equal(res.total, want.total)
    assert res.n_evals == want.n_evals
    V1, V2 = 1.0 / 12.0, 16.0 / 45.0
    np.testing.assert_allclose(res.first, [V1 / (V1 + V2), V2 / (V1 + V2)], atol=0.03)
    np.testing.assert_allclose(res.first, res.total, atol=0.03)
    assert waves == jax_waves == 4 * len(res.cubature.history)


def test_sobol_indices_validates_dimension_and_variance():
    with pytest.raises(ValueError, match="2\\*dim"):
        sobol_indices(lambda U: U[:, :1], 99)
    with pytest.raises(ValueError, match="variance"):
        sobol_indices(lambda U: np.ones((len(U), 1)), 2, n_max=256, replications=4)


# -- KDE ----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(support="positive", n_points=500),
    dict(n_points=400),
    dict(bandwidth=0.1, n_points=400),
    dict(points=np.linspace(0.5, 4.0, 33), support="positive", bandwidth=0.1),
])
def test_kde_equals_the_reference(kw):
    s = np.random.default_rng(0).lognormal(0.5, 0.3, 4000)
    got, got_pts = kde(s, **kw)
    want, want_pts = jax_kde.kde(s, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_pts, want_pts)
    if "points" not in kw:
        assert abs(np.trapezoid(got, got_pts) - 1.0) < 0.02


def test_silverman_bandwidth_keeps_a_bimodal_mixture_apart():
    rng = np.random.default_rng(0)
    comp = rng.uniform(size=4000) < 0.5
    s = np.where(comp, rng.normal(-2.0, 0.5, 4000), rng.normal(2.0, 0.5, 4000))
    h = silverman_bandwidth(s)
    assert h == jax_kde.silverman_bandwidth(s)
    assert 0.0 < h < np.std(s)
    d, p = kde(s, n_points=400)
    modes, valley = np.interp([-2.0, 2.0], p, d), np.interp(0.0, p, d)
    assert min(modes) > 2.0 * valley
