"""PyTorch port: surrogate-accelerated (three-stage) delayed acceptance,
`uq/surrogate.py` over the port's fabric tap and `uq/gp.py`'s online GP
(on `device="cpu"`).

The sampler is host numpy code in both packages, so the three-stage
`ensemble_mlda` is held to the JAX package's BIT FOR BIT: each package's
`SurrogateScreen` over the same deterministic numpy GP stub, the same
inputs and the same numpy `rng` must give identical samples, waves, evals
and screen statistics. The rest mirrors tests/test_surrogate_da.py on the
port: the tap sees each wave exactly once, the screen costs zero waves,
and a deliberately WRONG GP still leaves the fine posterior exact
(statistically, `tests/_stat_harness.py`)."""
import numpy as np
import pytest
import torch
from _stat_harness import assert_moments, sample_until

import repro.core.fabric as jax_fabric
import repro.uq.gp as jax_gp
import repro.uq.mlda as jax_mlda
import repro.uq.surrogate as jax_surrogate
import repro_torch.core.fabric as fabric
import repro_torch.uq.gp as gp_mod
import repro_torch.uq.mlda as mlda
import repro_torch.uq.surrogate as surrogate
from repro_torch.core.fabric import EvaluationFabric
from repro_torch.core.interface import TorchModel
from repro_torch.uq.gp import OnlineGP
from repro_torch.uq.mlda import ensemble_mlda
from repro_torch.uq.surrogate import ANY_CONFIG, SurrogateScreen, SurrogateStore

CPU = "cpu"
# toy 2-level hierarchy: coarse posterior N(-0.5, I), fine posterior N(1, I)
_SHIFTS = {0: -0.5, 1: 1.0}


def _level_model(thetas, config):
    shift = _SHIFTS[(config or {}).get("level", 1)]
    return ((np.asarray(thetas) - shift) ** 2).sum(1, keepdims=True)


def _loglik(y):
    return -0.5 * float(y[0])


def _lp_batch(shift):
    def f(thetas):
        return -0.5 * ((np.atleast_2d(thetas) - shift) ** 2).sum(1)

    return f


def _trained_gp(target_fn, rng, n=200, span=4.0, d=2, **kw):
    """OnlineGP (CPU) fit on `target_fn` over [-span, span]^d and FROZEN."""
    kw.setdefault("window", 256)
    kw.setdefault("min_train", 32)
    kw.setdefault("hyper_iters", 120)
    gp = OnlineGP(device=CPU, **kw)
    X = rng.uniform(-span, span, (n, d))
    gp.add(X, target_fn(X))
    gp.predict_batch(X[:2])  # force the fit before freezing
    gp.freeze()
    return gp


# -- the three-stage sampler, bit for bit against the JAX package -------------


def _stub_gp(base, **kw):
    """A deterministic numpy stand-in for each package's `OnlineGP`: a
    slightly wrong coarse log-likelihood (N(-0.8, I) with a ripple) as its
    mean, and a variance that grows away from the origin, so the variance
    gate skips some proposals."""

    class StubGP(base):
        @property
        def ready(self):
            return True

        def predict_batch(self, Xq, return_var=False):
            Xq = np.atleast_2d(np.asarray(Xq, float))
            mu = -0.5 * ((Xq + 0.8) ** 2).sum(1) + 0.3 * np.sin(2 * Xq[:, 0])
            if not return_var:
                return mu
            return mu, 0.01 + 0.05 * (Xq**2).sum(1)

    return StubGP(window=64, min_train=2, **kw)


def _three_stage(pkg, fabric_pkg, screen_pkg, gp, through_fabric):
    logprior = lambda th: 0.0 if np.all(np.abs(th) < 3.0) else -np.inf  # noqa: E731
    x0s = np.random.default_rng(4).standard_normal((10, 2)) * 0.7 + 1.0
    x0s[0] = [3.5, 0.0]  # starts outside the prior's support: the screen skips it
    kw = dict(n_samples=60, subsampling=[3], prop_cov=0.7 * np.eye(2),
              rng=np.random.default_rng(21))
    if not through_fabric:
        screen = screen_pkg.SurrogateScreen(gp, logprior=logprior, sd_skip=0.6)

        def lp(shift):
            f = _lp_batch(shift)
            return lambda X: np.where([logprior(t) == 0.0 for t in np.atleast_2d(X)], f(X), -np.inf)

        res = pkg.ensemble_mlda([lp(-0.5), lp(1.0)], x0s, surrogate=screen, **kw)
        return res, screen.stats(), None
    fab = fabric_pkg.EvaluationFabric(_level_model, cache_size=4096)
    fab.label_config({"level": 0}, "coarse")
    fab.label_config({"level": 1}, "fine")
    screen = screen_pkg.SurrogateScreen(gp, logprior=logprior, sd_skip=0.6, fabric=fab)
    try:
        res = pkg.ensemble_mlda(None, x0s, fabric=fab, loglik=_loglik, logprior=logprior,
                                level_configs=[{"level": 0}, {"level": 1}],
                                surrogate=screen, **kw)
        tel = fab.telemetry()
    finally:
        fab.shutdown()
    return res, screen.stats(), tel


@pytest.mark.parametrize("through_fabric", [False, True])
def test_three_stage_sampler_is_bit_for_bit_the_jax_package(through_fabric):
    got, got_stats, got_tel = _three_stage(
        mlda, fabric, surrogate, _stub_gp(gp_mod.OnlineGP, device=CPU), through_fabric)
    want, want_stats, want_tel = _three_stage(
        jax_mlda, jax_fabric, jax_surrogate, _stub_gp(jax_gp.OnlineGP), through_fabric)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.n_waves == want.n_waves
    assert got.evals_per_level == want.evals_per_level
    assert got.accept_rates == want.accept_rates
    assert got.surrogate == want.surrogate
    for key in ("screened", "passed", "pass_rate", "skipped"):
        assert got_stats[key] == want_stats[key]
    # the stub screened, rejected, skipped (gate and out-of-support) and moved
    assert 0 < got_stats["passed"] < got_stats["screened"] and got_stats["skipped"] > 0
    assert min(got.accept_rates) > 0
    if through_fabric:
        for key in ("waves", "points", "surrogate_screened", "surrogate_passed",
                    "screen_pass_rate"):
            assert got_tel[key] == want_tel[key], key
        for label in ("coarse", "fine"):
            assert got_tel["per_label"][label] == want_tel["per_label"][label]


# -- the fabric training tap --------------------------------------------------


def test_store_observes_each_wave_exactly_once():
    computed = {"points": 0}

    def model(thetas, config):
        computed["points"] += len(thetas)
        return _level_model(thetas, config)

    fab = EvaluationFabric(model, cache_size=256)
    store = SurrogateStore(lambda th, y: _loglik(y), config={"level": 0},
                           min_train=4, hyper_iters=10, device=CPU)
    fab.record_observer(store.observe)
    try:
        X = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 0.0]])  # duplicate row
        fab.evaluate_batch(X, {"level": 0})
        fab.evaluate_batch(X, {"level": 0})  # fully cache-served: no replay
        fab.evaluate_batch(X + 3.0, {"level": 1})  # other config: filtered
        [f.result() for f in [fab.submit([0.5 * i, 0.0], {"level": 0}) for i in range(6)]]
        fab.submit([0.0, 0.0], {"level": 0}).result()  # cached: no replay
    finally:
        fab.shutdown()
    assert len(store.gp) == store.n_points == computed["points"] - 2
    assert store.n_points == 2 + 5
    assert store.stats() == {"waves_observed": store.n_waves, "points_observed": 7}


def test_store_ignores_derivative_waves_and_any_config():
    tm = TorchModel(lambda th: th * 2.0, 2, 2, device=CPU)
    fab = EvaluationFabric(tm, cache_size=0)
    store = SurrogateStore(lambda th, y: float(y[0]), config=ANY_CONFIG,
                           min_train=4, hyper_iters=10, device=CPU)
    fab.record_observer(store.observe)
    try:
        fab.evaluate_batch([[1.0, 2.0]], {"level": 0})
        fab.evaluate_batch([[1.0, 3.0]], {"level": 1})  # ANY_CONFIG ingests both
        assert store.n_points == 2
        fab.gradient_batch([[1.0, 2.0]], [[1.0, 0.0]], {"level": 0})
        assert store.n_points == 2  # a VJP row is not a forward value
    finally:
        fab.shutdown()


def test_observer_failure_never_fails_the_wave():
    fab = EvaluationFabric(_level_model, cache_size=0)

    @fab.record_observer
    def bad(op, thetas, outs, config):
        raise RuntimeError("observer bug")

    try:
        with pytest.warns(RuntimeWarning, match="observer"):
            out = fab.evaluate_batch([[1.0, 1.0]], {"level": 1})
        np.testing.assert_allclose(out.ravel(), [0.0])
        fab.remove_observer(bad)
        np.testing.assert_allclose(fab.evaluate_batch([[2.0, 2.0]], {"level": 1}).ravel(), [2.0])
    finally:
        fab.shutdown()


def test_store_and_screen_take_the_gp_device_from_their_keywords(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SurrogateStore(lambda th, y: 0.0)
    fab = EvaluationFabric(_level_model, cache_size=0)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SurrogateScreen.from_fabric(fab, target=lambda th, y: 0.0)
        screen = SurrogateScreen.from_fabric(fab, target=lambda th, y: 0.0, device=CPU)
        assert screen.gp.device.type == "cpu"
    finally:
        fab.shutdown()


# -- the screen ---------------------------------------------------------------


def test_screen_costs_zero_fabric_waves(rng):
    gp = _trained_gp(lambda X: -0.5 * ((X + 0.5) ** 2).sum(1), rng)
    fab = EvaluationFabric(_level_model, cache_size=0)
    screen = SurrogateScreen(gp, fabric=fab)
    try:
        fab.evaluate_batch(rng.standard_normal((4, 2)), {"level": 0})
        before = dict(fab.stats)
        dg, skipped = screen.delta(rng.standard_normal((8, 2)), rng.standard_normal((8, 2)))
        assert dg.shape == (8,) and not skipped.any()
        assert fab.stats["waves"] == before["waves"]
        assert fab.stats["points"] == before["points"]
    finally:
        fab.shutdown()


def test_screen_inactive_until_min_train(rng):
    screen = SurrogateScreen(OnlineGP(window=64, min_train=16, hyper_iters=20, device=CPU))
    xs = rng.standard_normal((5, 2))
    dg, skipped = screen.delta(xs, xs + 0.1)
    assert not screen.active
    np.testing.assert_array_equal(dg, 0.0)
    assert skipped.all() and screen.stats()["skipped"] == 5


def test_screen_variance_gate_skips_uncertain_region(rng):
    gp = _trained_gp(lambda X: np.sin(X[:, 0]) + np.cos(X[:, 1]), rng, n=150, span=1.0)
    near = rng.uniform(-0.5, 0.5, (6, 2))
    far = near + 40.0
    _, var_near = gp.predict_batch(near, return_var=True)
    _, var_far = gp.predict_batch(far, return_var=True)
    tau = 0.5 * (np.sqrt(var_near).max() + np.sqrt(var_far).min())
    screen = SurrogateScreen(gp, sd_skip=float(tau))
    dg_n, skip_n = screen.delta(near, near + 0.05)
    assert not skip_n.any() and np.any(dg_n != 0.0)
    dg_f, skip_f = screen.delta(far, far + 0.05)
    assert skip_f.all()
    np.testing.assert_array_equal(dg_f, 0.0)
    assert screen.n_skipped == 6


def test_screen_skips_chain_whose_current_state_is_out_of_support(rng):
    gp = _trained_gp(lambda X: -0.5 * ((X - 1.0) ** 2).sum(1), rng)
    logprior = lambda th: 0.0 if np.all(np.abs(th) < 4.0) else -np.inf  # noqa: E731
    screen = SurrogateScreen(gp, logprior=logprior)
    dg, skipped = screen.delta(np.array([[9.0, 9.0], [1.0, 1.0]]),
                               np.array([[1.0, 1.0], [1.2, 0.8]]))
    assert skipped[0] and dg[0] == 0.0
    assert not skipped[1] and np.isfinite(dg[1])
    lp0 = lambda thetas: np.where(  # noqa: E731
        np.all(np.abs(np.atleast_2d(thetas)) < 4.0, axis=1),
        -0.5 * ((np.atleast_2d(thetas) - 1.0) ** 2).sum(1), -np.inf)
    res = ensemble_mlda([lp0], np.full((6, 2), 4.5), 400, [], 0.7 * np.eye(2),
                        np.random.default_rng(3), surrogate=screen)
    tail = res.samples[:, 200:, :].reshape(-1, 2)
    assert np.all(np.abs(tail) < 4.0)
    assert abs(tail.mean() - 1.0) < 0.3


def test_screen_logprior_rejects_out_of_support_for_free(rng):
    gp = _trained_gp(lambda X: np.zeros(len(X)), rng)
    logprior = lambda th: 0.0 if np.all((th >= -2.0) & (th <= 2.0)) else -np.inf  # noqa: E731
    screen = SurrogateScreen(gp, logprior=logprior)
    dg, _ = screen.delta(np.zeros((3, 2)), np.array([[0.5, 0.5], [3.0, 0.0], [0.0, -9.0]]))
    assert np.isfinite(dg[0]) and dg[1] == -np.inf and dg[2] == -np.inf


# -- three-stage DA on the port -----------------------------------------------


def _run_mlda(rng, *, surrogate=None, n=300, K=12, sub=3, x0=None):
    x0s = x0 if x0 is not None else rng.standard_normal((K, 2)) * 0.3 + 1.0
    return ensemble_mlda([_lp_batch(-0.5), _lp_batch(1.0)], x0s, n, [sub],
                         0.7 * np.eye(2), rng, surrogate=surrogate)


def test_three_stage_da_exact_with_wrong_surrogate(rng):
    """The GP is trained on the WRONG target (N(-1, I) where the coarse
    level is N(-0.5, I)); the fine posterior N(1, I) must still come out."""
    gp = _trained_gp(lambda X: -0.5 * ((X + 1.0) ** 2).sum(1), rng, n=250)
    screen = SurrogateScreen(gp)
    state = {"xs": None}

    def extend():
        res = _run_mlda(rng, surrogate=screen, n=400, x0=state["xs"])
        state["xs"] = res.samples[:, -1, :].copy()
        return res.samples

    samples = sample_until(extend, min_ess=200, max_rounds=4)
    assert_moments(samples, 1.0, 1.0, z=5.5, min_ess=150, label="three-stage DA (wrong GP)")
    assert screen.n_screened > 0
    assert 0 < screen.n_passed < screen.n_screened


def test_three_stage_da_saves_coarse_evals_with_good_surrogate(rng):
    gp = _trained_gp(lambda X: -0.5 * ((X + 0.5) ** 2).sum(1), rng, n=250)
    screen = SurrogateScreen(gp)
    base = _run_mlda(np.random.default_rng(7), n=400)
    res = _run_mlda(np.random.default_rng(8), surrogate=screen, n=400)
    assert base.surrogate is None and res.surrogate["screened"] > 0
    assert 0.0 < res.surrogate["pass_rate"] < 1.0
    assert res.evals_per_level[0] < 0.75 * base.evals_per_level[0]
    assert res.n_waves <= base.n_waves
    assert_moments(res.samples, 1.0, 1.0, z=6.0, min_ess=100, label="three-stage DA (good GP)")
    assert_moments(base.samples, 1.0, 1.0, z=6.0, min_ess=100, label="two-stage baseline")


def test_three_stage_da_trains_online_from_fabric_traffic(rng):
    fab = EvaluationFabric(_level_model, cache_size=4096)
    fab.label_config({"level": 0}, "coarse")
    screen = SurrogateScreen.from_fabric(
        fab, target=lambda th, y: _loglik(y), config={"level": 0},
        window=256, min_train=48, hyper_iters=60, refit_every=64, device=CPU)
    try:
        assert not screen.active
        kw = dict(fabric=fab, loglik=_loglik, level_configs=[{"level": 0}, {"level": 1}])
        x0s = rng.standard_normal((8, 2)) * 0.3 + 1.0
        warm = ensemble_mlda(None, x0s, 20, [3], 0.7 * np.eye(2), rng, surrogate=screen, **kw)
        assert screen.active
        screen.freeze()
        res = ensemble_mlda(None, warm.samples[:, -1, :], 60, [3], 0.7 * np.eye(2), rng,
                            surrogate=screen, **kw)
        tel = fab.telemetry()
        assert screen.store.n_points == tel["per_label"]["coarse"]["points"]
        assert res.surrogate["screened"] > 0
        assert tel["surrogate_screened"] >= res.surrogate["screened"]
        assert 0.0 < tel["screen_pass_rate"] < 1.0
    finally:
        fab.shutdown()


def test_three_stage_da_skipped_screen_degrades_to_two_stage():
    screen = SurrogateScreen(OnlineGP(window=64, min_train=10_000, hyper_iters=10, device=CPU))
    res = _run_mlda(np.random.default_rng(5), surrogate=screen, n=150)
    assert screen.n_screened == 0
    assert res.surrogate["pass_rate"] is None
    assert res.evals_per_level[0] > 0 and res.surrogate["skipped"] > 0
    # an inactive screen takes the reference's steps exactly
    want = jax_mlda.ensemble_mlda(
        [_lp_batch(-0.5), _lp_batch(1.0)],
        np.random.default_rng(5).standard_normal((12, 2)) * 0.3 + 1.0, 150, [3],
        0.7 * np.eye(2), _rng_after_x0s(5),
        surrogate=jax_surrogate.SurrogateScreen(
            jax_gp.OnlineGP(window=64, min_train=10_000, hyper_iters=10)))
    np.testing.assert_array_equal(res.samples, want.samples)


def _rng_after_x0s(seed):
    rng = np.random.default_rng(seed)
    rng.standard_normal((12, 2))
    return rng


def test_port_fabric_screen_telemetry_matches_jax_fabric():
    out = {}
    for pkg in (fabric, jax_fabric):
        fab = pkg.EvaluationFabric(_level_model, cache_size=0)
        try:
            fab.note_screen(10, 4)
            fab.note_screen(6, 1)
            tel = fab.telemetry()
        finally:
            fab.shutdown()
        out[pkg] = {k: tel[k] for k in ("surrogate_screened", "surrogate_passed",
                                         "screen_pass_rate")}
    assert out[fabric] == out[jax_fabric] == {
        "surrogate_screened": 16, "surrogate_passed": 5, "screen_pass_rate": 5 / 16}
