"""PyTorch port: the GP level of the §4.3 hierarchy (`uq/gp.py`) against the
JAX package's. The Matérn kernel and the negative log marginal likelihood
are held in float64 (torch against JAX under `jax.enable_x64`) within
1e-10, and in float32 within bounds measured here. A fit is two float32
Adam trajectories that drift apart (the jitted XLA gradient and torch's
round differently), so fitted GPs are held by their PREDICTIONS, in units
of y's standard deviation, never by their hyperparameters. The online
sliding-window GP must take the reference's decisions on the same stream.
Everything runs on `device="cpu"`; the same cases on the card are in
`tests/test_torch_gpu.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.uq.gp as jax_gp
import repro_torch.uq.gp as gp_mod
from repro_torch.uq.gp import GP, OnlineGP
from _torch_parity import FIT_TOL

CPU = "cpu"
#: float64 bound of the kernel matrix, the NLML and its gradient (relative)
F64_RTOL = 1e-10
#: float32 bounds, relative to the largest entry; measured on the cases of
#: `test_matern_and_nlml_match_jax_in_float32` (CPU): the Matérn matrix up
#: to 2.4e-7 (2 ulps: XLA's exp and torch's round differently), the NLML up
#: to 5.8e-5 and its gradient up to 4.3e-4 (the float32 Cholesky of a
#: near-singular K amplifies those ulps). Each bound is >= 2x the measurement.
MATERN_F32_RTOL = 1e-6
NLML_F32_RTOL = 2e-4
GRAD_F32_RTOL = 1e-3
#: bound on `from_params` (same hyperparameters, float32 Matérn, float64
#: factorization) against the reference's, in units of y's standard
#: deviation: measured up to 3.3e-4 (mean) where the window is nearly
#: singular and the kernel's 2-ulp differences pass through K^-1.
FROM_PARAMS_TOL = 1e-3


def _sets():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (25, 2))
    yield "interpolation", X, np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]), 200
    X = rng.uniform(-1, 1, (60, 2))
    yield "ard", X, np.sin(4 * X[:, 0]), 300
    base = rng.uniform(-1, 1, (10, 2))
    X = np.repeat(base, 3, axis=0)
    yield "degenerate", X, np.sin(2 * X[:, 0]) + X[:, 1], 150
    X = rng.uniform(-1, 1, (128, 2))
    yield "smooth128", X, np.sin(2 * X[:, 0]) + X[:, 1] ** 2, 250


SETS = {name: (X, y, iters) for name, X, y, iters in _sets()}


def _queries(X):
    q = np.random.default_rng(1).uniform(-1.2, 1.2, (48, X.shape[1]))
    return np.vstack([q, X[:8]])


def _assert_predictions_close(got, want, Xq, y_sd, tol):
    mg, vg = got.predict(Xq, return_var=True)
    mw, vw = want.predict(Xq, return_var=True)
    assert np.all(vg > 0) and np.all(np.isfinite(mg))
    np.testing.assert_allclose(mg, mw, rtol=0, atol=tol * y_sd)
    np.testing.assert_allclose(np.sqrt(vg), np.sqrt(vw), rtol=0, atol=tol * y_sd)
    np.testing.assert_allclose(got.predict(Xq), mg, rtol=0, atol=0)


def _params(X, kind):
    d = X.shape[1]
    if kind == "start":  # where `fit` starts
        return np.r_[np.log(np.ptp(X, 0) / 3), 0.0, np.log(1e-6), 0.0]
    return np.r_[np.linspace(-0.8, -0.2, d), 0.4, np.log(1e-3), 0.1]


def _torch_nlml(p, X, ys, dtype):
    pt = torch.tensor(p, dtype=dtype, requires_grad=True)
    v = gp_mod._nlml(pt, torch.tensor(X, dtype=dtype), torch.tensor(ys, dtype=dtype))
    (g,) = torch.autograd.grad(v, pt)
    return v.item(), g.numpy()


def _kernel_cases():
    rng = np.random.default_rng(0)
    for n, d in [(25, 2), (60, 2), (128, 2), (30, 3)]:
        X = rng.uniform(-1, 1, (n, d))
        y = np.sin(3 * X[:, 0]) + X[:, 1]
        for kind in ("start", "moved"):
            yield pytest.param(X, (y - y.mean()) / y.std(), _params(X, kind), id=f"{n}x{d}-{kind}")


@pytest.mark.parametrize("X, ys, p", list(_kernel_cases()))
def test_matern_and_nlml_match_jax_in_float64(X, ys, p):
    d = X.shape[1]
    with jax.enable_x64(True):
        K_ref = np.asarray(jax_gp._matern52(jnp.asarray(X), jnp.asarray(X),
                                            jnp.asarray(np.exp(p[:d])), np.exp(p[d])))
        v_ref, g_ref = jax.value_and_grad(
            lambda q: jax_gp._nlml(q, jnp.asarray(X), jnp.asarray(ys)))(jnp.asarray(p))
        v_ref, g_ref = float(v_ref), np.asarray(g_ref)
    Xt = torch.tensor(X)
    K = gp_mod._matern52(Xt, Xt, torch.tensor(np.exp(p[:d])), np.exp(p[d])).numpy()
    np.testing.assert_allclose(K, K_ref, rtol=F64_RTOL, atol=0)
    v, g = _torch_nlml(p, X, ys, torch.float64)
    np.testing.assert_allclose(v, v_ref, rtol=F64_RTOL)
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=F64_RTOL * np.abs(g_ref).max())


@pytest.mark.parametrize("X, ys, p", list(_kernel_cases()))
def test_matern_and_nlml_match_jax_in_float32(X, ys, p):
    d = X.shape[1]
    X32, ys32, p32 = (np.asarray(a, np.float32) for a in (X, ys, p))
    K_ref = np.asarray(jax.jit(jax_gp._matern52)(
        X32, X32, np.exp(p32[:d]), np.exp(p32[d])))
    v_ref, g_ref = jax.jit(jax.value_and_grad(lambda q: jax_gp._nlml(q, X32, ys32)))(p32)
    g_ref = np.asarray(g_ref)
    Xt = torch.tensor(X32)
    K = gp_mod._matern52(Xt, Xt, torch.tensor(np.exp(p32[:d])), torch.tensor(np.exp(p32[d])))
    assert K.dtype == torch.float32
    np.testing.assert_allclose(K.numpy(), K_ref, rtol=0, atol=MATERN_F32_RTOL * np.abs(K_ref).max())
    v, g = _torch_nlml(p32, X32, ys32, torch.float32)
    np.testing.assert_allclose(v, float(v_ref), rtol=NLML_F32_RTOL)
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=GRAD_F32_RTOL * np.abs(g_ref).max())


def test_nlml_is_nan_where_k_is_not_positive_definite():
    """JAX's Cholesky returns NaN for a K that is not positive definite; the
    port's must give a NaN value and gradient there too, never raise."""
    X = np.random.default_rng(0).uniform(-1, 1, (12, 2))
    p = _params(X, "start")
    orig = gp_mod._matern52
    try:
        gp_mod._matern52 = lambda *a: -orig(*a)
        v, g = _torch_nlml(p, X, np.zeros(12), torch.float32)
    finally:
        gp_mod._matern52 = orig
    assert np.isnan(v) and not np.isfinite(g).any()


@pytest.mark.parametrize("name", list(SETS))
def test_from_params_matches_jax(name):
    X, y, _ = SETS[name]
    p = _params(X, "moved")
    got = GP.from_params(X, y, p, device=CPU)
    want = jax_gp.GP.from_params(X, y, p)
    _assert_predictions_close(got, want, _queries(X), y.std(), FROM_PARAMS_TOL)


@pytest.mark.parametrize("name", list(SETS))
def test_fit_predictions_match_jax(name):
    X, y, iters = SETS[name]
    got = GP.fit(X, y, n_iters=iters, device=CPU)
    want = jax_gp.GP.fit(X, y, n_iters=iters)
    assert got.fit_steps == iters and got.device == torch.device(CPU)
    _assert_predictions_close(got, want, _queries(X), y.std(), FIT_TOL)


def test_cholesky_failure_mid_loop_keeps_the_same_last_finite_iterate():
    """No training set tried here (~80 of 8-400 points, duplicates, tight
    clusters, lr up to 1) makes the float32 Cholesky fail: the jitter of
    1e-5 amp keeps K positive definite. So both packages' Matérn kernel is
    made indefinite once the amplitude crosses a threshold (inside the NLML
    only), which sends each Cholesky down its failure path mid-loop: JAX's
    NaN, the port's `cholesky_ex` info. Both loops must stop at the same
    step and keep the same iterate (within the float32 drift of a few
    steps)."""
    X, y, _ = SETS["interpolation"]
    d = X.shape[1]
    # the reference's log-amplitude after each of its first 12 steps; the
    # threshold lies between the largest one before step k + 1 and step
    # k + 1's, so the first iterate past it is the (k + 1)-th
    amps = [0.0] + [jax_gp.GP.fit(X, y, n_iters=j).log_params[d] for j in range(1, 13)]
    k = next(j for j in range(4, 12) if amps[j + 1] > max(amps[:j + 1]) + 1e-3)
    thr = float(np.exp(0.5 * (max(amps[:k + 1]) + amps[k + 1])))

    def indefinite(matern, lib):
        def kernel(X1, X2, ls, amp):
            K = matern(X1, X2, ls, amp)
            if isinstance(amp, float):  # `from_params`: leave it alone
                return K
            return lib.where(amp > thr, -K, K)
        return kernel

    patched = {jax_gp: indefinite(jax_gp._matern52, jnp), gp_mod: indefinite(gp_mod._matern52, torch)}
    saved = {m: m._matern52 for m in patched}
    try:
        for m, f in patched.items():
            m._matern52 = f
        want = jax_gp.GP.fit(X, y, n_iters=40)
        got = GP.fit(X, y, n_iters=40, device=CPU)
    finally:
        for m, f in saved.items():
            m._matern52 = f
    # JAX stopped at step k + 1: its iterate is the unpatched fit's after
    # k + 1 steps (up to the ulps of the recompiled program: 2.6e-5
    # measured), and each step moves the iterate by ~0.05
    def dist(j):
        return np.abs(want.log_params - jax_gp.GP.fit(X, y, n_iters=j).log_params).max()

    assert dist(k + 1) < 1e-3 < 0.02 < min(dist(k), dist(k + 2))
    assert got.fit_steps == k + 1
    # measured 6e-5 apart
    np.testing.assert_allclose(got.log_params, want.log_params, rtol=0, atol=1e-3)


# -- the reference's GP cases (tests/test_uq.py) on the port -----------------


def test_gp_interpolates_training_points(rng):
    X = rng.uniform(-1, 1, (25, 2))
    y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1])
    gp = GP.fit(X, y, n_iters=200, device=CPU)
    np.testing.assert_allclose(gp.predict(X), y, atol=5e-3)
    assert np.all(gp.predict(X, return_var=True)[1] >= 0)


def test_gp_ard_lengthscales_detect_irrelevant_dim(rng):
    X = rng.uniform(-1, 1, (60, 2))
    gp = GP.fit(X, np.sin(4 * X[:, 0]), n_iters=300, device=CPU)
    ls = np.exp(gp.log_params[:2])
    assert ls[1] > 1.5 * ls[0]


def test_gp_predict_variance_floor_on_degenerate_training(rng):
    base = rng.uniform(-1, 1, (10, 2))
    X = np.repeat(base, 3, axis=0)
    gp = GP.fit(X, np.sin(2 * X[:, 0]) + X[:, 1], n_iters=150, device=CPU)
    mu, var = gp.predict(np.vstack([base, [[0.0, 0.0]], [[5.0, -5.0]]]), return_var=True)
    assert np.all(var > 0) and np.all(np.isfinite(np.log(var))) and np.all(np.isfinite(mu))


def test_gp_from_params_matches_fit_factorization(rng):
    X = rng.uniform(-1, 1, (30, 2))
    y = np.cos(3 * X[:, 0]) * X[:, 1]
    gp = GP.fit(X, y, n_iters=150, device=CPU)
    gp2 = GP.from_params(X, y, gp.log_params, device=CPU)
    Xq = rng.uniform(-1, 1, (15, 2))
    np.testing.assert_allclose(gp.predict(Xq), gp2.predict(Xq), rtol=1e-10)
    np.testing.assert_allclose(gp.predict(Xq, True)[1], gp2.predict(Xq, True)[1], rtol=1e-8)


def test_default_device_is_the_gpu_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).uniform(-1, 1, (8, 2))
    for make in (lambda: GP.fit(X, X[:, 0], n_iters=2),
                 lambda: GP.from_params(X, X[:, 0], _params(X, "start")),
                 lambda: OnlineGP()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# -- OnlineGP: the same decisions as the reference on the same stream ---------


def _both(**kw):
    return OnlineGP(device=CPU, **kw), jax_gp.OnlineGP(**kw)


def _same_counters(got, want):
    assert got.n_hyper_fits == want.n_hyper_fits
    assert got.n_chol_refits == want.n_chol_refits
    assert got.n_seen == want.n_seen and len(got) == len(want)
    np.testing.assert_array_equal(got._X, want._X)
    np.testing.assert_array_equal(got._y, want._y)


def test_online_gp_accurate_and_batch_consistent(rng):
    f = lambda X: np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1])  # noqa: E731
    got, want = _both(window=128, min_train=16, hyper_iters=200)
    X = rng.uniform(-1, 1, (90, 2))
    for lo in range(0, 90, 30):
        for g in (got, want):
            g.add(X[lo:lo + 30], f(X[lo:lo + 30]))
    Xq = rng.uniform(-0.9, 0.9, (40, 2))
    mu, var = got.predict_batch(Xq, return_var=True)
    assert np.sqrt(np.mean((mu - f(Xq)) ** 2)) < 0.1
    assert np.all(var > 0) and np.all(np.isfinite(np.log(var)))
    rows = np.concatenate([got.predict_batch(x[None]) for x in Xq])
    np.testing.assert_allclose(mu, rows, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(mu, want.predict_batch(Xq), rtol=0, atol=FIT_TOL * f(X).std())
    _same_counters(got, want)


def test_online_gp_sliding_window_evicts_oldest(rng):
    got, want = _both(window=32, min_train=4, hyper_iters=20)
    X = rng.uniform(-1, 1, (100, 1))
    y = np.arange(100.0)
    for i in range(100):
        got.add(X[i:i + 1], y[i:i + 1])
        want.add(X[i:i + 1], y[i:i + 1])
    assert len(got) == 32 and got.n_seen == 100
    np.testing.assert_array_equal(got._y, y[-32:])
    _same_counters(got, want)


def test_online_gp_lazy_refit_batches_factorizations(rng):
    got, want = _both(window=64, min_train=8, refit_every=16, hyper_iters=40)
    X = rng.uniform(-1, 1, (8, 1))
    burst = rng.uniform(-1, 1, (20, 1))
    for g in (got, want):
        g.add(X, np.sin(X[:, 0]))
        g.predict_batch(X[:1])
    assert got.n_hyper_fits == 1 and got.n_chol_refits == 0
    for g in (got, want):
        for x in burst:
            g.add(x[None], np.sin(x))
        g.predict_batch(X[:1])
    assert got.n_chol_refits == 1
    for g in (got, want):
        g.add(X[:4], np.sin(X[:4, 0]))
        g.predict_batch(X[:1])
    assert got.n_chol_refits == 1 and got.n_hyper_fits == 1
    _same_counters(got, want)


def test_online_gp_staleness_triggers_hyper_refit(rng):
    got, want = _both(window=64, min_train=16, refit_every=8, hyper_iters=60, stale_z=1.5)
    X = rng.uniform(-1, 1, (40, 1))
    drift = lambda X: 5.0 + 10.0 * np.sin(8 * X[:, 0])  # noqa: E731
    blocks = [rng.uniform(-1, 1, (8, 1)) for _ in range(8)]
    Xq = rng.uniform(-1, 1, (30, 1))
    ewmas = []
    for g in (got, want):
        g.add(X, np.sin(2 * X[:, 0]))
        g.predict_batch(X[:1])
        assert g.n_hyper_fits == 1
        trace = []
        for Xn in blocks:
            g.add(Xn, drift(Xn))
            trace.append(g.err_ewma)
        ewmas.append(trace)
        g.predict_batch(Xq)
        assert g.n_hyper_fits >= 2
    np.testing.assert_allclose(ewmas[0], ewmas[1], rtol=1e-2)
    _same_counters(got, want)
    mu = got.predict_batch(Xq)
    assert np.sqrt(np.mean((mu - drift(Xq)) ** 2)) < 3.0


def test_online_gp_variance_positive_on_degenerate_window():
    gp = OnlineGP(window=32, min_train=4, hyper_iters=30, device=CPU)
    gp.add(np.tile([[0.3, 0.7]], (16, 1)), np.ones(16))
    mu, var = gp.predict_batch(
        np.array([[0.3, 0.7], [0.30001, 0.70001], [2.0, -1.0]]), return_var=True)
    assert np.all(var > 0) and np.all(np.isfinite(np.log(var))) and np.all(np.isfinite(mu))


def test_online_gp_not_ready_raises_and_freeze_stops_ingest(rng):
    gp = OnlineGP(window=32, min_train=16, hyper_iters=20, device=CPU)
    gp.add(rng.uniform(-1, 1, (4, 1)), np.zeros(4))
    assert not gp.ready
    with pytest.raises(RuntimeError, match="not ready"):
        gp.predict_batch([[0.0]])
    gp.add(rng.uniform(-1, 1, (12, 1)), np.zeros(12))
    assert gp.ready
    gp.freeze()
    gp.add(rng.uniform(-1, 1, (8, 1)), np.ones(8))
    assert len(gp) == 16 and gp.stats()["frozen"]


def test_online_gp_drops_nonfinite_targets_and_inputs(rng):
    got, want = _both(window=32, min_train=2, hyper_iters=10)
    X = rng.uniform(-1, 1, (5, 1))
    X[4, 0] = np.nan
    y = np.array([1.0, -np.inf, np.nan, 2.0, 3.0])
    got.add(X, y)
    want.add(X, y)
    assert len(got) == 2
    _same_counters(got, want)


def test_online_gp_snapshot_restore_refits_the_same_window(rng):
    gp = OnlineGP(window=64, min_train=8, refit_every=16, hyper_iters=40, device=CPU)
    X = rng.uniform(-1, 1, (30, 2))
    gp.add(X, np.sin(2 * X[:, 0]) * X[:, 1])
    Xq = rng.uniform(-1, 1, (10, 2))
    before = gp.predict_batch(Xq)
    snap = gp.snapshot()
    snap_ref = jax_gp.OnlineGP(window=64, min_train=8, refit_every=16, hyper_iters=40)
    snap_ref.add(X, np.sin(2 * X[:, 0]) * X[:, 1])
    assert snap.keys() == snap_ref.snapshot().keys()
    resumed = OnlineGP(window=64, min_train=8, refit_every=16, hyper_iters=40, device=CPU)
    resumed.restore(snap)
    assert resumed.n_seen == 30 and not resumed.frozen
    # restore marks the fit dirty: the first predict re-runs the search on
    # the restored window, which is the same data, so the same fit
    np.testing.assert_array_equal(resumed.predict_batch(Xq), before)
    assert resumed.n_hyper_fits == 1
    snap["X"][:] = 0.0  # the restored window is a copy
    assert np.any(resumed._X != 0.0)
