"""PyTorch port: `core/hierarchy.py` (`MultilevelModel`, the per-level cost
split) and the slice as a whole: the paper's three-level §4.3 hierarchy,
GP emulator <- smoothed SWE <- fully resolved SWE, built as chip_smoke.py
builds it (`gp_design`, `gp_outputs`, `three_level_logposts`) on the
reduced tsunami (64 / 128 cells) in both packages, the JAX side by the
reference benchmark's own `build_hierarchy`."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import FIT_TOL, SOLVE_TOL

import repro.apps.tsunami as jax_tsunami
import repro.core.fabric as jax_fabric
import repro.core.hierarchy as jax_hierarchy
import repro.uq.gp as jax_gp
import repro.uq.mlda as jax_mlda
import repro_torch.apps.tsunami as tsunami
import repro_torch.core as core
import repro_torch.core.fabric as fabric
import repro_torch.core.hierarchy as hierarchy
from repro_torch.core.fabric import CallableBackend, EvaluationFabric, ModelBackend
from repro_torch.core.hierarchy import MultilevelModel
from repro_torch.core.interface import TorchModel
from repro_torch.uq.gp import GP
from repro_torch.uq.mcmc import batched_logpost
from repro_torch.uq.mlda import ensemble_mlda

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from benchmarks.mlda_tsunami import build_hierarchy  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
L0, L1 = {"level": 0}, {"level": 1}
N_CELLS = {0: 64, 1: 128}
N_TRAIN = 64  # examples/mlda_inversion.py's design size
#: bound on the GP level's log-posterior, port against the JAX package, each
#: with its own solver and its own fits: |d lp| <= LP_RTOL |lp| + LP_ATOL.
#: Measured (CPU): up to 0.60 (7.7e-3 relative) at lp ~ -190, 0.055 within
#: a few sigma of the true source. Both packages' design waves differ by up
#: to 2.0e-3 relative in the heights (inside `SOLVE_TOL`), which the fits
#: carry into the predicted observables.
LP_RTOL, LP_ATOL = 2e-2, 0.2


def _level_model(thetas, config):
    lvl = (config or {}).get("level", 0)
    return ((np.asarray(thetas) - lvl) ** 2).sum(1, keepdims=True)


# -- MultilevelModel (tests/test_core.py, tests/test_router.py) --------------


def test_multilevel_is_exported_and_accounts_per_level():
    assert core.MultilevelModel is MultilevelModel
    ml = MultilevelModel([lambda th: th * 2, lambda th: th * 2.01])
    ml.evaluate(0, np.array([1.0]))
    ml.evaluate(0, np.array([2.0]))
    ml.evaluate(1, np.array([1.0]))
    np.testing.assert_allclose(ml(1, np.array([3.0])), [6.03])
    rep = ml.report()
    assert ml.counts == [2, 2] and rep["counts"] == [2, 2] and ml.n_levels == 2
    assert len(rep["time_s"]) == 2 and "fabric_levels" not in rep


def test_multilevel_plain_and_model_batch_paths():
    ml = MultilevelModel([lambda th: np.atleast_1d(float(np.sum(th))),
                          lambda th: np.atleast_1d(2.0 * float(np.sum(th)))])
    out = ml.evaluate_batch(1, np.array([[1.0, 2.0], [3.0, 4.0]]))
    np.testing.assert_allclose(out.ravel(), [6.0, 14.0])
    assert ml.counts == [0, 2]
    tm = TorchModel(lambda th: th * 3.0, 2, 2, device=CPU)
    ml = MultilevelModel([tm, tm], configs=[{}, {}])
    np.testing.assert_allclose(ml.evaluate(0, [1.0, 2.0]), [3.0, 6.0])
    np.testing.assert_allclose(ml.evaluate_batch(1, [[1.0, 1.0], [2.0, 0.0]]),
                               [[3.0, 3.0], [6.0, 0.0]])
    assert ml.counts == [1, 2]


def test_multilevel_requires_levels_or_fabric_and_distinct_configs():
    with pytest.raises(ValueError):
        MultilevelModel()
    with EvaluationFabric(CallableBackend(_level_model), cache_size=0) as fab:
        with pytest.raises(ValueError, match="configs"):
            MultilevelModel(fabric=fab)
        with pytest.raises(ValueError, match="DISTINCT"):
            MultilevelModel(fabric=fab, configs=[{"level": 0}, {"level": 0}])


def _fabric_session(pkg_fabric, pkg_hierarchy):
    fab = pkg_fabric.EvaluationFabric(
        [pkg_fabric.CallableBackend(_level_model), pkg_fabric.CallableBackend(_level_model)],
        cache_size=64)
    ml = pkg_hierarchy.MultilevelModel(fabric=fab, configs=[L0, L1],
                                       level_backends={0: [0], 1: [0, 1]})
    try:
        x = np.array([2.0])
        outs = [ml.evaluate(0, x), ml.evaluate(1, x),
                ml.evaluate_batch(1, np.array([[2.0], [3.0], [2.0]]))]
        rep = ml.report()
    finally:
        fab.shutdown()
    return outs, rep


def test_multilevel_fabric_binding_and_telemetry_match_jax():
    outs, rep = _fabric_session(fabric, hierarchy)
    assert float(outs[0][0]) == 4.0 and float(outs[1][0]) == 1.0
    np.testing.assert_allclose(outs[2].ravel(), [1.0, 4.0, 1.0])
    assert rep["counts"] == [1, 4]
    levels = rep["fabric_levels"]
    assert levels["level0"]["points"] == 1
    assert levels["level1"]["cache_hits"] >= 2 and levels["level1"]["points"] == 2
    assert "backend_share" in rep["router"]
    want_outs, want = _fabric_session(jax_fabric, jax_hierarchy)
    for got_o, want_o in zip(outs, want_outs):
        np.testing.assert_array_equal(got_o, want_o)
    assert rep["counts"] == want["counts"]
    assert rep["fabric_levels"] == want["fabric_levels"]


# -- the slice as a whole: the three-level §4.3 hierarchy ----------------------


@pytest.fixture(scope="module")
def hierarchies():
    """Both packages' three-level hierarchy on the reduced tsunami: the JAX
    side is `benchmarks.mlda_tsunami.build_hierarchy` (per-point design
    solves and GP predictions), the port's is chip_smoke.py's (the design as
    one wave, one `predict` per GP for a whole step)."""
    saved = (jax_tsunami.TsunamiModel.N_CELLS, tsunami.TsunamiModel.N_CELLS)
    jax_tsunami.TsunamiModel.N_CELLS = tsunami.TsunamiModel.N_CELLS = N_CELLS
    want = None
    try:
        want = build_hierarchy(n_gp_train=N_TRAIN)
        model = tsunami.TsunamiModel(device=CPU)
        data, logprior, loglik, _ = chip_smoke.tsunami_problem(torch, model, CPU)
        X = chip_smoke.gp_design(N_TRAIN)
        Y = model.evaluate_batch(X, L0)
        gps = [GP.fit(X, Y[:, j], n_iters=chip_smoke.GP_ITERS, device=CPU) for j in range(4)]
        got = dict(model=model, data=data, logprior=logprior, loglik=loglik, X=X, Y=Y, gps=gps)
        yield got, want
    finally:
        if want is not None:
            want["fabric"].shutdown()
        jax_tsunami.TsunamiModel.N_CELLS, tsunami.TsunamiModel.N_CELLS = saved


def test_design_and_data_match_the_reference(hierarchies):
    got, want = hierarchies
    from repro.uq.qmc import sobol as jax_sobol

    u = jax_sobol(N_TRAIN, 2, scramble_seed=3)
    (x_lo, x_hi), (a_lo, a_hi) = ((30.0, 150.0), (0.5, 4.0))
    X_ref = np.stack([x_lo + u[:, 0] * (x_hi - x_lo), a_lo + u[:, 1] * (a_hi - a_lo)], axis=1)
    np.testing.assert_array_equal(got["X"], X_ref)
    # the port's design wave against the reference's point-by-point solves
    Y_ref = np.array([want["model"]([list(x)], L0)[0] for x in got["X"]])
    tol = SOLVE_TOL[0]
    np.testing.assert_allclose(got["Y"][:, [0, 2]], Y_ref[:, [0, 2]], rtol=0, atol=tol["arrival"])
    np.testing.assert_allclose(got["Y"][:, [1, 3]], Y_ref[:, [1, 3]], rtol=tol["height_rtol"])
    np.testing.assert_allclose(got["data"][[0, 2]], want["data"][[0, 2]], rtol=0,
                               atol=SOLVE_TOL[1]["arrival"])
    np.testing.assert_allclose(got["data"][[1, 3]], want["data"][[1, 3]],
                               rtol=SOLVE_TOL[1]["height_rtol"])


def test_gp_fits_on_the_same_design_values_match_the_reference(hierarchies):
    """Fitted to the SAME training values, the port's four GPs predict
    what the JAX package's do, within `FIT_TOL` of each output's sd."""
    got, _ = hierarchies
    X, Y = got["X"], got["Y"]
    Xq = chip_smoke.gp_design(32, skip=N_TRAIN)
    for j, gp in enumerate(got["gps"]):
        ref = jax_gp.GP.fit(X, Y[:, j], n_iters=chip_smoke.GP_ITERS)
        np.testing.assert_allclose(gp.predict(Xq), ref.predict(Xq), rtol=0,
                                   atol=FIT_TOL * Y[:, j].std())


def _per_point_gp_logpost(gps, data, theta):
    """benchmarks/mlda_tsunami.py's `gp_logpost`, over the given GPs."""
    x0, A = float(theta[0]), float(theta[1])
    if not (30.0 <= x0 <= 150.0 and 0.5 <= A <= 4.0):
        return -np.inf
    obs = np.array([float(g.predict(np.array([[x0, A]]))[0]) for g in gps])
    return float(-0.5 * np.sum(((obs - data) / chip_smoke.NOISE_SD) ** 2))


def _queries():
    near = chip_smoke.TRUE_THETA + np.random.default_rng(0).normal(0, [5.0, 0.2], (16, 2))
    out = np.array([[20.0, 2.0], [90.0, 4.5]])  # outside the prior box
    return np.vstack([chip_smoke.gp_design(32, skip=N_TRAIN), near, out])


def test_batched_gp_logpost_equals_the_per_point_one(hierarchies):
    """One `predict` per GP for the whole block gives the reference's
    point-by-point values within 1e-10 relative: the [K, n] and [1, n]
    products against the GP's weights sum in another order (measured up to
    5.0e-12)."""
    got, _ = hierarchies
    Xq = _queries()
    lp = batched_logpost(chip_smoke.gp_outputs(got["gps"]), got["loglik"], got["logprior"])
    batched = lp(Xq)
    per_point = np.array([_per_point_gp_logpost(got["gps"], got["data"], t) for t in Xq])
    np.testing.assert_allclose(batched, per_point, rtol=1e-10)
    assert np.isneginf(batched[-2:]).all() and lp.points_evaluated == len(Xq) - 2


def test_gp_level_logposts_match_the_reference(hierarchies):
    got, want = hierarchies
    Xq = _queries()
    lp = batched_logpost(chip_smoke.gp_outputs(got["gps"]), got["loglik"], got["logprior"])
    a, b = lp(Xq), want["gp_logpost_batch"](Xq)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    ok = np.isfinite(b)
    np.testing.assert_allclose(a[ok], b[ok], rtol=LP_RTOL, atol=LP_ATOL)


def test_three_level_campaign_matches_the_reference(hierarchies):
    """K = 4 chains, 3 fine samples, subsampling [5, 2], the same numpy rng.
    Held EXACTLY where measured equal: the fine samples, waves and evals per
    level. The GP and coarse acceptance rates are held within 3 decisions
    each: the two GP levels differ within `LP_RTOL`, which flipped one GP
    decision of 120 and one coarse decision of 23 (measured) without moving
    a fine sample."""
    got, want = hierarchies
    x0s = np.array([[84.0, 2.3], [97.0, 2.7], [70.0, 1.9], [110.0, 3.1]])
    kw = dict(n_samples=3, subsampling=[5, 2], prop_cov=np.diag([8.0**2, 0.25**2]))
    fab = EvaluationFabric(ModelBackend(got["model"]), cache_size=8192)
    try:
        ml = MultilevelModel(fabric=fab, configs=[L0, L1])
        lps = chip_smoke.three_level_logposts(got["gps"], ml, got["loglik"], got["logprior"])
        res = ensemble_mlda(lps, x0s, rng=np.random.default_rng(501), **kw)
        rep = ml.report()
    finally:
        fab.shutdown()
    jlps = [want["gp_logpost_batch"], *jax_mlda.batched_level_logposts(
        want["fabric"], want["loglik"], [L0, L1], want["logprior"])]
    ref = jax_mlda.ensemble_mlda(jlps, x0s, rng=np.random.default_rng(501), **kw)
    assert np.isfinite(res.samples).all() and res.samples.shape == (4, 3, 2)
    np.testing.assert_allclose(res.samples, ref.samples, atol=1e-6)
    assert res.n_waves == ref.n_waves and res.evals_per_level == ref.evals_per_level
    for lvl, n_dec in ((0, res.evals_per_level[0]), (1, res.evals_per_level[1])):
        assert abs(res.accept_rates[lvl] - ref.accept_rates[lvl]) * n_dec <= 3
    assert res.accept_rates[2] == ref.accept_rates[2]
    # the per-level cost split: the PDE levels' points reached the model
    # through the MultilevelModel, and the GP level carried the most
    assert rep["counts"] == [lp.points_evaluated for lp in lps[1:]]
    assert lps[0].points_evaluated > rep["counts"][0] > rep["counts"][1] > 0
    assert set(rep["fabric_levels"]) == {"level0", "level1"}
