"""PyTorch port: the device-resident fused sampler blocks (`uq.fused`)
against the JAX package's, on the CPU. Every test of `tests/test_fused.py`
but the sharded one (no mesh on one card) is re-pointed at the port:
bit-exactness of a block against the per-step reference, statistical
exactness (the same moment bounds, with the JAX runner on the same problem
in the same test), checkpoint/resume replay, MLDA fused subchains and fabric
step telemetry. jax threefry and torch's generators never match, so the
samplers agree with the JAX package in law; the target builders and the
block-diagonal gradient agree with it value for value (float64, 1e-12),
and the tsunami target within the solvers' own bounds (`SOLVE_TOL`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _stat_harness import assert_moments
from _torch_parity import SOLVE_THETAS, SOLVE_TOL

import repro.apps.tsunami as jax_tsunami
import repro.uq.fused as jax_fused
from repro_torch.apps.tsunami import solve_batch
from repro_torch.core.fabric import EvaluationFabric
from repro_torch.core.fleet import CampaignCheckpoint
from repro_torch.kernels.swe.testing import SOURCE_BOX
from repro_torch.uq import fused
from repro_torch.uq.fused import (
    _value_and_grad_rows,
    fused_ensemble_mala,
    fused_ensemble_pcn,
    fused_ensemble_rwm,
    gaussian_likelihood_target,
    gaussian_target,
)
from repro_torch.uq.mcmc import (
    batched_logpost,
    ensemble_mala,
    ensemble_pcn,
    ensemble_random_walk_metropolis,
)
from repro_torch.uq.mlda import ensemble_mlda

# the blocks here run [K <= 16, d] states and 64-cell solves, far below the
# size where torch's intra-op threads pay; one thread keeps the xdist
# workers from oversubscribing the cores they share with the JAX tests
torch.set_num_threads(1)

MEAN2 = np.array([1.0, -0.5])
COV2 = np.array([[0.8, 0.3], [0.3, 0.5]])


def _x0s(K=6, d=2, seed=3):
    return np.random.default_rng(seed).normal(size=(K, d))


def _gen(seed: int) -> torch.Generator:
    """A CPU generator: the block runs on its generator's device."""
    return torch.Generator().manual_seed(seed)


# -- fused block == per-step reference, bit for bit ---------------------------

def test_fused_rwm_bitexact_vs_per_step():
    lp = gaussian_target(MEAN2, COV2)
    kw = dict(fused_steps=5)
    r_f = fused_ensemble_rwm(lp, _x0s(), 30, 0.4 * COV2, _gen(7), **kw)
    r_p = fused_ensemble_rwm(lp, _x0s(), 30, 0.4 * COV2, _gen(7), per_step=True, **kw)
    # per_step runs the SAME body with S=1 and pays one dispatch per step —
    # the streams coincide exactly, not just statistically
    assert np.array_equal(r_f.samples, r_p.samples)
    assert np.array_equal(r_f.logposts, r_p.logposts)
    assert np.array_equal(r_f.accept_rates, r_p.accept_rates)
    # block accounting: 30 steps at S=5 -> 6 dispatches (+1 init)
    assert r_f.n_waves == 7 and r_p.n_waves == 31


def test_fused_pcn_bitexact_vs_per_step():
    ll = gaussian_target(MEAN2)  # likelihood-only; prior is the pCN kernel
    r_f = fused_ensemble_pcn(ll, _x0s(), 24, 0.3, _gen(11), fused_steps=6)
    r_p = fused_ensemble_pcn(ll, _x0s(), 24, 0.3, _gen(11), fused_steps=6,
                             per_step=True)
    assert np.array_equal(r_f.samples, r_p.samples)
    assert np.array_equal(r_f.accept_rates, r_p.accept_rates)


def test_fused_mala_bitexact_vs_per_step_with_adaptation():
    lp = gaussian_target(MEAN2, COV2)
    kw = dict(fused_steps=5, adapt_steps=15, precond=COV2)
    r_f = fused_ensemble_mala(lp, _x0s(), 30, 0.6, _gen(13), **kw)
    r_p = fused_ensemble_mala(lp, _x0s(), 30, 0.6, _gen(13), per_step=True, **kw)
    # Robbins-Monro eps rides in the carry, so even the adapted trajectory
    # is reproduced exactly by the per-step dispatch
    assert np.array_equal(r_f.samples, r_p.samples)
    assert r_f.final_step_size == r_p.final_step_size
    assert r_f.final_step_size != 0.6
    assert r_f.n_grad_waves == 7


# -- entry-point integration ---------------------------------------------------

def test_entrypoint_fused_matches_direct_runner():
    lp = gaussian_target(MEAN2, COV2)
    rng = np.random.default_rng(0)
    key = _gen(5)
    got = ensemble_random_walk_metropolis(
        lp, _x0s(), 20, 0.4 * COV2, rng, fused_steps=5, fused_key=key)
    want = fused_ensemble_rwm(lp, _x0s(), 20, 0.4 * COV2, _gen(5), fused_steps=5)
    assert np.array_equal(got.samples, want.samples)
    # the caller's generator advanced by what the run drew
    assert torch.equal(key.get_state(), _advanced(5, 20, 6, 2))


def _advanced(seed: int, n_steps: int, K: int, d: int) -> torch.Tensor:
    """The state of generator `seed` after `n_steps` RWM steps of K chains
    in d dimensions: K*d normals and K uniforms a step."""
    gen = _gen(seed)
    for _ in range(n_steps):
        torch.randn((K, d), generator=gen, dtype=torch.float32)
        torch.rand((K,), generator=gen, dtype=torch.float32)
    return gen.get_state()


def test_entrypoint_fused_adaptive_incompatible():
    lp = gaussian_target(MEAN2)
    with pytest.raises(ValueError, match="adaptive"):
        ensemble_random_walk_metropolis(
            lp, _x0s(), 20, np.eye(2), np.random.default_rng(0),
            fused_steps=5, fused_key=_gen(0), adaptive=True)


def test_fused_steps_must_divide_n_steps():
    lp = gaussian_target(MEAN2)
    with pytest.raises(ValueError, match="multiple"):
        fused_ensemble_rwm(lp, _x0s(), 21, np.eye(2), _gen(0), fused_steps=5)


# -- statistical exactness over long fused blocks ------------------------------
# Each runs the JAX runner on the same problem, held to the same bound.

def test_fused_rwm_recovers_gaussian_moments():
    d = 3
    x0s = np.random.default_rng(1).normal(size=(8, d))
    args = (x0s, 2000, (2.4**2 / d) * np.eye(d), np.random.default_rng(2))
    res = ensemble_random_walk_metropolis(
        gaussian_target(np.ones(d)), *args, fused_steps=100, fused_key=_gen(42))
    assert_moments(res.samples, np.ones(d), np.ones(d), label="port fused rwm")
    want = jax_fused.fused_ensemble_rwm(
        jax_fused.gaussian_target(np.ones(d)), *args[:3], jax.random.key(42),
        fused_steps=100)
    assert_moments(want.samples, np.ones(d), np.ones(d), label="jax fused rwm")


def test_fused_mala_recovers_gaussian_moments():
    d = 2
    x0s = np.random.default_rng(1).normal(size=(8, d))
    res = ensemble_mala(
        gaussian_target(np.ones(d)), x0s, 1500, 0.9, np.random.default_rng(2),
        adapt_steps=500, fused_steps=50, fused_key=_gen(9))
    assert_moments(res.samples, np.ones(d), np.ones(d), label="port fused mala")
    want = jax_fused.fused_ensemble_mala(
        jax_fused.gaussian_target(np.ones(d)), x0s, 1500, 0.9, jax.random.key(9),
        adapt_steps=500, fused_steps=50)
    assert_moments(want.samples, np.ones(d), np.ones(d), label="jax fused mala")


def test_fused_pcn_recovers_gaussian_posterior():
    # prior N(0, I), likelihood N(x; m, s^2 I) -> posterior N(m/(1+s^2), ...)
    d, s2 = 2, 0.5
    m = np.array([0.6, -0.4])
    x0s = np.random.default_rng(1).normal(size=(8, d))
    res = ensemble_pcn(
        gaussian_likelihood_target(lambda xs: xs, m, np.sqrt(s2)), None, x0s,
        2000, 0.5, np.random.default_rng(2), fused_steps=100, fused_key=_gen(17))
    post_var = s2 / (1.0 + s2)
    assert_moments(res.samples, m / (1.0 + s2), post_var * np.ones(d),
                   label="port fused pcn")
    want = jax_fused.fused_ensemble_pcn(
        jax_fused.gaussian_likelihood_target(lambda xs: xs, m, np.sqrt(s2)),
        x0s, 2000, 0.5, jax.random.key(17), fused_steps=100)
    assert_moments(want.samples, m / (1.0 + s2), post_var * np.ones(d),
                   label="jax fused pcn")


# -- checkpoint/resume replays the stream bit-exactly --------------------------

class _DieAfter:
    """Checkpoint wrapper that kills the campaign after `n` saves."""

    def __init__(self, ckpt, n):
        self.ckpt, self.n, self.saves = ckpt, n, 0

    def resume(self):
        return self.ckpt.resume()

    def save(self, step, arrays, meta):
        self.ckpt.save(step, arrays, meta)
        self.saves += 1
        if self.saves >= self.n:
            raise RuntimeError("simulated preemption")


def test_fused_checkpoint_resume_bitexact(tmp_path):
    lp = gaussian_target(MEAN2, COV2)
    kw = dict(fused_steps=5, adapt_steps=20, precond=COV2)
    want = fused_ensemble_mala(lp, _x0s(), 40, 0.6, _gen(23), **kw)

    ckpt = CampaignCheckpoint(str(tmp_path / "camp"))
    bomb = _DieAfter(ckpt, 2)
    with pytest.raises(RuntimeError, match="preemption"):
        fused_ensemble_mala(lp, _x0s(), 40, 0.6, _gen(23), checkpoint=bomb,
                            checkpoint_every=10, **kw)
    arrays, meta, step = CampaignCheckpoint(str(tmp_path / "camp")).resume()
    assert step == 20 and meta["steps_done"] == 20 and meta["key_device"] == "cpu"
    # resume from the block boundary with a generator in another state: the
    # restored stream wins -> identical tail
    got = fused_ensemble_mala(
        lp, _x0s(), 40, 0.6, _gen(999),
        checkpoint=CampaignCheckpoint(str(tmp_path / "camp")),
        checkpoint_every=10, **kw)
    assert np.array_equal(got.samples, want.samples)
    assert np.array_equal(got.logposts, want.logposts)
    assert got.final_step_size == want.final_step_size


def test_key_manifest_roundtrip():
    key = _gen(3)
    torch.randn(9, generator=key)  # a state mid-stream, not a fresh seed
    data = CampaignCheckpoint.pack_key(key)
    assert isinstance(data, np.ndarray) and data.dtype == np.uint8  # npy-serializable
    back = CampaignCheckpoint.unpack_key(data, "cpu")
    assert back.device.type == "cpu"
    a = torch.randn(4, generator=key)
    b = torch.randn(4, generator=back)
    assert torch.equal(a, b)


# -- MLDA fused coarse subchains ----------------------------------------------

def _mlda_logposts():
    coarse = gaussian_target(np.ones(2), 1.1 * np.eye(2))
    fine = gaussian_target(np.ones(2), np.eye(2))

    def lp_coarse(thetas):
        return coarse(torch.as_tensor(np.atleast_2d(thetas), dtype=torch.float32)).numpy()

    def lp_fine(thetas):
        return fine(torch.as_tensor(np.atleast_2d(thetas), dtype=torch.float32)).numpy()

    return coarse, [lp_coarse, lp_fine]


def test_mlda_fused_subchain_matches_statistics(rng):
    coarse_tensor, logposts = _mlda_logposts()
    x0s = rng.normal(size=(6, 2))
    host = ensemble_mlda(logposts, x0s, 150, [4], 0.5 * np.eye(2),
                         np.random.default_rng(0))
    got = ensemble_mlda(logposts, x0s, 150, [4], 0.5 * np.eye(2),
                        np.random.default_rng(0), fused_level0=coarse_tensor,
                        fused_key=_gen(31))
    # each coarse subchain is one dispatch instead of `sub` waves
    assert got.n_waves < host.n_waves
    assert got.evals_per_level[0] == 6 * 150 * (4 + 1)  # start + 4 steps a subchain
    assert abs(got.accept_rates[-1] - host.accept_rates[-1]) < 0.2
    m_host = host.samples[:, 50:].mean(axis=(0, 1))
    m_fused = got.samples[:, 50:].mean(axis=(0, 1))
    assert np.all(np.abs(m_fused - m_host) < 0.5)


def test_mlda_fused_incompatible_with_adaptive_and_surrogate(rng):
    coarse_tensor, logposts = _mlda_logposts()
    x0s = rng.normal(size=(4, 2))
    for kw in (dict(adaptive=True), dict(surrogate=object())):
        with pytest.raises(ValueError, match="fused_level0"):
            ensemble_mlda(logposts, x0s, 20, [3], np.eye(2),
                          np.random.default_rng(0), fused_level0=coarse_tensor,
                          fused_key=_gen(0), **kw)


def test_mlda_fused_checkpoint_roundtrips_key(tmp_path, rng):
    coarse_tensor, logposts = _mlda_logposts()
    x0s = rng.normal(size=(4, 2))
    kw = dict(fused_level0=coarse_tensor, checkpoint_every=10)
    want = ensemble_mlda(logposts, x0s, 40, [3], 0.5 * np.eye(2),
                         np.random.default_rng(0), fused_key=_gen(37), **kw,
                         checkpoint=CampaignCheckpoint(str(tmp_path / "full")))
    arrays, meta, _ = CampaignCheckpoint(str(tmp_path / "full")).resume()
    assert "fused_key" in arrays  # the subchain stream survives restarts
    assert meta["fused_key_device"] == "cpu"
    # and a kill after two saves resumes to the same samples, bit for bit
    bomb = _DieAfter(CampaignCheckpoint(str(tmp_path / "camp")), 2)
    with pytest.raises(RuntimeError, match="preemption"):
        ensemble_mlda(logposts, x0s, 40, [3], 0.5 * np.eye(2),
                      np.random.default_rng(0), fused_key=_gen(37), **kw,
                      checkpoint=bomb)
    got = ensemble_mlda(logposts, x0s, 40, [3], 0.5 * np.eye(2),
                        np.random.default_rng(0), fused_key=_gen(37), **kw,
                        checkpoint=CampaignCheckpoint(str(tmp_path / "camp")))
    assert np.array_equal(got.samples, want.samples)


# -- fabric step telemetry -----------------------------------------------------

def test_fabric_steps_per_wave_telemetry():
    fabric = EvaluationFabric(lambda thetas, cfg=None: np.asarray(thetas).sum(1),
                              adaptive=False)
    try:
        t0 = fabric.telemetry()
        assert t0["sampler_steps"] == 0 and t0["steps_per_wave"] is None
        fabric.note_steps(50, waves=1)   # one fused block, S=50
        fabric.note_steps(1, waves=1)    # one host proposal wave
        t = fabric.telemetry()
        assert t["sampler_steps"] == 51
        assert t["sampler_waves"] == 2
        assert t["steps_per_wave"] == pytest.approx(25.5)
        # a fused run with the fabric as its telemetry notes S steps a block
        fused_ensemble_rwm(gaussian_target(MEAN2), _x0s(), 20, np.eye(2), _gen(1),
                           fused_steps=10, telemetry=fabric)
        t = fabric.telemetry()
        assert t["sampler_steps"] == 71 and t["sampler_waves"] == 4
    finally:
        fabric.shutdown()


def test_host_sampler_notes_steps_through_batched_logpost():
    fabric = EvaluationFabric(lambda thetas, cfg=None: np.asarray(thetas).sum(1),
                              adaptive=False)
    try:
        lp = batched_logpost(fabric, lambda y: -0.5 * float(np.ravel(y)[0]) ** 2)
        x0s = np.random.default_rng(0).normal(size=(4, 2))
        ensemble_random_walk_metropolis(
            lp, x0s, 10, 0.3 * np.eye(2), np.random.default_rng(1))
        t = fabric.telemetry()
        # host lockstep loop: one step per proposal wave, every step noted
        assert t["sampler_steps"] == 10
        assert t["steps_per_wave"] == pytest.approx(1.0)
    finally:
        fabric.shutdown()


# -- the targets against the JAX package's, value for value ------------------

F64_RTOL = 1e-12


@pytest.fixture
def float64():
    """torch's default dtype float64 and JAX in x64 for the test."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_default_dtype(prev)


def _points(K=16, d=2, seed=4):
    return np.random.default_rng(seed).normal(size=(K, d)) * 1.5


@pytest.mark.parametrize("cov", [None, COV2], ids=["identity", "cov"])
def test_gaussian_target_matches_jax_in_float64(float64, cov):
    xs = _points()
    got = gaussian_target(MEAN2, cov)(torch.as_tensor(xs))
    want = np.asarray(jax_fused.gaussian_target(MEAN2, cov)(jnp.asarray(xs)))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=F64_RTOL, atol=0)


def _analytic_forward(pkg):
    """[K, 2] -> [K, 3], smooth and nonlinear, in either package's ops."""
    return lambda xs: pkg.stack(
        [pkg.sin(xs[:, 0]) * xs[:, 1], xs[:, 0] ** 2 - xs[:, 1], pkg.exp(0.3 * xs[:, 1])], 1)


DATA3, SD3, BOX = np.array([0.2, 0.5, 1.1]), np.array([0.3, 0.4, 0.2]), [(-2.0, 2.0), (-1.5, 1.5)]


def test_gaussian_likelihood_target_matches_jax_in_float64(float64):
    xs = _points()
    for bounds in (None, BOX):
        got = gaussian_likelihood_target(_analytic_forward(torch), DATA3, SD3, bounds)(
            torch.as_tensor(xs)).numpy()
        want = np.asarray(jax_fused.gaussian_likelihood_target(
            _analytic_forward(jnp), DATA3, SD3, bounds)(jnp.asarray(xs)))
        # the prior box's -inf mask, element for element
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        if bounds is not None:
            assert 0 < np.isneginf(got).sum() < len(xs)
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=F64_RTOL, atol=0)


def test_value_and_grad_rows_matches_jax_in_float64(float64):
    xs = _points()
    got_lp, got_g = _value_and_grad_rows(gaussian_likelihood_target(
        _analytic_forward(torch), DATA3, SD3, BOX))(torch.as_tensor(xs))
    want_lp, want_g = (np.asarray(a) for a in jax_fused._value_and_grad_rows(
        jax_fused.gaussian_likelihood_target(_analytic_forward(jnp), DATA3, SD3, BOX))(
        jnp.asarray(xs)))
    np.testing.assert_array_equal(np.isneginf(got_lp.numpy()), np.isneginf(want_lp))
    ok = np.isfinite(want_lp)
    np.testing.assert_allclose(got_lp.numpy()[ok], want_lp[ok], rtol=F64_RTOL, atol=0)
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=F64_RTOL * scale)
    assert np.array_equal(got_g.numpy()[~ok], np.zeros_like(want_g[~ok]))


# -- the tsunami target (float32, the 64/128-cell hierarchy) ------------------

TSUNAMI_LEVELS = [(0, 64, True), (1, 128, False)]
NOISE_SD = np.array([0.5, 0.05, 0.5, 0.05])


def _tsunami_targets(n_cells, smoothed):
    """Both packages' tsunami log-posteriors over their own solver, each
    recording the forward's output, on data from the JAX solver."""
    data = np.asarray(jax_tsunami._solve_batch(
        jnp.asarray([[90.0, 2.5]], jnp.float32), n_cells, smoothed))[0]
    seen = {}

    def port_fwd(xs):
        seen["port"] = solve_batch(xs, n_cells, smoothed)
        return seen["port"]

    def jax_fwd(xs):
        seen["jax"] = jax_tsunami._solve_batch(xs, n_cells, smoothed)
        return seen["jax"]

    port = gaussian_likelihood_target(port_fwd, data, NOISE_SD, SOURCE_BOX)
    ref = jax_fused.gaussian_likelihood_target(jax_fwd, data, NOISE_SD, SOURCE_BOX)
    return port, ref, data, seen


@pytest.mark.parametrize("level,n_cells,smoothed", TSUNAMI_LEVELS)
def test_tsunami_target_matches_jax_in_float32(level, n_cells, smoothed):
    port, ref, data, seen = _tsunami_targets(n_cells, smoothed)
    # the four measured sources, one outside the box on each side
    thetas = np.concatenate([SOLVE_THETAS, [[20.0, 2.0], [90.0, 4.5]]]).astype(np.float32)
    got = port(torch.as_tensor(thetas)).numpy()
    want = np.asarray(ref(jnp.asarray(thetas)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2
    # the forward within the solvers' bounds
    ys, ys_ref = seen["port"].numpy(), np.asarray(seen["jax"])
    tol = SOLVE_TOL[level]
    np.testing.assert_allclose(ys[:, [0, 2]], ys_ref[:, [0, 2]], atol=tol["arrival"])
    np.testing.assert_allclose(ys[:, [1, 3]], ys_ref[:, [1, 3]], rtol=tol["height_rtol"])
    # and the log-likelihood within what those forward deviations can move
    # it: r^2 - r'^2 = (r + r')(r - r'), plus float32 rounding of the sums
    r, r_ref = (ys - data) / NOISE_SD, (ys_ref - data) / NOISE_SD
    bound = 0.5 * np.sum(np.abs(r + r_ref) * np.abs(r - r_ref), 1) \
        + 1e-5 * np.abs(want).clip(1.0)
    ok = np.isfinite(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= bound[ok] * 1.01), (got, want, bound)


def test_fused_rwm_block_over_the_tsunami_runs_on_cpu():
    port, _, _, _ = _tsunami_targets(64, True)
    x0s = np.array([[84.0, 2.3], [97.0, 2.7], [90.0, 2.4], [88.0, 2.6]])
    res = fused_ensemble_rwm(port, x0s, 6, np.diag([8.0**2, 0.25**2]) * 0.1,
                             _gen(3), fused_steps=3)
    assert res.samples.shape == (4, 6, 2) and np.isfinite(res.samples).all()
    assert np.isfinite(res.logposts).all()
    assert res.n_waves == 3
    assert np.all((res.accept_rates > 0) & (res.accept_rates <= 1)), res.accept_rates


def test_block_memo_reuses_the_block():
    lp = gaussian_target(MEAN2, COV2)
    fused._BLOCK_MEMO.clear()
    a = fused_ensemble_rwm(lp, _x0s(), 10, 0.4 * COV2, _gen(2), fused_steps=5)
    n = len(fused._BLOCK_MEMO)
    b = fused_ensemble_rwm(lp, _x0s(), 10, 0.4 * COV2, _gen(2), fused_steps=5)
    assert len(fused._BLOCK_MEMO) == n == 2  # the step and the block, once
    assert np.array_equal(a.samples, b.samples)
