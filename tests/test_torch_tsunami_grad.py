"""PyTorch port: the tsunami derivative surface against the JAX package on
the CPU — the VJP, JVP and HVP waves and the fused value-and-gradient wave
in float64 (where a wrong derivative rule at a kink shows as a large error,
not as rounding), one step at a state full of kinks, the model's float32
surface, the primal of every derivative wave against `evaluate_batch`, the
reference's duality / symmetry / central-difference checks, chunking, and
the per-point time series. Small hierarchies (64/128 and 128/256 cells),
as the JAX package's own derivative tests use."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.tsunami as jax_tsunami
import repro_torch.apps.tsunami as tsunami
from _torch_parity import SOLVE_TOL
from repro_torch.kernels.swe.testing import GRAD_RTOL32, HVP32_FLOOR

# the waves here run [cells, <= 16] states, far below the size where
# torch's intra-op threads pay; one thread keeps the xdist workers from
# oversubscribing the cores they share with the JAX tests
torch.set_num_threads(1)

#: (n_cells, smoothed) of the small hierarchy's two levels
SMALL_LEVELS = [(64, True), (128, False)]
_RNG = np.random.default_rng(7)
THETAS = np.array([[90.0, 2.5], [60.0, 1.2], [110.0, 3.0]])
SENSS = _RNG.normal(size=(3, 4))
VECS = _RNG.normal(size=(3, 2))
#: float64 bound of every derivative wave against the JAX package: both
#: run the same expressions with the same rules at the kinks, so they
#: differ only by rounding (measured: <= 2e-14 relative, element by element)
RTOL64 = 1e-8
#: the JAX package computes the arrival time in float32 even under x64 (its
#: step counter is a float32 `arange`), so the primal's arrival columns
#: agree to float32 rounding (measured: 6.3e-8); the height columns to RTOL64
ARRIVAL_RTOL64 = 1e-6


class SmallModel(tsunami.TsunamiModel):
    N_CELLS = {0: 64, 1: 128}


class SmallJaxModel(jax_tsunami.TsunamiModel):
    N_CELLS = {0: 64, 1: 128}


def _t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _weights():
    """A traceable per-row sensitivity, written once for each package:
    w * (y - d) with fixed w and d."""
    w = np.array([0.3, -1.2, 0.5, 2.0])
    d = np.array([10.0, 1.0, 20.0, 0.8])
    return w, d


_JAX64: dict = {}


def _jax64(n_cells, smoothed):
    """The JAX package's four derivative waves under x64, once per level."""
    key = (n_cells, smoothed)
    if key not in _JAX64:
        w, d = _weights()
        with jax.enable_x64(True):
            th = jnp.asarray(THETAS)
            y, g = jax_tsunami._vjp_batch(th, jnp.asarray(SENSS), n_cells, smoothed)
            jv = jax_tsunami._jvp_batch(th, jnp.asarray(VECS), n_cells, smoothed)
            hv = jax_tsunami._hvp_batch(th, jnp.asarray(SENSS), jnp.asarray(VECS),
                                        n_cells, smoothed)
            yf, pull = jax.vjp(lambda t: jax_tsunami._solve_batch(t, n_cells, smoothed), th)
            gf = pull(jax.vmap(lambda row: jnp.asarray(w) * (row - jnp.asarray(d)))(yf))[0]
            _JAX64[key] = {k: np.asarray(v) for k, v in dict(
                y=y, g=g, jv=jv, hv=hv, yf=yf, gf=gf).items()}
    return _JAX64[key]


def _assert_primal64(got, want):
    got = np.asarray(got)
    np.testing.assert_allclose(got[:, [1, 3]], want[:, [1, 3]], rtol=RTOL64, atol=0)
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=ARRIVAL_RTOL64, atol=0)


@pytest.mark.parametrize("n_cells,smoothed", SMALL_LEVELS)
def test_float64_vjp_wave_matches_jax(n_cells, smoothed):
    want = _jax64(n_cells, smoothed)
    y, g = tsunami._vjp_batch(_t64(THETAS), _t64(SENSS), n_cells, smoothed)
    assert y.dtype == g.dtype == torch.float64
    _assert_primal64(y, want["y"])
    np.testing.assert_allclose(g.numpy(), want["g"], rtol=RTOL64, atol=0)


@pytest.mark.parametrize("n_cells,smoothed", SMALL_LEVELS)
def test_float64_jvp_wave_matches_jax(n_cells, smoothed):
    want = _jax64(n_cells, smoothed)
    jv = tsunami._jvp_batch(_t64(THETAS), _t64(VECS), n_cells, smoothed)
    assert jv.dtype == torch.float64 and jv.shape == (3, 4)
    np.testing.assert_allclose(jv.numpy(), want["jv"], rtol=RTOL64, atol=0)


@pytest.mark.parametrize("n_cells,smoothed", SMALL_LEVELS)
def test_float64_hvp_wave_matches_jax(n_cells, smoothed):
    want = _jax64(n_cells, smoothed)
    hv = tsunami._hvp_batch(_t64(THETAS), _t64(SENSS), _t64(VECS), n_cells, smoothed)
    assert np.isfinite(hv.numpy()).all()
    np.testing.assert_allclose(hv.numpy(), want["hv"], rtol=RTOL64, atol=0)


@pytest.mark.parametrize("n_cells,smoothed", SMALL_LEVELS)
def test_float64_fused_value_and_gradient_matches_jax(n_cells, smoothed):
    want = _jax64(n_cells, smoothed)
    w, d = _weights()
    w_t, d_t = _t64(w), _t64(d)
    y, g = tsunami._value_and_grad(_t64(THETAS), n_cells, smoothed,
                                   sens_fn=lambda row: w_t * (row - d_t))
    _assert_primal64(y, want["yf"])
    np.testing.assert_allclose(g.numpy(), want["gf"], rtol=RTOL64, atol=0)


# -- one step at a state full of kinks ----------------------------------------


def _jax_step(h, hu, b, dt_dx):
    """The JAX package's scan body of `_solve_batch` (its `swe_impl="scan"`
    branch), with the reference's own `_sqrt_safe`."""
    G, H_DRY = jax_tsunami.G, jax_tsunami.H_DRY
    bL, bR = b[:-1], b[1:]
    bstar = jnp.maximum(bL, bR)
    h4 = h**4
    u = jnp.sqrt(2.0) * h * hu / jnp.sqrt(h4 + jnp.maximum(h, H_DRY) ** 4)
    hsL = jnp.maximum(h[:-1] + bL - bstar, 0.0)
    hsR = jnp.maximum(h[1:] + bR - bstar, 0.0)
    uL, uR = u[:-1], u[1:]
    mL, mR = hsL * uL, hsR * uR
    a = jnp.maximum(jnp.abs(uL) + jax_tsunami._sqrt_safe(G * hsL),
                    jnp.abs(uR) + jax_tsunami._sqrt_safe(G * hsR))
    Fh = 0.5 * (mL + mR) - 0.5 * a * (hsR - hsL)
    Fq = 0.5 * ((mL * uL + 0.5 * G * hsL * hsL) + (mR * uR + 0.5 * G * hsR * hsR)) \
        - 0.5 * a * (mR - mL)
    A = Fq + 0.5 * G * (h[:-1] ** 2 - hsL**2)
    B = Fq + 0.5 * G * (h[1:] ** 2 - hsR**2)
    div_h = jnp.concatenate([Fh[:1], Fh[1:] - Fh[:-1], -Fh[-1:]], 0)
    pL = 0.5 * G * h[:1] ** 2
    pR = 0.5 * G * h[-1:] ** 2
    div_hu = jnp.concatenate([A[:1] - pL, A[1:] - B[:-1], pR - B[-1:]], 0)
    h_new = jnp.maximum(h - dt_dx * div_h, 0.0)
    hu_new = jnp.where(h_new > H_DRY, hu - dt_dx * div_hu, 0.0)
    return h_new, hu_new


def _kink_state():
    """[12, 3] float64 state on a beach: dry cells (h == 0, so interface
    depths tie with 0 in `max(., 0)`), still cells (hu == 0 with h > 0, so
    u == 0 at |u|'s kink), moving water, and tangents and cotangents that
    are non-zero everywhere, dry and still cells included."""
    rng = np.random.default_rng(11)
    C, N = 12, 3
    b = np.concatenate([np.full(6, -10.0), np.linspace(-2.0, 3.0, 6)])[:, None]
    h = np.maximum(-b + 0.3 * np.sin(np.arange(C))[:, None] * np.ones((1, N)), 0.0)
    h[9:] = 0.0  # dry beach
    hu = rng.normal(size=(C, N)) * (h > 0.05)
    hu[2:4] = 0.0  # still water
    tangents = rng.normal(size=(2, C, N))
    cotangents = rng.normal(size=(2, C, N))
    return h, hu, b, 0.01, tangents, cotangents


def _step_derivatives():
    """(VJP, JVP) of one step at `_kink_state`: the port's `_ad_step` (its
    JVP the hand-written tangent the waves carry) and the JAX reference's."""
    h, hu, b, dt_dx, (dh, dhu), (gh, ghu) = _kink_state()
    hs = [_t64(h).requires_grad_(), _t64(hu).requires_grad_()]
    out = tsunami._ad_step(*hs, _t64(b), dt_dx)
    vjp = torch.autograd.grad(out, hs, [_t64(gh), _t64(ghu)])
    with torch.no_grad():
        _, _, jh, jhu = tsunami._ad_step(_t64(h), _t64(hu), _t64(b), dt_dx, _t64(dh), _t64(dhu))
    with jax.enable_x64(True):
        f = lambda x, y: _jax_step(x, y, jnp.asarray(b), dt_dx)  # noqa: E731
        _, pull = jax.vjp(f, jnp.asarray(h), jnp.asarray(hu))
        want_vjp = pull((jnp.asarray(gh), jnp.asarray(ghu)))
        _, want_jvp = jax.jvp(f, (jnp.asarray(h), jnp.asarray(hu)),
                              (jnp.asarray(dh), jnp.asarray(dhu)))
    got = [t.numpy() for t in (*vjp, jh, jhu)]
    want = [np.asarray(t) for t in (*want_vjp, *want_jvp)]
    return got, want


def test_step_derivatives_match_jax_at_the_kinks():
    h, hu, *_ = _kink_state()
    # the state does sit on the kinks
    assert (h == 0).sum() >= 6 and ((hu == 0) & (h > 0)).sum() >= 6
    got, want = _step_derivatives()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL64, atol=1e-12)


def _clamp_relu(x):
    return torch.clamp_min(x, 0.0)


def _slope_one_at_ties(x, y):
    return (x >= y).to(x.dtype)


def _uncapped_sqrt_slope(t, y):
    return t * 0.5 / y


@pytest.mark.parametrize("name,patch", [
    ("_abs", torch.abs),  # slope 0 at u == 0 (JAX's jnp.abs: 1)
    ("_relu", _clamp_relu),  # slope 1 at a dry tie (JAX's jnp.maximum: 1/2)
    ("_slope", _slope_one_at_ties),  # the hand-written tangent's tie rule
    ("_sqrt_slope", _uncapped_sqrt_slope),  # sqrt'(0) = inf at a dry interface
])
def test_torch_tie_rules_break_the_float64_parity(monkeypatch, name, patch):
    """Regression for the rules at the kinks: the plain step's `torch.abs` /
    `torch.clamp_min` compute the same values but other slopes there, and a
    plain square root's slope is infinite where a cell is dry; the parity
    above sees each far outside rounding (or as inf / NaN)."""
    monkeypatch.setattr(tsunami, name, patch)
    got, want = _step_derivatives()
    worst = max(np.max(np.abs(g - w)) / np.max(np.abs(w)) for g, w in zip(got, want))
    assert np.isnan(worst) or worst > 1e3 * RTOL64, worst


# -- the model's float32 surface ----------------------------------------------

#: the float32 bounds (`kernels.swe.testing`): first order against the JAX
#: package's model on the largest entry; a float32 HVP lane by lane against
#: the float64 one, within twice the JAX package's own float32 error + floor
MODEL_RTOL32 = GRAD_RTOL32


def _rel_max(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("level", [0, 1])
def test_model_float32_derivatives_match_jax_model(level):
    pm, jm = SmallModel(device="cpu"), SmallJaxModel()
    c = {"level": level}
    rng = np.random.default_rng(3)
    th = np.stack([rng.uniform(40, 140, 5), rng.uniform(0.8, 3.5, 5)], 1)
    se, ve = rng.normal(size=(5, 4)), rng.normal(size=(5, 2))
    data = jm.evaluate_batch(th[:1], c)[0] + 0.1
    data_t = torch.as_tensor(data, dtype=torch.float32)
    pairs = {
        "gradient": (pm.gradient_batch(th, se, c), jm.gradient_batch(th, se, c)),
        "apply_jacobian": (pm.apply_jacobian_batch(th, ve, c),
                           jm.apply_jacobian_batch(th, ve, c)),
        "value_and_gradient": (
            pm.value_and_gradient_batch(th, lambda y: -(y - data_t), c)[1],
            jm.value_and_gradient_batch(th, lambda y: -(y - data), c)[1],
        ),
    }
    for op, (got, want) in pairs.items():
        assert got.shape == want.shape and got.dtype == np.float64, op
        assert np.isfinite(got).all(), op
        err = _rel_max(got, want)
        print(f"level {level} {op}: {err:.3g} relative to the largest entry")
        assert err <= MODEL_RTOL32, (op, err)
    hv_port, hv_jax = pm.apply_hessian_batch(th, se, ve, c), jm.apply_hessian_batch(th, se, ve, c)
    assert np.isfinite(hv_port).all()
    f64 = [torch.as_tensor(a.astype(np.float32).astype(float)) for a in (th, se, ve)]
    exact = tsunami._hvp_batch(*f64, pm.N_CELLS[level], level == 0).numpy()
    scale = np.max(np.abs(exact))
    err_port = np.max(np.abs(hv_port - exact), axis=1) / scale
    err_jax = np.max(np.abs(hv_jax - exact), axis=1) / scale
    print(f"level {level} apply_hessian vs float64, per lane: port {err_port}, jax {err_jax}")
    assert np.all(err_port <= 2 * err_jax + HVP32_FLOOR), (err_port, err_jax)
    pairs["apply_hessian"] = (hv_port, hv_jax)
    # the per-point surface delegates to the same waves, one lane wide (the
    # CPU's vector kernels may round a 1-lane and a 5-lane wave differently;
    # measured 6e-6)
    for got, want in (
        (pm.gradient(0, 0, [list(th[0])], list(se[0]), c), pairs["gradient"][0][0]),
        (pm.apply_jacobian(0, 0, [list(th[0])], list(ve[0]), c),
         pairs["apply_jacobian"][0][0]),
        (pm.apply_hessian(0, 0, 0, [list(th[0])], list(se[0]), list(ve[0]), c),
         pairs["apply_hessian"][0][0]),
    ):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("level", [0, 1])
def test_primal_of_every_derivative_wave_equals_evaluate_batch(level):
    """The differentiable step computes the plain step's values: the fused
    wave's, the VJP's and the JVP's primal equal the evaluate wave bit for
    bit (float32, the model's dtype)."""
    m = SmallModel(device="cpu")
    n_cells = m.N_CELLS[level]
    th = torch.as_tensor(np.stack([np.linspace(40, 140, 5), np.linspace(0.8, 3.5, 5)], 1),
                         dtype=torch.float32)
    ev = m.evaluate_batch(th.numpy(), {"level": level})
    ys, _ = m.value_and_gradient_batch(th.numpy(), lambda y: torch.ones_like(y), {"level": level})
    assert torch.equal(torch.as_tensor(ys), torch.as_tensor(ev))
    y_vjp, _ = tsunami._vjp_batch(th, torch.ones(5, 4), n_cells, level == 0)
    with torch.no_grad():
        y_jvp, _ = tsunami._jvp_wave(th, torch.ones(5, 2), n_cells, level == 0)
    plain = tsunami.solve_batch(th, n_cells, level == 0)
    assert torch.equal(y_vjp, plain) and torch.equal(y_jvp, plain)


def test_numpy_sens_fn_takes_the_two_wave_route():
    m = SmallModel(device="cpu")
    th = np.array([[90.0, 2.5], [60.0, 1.2]])
    data = np.array([10.0, 1.0, 20.0, 0.8])
    fused = m.value_and_gradient_batch(th, lambda y: torch.as_tensor(data, dtype=y.dtype) - y)
    assert m.waves[0] == 0  # no evaluate wave: one fused forward + reverse sweep
    two = m.value_and_gradient_batch(th, lambda y: data - np.asarray(y))
    assert m.waves[0] == 1  # an evaluate wave, then a gradient wave
    np.testing.assert_array_equal(fused[0], two[0])
    np.testing.assert_allclose(fused[1], two[1], rtol=1e-6)


# -- the JAX package's own checks (tests/test_capabilities.py) -----------------


def test_gradient_duality_at_the_published_coarse_level():
    """sens.(J v) == (J^T sens).v through 2,224 steps at 512 cells, and the
    amplitude sensitivity of the max heights is positive, as the JAX
    package checks its own solver."""
    m = tsunami.TsunamiModel(device="cpu")
    caps = m.capabilities()
    assert caps.gradient_batch and caps.apply_jacobian_batch
    thetas = np.array([[90.0, 2.5], [120.0, 1.5]])
    senss = np.array([[0.0, 1.0, 0.0, 0.5], [0.0, 0.5, 0.0, 1.0]])
    vecs = np.array([[1.0, 0.2], [0.5, -0.1]])
    g = m.gradient_batch(thetas, senss, {"level": 0})
    jv = m.apply_jacobian_batch(thetas, vecs, {"level": 0})
    assert np.all(np.isfinite(g)) and np.all(np.isfinite(jv))
    np.testing.assert_allclose((jv * senss).sum(1), (g * vecs).sum(1), rtol=5e-2, atol=1e-4)
    assert np.all(g[:, 1] > 0)


def test_hessian_symmetry_and_central_difference():
    """The sens-contracted Hessian is symmetric (v2.(H v1) == v1.(H v2) per
    lane) on the model's float32 waves, and agrees with a central
    difference of J^T sens along v1, with the JAX package's bounds. The
    central difference runs in float64: in float32 a rounding can move the
    step at which a buoy's max is attained, which makes the JVP jump
    between the difference's two points (measured in lane 0 here: the
    port's float32 difference is 1.14e-3, the JAX package's 5.4e-4, the
    float64 one 6.12e-4 in both packages)."""
    class Small(tsunami.TsunamiModel):
        N_CELLS = {0: 128, 1: 256}

    m = Small(device="cpu")
    assert m.capabilities().apply_hessian_batch
    rng = np.random.default_rng(0)
    thetas = np.array([[90.0, 2.5], [60.0, 1.2]])
    v1, v2 = rng.normal(size=(2, 2)), rng.normal(size=(2, 2))
    senss = rng.normal(size=(2, 4))
    h1 = m.apply_hessian_batch(thetas, senss, v1)
    h2 = m.apply_hessian_batch(thetas, senss, v2)
    assert np.all(np.isfinite(h1)) and np.all(np.isfinite(h2))
    np.testing.assert_allclose(np.einsum("ki,ki->k", h1, v2),
                               np.einsum("ki,ki->k", h2, v1), rtol=1e-4)
    d = 2

    def sens_grad(tb):
        jv = tsunami._jvp_batch(
            _t64(np.repeat(tb, d, axis=0)), _t64(np.tile(np.eye(d), (len(tb), 1))), 128, True
        ).numpy().reshape(len(tb), d, 4)
        return np.einsum("km,kdm->kd", senss, jv)

    eps = 1e-2
    fd = (sens_grad(thetas + eps * v1) - sens_grad(thetas - eps * v1)) / (2 * eps)
    h64 = tsunami._hvp_batch(_t64(thetas), _t64(senss), _t64(v1), 128, True).numpy()
    np.testing.assert_allclose(h64, fd, rtol=0.1, atol=2e-5)
    pp = m.apply_hessian(0, 0, 0, [thetas[0].tolist()], senss[0].tolist(), v1[0].tolist())
    np.testing.assert_allclose(np.asarray(pp), h1[0], rtol=1e-5)


# -- chunking --------------------------------------------------------------------


@pytest.mark.parametrize("op", ["gradient", "apply_jacobian", "apply_hessian",
                                "value_and_gradient"])
def test_derivative_waves_run_in_unpadded_chunks_of_16(monkeypatch, op):
    """A 37-lane wave runs as chunks of 16, 16 and 5 lanes, one after
    another, none padded, and the rows come back in order."""
    seen = []

    def fake(*args):
        thetas = args[0]
        seen.append(tuple(thetas.shape))
        assert args[-2:] == (64, True)
        return (thetas.sum(1, keepdim=True).repeat(1, 4), 2 * thetas)

    monkeypatch.setattr(tsunami, "_vjp_batch", lambda t, s, n, sm: fake(t, s, n, sm))
    monkeypatch.setattr(tsunami, "_jvp_batch", lambda t, v, n, sm: fake(t, v, n, sm)[0])
    monkeypatch.setattr(tsunami, "_hvp_batch", lambda t, s, v, n, sm: fake(t, s, v, n, sm)[1])
    monkeypatch.setattr(tsunami, "_value_and_grad",
                        lambda t, n, sm, sens_fn: fake(t, n, sm))
    m = SmallModel(device="cpu")
    th = np.stack([np.arange(37.0), np.ones(37)], 1)
    senss, vecs = np.ones((37, 4)), np.ones((37, 2))
    if op == "gradient":
        out = m.gradient_batch(th, senss)
    elif op == "apply_jacobian":
        out = m.apply_jacobian_batch(th, vecs)
    elif op == "apply_hessian":
        out = m.apply_hessian_batch(th, senss, vecs)
    else:
        ys, out = m.value_and_gradient_batch(th, lambda y: y)
        np.testing.assert_array_equal(ys[:, 0], th.sum(1))
    assert seen == [(16, 2), (16, 2), (5, 2)]
    if op == "apply_jacobian":
        np.testing.assert_array_equal(out[:, 0], th.sum(1))
    else:
        np.testing.assert_array_equal(out, 2 * th)
    assert m.stats == {0: 37, 1: 0} and m.waves == {0: 0, 1: 0}


# -- the per-point time series ---------------------------------------------------


@pytest.mark.parametrize("level,n_cells,smoothed", [(0, 512, True)])
def test_observables_match_jax_and_a_wave_of_one(level, n_cells, smoothed):
    """`observables` (the per-point series in the JAX package's `_simulate`
    order) against the JAX package's `observables`, and against the model's
    point call, which solves a wave of one in the wave's order: the two
    orderings differ by float32 reassociation, within the bounds the JAX
    package holds its own two orderings to (`_torch_parity.SOLVE_TOL`)."""
    theta = np.array([90.0, 2.5])
    got = tsunami.observables(theta, n_cells, smoothed, device="cpu")
    want = jax_tsunami.observables(theta, n_cells, smoothed)
    etas, dt = tsunami._solve(torch.as_tensor(theta, dtype=torch.float32), n_cells, smoothed)
    assert etas.shape == (tsunami.level_grid(n_cells)[1], 2) and dt > 0
    point = np.asarray(tsunami.TsunamiModel(device="cpu")([list(theta)], {"level": level})[0])
    tol = SOLVE_TOL[level]
    for other in (want, point):
        np.testing.assert_allclose(got[[0, 2]], other[[0, 2]], atol=tol["arrival"])
        np.testing.assert_allclose(got[[1, 3]], other[[1, 3]], rtol=tol["height_rtol"])


def test_tangent_waves_from_threads_at_once_equal_serial():
    """A server answers each request on its own thread, so JVP and HVP waves
    of one model run at once. Their initial tangent comes from
    `torch.func.jvp`, whose forward-AD level is process-wide: two threads
    inside it at once raised (an internal assert, or "a forward AD level
    with an invalid index" on an H100). `apps.tsunami._JVP_LOCK` makes them
    take turns; eight threads, five JVP waves each (the HVP wave's initial
    tangent is the same code), equal the serial wave bit for bit."""
    import threading

    class Tiny(tsunami.TsunamiModel):
        N_CELLS = {0: 16, 1: 16}

    m = Tiny(device="cpu")
    th, vecs = THETAS[:2], VECS[:2]
    want = m.apply_jacobian_batch(th, vecs)
    errors = []

    def run():
        try:
            for _ in range(5):
                np.testing.assert_array_equal(m.apply_jacobian_batch(th, vecs), want)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
