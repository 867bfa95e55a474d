"""PyTorch port: the composite-laminate app (paper §4.2, `apps/composite.py`)
against the JAX package's, at the reference's full size (48 x 96 cells,
4,416 interior dof, 16 subdomains, 171 ROM dof). The hard and smooth
defect fields, the face coefficients and the stencil; the full CG solve
(point and wave), its per-lane semantics (the chunked loop == the loop
that checks every iteration, bit for bit; a lane that stops early is
frozen); the implicit-adjoint gradient under `jax.enable_x64` and in
float32; the port's own FD-vs-AD check in float64; the ROM (local
operators, bases by their projectors, `online`, the batched wave); and
tests/test_apps.py's and test_batch_native.py's composite tests
re-pointed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.composite as jc
from repro_torch.apps import composite as tc

torch.set_num_threads(1)

F32 = torch.float32
THETAS = np.array([[77.5, 210.0, 10.0], [78.0, 180.0, 30.0], [70.0, 205.0, 8.0],
                   [85.0, 240.0, 15.0], [60.0, 120.0, 40.0]])
#: float32 bound of the full solve against the JAX package: the same CG in
#: another summation order (measured: <= 7.2e-7 relative in the energy and
#: <= 5.1e-7 in u at THETAS)
SOLVE_RTOL, U_ATOL = 1e-5, 1e-5
#: the ROM's bounds: `online` (float32 Galerkin matrix, float64 solve) and
#: the batched wave, whose solve is float32 (the JAX package holds its two
#: paths to each other within 1e-4: tests/test_batch_native.py)
ONLINE_RTOL, WAVE_RTOL = 1e-5, 1e-4


def _fields(thetas, dtype=F32):
    ks = [tc.coefficient_field(t) for t in thetas]
    return (torch.as_tensor(np.stack([k[0] for k in ks]), dtype=dtype),
            torch.as_tensor(np.stack([k[1] for k in ks]), dtype=dtype))


def _rhs(fx, fy):
    return tc._rhs_from_lifting(fx, fy, tc._lifting(fx.dtype, fx.device))


class _CompositeModel64(tc.CompositeModel):
    DTYPE = torch.float64


@pytest.fixture(scope="module")
def jax_model():
    return jc.CompositeModel()


@pytest.fixture(scope="module")
def model():
    return tc.CompositeModel(device="cpu")


# -- fields and stencil ---------------------------------------------------------


@pytest.mark.parametrize("theta", [[77.5, 210.0, 10.0], [0.0, 0.0, 0.0],
                                   [150.0, 5.0, 60.0], [77.5, 210.0, -3.0]])
def test_coefficient_field_is_bit_for_bit(theta):
    for a, b in zip(tc.coefficient_field(np.array(theta)), jc.coefficient_field(np.array(theta))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("softness", [1.0, 0.25])
def test_smooth_field_and_stencil_match_jax(softness):
    """Within 1e-6 relative; measured: 0 (the same float32 operations)."""
    kx, ky = tc.coefficient_field_smooth(torch.as_tensor(THETAS, dtype=F32), softness)
    u = np.random.default_rng(0).standard_normal(tc._INTERIOR).astype(np.float32)
    for i, t in enumerate(THETAS):
        jkx, jky = jc.coefficient_field_smooth(jnp.asarray(t, jnp.float32), softness)
        np.testing.assert_allclose(kx[i].numpy(), np.asarray(jkx), rtol=1e-6)
        np.testing.assert_allclose(ky[i].numpy(), np.asarray(jky), rtol=1e-6)
        fx, fy = tc._face_coeffs(kx[i], ky[i])
        jfx, jfy = jc._face_coeffs(jkx, jky)
        np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), rtol=1e-6)
        np.testing.assert_allclose(fy.numpy(), np.asarray(jfy), rtol=1e-6)
        got = tc._apply_K(fx, fy, torch.as_tensor(u)).numpy()
        want = np.asarray(jc._apply_K(jfx, jfy, jnp.asarray(u)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(_rhs(fx, fy).numpy(),
                                   np.asarray(jc._rhs_from_lifting(jfx, jfy, jc._lifting())),
                                   rtol=1e-6, atol=1e-6)


def test_lifting_is_jax_linspace_bit_for_bit():
    np.testing.assert_array_equal(tc._lifting(F32, "cpu").numpy(), np.asarray(jc._lifting()))


# -- the full solve -------------------------------------------------------------


@pytest.mark.parametrize("theta", [[77.5, 210.0, 10.0], [78.0, 180.0, 30.0]])
def test_solve_full_matches_jax(theta):
    kx, ky = tc.coefficient_field(np.array(theta))
    e, u = tc.solve_full(torch.as_tensor(kx, dtype=F32), torch.as_tensor(ky, dtype=F32))
    je, ju = jc.solve_full(jnp.asarray(kx), jnp.asarray(ky))
    assert e.shape == () and u.shape == (tc.NX, tc.NY)
    np.testing.assert_allclose(float(e), float(je), rtol=SOLVE_RTOL)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(ju), atol=U_ATOL)


def test_full_wave_of_five_matches_jax():
    kx, ky = _fields(THETAS)
    got = tc._full_energy_batch(kx, ky).numpy()
    want = np.asarray(jc._full_energy_batch(jnp.asarray(kx.numpy()), jnp.asarray(ky.numpy())))
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=SOLVE_RTOL)


def test_chunked_cg_equals_per_iteration_cg_bit_for_bit():
    fx, fy = tc._face_coeffs(*_fields(THETAS[:3]))
    b = _rhs(fx, fy)
    x, k = tc.cg(fx, fy, b)
    x1, k1 = tc.cg(fx, fy, b, check_every=1)
    assert tc.CG_CHECK_EVERY > 1 and (k % tc.CG_CHECK_EVERY != 0).any()
    assert torch.equal(k, k1) and torch.equal(x, x1)


def test_a_lane_that_stops_early_is_frozen():
    """Lane 0 (no defect) stops many iterations before lane 1 (a 60 mm
    delamination); its x and k equal its solo solve's bit for bit."""
    fx, fy = tc._face_coeffs(*_fields(np.array([[0.0, 0.0, 0.0], [77.5, 210.0, 60.0]])))
    b = _rhs(fx, fy)
    x, k = tc.cg(fx, fy, b)
    assert k[0] + tc.CG_CHECK_EVERY < k[1]
    for i in range(2):
        xi, ki = tc.cg(fx[i:i + 1], fy[i:i + 1], b[i:i + 1])
        assert torch.equal(ki[0], k[i]) and torch.equal(xi[0], x[i])


def test_cg_stops_at_maxiter(monkeypatch):
    monkeypatch.setattr(tc, "CG_MAXITER", 37)
    fx, fy = tc._face_coeffs(*_fields(THETAS[:2]))
    _, k = tc.cg(fx, fy, _rhs(fx, fy))
    assert k.tolist() == [37, 37]


# -- the gradient: the implicit adjoint -----------------------------------------


def test_full_gradient_matches_jax_under_x64():
    """The adjoint CG and the matvec's linearisation against JAX's
    `custom_linear_solve` VJP, both in float64: within 1e-6 relative
    (measured: 2.7e-16 in the energy, 1.4e-16 of the largest entry of the
    gradient)."""
    thetas, senss = THETAS[:3], np.array([[1.0], [-0.5], [2.0]])
    y, g = tc._smooth_vjp_batch(torch.as_tensor(thetas), torch.as_tensor(senss), 1.0)
    with jax.enable_x64(True):
        jy, jg = jc._smooth_vjp_batch(jnp.asarray(thetas), jnp.asarray(senss), 1.0)
        jy, jg = np.asarray(jy), np.asarray(jg)
    assert y.dtype == g.dtype == torch.float64 and jg.dtype == np.float64
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-6, atol=1e-6 * np.abs(jg).max())


def test_full_gradient_in_float32_within_the_reference_bounds(model):
    """The model's float32 gradient wave against JAX's float64 one, by the
    bounds tests/test_capabilities.py holds FD to AD with: the diameter
    component within 5e-2, every component within 5e-3 of the largest."""
    thetas, senss = THETAS[:2], np.ones((2, 1))
    got = model.gradient_batch(thetas, senss, {"mode": "full", "defect_softness": 1.0})
    with jax.enable_x64(True):
        want = np.asarray(jc._smooth_vjp_batch(jnp.asarray(thetas), jnp.asarray(senss), 1.0)[1])
    assert got.shape == (2, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=5e-2)
    np.testing.assert_allclose(got, want, atol=5e-3 * np.abs(want).max())


def test_fd_matches_autodiff_on_composite_in_float64():
    """tests/test_capabilities.py::test_fd_matches_autodiff_on_composite,
    re-pointed at a float64 port model: the relative-step FD fallback
    against the implicit adjoint on the smooth full solve."""
    m = _CompositeModel64(device="cpu")
    cfg = {"mode": "full", "defect_softness": 1.0}
    thetas = np.array([[77.5, 210.0, 10.0], [70.0, 205.0, 8.0]])
    senss = np.ones((2, 1))
    ad = m.gradient_batch(thetas, senss, cfg)
    m.fd_step = 1e-6  # a float64 forward supports a tighter relative step
    fd = m._fd_gradient_batch(thetas, senss, cfg)
    assert np.all(np.isfinite(ad))
    # diameter sensitivity is the dominant, well-conditioned component
    np.testing.assert_allclose(fd[:, 2], ad[:, 2], rtol=5e-2)
    np.testing.assert_allclose(fd, ad, atol=5e-3 * np.abs(ad).max())


def test_hard_config_gradient_uses_the_default_softness(model):
    thetas, senss = THETAS[:1], np.ones((1, 1))
    np.testing.assert_array_equal(
        model.gradient_batch(thetas, senss, {"mode": "full"}),
        model.gradient_batch(thetas, senss, {"mode": "full",
                                             "defect_softness": tc.DEFECT_SOFTNESS}))


# -- the ROM --------------------------------------------------------------------


@pytest.mark.parametrize("si", [0, 5, 15])
def test_local_operator_matches_jax(si, jax_model, model):
    slc = tc._subdomain_slices()[si]
    got = tc._local_operator_dense(model.rom.fx0, model.rom.fy0, slc)
    want = jc._local_operator_dense(jax_model.rom.fx0, jax_model.rom.fy0, slc)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_offline_bases_match_jax_by_their_span(jax_model, model):
    assert [s for s in model.rom.slices] == [s for s in jax_model.rom.slices]
    for got, want in zip(model.rom.local_bases, jax_model.rom.local_bases):
        assert got.shape == want.shape == (got.shape[0], tc.Q_LOCAL)
        np.testing.assert_allclose(got @ got.T, want @ want.T, atol=1e-5)
    np.testing.assert_allclose(model.rom.coarse, jax_model.rom.coarse, atol=1e-5)


@pytest.mark.parametrize("theta", [[77.5, 210.0, 10.0], [78.0, 180.0, 30.0]])
def test_online_matches_jax(theta, jax_model, model):
    e, info = model.rom.online(np.array(theta))
    je, jinfo = jax_model.rom.online(np.array(theta))
    np.testing.assert_allclose(e, je, rtol=ONLINE_RTOL)
    assert info == jinfo and info["n_red"] == 171


def test_rom_wave_matches_jax(jax_model, model):
    got = model.evaluate_batch(THETAS[:3])
    want = jax_model.evaluate_batch(THETAS[:3])
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=WAVE_RTOL)


# -- tests/test_apps.py and test_batch_native.py, re-pointed --------------------


def test_composite_rom_matches_full(model):
    for th in ([77.5, 210.0, 10.0], [78.0, 180.0, 30.0]):
        e_full = model([th], {"mode": "full"})[0][0]
        e_rom = model([th], {"mode": "rom"})[0][0]
        assert abs(e_rom - e_full) / e_full < 5e-3, th


def test_composite_defect_reduces_energy(model):
    pristine = model([[0.0, 0.0, 0.001]], {"mode": "full"})[0][0]
    damaged = model([[77.5, 210.0, 60.0]], {"mode": "full"})[0][0]
    assert damaged < pristine


def test_composite_online_locality(model):
    _, info = model.rom.online(np.array([77.5, 210.0, 10.0]))
    assert 1 <= len(info["updated_subdomains"]) <= 8  # paper: "one to ~eight"


@pytest.mark.parametrize("config,rtol", [(None, 1e-4), ({"mode": "full"}, 1e-5),
                                         ({"mode": "full", "defect_softness": 0.5}, 1e-5)])
def test_call_matches_evaluate_batch(model, config, rtol):
    thetas = THETAS[:2]
    seq = np.array([model([list(t)], config)[0][0] for t in thetas])
    np.testing.assert_allclose(model.evaluate_batch(thetas, config).ravel(), seq, rtol=rtol)


@pytest.mark.parametrize("mode,program", [("full", "_full_energy_batch"),
                                          ("rom", "_rom_energy_batch")])
def test_a_wave_solves_exactly_its_lanes(model, monkeypatch, mode, program):
    """No power-of-two padding: 5 points are one 5-lane program, 18 points
    a 16-lane and a 2-lane one."""
    widths, inner = [], getattr(tc, program)

    def spy(*args):
        widths.append(len(args[0]))
        return inner(*args)

    monkeypatch.setattr(tc, program, spy)
    x5 = np.tile(THETAS, (4, 1))[:18]
    assert model.evaluate_batch(x5[:5], {"mode": mode}).shape == (5, 1)
    assert widths == [5]
    if mode == "full":
        model.evaluate_batch(x5, {"mode": mode})
        assert widths == [5, 16, 2]


def test_stats_count_points_per_mode():
    m = tc.CompositeModel(device="cpu")
    m.evaluate_batch(THETAS[:2])
    m([list(THETAS[0])], {"mode": "full"})
    assert m.stats == {"rom": 2, "full": 1}
    assert m.capabilities().op_supported("gradient")


def test_rom_gradient_is_finite_differences_over_one_wave(model, monkeypatch):
    calls = []
    inner = model.evaluate_batch

    def spy(thetas, config=None):
        calls.append(len(thetas))
        return inner(thetas, config)

    monkeypatch.setattr(model, "evaluate_batch", spy)
    g = model.gradient_batch(THETAS[:1], np.ones((1, 1)))
    assert g.shape == (1, 3) and np.isfinite(g).all() and len(calls) == 1


def test_default_device_is_the_gpu_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.CompositeModel()
