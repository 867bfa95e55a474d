"""PyTorch port: the tsunami forward path against the JAX package on the
CPU — bathymetry, the lockstep solver at both published levels, and the
model's device and capability contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.tsunami as jax_tsunami
import repro_torch.apps.tsunami as tsunami
from repro_torch.convert import swe_state_from_numpy
from repro_torch.core.interface import Capabilities

# the solves here run [cells, 4] states, far below the size where torch's
# intra-op threads pay; one thread keeps the xdist workers from
# oversubscribing the cores they share with the JAX tests
torch.set_num_threads(1)

LEVELS = [(0, 512, True), (1, 2048, False)]
RNG = np.random.default_rng(42)
THETAS = np.stack(
    [RNG.uniform(40.0, 140.0, 4), RNG.uniform(0.8, 3.5, 4)], axis=1
).astype(np.float32)


@pytest.mark.parametrize("level,n_cells,smoothed", LEVELS)
def test_bathymetry_identical_to_reference(level, n_cells, smoothed):
    want = jax_tsunami._bathymetry_cached(n_cells, smoothed)
    got = tsunami._bathymetry_cached(n_cells, smoothed)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)  # bit for bit
    # and through the state converter, as the kernel takes it
    h = np.zeros((n_cells, 4), np.float32)
    _, _, b = swe_state_from_numpy(h, h, want, "cpu")
    assert b.shape == (n_cells, 1) and b.is_contiguous()
    assert np.array_equal(b.numpy()[:, 0], want)


# Full-solve bounds: the ones the JAX package holds its own two orderings of
# this solver to (tests/test_batch_native.py). The plain step agrees with
# the JAX oracle to within about one ulp, but XLA also contracts
# multiply-adds inside the jitted scan, and float32 drift over 2,224 / 8,899 nonlinear steps turns
# those ulps into the deviations this test prints (`-s`) on these thetas:
# coarse 0.019 min (one step) / 1.0e-3, fine 0.024 min / 8.2e-3 (arrival
# / max height, PERF.md). The coarse height bound is tightened to 5e-3 (5x
# the measurement); the fine level keeps the reference's bounds, since its
# arrival deviation is already half of 0.05 min.
SOLVE_TOL = {0: dict(arrival=0.05, height_rtol=5e-3),
             1: dict(arrival=0.05, height_rtol=5e-2)}


@pytest.mark.parametrize("level,n_cells,smoothed", LEVELS)
def test_solve_batch_matches_jax_solver(level, n_cells, smoothed):
    want = np.asarray(jax_tsunami._solve_batch(jnp.asarray(THETAS), n_cells, smoothed))
    got = tsunami.solve_batch(torch.as_tensor(THETAS), n_cells, smoothed).numpy()
    assert got.shape == (4, 4) and got.dtype == np.float32
    assert np.isfinite(got).all()
    dev = np.abs(got.astype(float) - want)
    print(f"level {level}: max arrival deviation {dev[:, [0, 2]].max():.6g} min, "
          f"max height deviation {(dev / np.abs(want).clip(1e-30))[:, [1, 3]].max():.6g} relative")
    tol = SOLVE_TOL[level]
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], atol=tol["arrival"])
    np.testing.assert_allclose(got[:, [1, 3]], want[:, [1, 3]], rtol=tol["height_rtol"])


def test_evaluate_batch_pads_trims_and_point_call(monkeypatch):
    m = tsunami.TsunamiModel(device="cpu")
    seen = []
    solve = tsunami.solve_batch

    def spy(thetas, n_cells, smoothed, **kw):
        seen.append((tuple(thetas.shape), n_cells))
        return solve(thetas, n_cells, smoothed, **kw)

    monkeypatch.setattr(tsunami, "solve_batch", spy)
    out = m.evaluate_batch(THETAS[:3], {"level": 0})
    one = m([list(THETAS[0])], {"level": 0})
    # a wave of 3 runs as one padded wave of 4; a point as a wave of 4 too
    assert seen == [((4, 2), 512), ((4, 2), 512)]
    assert out.shape == (3, 4) and out.dtype == np.float64
    np.testing.assert_array_equal(np.asarray(one[0]), out[0])
    assert m.stats == {0: 4, 1: 0}
    assert m.waves == {0: 2, 1: 0}


def test_model_advertises_only_evaluate():
    m = tsunami.TsunamiModel(device="cpu")
    assert m.device == torch.device("cpu")
    assert m.capabilities() == Capabilities(evaluate=True, evaluate_batch=True)
    assert not m.capabilities().op_supported("gradient")


def test_default_device_is_the_gpu_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_solve(*a, **k):
        raise AssertionError("solved although no GPU is present")

    monkeypatch.setattr(tsunami, "solve_batch", no_solve)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsunami.TsunamiModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsunami.TsunamiModel(device="cuda")
