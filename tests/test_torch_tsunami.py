"""PyTorch port: the tsunami forward path against the JAX package on the
CPU — bathymetry, the lockstep solver at both published levels, and the
model's device and capability contract (its derivative surface:
`test_torch_tsunami_grad.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.tsunami as jax_tsunami
import repro_torch.apps.tsunami as tsunami
from _torch_parity import SOLVE_THETAS, SOLVE_TOL
from repro_torch.convert import swe_state_from_numpy
from repro_torch.core.interface import Capabilities

# the solves here run [cells, 4] states, far below the size where torch's
# intra-op threads pay; one thread keeps the xdist workers from
# oversubscribing the cores they share with the JAX tests
torch.set_num_threads(1)

LEVELS = [(0, 512, True), (1, 2048, False)]
THETAS = SOLVE_THETAS


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


# Full-solve bounds and their reason: `_torch_parity.SOLVE_TOL`.


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
    # a wave of 3 runs as one wave of 3 lanes, unpadded; a point as a wave
    # of one
    assert seen == [((3, 2), 512), ((1, 2), 512)]
    assert out.shape == (3, 4) and out.dtype == np.float64
    np.testing.assert_array_equal(np.asarray(one[0]), out[0])
    assert m.stats == {0: 4, 1: 0}
    assert m.waves == {0: 2, 1: 0}


def test_evaluate_batch_solves_exactly_n_lanes(monkeypatch):
    """A 5-lane wave is one `solve_batch` call of 5 lanes (the JAX package,
    and this model until the repair, pad it to 8), and its values equal the
    padded wave's bit for bit: the lanes are independent."""
    from repro_torch.core.interface import next_pow2, pad_to_bucket

    m = tsunami.TsunamiModel(device="cpu")
    seen = []
    solve = tsunami.solve_batch

    def spy(thetas, n_cells, smoothed, **kw):
        seen.append(tuple(thetas.shape))
        return solve(thetas, n_cells, smoothed, **kw)

    monkeypatch.setattr(tsunami, "solve_batch", spy)
    thetas = np.concatenate([THETAS, THETAS[:1] + np.float32(3.0)])
    out = m.evaluate_batch(thetas, {"level": 0})
    assert seen == [(5, 2)]
    padded, _ = pad_to_bucket(thetas, next_pow2(len(thetas)))
    want = solve(torch.as_tensor(padded), 512, True).numpy().astype(float)[:5]
    assert out.shape == (5, 4) and out.dtype == np.float64
    np.testing.assert_array_equal(out, want)


def test_chip_smoke_holds_every_wave_width_as_launched():
    """chip_smoke.py's `WaveWidths` records each [cells, lanes] the model
    hands the solve kernel, only while installed, keeping the first wave of
    each width; `phase_wave_widths_vs_plain` holds each kept wave whose
    width `SOLVE_SHAPES` lacks against the plain loop: it passes on the
    waves as launched and sees one output moved by one ulp."""
    import sys
    from pathlib import Path

    from repro_torch.kernels.swe import swe_solve

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    m, cpu = tsunami.TsunamiModel(device="cpu"), torch.device("cpu")
    widths = chip_smoke.WaveWidths(torch)
    with widths.installed():
        widths.run("campaign", m.evaluate_batch, THETAS[:3], {"level": 0})
        widths.run("campaign", m.evaluate_batch, THETAS[1:4], {"level": 0})
        widths.run("point", m, [list(THETAS[0])], {"level": 0})
    m.evaluate_batch(THETAS[:2], {"level": 0})  # not installed: not recorded
    assert tsunami.swe_solve is swe_solve
    assert widths.by_phase == {"campaign": {(512, 3)}, "point": {(512, 1)}}
    # the first wave of the width is kept: its inputs are THETAS[:3]'s
    inputs, (mx, _) = widths.first[(512, 3)]
    h, _, _ = tsunami.initial_state(torch.as_tensor(THETAS[:3]), 512, True)
    assert torch.equal(inputs["h"], h)
    # (512, 1) is one of SOLVE_SHAPES, which kernel_vs_plain holds already
    assert chip_smoke.phase_wave_widths_vs_plain(torch, cpu, widths) == {
        "max_abs_err": 0.0, "held": [[512, 3]]}
    mx[0, 1] = torch.nextafter(mx[0, 1], torch.tensor(float("inf")))
    with pytest.raises(AssertionError, match="512x3"):
        chip_smoke.phase_wave_widths_vs_plain(torch, cpu, widths)


def test_model_advertises_all_eight():
    m = tsunami.TsunamiModel(device="cpu")
    assert m.device == torch.device("cpu")
    assert m.capabilities() == Capabilities(
        evaluate=True, evaluate_batch=True, gradient=True, gradient_batch=True,
        apply_jacobian=True, apply_jacobian_batch=True,
        apply_hessian=True, apply_hessian_batch=True,
    )
    for op in Capabilities.OPS:
        assert m.capabilities().batched(op)


def test_default_device_is_the_gpu_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_solve(*a, **k):
        raise AssertionError("solved although no GPU is present")

    monkeypatch.setattr(tsunami, "solve_batch", no_solve)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsunami.TsunamiModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsunami.TsunamiModel(device="cuda")
