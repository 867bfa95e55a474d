"""PyTorch port: the SWE step — plain version against the JAX package's
oracle, and the wrapper's dispatch (a CUDA tensor never takes the plain
version). The kernel itself is held against the plain version on the card
in test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import STEP_TOL_H, STEP_TOL_HU
from repro.kernels.swe.ref import swe_step_ref as jax_swe_step_ref
from repro_torch.convert import swe_state_from_numpy
from repro_torch.kernels.swe import ops, swe_step, swe_step_ref
from repro_torch.kernels.swe.testing import (
    CASE_DT_DX as DT_DX,
    MAIN_PATH_SHAPES,
    SWE_KINDS,
    assert_step_equal,
    main_path_state,
    swe_state,
)


@pytest.mark.parametrize("kind", SWE_KINDS)
def test_plain_step_matches_jax_ref(kind):
    h, hu, b = swe_state(kind)
    ref_h, ref_hu = jax_swe_step_ref(jnp.asarray(h), jnp.asarray(hu), jnp.asarray(b), DT_DX)
    out_h, out_hu = swe_step(*swe_state_from_numpy(h, hu, b, "cpu"), dt_dx=DT_DX)
    # the JAX package's single-step bounds (see _torch_parity); measured on
    # the CPU the two agree to the last bit or within about one ulp (same
    # operation order, no FMA), which this prints with -s
    print(f"{kind}: max |h - ref| {np.abs(out_h.numpy() - ref_h).max():.3g}, "
          f"max |hu - ref| {np.abs(out_hu.numpy() - ref_hu).max():.3g}")
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h), **STEP_TOL_H)
    np.testing.assert_allclose(out_hu.numpy(), np.asarray(ref_hu), **STEP_TOL_HU)


def test_well_balanced_and_dry_invariants():
    # lake at rest stays at rest (well-balanced hydrostatic reconstruction)
    h, hu, b = swe_state_from_numpy(*swe_state("lake_at_rest"), "cpu")
    out_h, out_hu = swe_step(h, hu, b, dt_dx=DT_DX)
    np.testing.assert_allclose(out_h.numpy(), h.numpy(), atol=1e-6)
    np.testing.assert_allclose(out_hu.numpy(), 0.0, atol=1e-6)
    # dry cells: depth stays non-negative, momentum zeroed below threshold
    h, hu, b = swe_state_from_numpy(*swe_state("dry_bed"), "cpu")
    out_h, out_hu = swe_step(h, hu, b, dt_dx=DT_DX)
    oh, ohu = out_h.numpy(), out_hu.numpy()
    assert (oh >= 0.0).all()
    assert (ohu[oh <= 0.05] == 0.0).all()


def test_out_buffers_and_input_checks():
    h, hu, b = swe_state_from_numpy(*swe_state("moving"), "cpu")
    pair = (torch.empty_like(h), torch.empty_like(hu))
    got = swe_step(h, hu, b[:, 0], dt_dx=DT_DX, out=pair)  # [C] bathymetry too
    assert got[0] is pair[0] and got[1] is pair[1]
    want = swe_step_ref(h, hu, b, DT_DX)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="alias"):
        swe_step(h, hu, b, dt_dx=DT_DX, out=(h, pair[1]))
    with pytest.raises(TypeError, match="float32"):
        swe_step(h.double(), hu, b, dt_dx=DT_DX)
    with pytest.raises(ValueError, match="contiguous"):
        swe_step(h, hu.t().contiguous().t(), b, dt_dx=DT_DX)
    with pytest.raises(ValueError, match="shape"):
        swe_step(h, hu[:, :4].contiguous(), b, dt_dx=DT_DX)
    with pytest.raises(ValueError, match="no kernel"):
        swe_step(h.to("meta"), hu.to("meta"), b.to("meta"), dt_dx=DT_DX)


@pytest.mark.parametrize("C,N", MAIN_PATH_SHAPES)
def test_kernel_check_sees_a_wrong_update_at_main_path_shapes(C, N):
    # The check that holds the kernel to its plain version on the card must
    # see, in ONE step of the main path's ~4,000 m deep states, a mass
    # update 1% too large (h alone) and a momentum update 0.1% too large
    # (hu alone). The first moves h by at most about one float32 ulp there.
    h, hu, b, dt_dx = main_path_state(C, N, "cpu")
    want = swe_step_ref(h, hu, b, dt_dx)
    report = assert_step_equal(want, want, (h, hu), "identical")
    assert report["h"]["max_ulp"] == report["hu"]["max_ulp"] == 0.0
    wrong_h = swe_step_ref(h, hu, b, dt_dx * 1.01)[0]
    with pytest.raises(AssertionError, match=", h:"):
        assert_step_equal((wrong_h, want[1]), want, (h, hu), "wrong mass update")
    wrong_hu = swe_step_ref(h, hu, b, dt_dx * 1.001)[1]
    with pytest.raises(AssertionError, match=", hu:"):
        assert_step_equal((want[0], wrong_hu), want, (h, hu), "wrong momentum update")


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper's CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Stream:
    cuda_stream = 0


def test_cuda_tensor_never_takes_plain_version(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    launched = []

    def fake_kernel(*args):
        launched.append(args)
        return fake_kernel.err

    fake_kernel.err = 0
    monkeypatch.setattr(ops, "swe_step_ref", plain)
    monkeypatch.setattr(ops, "_kernel", lambda: fake_kernel)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    h, hu, b = (t.as_subclass(_OnCuda) for t in swe_state_from_numpy(*swe_state("moving"), "cpu"))
    before = swe_step.launches
    swe_step(h, hu, b, dt_dx=DT_DX)
    assert len(launched) == 1 and swe_step.launches == before + 1
    C, N = h.shape
    assert launched[0][5:7] == (C, N)
    # a non-zero cudaGetLastError() raises and is not counted
    fake_kernel.err = 9
    with pytest.raises(RuntimeError, match="cudaError 9"):
        swe_step(h, hu, b, dt_dx=DT_DX)
    assert swe_step.launches == before + 1
