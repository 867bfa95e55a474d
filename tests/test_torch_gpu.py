"""PyTorch port on the card: the CUDA SWE step kernel against its plain
PyTorch version, one step and whole solves, bit for bit (the bound and its
reason: `repro_torch.kernels.swe.testing`). Every test here is marked `gpu`
and skips without a CUDA device. The file imports neither JAX nor the JAX
package, so it also runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import cuda_or_skip
from repro_torch.apps.tsunami import level_grid, solve_batch
from repro_torch.kernels.swe import swe_step, swe_step_ref, swe_step_ref_into
from repro_torch.kernels.swe.testing import CASES, assert_step_equal, case_inputs, sources


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_cuda(case):
    dev = cuda_or_skip()
    h, hu, b, dt_dx = case_inputs(case, dev)
    before = swe_step.launches
    got = swe_step(h, hu, b, dt_dx=dt_dx)
    torch.cuda.synchronize()
    assert swe_step.launches == before + 1
    assert_step_equal(got, swe_step_ref(h, hu, b, dt_dx), (h, hu), case)


def _solve_kernel_path_matches_plain_path(n_cells: int, smoothed: bool):
    dev = cuda_or_skip()
    thetas = torch.as_tensor(sources(16, 11), device=dev)
    before = swe_step.launches
    got = solve_batch(thetas, n_cells, smoothed).cpu().numpy()
    assert swe_step.launches - before == level_grid(n_cells)[1]
    want = solve_batch(thetas, n_cells, smoothed, step=swe_step_ref_into).cpu().numpy()
    # every step is bit for bit, and the buoy reduction is the same code
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_coarse_solve_kernel_path_matches_plain_path():
    _solve_kernel_path_matches_plain_path(512, True)


@pytest.mark.gpu
def test_fine_solve_kernel_path_matches_plain_path():
    _solve_kernel_path_matches_plain_path(2048, False)
