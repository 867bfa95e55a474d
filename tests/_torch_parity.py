"""Shared helpers of the PyTorch-port parity tests (`test_torch_*.py`).

Inputs are built with numpy and handed to both packages, so the JAX
reference and the port see the same numbers; the SWE cases themselves live
in `repro_torch.kernels.swe.testing`, which chip_smoke.py uses too. Whether
a GPU is present is decided inside a test (`cuda_or_skip`), never at import
time, so every xdist worker collects the same tests.
"""
from __future__ import annotations

import pytest
import torch

# single-step bounds of the port's plain version against the JAX oracle:
# the JAX package's own kernel-vs-oracle tolerances (tests/test_kernels.py);
# the slack covers FMA contraction and the rounding of sqrt and division on
# another compiler
STEP_TOL_H = dict(rtol=1e-4, atol=1e-6)
STEP_TOL_HU = dict(rtol=1e-4, atol=1e-4)


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())
