"""Carry state across from the JAX package's numpy arrays to the port.

The tsunami model has no learned weights: its "parameters" are the
bathymetry and the ``[C, N]`` shallow-water state. These helpers turn numpy
arrays (as the JAX package's tests and oracles produce them) into the
tensors the port's kernels take.
"""
from __future__ import annotations

import numpy as np
import torch


def swe_state_from_numpy(h, hu, b, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """numpy ``h, hu: [C, N]`` and ``b: [C]`` or ``[C, 1]`` -> contiguous
    float32 tensors ``h, hu: [C, N]`` and ``b: [C, 1]`` on `device`."""
    h = np.asarray(h, np.float32)
    hu = np.asarray(hu, np.float32)
    b = np.asarray(b, np.float32).reshape(-1, 1)
    if h.ndim != 2 or hu.shape != h.shape or b.shape[0] != h.shape[0]:
        raise ValueError(
            f"expected h, hu: [C, N] and b: [C] or [C, 1]; got {h.shape}, "
            f"{hu.shape}, {b.shape}"
        )
    device = torch.device(device)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device).contiguous()
        for a in (h, hu, b)
    )
