"""Carry state across from the JAX package's numpy arrays to the port.

The tsunami model has no learned weights: its "parameters" are the
bathymetry and the ``[C, N]`` shallow-water state. The LM zoo's weights are
a parameter tree, stacked ``[L, ...]`` per group. These helpers turn numpy
arrays (as the JAX package's tests and oracles produce them) into the
tensors the port takes, so that both packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import params as pm
from repro_torch.models import transformer
from repro_torch.types import ModelConfig, dtype_of


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


def _leaf_tensor(a, decl: pm.ParamDecl, default_dtype: torch.dtype, device, path: str):
    a = np.asarray(a)
    if tuple(a.shape) != tuple(decl.shape):
        raise ValueError(f"parameter {path}: shape {a.shape}, the port declares {decl.shape}")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits across
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    dtype = dtype_of(decl.dtype) if decl.dtype else default_dtype
    return t.to(device=device, dtype=dtype)


def lm_params_from_numpy(cfg: ModelConfig, tree, device):
    """The JAX package's parameter tree of `cfg` (nested dicts and lists of
    numpy arrays, e.g. `jax.tree.map(np.asarray, init_params(cfg, key))`)
    -> the port's parameter tree on `device`, leaf for leaf, each in the
    dtype the port declares for it. Raises if a leaf is missing or its
    shape differs from the declaration."""
    device = torch.device(device)
    default = dtype_of(cfg.param_dtype)

    def leaf(decl: pm.ParamDecl, path: str):
        node = tree
        for key in path.strip("/").split("/"):
            node = node[int(key)] if isinstance(node, (list, tuple)) else node[key]
        return _leaf_tensor(node, decl, default, device, path)

    return pm.walk(transformer.decl_model(cfg), leaf)
