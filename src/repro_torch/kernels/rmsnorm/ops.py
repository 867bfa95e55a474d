"""Public wrapper of the fused RMSNorm kernel (counterpart of
`repro.kernels.rmsnorm.ops.rmsnorm_fused` and
`repro.kernels.rmsnorm.rmsnorm.rmsnorm_kernel`).

A CUDA tensor goes to the hand-written Hopper kernel (`csrc/rmsnorm.cu`) or
the call raises; a CPU tensor goes to the plain version (`ref.rmsnorm_ref`).
There is no switch and no fallback. `rmsnorm_fused.launches` counts kernel
launches. As in the JAX package, no model calls it: the models' norms are
plain PyTorch (`models/layers.py`). The kernel has no backward (ROADMAP
queue 2, item 4a): with grad enabled and an input that requires it, the
call raises on every device, so the CPU tests see what the card does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

#: dtype codes of the C entry point
_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rmsnorm").rmsnorm_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, y
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float,  # n_rows, d, eps
            ctypes.c_int, ctypes.c_int,  # x dtype, w dtype
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rmsnorm_fused(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x [..., d]``, ``w [d]`` -> ``x · rsqrt(mean(x²) + eps) · w`` in x's
    dtype. On the card x is float32 or bfloat16, w float32 or x's dtype,
    both contiguous, d a multiple of 16 bytes' worth of x."""
    if not isinstance(x, torch.Tensor) or x.dim() < 1:
        raise ValueError("rmsnorm_fused: x must be a [..., d] tensor")
    d = x.shape[-1]
    if not isinstance(w, torch.Tensor) or tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm_fused: w must have shape ({d},)")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "rmsnorm_fused: the RMSNorm kernel has no backward (no model calls it; ROADMAP "
            "queue 2, item 4a): its output would carry no gradient. Call it under "
            "torch.no_grad(), or use models/layers.py::rmsnorm"
        )
    device = x.device
    if w.device != device:
        raise ValueError(f"rmsnorm_fused: w is on {w.device}, x is on {device}")
    if device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if device.type != "cuda":
        raise ValueError(f"rmsnorm_fused: no kernel for device {device}")
    if x.dtype not in _CODES:
        raise TypeError(f"rmsnorm_fused: x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"rmsnorm_fused: w must be float32 or {x.dtype}, got {w.dtype}")
    vec = 16 // x.element_size()
    if d % vec:
        raise ValueError(f"rmsnorm_fused: the kernel reads {vec} x {x.dtype} at a time; "
                         f"d={d} is not a multiple")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_fused: x and w must be contiguous")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry point launches on the current device's context
        with torch.cuda.device(device):
            return rmsnorm_fused(x, w, eps)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if any(t.data_ptr() % 16 for t in (x, w, y)):
        raise ValueError("rmsnorm_fused: the kernel reads 16-byte vectors; "
                         "x, w and y must be 16-byte aligned")
    err = _kernel()(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // d, d, float(eps),
        _CODES[x.dtype], _CODES[w.dtype], torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rmsnorm_fused: kernel launch failed, cudaError {err}")
    launches.count(rmsnorm_fused)
    return y


#: kernel launches since the last reset (CPU calls never count)
rmsnorm_fused.launches = 0
