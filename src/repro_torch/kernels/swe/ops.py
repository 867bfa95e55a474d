"""Public wrapper for the SWE step kernel (counterpart of
`repro.kernels.swe.ops.swe_step`).

A CUDA tensor goes to the hand-written Hopper kernel (`csrc/swe_step.cu`)
or the call raises; a CPU tensor goes to the plain version
(`ref.swe_step_ref`). There is no switch and no fallback: on the card the
kernel is the step. `swe_step.launches` counts kernel launches, so a run can
show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.races import named_lock
from repro_torch.kernels import _build
from repro_torch.kernels.swe.ref import G, H_DRY, swe_step_ref, swe_step_ref_into

_count_lock = named_lock("swe_step.launches")
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("swe_step").swe_step_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, hu, b
            ctypes.c_void_p, ctypes.c_void_p,  # h_out, hu_out
            ctypes.c_int, ctypes.c_int,  # C, N
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # dt_dx, g, h_dry
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"swe_step: {name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"swe_step: {name} is on {t.device}, h is on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"swe_step: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"swe_step: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"swe_step: {name} must be contiguous")


def swe_step(
    h: torch.Tensor,  # [C, N]
    hu: torch.Tensor,  # [C, N]
    b: torch.Tensor,  # [C] or [C, 1]
    *,
    dt_dx: float,
    g: float = G,
    h_dry: float = H_DRY,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused Rusanov flux + limiter + update step on a [cells, batch]
    block. `out=(h_new, hu_new)` writes into caller-owned buffers (the
    solver's ping-pong pair); they must not alias the inputs, since every
    cell reads its neighbours' old state."""
    if b.dim() == 1:
        b = b[:, None]
    if h.dim() != 2 or h.shape[0] < 2:
        raise ValueError(f"swe_step: h must be [C >= 2, N], got {tuple(h.shape)}")
    C, N = h.shape
    device = h.device
    for name, t, shape in (("h", h, (C, N)), ("hu", hu, (C, N)), ("b", b, (C, 1))):
        _check(name, t, shape, device)
    if out is not None:
        for name, t in zip(("out[0]", "out[1]"), out):
            _check(name, t, (C, N), device)
        if {out[0].data_ptr(), out[1].data_ptr()} & {h.data_ptr(), hu.data_ptr()}:
            raise ValueError("swe_step: out= buffers must not alias h or hu")
    if device.type == "cpu":
        if out is None:
            return swe_step_ref(h, hu, b, dt_dx, g=g, h_dry=h_dry)
        return swe_step_ref_into(h, hu, b, dt_dx=dt_dx, g=g, h_dry=h_dry, out=out)
    if device.type != "cuda":
        raise ValueError(f"swe_step: no kernel for device {device}")
    if C * N >= 2**31:
        raise ValueError(f"swe_step: [{C}, {N}] exceeds the kernel's int index range")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry point launches on the current device's context
        with torch.cuda.device(device):
            return swe_step(h, hu, b, dt_dx=dt_dx, g=g, h_dry=h_dry, out=out)
    h_new, hu_new = out if out is not None else (torch.empty_like(h), torch.empty_like(hu))
    err = _kernel()(
        h.data_ptr(), hu.data_ptr(), b.data_ptr(),
        h_new.data_ptr(), hu_new.data_ptr(),
        C, N, float(dt_dx), float(g), float(h_dry),
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"swe_step: kernel launch failed, cudaError {err}")
    with _count_lock:
        swe_step.launches += 1
    return h_new, hu_new


#: kernel launches since the last reset (CPU calls never count)
swe_step.launches = 0
