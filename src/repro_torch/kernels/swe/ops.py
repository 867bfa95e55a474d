"""Public wrappers of the SWE kernels.

`swe_step` (counterpart of `repro.kernels.swe.ops.swe_step`) is one step:
`csrc/swe_step.cu`. `swe_solve` is a whole wave, all its steps with the
buoy reduction, in one launch of `csrc/swe_solve.cu`: the counterpart of
the JAX package's `lax.scan` over `swe_step_kernel`
(`repro.apps.tsunami._solve_batch`).

A CUDA tensor goes to the hand-written Hopper kernel or the call raises; a
CPU tensor goes to the plain version (`ref.swe_step_ref`,
`ref.swe_solve_ref`). There is no switch and no fallback: on the card the
kernel is the step, or the solve. `swe_step.launches` and
`swe_solve.launches` count kernel launches, so a run can show that its path
went through the kernel; a launch captured into a CUDA graph counts once
per replay of the graph (`kernels.launches`).

On the CPU the plain version runs under `torch.no_grad()`: neither kernel
has an autograd rule, on any device.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.swe.ref import (
    ARRIVAL_THRESH,
    G,
    H_DRY,
    swe_solve_ref,
    swe_step_ref,
    swe_step_ref_into,
)

#: buoy rows one solve reduces: the model's two buoys (`kRows` in
#: csrc/swe_solve.cu)
N_ROWS = 2
#: cells of one lane `swe_solve` takes, at most: 2 per thread of a block,
#: the fine level's 2,048
MAX_CELLS = 2048
#: steps of one solve, at most: `arr` holds the step index in float32
MAX_STEPS = 2**24

_fn = None
_solve_fn = None


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


def _solve_kernel():
    global _solve_fn
    if _solve_fn is None:
        fn = _build.load("swe_solve").swe_solve_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, hu, b
            ctypes.c_void_p,  # h0_rows
            ctypes.c_void_p, ctypes.c_void_p,  # mx, arr
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # C, N, n_steps
            ctypes.c_int, ctypes.c_int,  # buoy rows r0, r1
            ctypes.c_float, ctypes.c_float,  # dt_dx, g
            ctypes.c_float, ctypes.c_float,  # h_dry, arrival threshold
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _solve_fn = fn
    return _solve_fn


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           fn: str = "swe_step"):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, h is on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


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
        with torch.no_grad():
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
    launches.count(swe_step)
    return h_new, hu_new


#: kernel launches since the last reset (CPU calls never count; a captured
#: launch counts at each replay, `kernels.launches`)
swe_step.launches = 0


def swe_solve(
    h: torch.Tensor,  # [C, N]
    hu: torch.Tensor,  # [C, N]
    b: torch.Tensor,  # [C] or [C, 1]
    *,
    dt_dx: float,
    n_steps: int,
    rows,
    h0_rows: torch.Tensor,  # [2]
) -> tuple[torch.Tensor, torch.Tensor]:
    """A whole wave: `n_steps` SWE steps from (h, hu) with the buoy
    reduction of `ref.swe_solve_ref` inside the time loop, for the two buoy
    `rows` (ints in [0, C)) with their depths at rest `h0_rows`. Returns
    (mx, arr), each [2, N] float32; h and hu are left as they are. On the
    card this is ONE kernel launch, whatever `n_steps` is."""
    if b.dim() == 1:
        b = b[:, None]
    if h.dim() != 2 or h.shape[0] < 2 or h.shape[1] < 1:
        raise ValueError(f"swe_solve: h must be [C >= 2, N >= 1], got {tuple(h.shape)}")
    C, N = h.shape
    device = h.device
    rows = tuple(operator.index(r) for r in rows)
    if len(rows) != N_ROWS:
        raise ValueError(f"swe_solve: {len(rows)} buoy rows, expected {N_ROWS}")
    if not all(0 <= r < C for r in rows):
        raise ValueError(f"swe_solve: buoy rows {rows} must lie in [0, {C})")
    n_steps = operator.index(n_steps)
    if not 0 <= n_steps < MAX_STEPS:
        raise ValueError(f"swe_solve: n_steps {n_steps} must lie in [0, 2**24): the "
                         "arrival step is kept as a float32")
    for name, t, shape in (("h", h, (C, N)), ("hu", hu, (C, N)), ("b", b, (C, 1)),
                           ("h0_rows", h0_rows, (len(rows),))):
        _check(name, t, shape, device, "swe_solve")
    kw = dict(dt_dx=dt_dx, n_steps=n_steps, rows=rows, h0_rows=h0_rows)
    if device.type == "cpu":
        with torch.no_grad():
            return swe_solve_ref(h, hu, b, **kw)
    if device.type != "cuda":
        raise ValueError(f"swe_solve: no kernel for device {device}")
    if C > MAX_CELLS:
        raise ValueError(f"swe_solve: {C} cells, the kernel takes at most {MAX_CELLS}")
    if C * N >= 2**31:
        raise ValueError(f"swe_solve: [{C}, {N}] exceeds the kernel's int index range")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry point launches on the current device's context
        with torch.cuda.device(device):
            return swe_solve(h, hu, b, **kw)
    mx, arr = h.new_empty((len(rows), N)), h.new_empty((len(rows), N))
    err = _solve_kernel()(
        h.data_ptr(), hu.data_ptr(), b.data_ptr(), h0_rows.data_ptr(),
        mx.data_ptr(), arr.data_ptr(), C, N, n_steps, *rows,
        float(dt_dx), G, H_DRY, ARRIVAL_THRESH,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"swe_solve: kernel launch failed, cudaError {err}")
    launches.count(swe_solve)
    return mx, arr


#: kernel launches since the last reset (CPU calls never count; a captured
#: launch counts at each replay, `kernels.launches`)
swe_solve.launches = 0
