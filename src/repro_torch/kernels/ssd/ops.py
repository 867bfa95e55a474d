"""Public wrappers of the SSD chunk-scan kernel (counterpart of
`repro.kernels.ssd.ops.ssd` and `repro.kernels.ssd.ssd.ssd_kernel`).

`ssd_chunk_scan` takes the kernel layout. A CUDA tensor goes to the
hand-written Hopper kernel (`csrc/ssd.cu`: its four products on the tensor
cores, mma.sync in 3xTF32 with float32 sums, so float32 accuracy) or the
call raises; a CPU tensor goes to the plain version
(`ref.ssd_chunked_ref`). On every device N and P must be multiples of 8,
as the kernel's m16n8k8 tiles need. There is no switch and no
fallback. `ssd` adapts the model's layout to it, as the JAX package's
adapter does. `ssd.launches` counts kernel launches, so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.ssd.ref import CHUNK, ssd_chunked_ref

#: dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

_fn = None


def smem_bytes(N: int, P: int) -> int:
    """Shared memory of one kernel block, in float32 (as `csrc/ssd.cu`): C
    and B [Q][N + 4], x [Q][P + 4], the transposed state [P][N + 4] (the
    paddings keep the fragment loads free of bank conflicts), four [Q]
    vectors and the cumulative sum's four warp sums. 205,840 B at
    mamba2-1.3b's N = 128, P = 64."""
    return 4 * (2 * CHUNK * (N + 4) + CHUNK * (P + 4) + P * (N + 4) + 4 * CHUNK + CHUNK // 32)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ssd").ssd_chunk_scan_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, dt, Bm
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # Cm, A, s0
            ctypes.c_void_p, ctypes.c_void_p,  # y, s_out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, G
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # S, N, P
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name: str, t, shape: tuple, device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"ssd: {name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"ssd: {name} is on {t.device}, x is on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"ssd: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"ssd: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"ssd: {name} must be contiguous")


def ssd_chunk_scan(x, dt, Bm, Cm, A, init_state):
    """Chunked SSD scan in the kernel layout: ``x [B,H,S,P]``, ``dt [B,H,S]``
    (post-softplus), ``Bm, Cm [B,G,S,N]``, ``A [H]`` (negative),
    ``init_state [B,H,N,P]``, all float32 and contiguous, S a multiple of
    128, N and P multiples of 8. Returns ``(y [B,H,S,P], final state [B,H,N,P])``."""
    if not isinstance(x, torch.Tensor) or x.dim() != 4:
        raise ValueError("ssd: x must be a [B, H, S, P] tensor")
    Bsz, H, S, P = x.shape
    if not isinstance(Bm, torch.Tensor) or Bm.dim() != 4:
        raise ValueError("ssd: Bm must be a [B, G, S, N] tensor")
    G, N = Bm.shape[1], Bm.shape[3]
    device = x.device
    for name, t, shape in (
        ("x", x, (Bsz, H, S, P)), ("dt", dt, (Bsz, H, S)), ("Bm", Bm, (Bsz, G, S, N)),
        ("Cm", Cm, (Bsz, G, S, N)), ("A", A, (H,)), ("init_state", init_state, (Bsz, H, N, P)),
    ):
        _check(name, t, shape, device)
    if G == 0 or H % G:
        raise ValueError(f"ssd: {H} heads do not split into {G} groups")
    if S == 0 or S % CHUNK:
        raise ValueError(f"ssd: S={S} is not a positive multiple of {CHUNK}")
    if N == 0 or N % 8 or P == 0 or P % 8:
        raise ValueError(f"ssd: the kernel needs N and P divisible by 8, got N={N}, P={P}")
    if device.type == "cpu":
        return ssd_chunked_ref(x, dt, Bm, Cm, A, init_state)
    if device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {device}")
    if P > 128:
        raise ValueError(f"ssd: the kernel holds a row of y in one warp, P <= 128, got P={P}")
    if smem_bytes(N, P) > MAX_SMEM_BYTES:
        raise ValueError(f"ssd: N={N}, P={P} need {smem_bytes(N, P)} B of shared "
                         f"memory, more than a block's {MAX_SMEM_BYTES}")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry point launches on the current device's context
        with torch.cuda.device(device):
            return ssd_chunk_scan(x, dt, Bm, Cm, A, init_state)
    y = torch.empty_like(x)
    s_out = torch.empty_like(init_state)
    tensors = (x, dt, Bm, Cm, A, init_state, y, s_out)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("ssd: the kernel copies 16-byte pieces; every tensor must be 16-byte aligned")
    err = _kernel()(
        *(t.data_ptr() for t in tensors), Bsz, H, G, S, N, P,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd: kernel launch failed, cudaError {err}")
    launches.count(ssd)
    return y, s_out


def _kernel_layout(t: torch.Tensor, shape: tuple, S_pad: int) -> torch.Tensor:
    """A contiguous float32 copy of `t` (already permuted to the kernel
    layout, S on dim 2) zero-padded along S to S_pad."""
    out_shape = (*shape[:2], S_pad, *shape[3:])
    if S_pad == shape[2]:
        return t.to(torch.float32).contiguous()
    out = torch.zeros(out_shape, dtype=torch.float32, device=t.device)
    out[:, :, : shape[2]] = t
    return out


def ssd(cfg, xh, dt, Bn, Cn, A, init_state=None):
    """Adapter from the model's layout (``xh [B,S,g,r,P]``, ``dt [B,S,g,r]``,
    ``Bn, Cn [B,S,g,N]``, ``A [g,r]``, ``init_state [B,g,r,N,P]`` or None
    for zeros) to the kernel's ``[B,H,S,P]``. S is zero-padded to a multiple
    of 128; dt = 0 there, so the padded tail neither decays nor feeds the
    state. Returns ``(y [B,S,g,r,P], state [B,g,r,N,P])``. `cfg` is kept for
    the JAX package's signature."""
    Bsz, S, g, r, P = xh.shape
    N = Bn.shape[-1]
    H = g * r
    Sp = S + (-S) % CHUNK
    x_k = _kernel_layout(xh.reshape(Bsz, S, H, P).transpose(1, 2), (Bsz, H, S, P), Sp)
    dt_k = _kernel_layout(dt.reshape(Bsz, S, H).transpose(1, 2), (Bsz, H, S), Sp)
    B_k = _kernel_layout(Bn.transpose(1, 2), (Bsz, g, S, N), Sp)
    C_k = _kernel_layout(Cn.transpose(1, 2), (Bsz, g, S, N), Sp)
    A_k = A.reshape(H).to(torch.float32).contiguous()
    if init_state is None:
        s0 = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=xh.device)
    else:
        s0 = init_state.reshape(Bsz, H, N, P).to(torch.float32).contiguous()
    y, s_out = ssd_chunk_scan(x_k, dt_k, B_k, C_k, A_k, s0)
    y = y[:, :, :S].transpose(1, 2).reshape(Bsz, S, g, r, P)
    return y, s_out.reshape(Bsz, g, r, N, P)


#: kernel launches since the last reset (CPU calls never count)
ssd.launches = 0
