"""Public wrapper of the flash-attention kernel (counterpart of
`repro.kernels.flash_attention.ops.flash_attention` and
`repro.kernels.flash_attention.flash_attention.flash_attention_kernel`).

`flash_attention` has the JAX package's signature and layout. A CUDA
tensor goes to the hand-written Hopper kernel (`csrc/flash_attention.cu`)
or the call raises; a CPU tensor goes to the plain version
(`ref.attention_ref`). There is no switch and no fallback.
`flash_attention.launches` counts kernel launches, so a run can show that
its path went through the kernel.

Causal attention with Sq != Sk raises on every device: the JAX kernel masks
from the top left (`flash_attention.py:70-73`) and its oracle from the
bottom right (`ref.py:19`), so the reference does not say which is meant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.races import named_lock
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128)
#: dtype codes of the C entry point
_CODES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = named_lock("flash_attention.launches")
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, o
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, nq, nkv
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Sq, Sk, hd
            ctypes.c_int, ctypes.c_int,  # dtype, causal
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``q [B, nq, Sq, hd]``, ``k, v [B, nkv, Sk, hd]`` -> ``[B, nq, Sq, hd]``
    in q's dtype; q head h reads kv head h // (nq / nkv). On the card all
    three are contiguous, of one dtype (float32 or bfloat16), with hd in
    `HEAD_DIMS`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a [B, n, S, hd] tensor")
    B, nq, Sq, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, nkv, Sk, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not fit [B, nq, Sq, hd], [B, nkv, Sk, hd]")
    if nkv == 0 or nq % nkv:
        raise ValueError(f"flash_attention: {nq} q heads do not split into {nkv} kv heads")
    if causal and Sq != Sk:
        raise ValueError(f"flash_attention: causal attention needs Sq == Sk, got {Sq} and "
                         f"{Sk} (the reference's kernel and oracle align the mask differently)")
    device = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q is on {device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
    if device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    if q.dtype not in _CODES:
        raise TypeError(f"flash_attention: the kernel takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for hd in {HEAD_DIMS}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry point launches on the current device's context
        with torch.cuda.device(device):
            return flash_attention(q, k, v, causal=causal)
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    if any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError("flash_attention: the kernel reads 16-byte vectors; "
                         "q, k, v and o must be 16-byte aligned")
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, nq, nkv, Sq, Sk, hd,
        _CODES[q.dtype], int(bool(causal)), torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed, cudaError {err}")
    with _count_lock:
        flash_attention.launches += 1
    return o


#: kernel launches since the last reset (CPU calls never count)
flash_attention.launches = 0
