"""Public wrapper of the flash-attention kernels (counterpart of
`repro.kernels.flash_attention.ops.flash_attention` and
`repro.kernels.flash_attention.flash_attention.flash_attention_kernel`).

`flash_attention` has the JAX package's signature and layout. A CUDA
tensor goes to a hand-written Hopper kernel or the call raises: bfloat16 to
the tensor-core kernel (`csrc/flash_attention_wgmma.cu`: wgmma and TMA),
float32 to the CUDA-core kernel (`csrc/flash_attention.cu`: the float32
bound is below TF32's error). A CPU tensor goes to the plain version
(`ref.attention_ref`). There is no switch and no fallback. Both kernels
read q, k and v and write o through strides, so the model's
``[B, S, n, hd]`` tensors are passed as transposed views without a copy
(`check_layout` says which views a kernel takes), and o comes back in q's
memory order. `flash_attention.launches` counts kernel launches and
`flash_attention.launches_by_kernel` splits them by kernel, so a run can
show which kernel its path went through.

Causal attention with Sq != Sk raises on every device: the JAX kernel masks
from the top left (`flash_attention.py:70-73`) and its oracle from the
bottom right (`ref.py:19`), so the reference does not say which is meant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.flash_attention.ref import attention_ref

#: head dims the kernels are built for
HEAD_DIMS = (32, 64, 128)
#: the kernel (library stem) each dtype goes to on the card
KERNEL_OF = {torch.float32: "flash_attention", torch.bfloat16: "flash_attention_wgmma"}
#: dtype codes of the CUDA-core kernel's C entry point (it takes both)
_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: strides and bases the kernels read: 16-byte vectors and TMA boxes
ALIGN_BYTES = 16

_fns: dict = {}


def _kernel(stem: str):
    fn = _fns.get(stem)
    if fn is None:
        lib = _build.load(stem)
        fn = getattr(lib, f"{stem}_fwd")
        dtype_arg = [ctypes.c_int] if stem == "flash_attention" else []
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, o
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, nq, nkv
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Sq, Sk, hd
            *dtype_arg,
            ctypes.POINTER(ctypes.c_longlong),  # strides of (B, n, S) of q, k, v, o
            ctypes.c_int,  # causal
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fns[stem] = fn
    return fn


def check_layout(*tensors: torch.Tensor) -> None:
    """Raises ValueError unless every ``[B, n, S, hd]`` tensor is one the
    kernels read through strides: stride 1 along hd, every other stride (of
    a dimension longer than 1) and the base address a multiple of 16 bytes.
    A ``[B, S, n, hd]`` tensor's ``.transpose(1, 2)`` view passes."""
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: the last dimension must have stride 1, got "
                             f"strides {tuple(t.stride())}")
        size = t.element_size()
        for dim in range(3):
            if t.shape[dim] > 1 and (t.stride(dim) * size) % ALIGN_BYTES:
                raise ValueError(f"flash_attention: strides {tuple(t.stride())} of a "
                                 f"{t.dtype} tensor are not all multiples of {ALIGN_BYTES} "
                                 "bytes")
        if t.data_ptr() % ALIGN_BYTES:
            raise ValueError(f"flash_attention: the kernels read {ALIGN_BYTES}-byte vectors; "
                             f"a base address {t.data_ptr():#x} is not {ALIGN_BYTES}-byte "
                             "aligned")


def _strides(t: torch.Tensor) -> list[int]:
    """Element strides of t's B, n and S dims; a dimension of length 1 gets
    the tensor's span, so every stride the kernels see is aligned."""
    span = max(s * n for s, n in zip(t.stride(), t.shape))
    return [t.stride(d) if t.shape[d] > 1 else span for d in range(3)]


def launch(stem: str, q, k, v, o, causal: bool) -> None:
    """One launch of kernel `stem` writing o (checked by `flash_attention`;
    `chip_smoke.py` also calls the CUDA-core kernel on bf16 through here to
    time it beside the tensor-core one)."""
    B, nq, Sq, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, o) for s in _strides(t)])
    dtype_arg = [_CODES[q.dtype]] if stem == "flash_attention" else []
    err = _kernel(stem)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, nq, nkv, Sq, Sk, hd,
        *dtype_arg, strides, int(bool(causal)), torch.cuda.current_stream().cuda_stream,
    )
    if err >= 10000:
        raise RuntimeError(f"flash_attention: {stem}: tensor map encoding failed, "
                           f"CUresult {err - 10000}")
    if err != 0:
        raise RuntimeError(f"flash_attention: {stem}: kernel launch failed, cudaError {err}")
    launches.count(flash_attention, stem)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``q [B, nq, Sq, hd]``, ``k, v [B, nkv, Sk, hd]`` -> ``[B, nq, Sq, hd]``
    in q's dtype and memory order; q head h reads kv head h // (nq / nkv).
    On the card all three are of one dtype (float32 or bfloat16), with hd
    in `HEAD_DIMS`, laid out as `check_layout` asks."""
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
        o = torch.empty_like(q)  # q's memory order, as on the card
        return o.copy_(attention_ref(q, k, v, causal=causal))
    if device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    if q.dtype not in KERNEL_OF:
        raise TypeError(f"flash_attention: the kernels take float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernels are built for hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the C entry points launch on the current device's context
        with torch.cuda.device(device):
            return flash_attention(q, k, v, causal=causal)
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    check_layout(q, k, v, o)
    launch(KERNEL_OF[q.dtype], q, k, v, o, causal)
    return o


#: kernel launches since the last reset (CPU calls never count), in all and
#: by kernel
flash_attention.launches = 0
flash_attention.launches_by_kernel = {stem: 0 for stem in KERNEL_OF.values()}
