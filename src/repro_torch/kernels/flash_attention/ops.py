"""Public wrapper of the flash-attention kernels (counterpart of
`repro.kernels.flash_attention.ops.flash_attention` and
`repro.kernels.flash_attention.flash_attention.flash_attention_kernel`).

`flash_attention` has the JAX package's signature and layout. A CUDA
tensor goes to a hand-written Hopper kernel or the call raises: bfloat16 to
`csrc/flash_attention_wgmma.cu` (wgmma and TMA), float32 to
`csrc/flash_attention.cu` (mma.sync in 3xTF32, which keeps float32
accuracy: one TF32 pass would miss the float32 bound). Both run on the
tensor cores. A CPU tensor goes to the plain version
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

`scale` multiplies q k^T. Its default is the JAX kernel's 1/sqrt(hd)
(`flash_attention.py:106`), passed to the C entry points as a double: they
fold it into log2(e) * scale in float32, which at every hd of `HEAD_DIMS`
rounds to the constant log2(e) / sqrt(hd) they fixed before, so default
calls compute what they computed, bit for bit. MLA passes 1/sqrt(96) with
q and k zero-padded from 96 to 128 columns (`models/attention.py`).

The gradient. When grad is enabled and q, k or v requires it,
`flash_attention` goes through `FlashAttention`, a `torch.autograd.Function`
(in the `setup_context` style, so `torch.func` transforms go through it):
its forward launches the same kernel with a second output, each row's
log-sum-exp, and its backward (`flash_attention_bwd`: three kernels, the
rows' D = rowsum(dO o), dK and dV, dQ) launches the library of q's dtype
(`bwd_stem`): bfloat16 `csrc/flash_attention_bwd_wgmma.cu`, float32
`csrc/flash_attention_bwd_3xbf16.cu` (both wgmma and TMA; float32 in 3xBF16,
its first kernel splitting q, k, v and dO into bf16 parts). On the CPU the
Function's forward is `ref.attention_lse_ref` and its backward
`ref.attention_bwd_ref`. Every other call takes the forward alone, with a
null log-sum-exp pointer, and computes what it computed before, bit for
bit: a kernel's output never leaves the wrapper detached from a tensor that
requires grad. `flash_attention_bwd.launches_by_kernel` counts each
library's three kernels (`BWD_KERNELS`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, launches
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

#: head dims the kernels are built for
HEAD_DIMS = (32, 64, 128)
#: the kernel (library stem) each dtype goes to on the card
KERNEL_OF = {torch.float32: "flash_attention", torch.bfloat16: "flash_attention_wgmma"}
#: dtype codes of `flash_attention.cu`'s C entry point (it takes both)
_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: strides and bases the kernels read: 16-byte vectors and TMA boxes
ALIGN_BYTES = 16
#: the backward's library (stem) each dtype goes to on the card
BWD_KERNEL_OF = {torch.float32: "flash_attention_bwd_3xbf16",
                 torch.bfloat16: "flash_attention_bwd_wgmma"}
#: each backward library's three kernels, in launch order: the rows' D and
#: log-sum-exp in log2 units (in the float32 library with the split of q, k,
#: v and dO into bf16 hi and lo parts), dK and dV, dQ
BWD_KERNELS = {
    "flash_attention_bwd_3xbf16": ("flash_attention_bwd_3xbf16_split",
                                   "flash_attention_bwd_3xbf16_dkdv",
                                   "flash_attention_bwd_3xbf16_dq"),
    "flash_attention_bwd_wgmma": ("flash_attention_bwd_wgmma_stats",
                                  "flash_attention_bwd_wgmma_dkdv",
                                  "flash_attention_bwd_wgmma_dq"),
}
#: the arguments each backward library's `<stem>_scratch` takes, a prefix of
#: (B, nq, Sq, nkv, Sk, hd): the bf16 library's scratch holds q's rows only,
#: the float32 one's also the bf16 parts of q, k, v and dO
BWD_SCRATCH_ARGS = {"flash_attention_bwd_3xbf16": 6, "flash_attention_bwd_wgmma": 3}
_fns: dict = {}


def _kernel(stem: str):
    fn = _fns.get(stem)
    if fn is None:
        lib = _build.load(stem)
        fn = getattr(lib, f"{stem}_fwd")
        dtype_arg = [ctypes.c_int] if stem == "flash_attention" else []
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, o
            ctypes.c_void_p,  # lse, or null
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, nq, nkv
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Sq, Sk, hd
            *dtype_arg,
            ctypes.POINTER(ctypes.c_longlong),  # strides of (B, n, S) of q, k, v, o
            ctypes.c_int,  # causal
            ctypes.c_double,  # scale
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fns[stem] = fn
    return fn


def _bwd_kernel(stem: str):
    """The C entry point of backward library `stem` (both take the same
    arguments)."""
    fn = _fns.get(stem)
    if fn is None:
        fn = getattr(_build.load(stem), stem)
        fn.argtypes = [
            *[ctypes.c_void_p] * 10,  # q, k, v, o, dout, lse, scratch, dq, dk, dv
            *[ctypes.c_int] * 6,  # B, nq, nkv, Sq, Sk, hd
            ctypes.POINTER(ctypes.c_longlong),  # strides of (B, n, S) of the eight tensors
            ctypes.c_int,  # causal
            ctypes.c_double,  # scale
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fns[stem] = fn
    return fn


def _bwd_scratch(stem: str, B: int, nq: int, Sq: int, nkv: int, Sk: int, hd: int) -> int:
    """float32 values of the scratch that backward library `stem` takes for
    q of ``[B, nq, Sq, hd]`` and k of ``[B, nkv, Sk, hd]``, as the library
    itself says (`<stem>_scratch`, given the first `BWD_SCRATCH_ARGS[stem]`
    of those six): the layout (rows padded to the .cu's ROW_PAD, the
    float32 library's bf16 parts) lives in the .cu file alone."""
    key = f"{stem}_scratch"
    n = BWD_SCRATCH_ARGS[stem]
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(_build.load(stem), key)
        fn.argtypes = [ctypes.c_int] * n
        fn.restype = ctypes.c_longlong
        _fns[key] = fn
    return fn(*(B, nq, Sq, nkv, Sk, hd)[:n])


def _launch_bwd(q, k, v, o, lse, do, causal: bool, scale: float | None):
    """(dq, dk, dv) from the three kernels of the library of q's dtype
    (`bwd_stem`), on tensors `flash_attention_bwd` has checked, with the
    float32 scratch the library asks for; each launch counted. `scale` None
    is 1/sqrt(hd)."""
    B, nq, Sq, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    stem = bwd_stem(q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    check_layout(dq, dk, dv)
    scratch = torch.empty(_bwd_scratch(stem, B, nq, Sq, nkv, Sk, hd), dtype=torch.float32,
                          device=q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*[s for t in tensors for s in _strides(t)])
    err = _bwd_kernel(stem)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, nq, nkv, Sq, Sk, hd,
        strides, int(bool(causal)), default_scale(hd) if scale is None else scale,
        torch.cuda.current_stream().cuda_stream,
    )
    if err >= 10000:
        raise RuntimeError(f"flash_attention_bwd: {stem}: tensor map encoding failed, "
                           f"CUresult {err - 10000}")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: {stem}: kernel launch failed, cudaError {err}")
    for kernel in BWD_KERNELS[stem]:
        launches.count(flash_attention_bwd, kernel)
    return dq, dk, dv


def bwd_stem(dtype: torch.dtype) -> str:
    """The backward library that a gradient of `dtype` goes to on the card
    (`BWD_KERNEL_OF`); TypeError for a dtype no kernel takes."""
    stem = BWD_KERNEL_OF.get(dtype)
    if stem is None:
        raise TypeError(f"flash_attention_bwd: the kernels take float32 or bfloat16, got {dtype}")
    return stem


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


def launch(stem: str, q, k, v, o, causal: bool, scale: float | None = None,
           lse: torch.Tensor | None = None) -> None:
    """One launch of kernel `stem` writing o, and each row's log-sum-exp
    into `lse` (float32 ``[B, nq, Sq]``, contiguous) where one is given
    (checked by `flash_attention`; `chip_smoke.py` also calls the float32
    kernel on bf16 through here to time it beside the wgmma one). `scale`
    None is 1/sqrt(hd)."""
    B, nq, Sq, hd = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, o) for s in _strides(t)])
    dtype_arg = [_CODES[q.dtype]] if stem == "flash_attention" else []
    err = _kernel(stem)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, nq, nkv, Sq, Sk, hd, *dtype_arg, strides,
        int(bool(causal)), default_scale(hd) if scale is None else scale,
        torch.cuda.current_stream().cuda_stream,
    )
    if err >= 10000:
        raise RuntimeError(f"flash_attention: {stem}: tensor map encoding failed, "
                           f"CUresult {err - 10000}")
    if err != 0:
        raise RuntimeError(f"flash_attention: {stem}: kernel launch failed, cudaError {err}")
    launches.count(flash_attention, stem)


def default_scale(hd: int) -> float:
    """The reference's softmax scale, 1/sqrt(hd)."""
    return 1.0 / math.sqrt(hd)


def _check(q, k, v, causal: bool, scale: float | None) -> None:
    """The wrapper's checks on every device (and the card's dtype and hd)."""
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
    if scale is not None and not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"flash_attention: scale must be a positive number, got {scale}")
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
        return
    if device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    if q.dtype not in KERNEL_OF:
        raise TypeError(f"flash_attention: the kernels take float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernels are built for hd in {HEAD_DIMS}, "
                         f"got {hd}")


def _forward(q, k, v, causal: bool, scale: float | None, want_lse: bool):
    """o in q's dtype and memory order, and (`want_lse`) each row's
    log-sum-exp, float32 ``[B, nq, Sq]``, else None: the kernel of q's dtype
    on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        o = torch.empty_like(q)  # q's memory order, as on the card
        if not want_lse:
            return o.copy_(attention_ref(q, k, v, causal=causal, scale=scale)), None
        ref_o, lse = attention_lse_ref(q, k, v, causal=causal, scale=scale)
        return o.copy_(ref_o), lse
    o = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if want_lse
           else None)
    if q.numel() == 0:
        return o, lse
    check_layout(q, k, v, o)
    launch(KERNEL_OF[q.dtype], q, k, v, o, causal, scale, lse)
    return o, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel, which also
    writes each row's log-sum-exp, and the backward kernel
    (`flash_attention_bwd`). `apply(q, k, v, causal, scale)` -> (o, lse);
    lse is not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, scale):
        return _forward(q, k, v, causal, scale, want_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        """First order only, on every device. On the card the backward
        kernels fill fresh tensors that carry no graph, so a second
        derivative through them would silently drop every attention term;
        so a `create_graph=True` backward raises here (the CPU's plain
        backward could carry a graph, and raises the same). `torch.func`'s
        transforms call this through a generated Function (another ctx
        type) with grad enabled: they pass, and `once_differentiable`
        stops any transform of them from differentiating again."""
        if torch.is_grad_enabled() and type(ctx) is FlashAttention._backward_cls:
            raise RuntimeError(
                "flash_attention: the kernels' backward is once-differentiable; a "
                "create_graph=True backward (a second derivative) must run the plain "
                "attention (cfg.attn_impl='plain')")
        return FlashAttention._first_order(ctx, do)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def _first_order(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """``q [B, nq, Sq, hd]``, ``k, v [B, nkv, Sk, hd]`` -> ``[B, nq, Sq, hd]``
    in q's dtype and memory order; q head h reads kv head h // (nq / nkv);
    the scores are ``scale * q k^T`` (None: 1/sqrt(hd)). On the card all
    three are of one dtype (float32 or bfloat16), with hd in `HEAD_DIMS`,
    laid out as `check_layout` asks. Differentiable: with grad enabled and
    an input that requires it, the call goes through `FlashAttention`."""
    _check(q, k, v, causal, scale)
    device = q.device
    if (device.type == "cuda" and device.index is not None
            and device.index != torch.cuda.current_device()):
        # the C entry points launch on the current device's context
        with torch.cuda.device(device):
            return flash_attention(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)[0]
    return _forward(q, k, v, causal, scale, want_lse=False)[0]


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: float | None = None):
    """The gradient of `flash_attention` with respect to q, k and v: (dq,
    dk, dv) in the dtypes and shapes of q, k and v, from the forward's o and
    log-sum-exp `lse` (float32 ``[B, nq, Sq]``) and the output gradient `do`
    (o's shape and dtype). On the card the three kernels of the library
    of q's dtype (`bwd_stem`), each counted in `.launches_by_kernel`; on
    the CPU `ref.attention_bwd_ref`. `do` in a layout the kernels do not
    read (an expanded or unaligned view) is copied first."""
    _check(q, k, v, causal, scale)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 {tuple(q.shape[:3])}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    for name, t in (("o", o), ("do", do), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is on {t.device}, q is on "
                             f"{q.device}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: o ({o.dtype}) and do ({do.dtype}) must be "
                        f"{q.dtype}")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, scale=scale)
    device = q.device
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    if q.numel() == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    try:
        check_layout(do)
    except ValueError:
        do = do.contiguous()
    lse = lse.contiguous()
    check_layout(q, k, v, o, do)
    return _launch_bwd(q, k, v, o, lse, do, causal, scale)


#: kernel launches since the last reset (CPU calls never count), in all and
#: by kernel
flash_attention.launches = 0
flash_attention.launches_by_kernel = {stem: 0 for stem in KERNEL_OF.values()}
#: backward launches since the last reset, in all (three a backward) and by
#: kernel, both libraries'
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_kernel = {name: 0 for names in BWD_KERNELS.values()
                                          for name in names}
