"""Inputs and the check that hold the flash-attention kernels against their
plain version (`ref.attention_ref`). `chip_smoke.py` and the port's tests
both use them, so the card and the test suite run the same cases against
the same bound.

The bound is the JAX package's own kernel-vs-oracle tolerance on the
largest absolute error (tests/test_kernels.py): 2e-5 in float32 and 2e-2 in
bfloat16. In float32 the kernel computes both products in 3xTF32 (each
product to about float32 accuracy) and the plain version in IEEE float32
from the same inputs; they differ in summation order and in the online
softmax's rescaling (a few float32 ulp of outputs of order 1; PERF.md
gives the largest measured on an H100). In bf16 the tensor-core kernel also
rounds the probabilities to bf16 before P V (relative error <= 2^-9 of
each term, ~0.002 of an output of order 1, as the JAX package's model path
does), and both sides round their float32 result to bf16, so they differ by
about one bf16 rounding (0.0078 for outputs in [1, 2), 0.0156 in [2, 4)).
Inputs are standard normals, as in the JAX package's tests. A dropped
diagonal moves outputs by O(1) and fails it; so does a 1/hd scale, and at
qwen3-0.6b's shape a scale 1% off.

The backward kernels (`csrc/flash_attention_bwd_wgmma.cu` for bf16,
`csrc/flash_attention_bwd_3xbf16.cu` for float32) are held by `check_bwd` at
`BWD_CASES`: dq, dk and dv against the plain backward
(`ref.attention_bwd_ref`) on the same q, k, v, o, log-sum-exp and output
gradient, each gradient's largest error within `BWD_RTOL` of its largest
element: 2e-2 in bf16 (the forward's bound: both sides round P and dS to
bf16 and their results to bf16, and sum in other orders), 1e-4 in float32
(the kernel's products are 3xBF16, about 2^-16 of each term, and a
gradient sums twice the forward's products; the forward's 2e-5 absolute
is no bound for gradients whose largest elements run to O(10)). The plain
backward runs from the plain forward's own o and log-sum-exp, not the
kernel's, and the kernel's log-sum-exp is held within `LSE_ATOL` of the
plain one: a wrong log-sum-exp would otherwise be read the same wrong way
on both sides and cancel out of the comparison. `backward_tap` holds every
attention call of a training step the same way, on its saved tensors.
"""
from __future__ import annotations

import contextlib
import math
import types
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

#: max |kernel - plain| by dtype (see above)
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the FLASH_CASES of the JAX package's tests:
#: (B, nq, nkv, Sq, Sk, hd, causal, dtype)
FLASH_CASES = (
    (2, 4, 2, 256, 256, 64, True, "float32"),
    (1, 4, 4, 128, 128, 128, True, "float32"),
    (2, 8, 2, 256, 256, 64, False, "float32"),
    (1, 2, 1, 512, 512, 64, True, "float32"),
    (1, 4, 2, 256, 256, 64, True, "bfloat16"),
)
#: the reduced qwen3-0.6b's widths (hd 32, at the parity tests' seq 128),
#: a causal S that is no multiple of the 64-row tiles, and full attention
#: with Sq != Sk, both ragged, in float32 and in bf16 (the wgmma kernel's
#: TMA zero fill and key mask past Sk, as cross-attention meets them)
EDGE_CASES = (
    (2, 4, 2, 128, 128, 32, True, "float32"),
    (1, 4, 2, 100, 100, 32, True, "bfloat16"),
    (1, 4, 1, 96, 200, 64, False, "float32"),
    (1, 8, 2, 130, 161, 128, False, "bfloat16"),
)
#: the float32 kernel's own path (the reduced qwen3-0.6b in float32 over a
#: 13-point grid wave: 26 sequences of 512, hd 32, chip_smoke.py's
#: `flash_f32_path`) and qwen3-0.6b's published attention width in float32
F32_CASES = (
    (26, 4, 2, 512, 512, 32, True, "float32"),
    (2, 16, 8, 2048, 2048, 128, True, "float32"),
)
#: qwen3-0.6b's attention on the main path (16 q heads, 8 kv heads of 128,
#: 2,048 tokens, bf16): one point (2 sequences), a wave of 8 (16) and the
#: 41-point grid as one wave (82)
MAIN_PATH_BATCHES = (2, 16, 82)
QWEN3_HEADS, QWEN3_KV_HEADS, QWEN3_HD, MAIN_PATH_SEQ = 16, 8, 128, 2048
MODEL_CASES = tuple((B, QWEN3_HEADS, QWEN3_KV_HEADS, MAIN_PATH_SEQ, MAIN_PATH_SEQ, QWEN3_HD,
                     True, "bfloat16") for B in MAIN_PATH_BATCHES)
CASES = FLASH_CASES + EDGE_CASES + F32_CASES + MODEL_CASES


class ZooCase(NamedTuple):
    """One model's attention on its path: the kernel's case, the scale
    (None: 1/sqrt(hd)) and, where the model pads its heads to the kernel's
    hd, the columns of q and k and of v that carry values (the rest are
    zero)."""
    case: tuple
    scale: float | None = None
    widths: tuple[int, int] | None = None


#: the LM zoo's attention shapes on their paths (bf16, at the model layout):
#: deepseek-moe-16b's grid wave (41 points, 82 sequences; 16 heads of 128,
#: no GQA), and a wave of 8 points (16 sequences) of zamba2-1.2b's shared
#: block (32 heads of 64), minicpm3-4b's MLA (40 heads, q.k over 64 + 32 =
#: 96 columns and v over 64, zero-padded to 128, at scale 1/sqrt(96)) and
#: llama-3.2-vision-90b's cross-attention (64 q heads over 8 kv heads of
#: 128, 2,048 tokens against 1,601 context tokens, full)
ZOO_CASES = {
    "deepseek-moe-16b": ZooCase((82, 16, 16, 2048, 2048, 128, True, "bfloat16")),
    "zamba2-1.2b": ZooCase((16, 32, 32, 2048, 2048, 64, True, "bfloat16")),
    "minicpm3-4b": ZooCase((16, 40, 40, 2048, 2048, 128, True, "bfloat16"),
                           1.0 / math.sqrt(96), (96, 64)),
    "llama-3.2-vision-90b": ZooCase((16, 64, 8, 2048, 1601, 128, False, "bfloat16")),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: sequences of one plain-version call: the plain version holds the whole
#: [B, nq, Sq, Sk] float32 score tensor (4.3 GB at 16 qwen3 sequences)
PLAIN_BATCH = 16


def case_name(case) -> str:
    B, nq, nkv, Sq, Sk, hd, causal, dt = case
    s = f"S{Sq}" if Sq == Sk else f"Sq{Sq}_Sk{Sk}"
    return f"B{B}_nq{nq}_nkv{nkv}_{s}_hd{hd}_{'causal' if causal else 'full'}_{dt}"


def case_inputs(case, device, seed: int = 0, widths: tuple[int, int] | None = None):
    """Standard-normal (q [B,nq,Sq,hd], k, v [B,nkv,Sk,hd]) in the case's
    dtype, drawn on `device` from `seed`; with `widths` = (dqk, dv), the
    columns of q and k past dqk and of v past dv are zero, as a model that
    pads its heads to hd leaves them."""
    B, nq, nkv, Sq, Sk, hd, _, dt = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(_DTYPES[dt])
               for shape in ((B, nq, Sq, hd), (B, nkv, Sk, hd), (B, nkv, Sk, hd)))
    if widths is not None:
        for t, w in ((q, widths[0]), (k, widths[0]), (v, widths[1])):
            t[..., w:] = 0
    return q, k, v


def plain(q, k, v, causal: bool, scale: float | None = None) -> torch.Tensor:
    """`attention_ref` PLAIN_BATCH sequences at a time (it is independent
    per sequence), so the largest main-path shape fits the card."""
    return torch.cat([attention_ref(q[i:i + PLAIN_BATCH], k[i:i + PLAIN_BATCH],
                                    v[i:i + PLAIN_BATCH], causal=causal, scale=scale)
                      for i in range(0, q.shape[0], PLAIN_BATCH)])


def variant(q, k, v, *, drop_diagonal: bool = False, scale: float | None = None):
    """Causal attention gone wrong, for the tests that show the check sees
    it: the diagonal masked out (row 0 then sees no key and, as in the
    kernels' masked arithmetic, averages all of them) or another scale.
    With neither, the plain version's function."""
    hd, S = q.shape[-1], q.shape[2]
    group = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(group, 1).float(), v.repeat_interleave(group, 1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * (scale or hd ** -0.5)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril(-1 if drop_diagonal else 0)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def assert_close(got: torch.Tensor, want: torch.Tensor, name: str) -> dict:
    """Raises unless `got` has `want`'s shape and dtype, is finite and is
    within ATOL of its dtype; returns the error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}, "
                             f"expected {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: result is not finite")
    tol = ATOL[str(want.dtype).removeprefix("torch.")]
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err:.3g} exceeds {tol}")
    return {"max_abs_err": err, "bound": tol}


#: the backward's cases, at the model layout: qwen3-0.6b's training shape
#: (B = 4 sequences of 4,096, bf16, causal: `train_path`'s), deepseek's
#: no-GQA heads, zamba2's hd 64, minicpm3's MLA padded to hd 128 at scale
#: 1/sqrt(96), llama's cross-attention (full, 2,048 -> 1,601), float32 (the
#: float32 path's shape and qwen3-0.6b's heads of 128), and the wgmma
#: kernel's edges in bf16: a causal S of 1,000, no multiple of any tile, with
#: a GQA group of 4, and hd 32 at the float32 path's shape (last, so that
#: the cases before them keep their seeds in chip_smoke.py)
BWD_CASES = {
    "qwen3-0.6b_train": ZooCase((4, 16, 8, 4096, 4096, 128, True, "bfloat16")),
    "deepseek-moe-16b": ZooCase((2, 16, 16, 2048, 2048, 128, True, "bfloat16")),
    "zamba2-1.2b": ZooCase((2, 32, 32, 2048, 2048, 64, True, "bfloat16")),
    "minicpm3-4b": ZooCase((2, 40, 40, 2048, 2048, 128, True, "bfloat16"),
                           1.0 / math.sqrt(96), (96, 64)),
    "llama-3.2-vision-90b_cross": ZooCase((2, 64, 8, 2048, 1601, 128, False, "bfloat16")),
    "float32_path": ZooCase((26, 4, 2, 512, 512, 32, True, "float32")),
    "float32_hd128": ZooCase((2, 16, 8, 2048, 2048, 128, True, "float32")),
    "ragged_gqa4": ZooCase((3, 8, 2, 1000, 1000, 64, True, "bfloat16")),
    "bfloat16_hd32": ZooCase((26, 4, 2, 512, 512, 32, True, "bfloat16")),
}
#: each gradient's largest error over its largest element (see above)
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: max |kernel - plain| of the forward's log-sum-exp, either dtype: both
#: are float32 log-sum-exps of the same float32 scores, summed in other
#: orders (PERF.md gives the largest measured on an H100: 1.9e-6, two
#: float32 ulps of values near 8). An offset d in it scales every
#: probability of its row by exp(-d) in the backward.
LSE_ATOL = 1e-4
#: score elements of one plain-backward call (it holds ~6 float32 [B, nq,
#: Sq, Sk] tensors): 2^28, 1 GiB each
PLAIN_BWD_ELEMENTS = 1 << 28


def _plain_rows(q, k) -> int:
    """Sequences a plain call takes at once (PLAIN_BWD_ELEMENTS scores)."""
    return max(1, PLAIN_BWD_ELEMENTS // (q.shape[1] * q.shape[2] * k.shape[2]))


def plain_forward(q, k, v, causal: bool, scale: float | None = None):
    """`attention_lse_ref` (o and its log-sum-exp) a few sequences at a
    time, so the training shape fits the card."""
    n = _plain_rows(q, k)
    parts = [attention_lse_ref(q[i:i + n], k[i:i + n], v[i:i + n], causal=causal, scale=scale)
             for i in range(0, q.shape[0], n)]
    return tuple(torch.cat(t) for t in zip(*parts))


def plain_bwd(q, k, v, o, lse, do, causal: bool, scale: float | None = None):
    """`attention_bwd_ref` a few sequences at a time (it is independent per
    sequence), so the training shape fits the card."""
    n = _plain_rows(q, k)
    parts = [attention_bwd_ref(q[i:i + n], k[i:i + n], v[i:i + n], o[i:i + n], lse[i:i + n],
                               do[i:i + n], causal=causal, scale=scale)
             for i in range(0, q.shape[0], n)]
    return tuple(torch.cat(g) for g in zip(*parts))


def lse_error(lse, want, name: str) -> float:
    """Raises unless the forward's log-sum-exp `lse` is float32 of the
    plain one's shape, finite, and within LSE_ATOL of it; returns the
    largest absolute error."""
    if lse.shape != want.shape or lse.dtype != torch.float32:
        raise AssertionError(f"{name} lse: got {tuple(lse.shape)} {lse.dtype}, expected "
                             f"{tuple(want.shape)} torch.float32")
    if not bool(torch.isfinite(lse).all()):
        raise AssertionError(f"{name} lse: not finite")
    err = float((lse - want).abs().max()) if lse.numel() else 0.0
    if not err <= LSE_ATOL:
        raise AssertionError(f"{name} lse: max abs error {err:.3g} over {LSE_ATOL}")
    return err


def bwd_errors(got, want, dtype: str, name: str, rtol: float | None = None) -> dict:
    """Raises unless each of (dq, dk, dv) has its plain twin's shape and
    dtype, is finite, and lies within `rtol` (default BWD_RTOL[dtype]) of
    the twin's largest element; returns each gradient's largest error and
    that ratio."""
    rtol = BWD_RTOL[dtype] if rtol is None else rtol
    out = {}
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {gname}: got {tuple(g.shape)} {g.dtype}, expected "
                                 f"{tuple(w.shape)} {w.dtype}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {gname}: not finite")
        err = float((g.float() - w.float()).abs().max())
        ref = float(w.float().abs().max())
        rel = err / ref if ref > 0 else err
        if not rel <= rtol:
            raise AssertionError(f"{name} {gname}: max abs error {err:.3g} is {rel:.3g} of the "
                                 f"largest element {ref:.3g}, over {rtol}")
        out[gname] = {"max_abs_err": err, "largest": ref, "rel": rel}
    return out


def bwd_inputs(zoo: ZooCase, device, seed: int = 0):
    """`case_inputs` at the model layout (transposed views of [B, S, n, hd]
    tensors) and a standard-normal output gradient in o's layout, its
    columns past the model's v width zero (the model drops them)."""
    q, k, v = case_inputs(zoo.case, device, seed=seed, widths=zoo.widths)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(q.transpose(1, 2).shape, generator=gen, device=device).to(q.dtype)
    do = do.transpose(1, 2)
    if zoo.widths is not None:
        do[..., zoo.widths[1]:] = 0
    return q, k, v, do


def held_to_plain(q, k, v, lse, do, got, causal: bool, scale: float | None = None,
                  name: str = "", rtol: float | None = None) -> dict:
    """Holds what the kernels gave for one attention call against the
    plain version run from q, k and v alone: the forward's log-sum-exp
    `lse` within LSE_ATOL of the plain forward's (`lse_error`), and the
    gradients `got` (dq, dk, dv) within `rtol` (default BWD_RTOL) of the
    plain backward run from the plain forward's own o and log-sum-exp
    (`bwd_errors`), so a wrong log-sum-exp cannot cancel out of the
    comparison. Raises past either bound; returns the errors."""
    o_ref, lse_ref = plain_forward(q, k, v, causal, scale)
    lse_err = lse_error(lse, lse_ref, name)
    want = plain_bwd(q, k, v, o_ref, lse_ref, do, causal, scale)
    dt = str(q.dtype).removeprefix("torch.")
    errors = bwd_errors(got, want, dt, name, rtol)
    return {**errors, "lse_max_abs_err": lse_err, "lse_bound": LSE_ATOL,
            "bound": BWD_RTOL[dt] if rtol is None else rtol}


def check_bwd(q, k, v, do, causal: bool, scale: float | None = None, name: str = "") -> dict:
    """The forward with its log-sum-exp and the backward through the
    wrappers on q's device (the kernels on the card), held to the plain
    version by `held_to_plain`. Returns the errors."""
    from repro_torch.kernels.flash_attention import ops

    o, lse = ops._forward(q, k, v, causal, scale, want_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    return held_to_plain(q, k, v, lse, do, got, causal, scale, name)


@contextlib.contextmanager
def backward_tap(rtol: float | None = None):
    """Within the block every `ops.FlashAttention` backward (each attention
    call of a training step) is also held to the plain version on its own
    saved q, k, v and log-sum-exp (`held_to_plain` at `rtol`). Yields a
    list that gains, for each call, its errors or, past a bound, {"error":
    message}; the step itself goes on. The kernels launch and count as
    always."""
    from repro_torch.kernels.flash_attention import ops

    real = ops.FlashAttention.__dict__["backward"]
    seen: list[dict] = []

    def backward(ctx, do, dlse):
        # saved tensors unpack once: an activation checkpoint refuses a second
        saved = ctx.saved_tensors
        grads = real.__func__(types.SimpleNamespace(saved_tensors=saved, causal=ctx.causal,
                                                    scale=ctx.scale), do, dlse)
        q, k, v, _, lse = saved
        try:
            seen.append(held_to_plain(q, k, v, lse, do, grads[:3], ctx.causal, ctx.scale,
                                      f"call {len(seen)}", rtol))
        except AssertionError as e:
            seen.append({"error": str(e)})
        return grads

    ops.FlashAttention.backward = staticmethod(backward)
    try:
        yield seen
    finally:
        ops.FlashAttention.backward = real