"""Inputs and the check that hold the RMSNorm kernel against its plain
version (`ref.rmsnorm_ref`). `chip_smoke.py` and the port's tests both use
them, so the card and the test suite run the same cases against the same
bound.

The bound is 1e-5 absolute in float32, the JAX package's own
kernel-vs-oracle tolerance for that dtype (tests/test_kernels.py), and one
bf16 ulp of the plain result in bfloat16. Both sides reduce in float32 but
sum in another order and take rsqrt with another rounding (a few float32
ulp apart); in bf16 that can only move a result across one rounding
boundary. Each row of x is a standard normal times its own scale
10^U(-3, 1), so rows whose mean square is far below eps = 1e-5 are in every
case: a kernel that drops eps, or w, fails the check in either dtype.
"""
from __future__ import annotations

import torch

#: absolute bound in float32 (see above)
F32_ATOL = 1e-5
#: bound in bfloat16, in ulp of the plain result
BF16_ULPS = 1
#: the RMS_CASES of the JAX package's tests: (rows, d, x dtype, w dtype)
RMS_CASES = (
    (64, 128, "float32", "float32"),
    (256, 256, "float32", "float32"),
    (128, 512, "bfloat16", "bfloat16"),
)
#: qwen3-0.6b's norms on the main path, bf16 activations with the float32
#: scale the model declares: the layer norms of one point (2 x 2,048
#: tokens) and of the 41-point grid wave (82 x 2,048), and the qk-norm rows
#: of one point's queries (4,096 tokens x 16 heads of 128)
MODEL_CASES = (
    (4096, 1024, "bfloat16", "float32"),
    (167936, 1024, "bfloat16", "float32"),
    (65536, 128, "bfloat16", "float32"),
)
#: a row wider than the kernel keeps in registers (1,024 floats), and a
#: row count that is no multiple of a block's 8 rows
EDGE_CASES = ((300, 4096, "float32", "float32"),)
CASES = RMS_CASES + MODEL_CASES + EDGE_CASES

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def case_name(case) -> str:
    n, d, xd, wd = case
    return f"n{n}_d{d}_{xd}" + ("" if wd == xd else f"_w{wd}")


def case_inputs(case, device, seed: int = 0):
    """(x [n, d], w [d]) drawn on `device` from `seed`: x a standard normal
    times a per-row scale 10^U(-3, 1), w a standard normal plus 1 (as the
    JAX package's tests draw it)."""
    n, d, xd, wd = case
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device)
    x *= 10.0 ** (torch.rand(n, 1, generator=gen, device=device) * 4.0 - 3.0)
    w = torch.randn(d, generator=gen, device=device) + 1.0
    return x.to(_DTYPES[xd]), w.to(_DTYPES[wd])


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |t| (float32): 2^(e - 7) for
    |t| in [2^e, 2^(e+1)), and the smallest normal spacing at 0."""
    a = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def assert_close(got: torch.Tensor, want: torch.Tensor, name: str) -> dict:
    """Raises unless `got` has `want`'s shape and dtype, is finite and is
    within the bound of its dtype; returns the errors."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}, "
                             f"expected {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: result is not finite")
    diff = (got.double() - want.double()).abs()
    report = {"max_abs_err": float(diff.max())}
    if want.dtype == torch.bfloat16:
        ulps = float((diff / bf16_ulp(want).double()).max())
        report["max_ulp"] = ulps
        if not ulps <= BF16_ULPS:
            raise AssertionError(f"{name}: error {ulps:.3g} bf16 ulp exceeds {BF16_ULPS}")
    elif not report["max_abs_err"] <= F32_ATOL:
        raise AssertionError(f"{name}: max abs error {report['max_abs_err']:.3g} "
                             f"exceeds {F32_ATOL}")
    return report
