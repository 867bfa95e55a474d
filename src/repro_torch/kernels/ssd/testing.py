"""Inputs and the check that hold the SSD chunk-scan kernel against its
plain version (`ref.ssd_chunked_ref`). `chip_smoke.py` and the port's tests
both use them, so the card and the test suite run the same cases against
the same bound.

The bound is on the largest error relative to the largest output, 1e-4 for
y and for the final state: the JAX package's own kernel-vs-oracle tolerance
(tests/test_kernels.py). Both sides compute in float32 but sum in another
order (the kernel sums its products on the tensor cores, in 3xTF32, and
takes the cumulative sum as a warp scan), and the decays exp(cum_i - cum_j)
turn the rounding of a cumulative sum that reaches a few hundred within a
chunk (one float32 ulp there is ~3e-5) into a relative error of that size. A wrong mask, decay or
state update moves y by O(1) relative and fails it.

`ssd_chunked_tf32` is a plain emulation of the kernel's arithmetic: every
one of the four products with its operands rounded to TF32 as `cvt.rna`
rounds (`tf32_rna`), split in 3xTF32 form or in one TF32 pass. The CPU
tests hold the split to the plain version within REL_TOL, which is the
evidence that the kernel's precision scheme meets the bound.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import CHUNK

#: relative bound of the kernel against its plain version (see above)
REL_TOL = 1e-4
#: mamba2-1.3b's SSD widths: 64 heads of P = 64 in one group, state N = 128
MAMBA2_HEADS, MAMBA2_P, MAMBA2_N = 64, 64, 128
#: sequences of the main path's forwards: one point (B = 2), a wave of 8,
#: and the 41-point sparse grid as one wave (82 sequences)
MAIN_PATH_BATCHES = (2, 16, 82)
MAIN_PATH_SEQ = 2048
#: zamba2-1.2b's SSD on its path (a wave of 8 points, 16 sequences): 64
#: heads of P = 64 in one group, state N = 64
ZAMBA2_CASE = (16, 64, 1, MAIN_PATH_SEQ, 64, 64, False)
#: (B, H, G, S, P, N, non-zero initial state): the SSD_CASES shapes of the
#: JAX package's tests, one of them from a non-zero state, the main path's
#: shapes and zamba2-1.2b's
CASES = (
    (2, 4, 2, 256, 32, 16, False),
    (1, 8, 1, 128, 64, 32, False),
    (1, 2, 2, 384, 32, 16, False),
    (2, 4, 2, 256, 32, 16, True),
    *((B, MAMBA2_HEADS, 1, MAIN_PATH_SEQ, MAMBA2_P, MAMBA2_N, False)
      for B in MAIN_PATH_BATCHES),
    ZAMBA2_CASE,
)


def case_name(case) -> str:
    B, H, G, S, P, N, nonzero = case
    return f"B{B}_H{H}_G{G}_S{S}_P{P}_N{N}" + ("_state" if nonzero else "")


def kernel_inputs(case, device, seed: int = 0):
    """Float32 kernel-layout inputs (x, dt, Bm, Cm, A, s0) on `device`,
    drawn there from `seed`, distributed as in mamba2: dt = softplus of a
    normal around the init's dt bias (dt ~ 1e-3..1), A = -exp(U[0, log 16))."""
    B, H, G, S, P, N, nonzero = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x = normal(B, H, S, P)
    dt = torch.nn.functional.softplus(normal(B, H, S) - 3.0)
    Bm = normal(B, G, S, N, scale=0.5)
    Cm = normal(B, G, S, N, scale=0.5)
    A = -torch.exp(torch.rand(H, generator=gen, device=device) * 2.772588722239781)
    s0 = normal(B, H, N, P, scale=0.5 if nonzero else 0.0)
    return x, dt, Bm, Cm, A, s0


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def assert_close(got, want, name: str) -> dict:
    """`got` and `want` are (y, final state) pairs. Raises unless both are
    finite and within REL_TOL; returns the errors."""
    report = {}
    for key, g, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: {key} shape {tuple(g.shape)}, expected {tuple(w.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: {key} is not finite")
        report[key] = {"rel_err": rel_err(g, w),
                       "max_abs_err": float((g.double() - w.double()).abs().max())}
        if not report[key]["rel_err"] <= REL_TOL:
            raise AssertionError(f"{name}: {key} relative error {report[key]['rel_err']:.3g} "
                                 f"exceeds {REL_TOL}")
    return report


def padded_adapter_inputs(device, seed: int = 0, S: int = 200):
    """Model-layout inputs of `ops.ssd` at mamba2's widths, B = 2, with an
    S that the adapter pads (200 -> 256) and a non-zero initial state:
    (xh [2,S,1,64,64], dt [2,S,1,64], Bn, Cn [2,S,1,128], A [1,64],
    init_state [2,1,64,128,64])."""
    H, P, N = MAMBA2_HEADS, MAMBA2_P, MAMBA2_N
    x, dt, Bm, Cm, A, s0 = kernel_inputs((2, H, 1, S, P, N, True), device, seed)
    return (x.transpose(1, 2).reshape(2, S, 1, H, P), dt.transpose(1, 2).reshape(2, S, 1, H),
            Bm.transpose(1, 2), Cm.transpose(1, 2), A.reshape(1, H), s0.reshape(2, 1, H, N, P))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits) as PTX's
    `cvt.rna.tf32.f32` rounds: to nearest, ties away from zero, on the low
    13 bits of the bit pattern (a carry runs into the exponent). Inf and NaN
    pass through."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b with TF32 operands and float32 sums: in 3xTF32 when `split`
    (a = a_big + a_small, each TF32; small*big + big*small + big*big), else
    one pass (big*big)."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    out = a_big @ b_big
    if split:
        a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
        out = a_small @ b_big + a_big @ b_small + out
    return out


def ssd_chunked_tf32(x, dt, Bm, Cm, A, init_state, split: bool = True):
    """`ref.ssd_chunked_ref` with the kernel's arithmetic for its four
    products: C B^T, the masked decayed scores times X, (diag(exp(cum)) C) S
    and (diag(w) B)^T X, each through `_mm_tf32`. Returns (y [B,H,S,P],
    final state [B,H,N,P]), float32."""
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    r = H // G
    Q = CHUNK
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    A_g = A.float().reshape(G, r)
    state = init_state.float().reshape(Bsz, G, r, N, P)
    y = torch.empty(Bsz, G, r, S, P, dtype=torch.float32)
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        x_c = x[:, :, sl].float().reshape(Bsz, G, r, Q, P)
        dt_c = dt[:, :, sl].float().reshape(Bsz, G, r, Q)
        B_c = Bm[:, :, sl].float()[:, :, None]  # [B,G,1,Q,N]
        C_c = Cm[:, :, sl].float()[:, :, None]
        cum = torch.cumsum(dt_c * A_g[None, :, :, None], dim=-1)  # [B,G,r,Q]
        total = cum[..., -1:]
        CB = _mm_tf32(C_c, B_c.transpose(-1, -2), split)  # [B,G,1,Q,Q]
        decay = torch.exp(cum[..., :, None] - cum[..., None, :]) * dt_c[..., None, :]
        scores = torch.where(causal, CB * decay, torch.zeros(()))
        y_c = (_mm_tf32(scores, x_c, split)
               + _mm_tf32(C_c * torch.exp(cum)[..., None], state, split))
        w = dt_c * torch.exp(total - cum)  # [B,G,r,Q]
        state = state * torch.exp(total)[..., None] + _mm_tf32(
            (B_c * w[..., None]).transpose(-1, -2), x_c, split)
        y[:, :, :, sl] = y_c
    return y.reshape(Bsz, H, S, P), state.reshape(Bsz, H, N, P)
