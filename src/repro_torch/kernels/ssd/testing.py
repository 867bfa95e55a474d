"""Inputs and the check that hold the SSD chunk-scan kernel against its
plain version (`ref.ssd_chunked_ref`). `chip_smoke.py` and the port's tests
both use them, so the card and the test suite run the same cases against
the same bound.

The bound is on the largest error relative to the largest output, 1e-4 for
y and for the final state: the JAX package's own kernel-vs-oracle tolerance
(tests/test_kernels.py). Both sides compute in float32 but sum in another
order (the kernel contracts multiply-adds and takes the cumulative sum
sequentially), and the decays exp(cum_i - cum_j) turn the rounding of a
cumulative sum that reaches a few hundred within a chunk (one float32 ulp
there is ~3e-5) into a relative error of that size. A wrong mask, decay or
state update moves y by O(1) relative and fails it.
"""
from __future__ import annotations

import torch

#: relative bound of the kernel against its plain version (see above)
REL_TOL = 1e-4
#: mamba2-1.3b's SSD widths: 64 heads of P = 64 in one group, state N = 128
MAMBA2_HEADS, MAMBA2_P, MAMBA2_N = 64, 64, 128
#: sequences of the main path's forwards: one point (B = 2), a wave of 8,
#: and the 41-point sparse grid as one wave (82 sequences)
MAIN_PATH_BATCHES = (2, 16, 82)
MAIN_PATH_SEQ = 2048
#: (B, H, G, S, P, N, non-zero initial state): the SSD_CASES shapes of the
#: JAX package's tests, one of them from a non-zero state, and the main
#: path's shapes
CASES = (
    (2, 4, 2, 256, 32, 16, False),
    (1, 8, 1, 128, 64, 32, False),
    (1, 2, 2, 384, 32, 16, False),
    (2, 4, 2, 256, 32, 16, True),
    *((B, MAMBA2_HEADS, 1, MAIN_PATH_SEQ, MAMBA2_P, MAMBA2_N, False)
      for B in MAIN_PATH_BATCHES),
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
