"""PyTorch port: the fused RMSNorm. The port's plain version (the kernel's
CPU path) against the JAX package's oracle and its Pallas kernel in
interpret mode, the wrapper's dispatch and checks, and the check that holds
the CUDA kernel to its plain version on the card
(`repro_torch.kernels.rmsnorm.testing`; the kernel itself runs in
test_torch_gpu.py and chip_smoke.py).

Inputs come from a numpy seed (x a standard normal, w a standard normal
plus 1, as in the JAX package's tests) and go to both packages. The bound
is the kernel check's: 1e-5 absolute in float32, one bf16 ulp in bf16
(printed with -s).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm_fused as jax_rmsnorm_fused
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels.rmsnorm import rmsnorm_fused, rmsnorm_ref
from repro_torch.kernels.rmsnorm import testing as T

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the cases small enough for the CPU (all but the 64-point wave's norm)
SMALL_CASES = [c for c in T.CASES if c[0] * c[1] <= 2**23]


def _inputs(case, seed):
    n, d, xd, wd = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal(d) + 1.0).astype(np.float32)
    return ((jnp.asarray(x).astype(_JNP[xd]), jnp.asarray(w).astype(_JNP[wd])),
            (torch.from_numpy(x).to(_TORCH[xd]), torch.from_numpy(w).to(_TORCH[wd])))


def _from_jax(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


@pytest.mark.parametrize("case", SMALL_CASES, ids=T.case_name)
def test_plain_matches_jax(case):
    """Every RMS_CASES entry against the JAX oracle and its Pallas kernel
    (interpret mode); the model shapes against the oracle."""
    (jx, jw), (x, w) = _inputs(case, seed=case[0] + case[1])
    before = rmsnorm_fused.launches
    got = rmsnorm_fused(x, w)  # the CPU takes the plain version
    assert rmsnorm_fused.launches == before
    torch.testing.assert_close(got, rmsnorm_ref(x, w), rtol=0, atol=0)
    wants = {"oracle": jax_rmsnorm_ref(jx, jw)}
    if case in T.RMS_CASES:
        wants["interpret"] = jax_rmsnorm_fused(jx, jw, impl="interpret")
    for name, want in wants.items():
        report = T.assert_close(got, _from_jax(want).to(got.dtype), f"{T.case_name(case)} {name}")
        print(f"{T.case_name(case)} vs {name}: {report}")


def test_leading_dims_are_rows():
    x, w = T.case_inputs((24, 128, "float32", "float32"), "cpu", seed=1)
    got = rmsnorm_fused(x.reshape(2, 3, 4, 128), w)
    torch.testing.assert_close(got.reshape(24, 128), rmsnorm_ref(x, w), rtol=0, atol=0)


def test_wrapper_checks_its_inputs():
    x, w = torch.zeros(4, 128), torch.ones(128)
    with pytest.raises(ValueError, match=r"shape \(128,\)"):
        rmsnorm_fused(x, w[:64])
    with pytest.raises(ValueError, match="is on meta"):
        rmsnorm_fused(x, w.to("meta"))
    # a tensor on a device that has no kernel raises instead of falling back
    with pytest.raises(ValueError, match="no kernel"):
        rmsnorm_fused(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("case", SMALL_CASES, ids=T.case_name)
def test_kernel_check_sees_a_missing_eps_or_w(case):
    """The bound that holds the kernel to its plain version on the card
    rejects an RMSNorm without eps and one without w, in both dtypes: the
    check's inputs hold rows whose mean square is far below eps."""
    x, w = T.case_inputs(case, "cpu", seed=2)
    want = rmsnorm_ref(x, w)
    T.assert_close(rmsnorm_ref(x.clone(), w), want, "same")
    with pytest.raises(AssertionError, match="exceeds"):
        T.assert_close(rmsnorm_ref(x, w, eps=0.0), want, "no eps")
    with pytest.raises(AssertionError, match="exceeds"):
        T.assert_close(rmsnorm_ref(x, torch.ones_like(w)), want, "no w")


def test_bf16_ulp():
    t = torch.tensor([1.0, 1.5, 2.0, -3.0, 0.0])
    assert T.bf16_ulp(t)[:4].tolist() == [2**-7, 2**-7, 2**-6, 2**-6]
    assert T.bf16_ulp(t)[4] > 0
