"""PyTorch port: flash attention. The port's plain version (the kernel's
CPU path) against the JAX package's oracle and its Pallas kernel in
interpret mode, the wrapper's dispatch and checks, and the check that holds
the CUDA kernel to its plain version on the card
(`repro_torch.kernels.flash_attention.testing`; the kernel itself runs in
test_torch_gpu.py and chip_smoke.py).

Inputs are standard normals from a numpy seed, handed to both packages (in
bf16 cases both round the same float32 numbers to bf16). The bounds are
the JAX package's own (tests/test_kernels.py): 2e-5 in float32, 2e-2 in
bf16, on the largest absolute error (printed with -s).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import testing as T

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, seed):
    B, nq, nkv, Sq, Sk, hd, _, dt = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, nq, Sq, hd), (B, nkv, Sk, hd), (B, nkv, Sk, hd))]
    return ([jnp.asarray(a).astype(_JNP[dt]) for a in arrays],
            [torch.from_numpy(a).to(_TORCH[dt]) for a in arrays])


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("case", T.FLASH_CASES, ids=T.case_name)
def test_plain_matches_jax_kernel_and_oracle(case):
    causal, dt = case[6], case[7]
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=sum(case[:6]))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)  # the CPU takes the plain version
    assert flash_attention.launches == before
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(q.shape)
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal), rtol=0, atol=0)
    err_kernel = _err(got, jax_flash(jq, jk, jv, causal=causal, impl="interpret").astype(jnp.float32))
    err_oracle = _err(got, jax_attention_ref(jq, jk, jv, causal=causal).astype(jnp.float32))
    print(f"{T.case_name(case)}: vs Pallas interpret {err_kernel:.3g}, vs oracle {err_oracle:.3g}")
    assert err_kernel <= T.ATOL[dt] and err_oracle <= T.ATOL[dt]


@pytest.mark.parametrize("case", T.EDGE_CASES, ids=T.case_name)
def test_plain_matches_jax_oracle_on_ragged_shapes(case):
    """hd 32, an S that is no multiple of the kernel's tiles, and full
    attention with Sq != Sk, against the JAX oracle (the Pallas kernel
    needs S to be a multiple of its blocks)."""
    causal, dt = case[6], case[7]
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=sum(case[:6]))
    err = _err(flash_attention(q, k, v, causal=causal),
               jax_attention_ref(jq, jk, jv, causal=causal).astype(jnp.float32))
    print(f"{T.case_name(case)}: vs oracle {err:.3g}")
    assert err <= T.ATOL[dt]


def test_entry_point_raises_for_causal_with_sq_ne_sk():
    q = torch.zeros(1, 2, 64, 32)
    kv = torch.zeros(1, 1, 128, 32)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, kv, kv, causal=True)
    # full attention with Sq != Sk is defined, and is the oracle's
    assert tuple(flash_attention(q, kv, kv, causal=False).shape) == (1, 2, 64, 32)


def test_wrapper_checks_its_inputs():
    q, k, v = torch.zeros(1, 4, 64, 32), torch.zeros(1, 2, 64, 32), torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[..., :16], v)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, torch.zeros(1, 3, 64, 32), torch.zeros(1, 3, 64, 32))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="B, n, S, hd"):
        flash_attention(q[0], k, v)
    # a tensor on a device that has no kernel raises instead of falling back
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _variant(q, k, v, *, drop_diagonal=False, scale=None):
    """Causal attention with the diagonal masked out (row 0 then sees no
    key and, as in the kernel's masked arithmetic, averages all of them) or
    with another scale."""
    hd, S = q.shape[-1], q.shape[2]
    group = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(group, 1).float(), v.repeat_interleave(group, 1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * (scale or hd ** -0.5)
    mask = torch.ones(S, S, dtype=torch.bool).tril(-1 if drop_diagonal else 0)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


@pytest.mark.parametrize("case", [T.FLASH_CASES[0], T.FLASH_CASES[4], T.EDGE_CASES[0]],
                         ids=T.case_name)
def test_kernel_check_sees_a_dropped_diagonal_or_a_wrong_scale(case):
    """The bound that holds the kernel to its plain version on the card
    rejects a causal mask without its diagonal and a 1/hd scale."""
    q, k, v = T.case_inputs(case, "cpu", seed=4)
    want = attention_ref(q, k, v, causal=True)
    T.assert_close(_variant(q, k, v), want, "same")
    with pytest.raises(AssertionError, match="max abs error"):
        T.assert_close(_variant(q, k, v, drop_diagonal=True), want, "diagonal")
    with pytest.raises(AssertionError, match="max abs error"):
        T.assert_close(_variant(q, k, v, scale=1.0 / q.shape[-1]), want, "scale")


def test_plain_in_batches_is_the_plain_version():
    case = (T.PLAIN_BATCH + 3, 2, 1, 64, 64, 32, True, "float32")
    q, k, v = T.case_inputs(case, "cpu", seed=5)
    torch.testing.assert_close(T.plain(q, k, v, True), attention_ref(q, k, v), rtol=0, atol=0)
