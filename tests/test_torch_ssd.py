"""PyTorch port: the SSD chunk scan. The port's plain versions against the
JAX package's Pallas kernel (interpret mode), its oracle and its XLA path,
and the adapter at the model layout; the wrapper's dispatch (a CUDA tensor
never takes the plain version). The CUDA kernel itself is held against
`ssd_chunked_ref` on the card in test_torch_gpu.py and chip_smoke.py.

Inputs come from a numpy seed and go to both packages. Both sides compute
in float32 but in another summation order, so each check bounds the error
relative to the largest output (printed with -s).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd.ops import ssd as jax_ssd_op
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.kernels.ssd.ssd import ssd_kernel as jax_ssd_kernel
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops, ssd, ssd_chunk_scan, ssd_chunked_ref, ssd_ref
from repro_torch.kernels.ssd import testing as ssd_testing
from repro_torch.kernels.ssd.testing import assert_close, kernel_inputs
from repro_torch.models import ssm

#: relative bound of every SSD check here, half the JAX package's own
#: kernel-vs-oracle tolerance (1e-4, tests/test_kernels.py). Within a chunk
#: the cumulative sum of dt * A reaches a few hundred, where one float32 ulp
#: is ~3e-5, and exp(cum_i - cum_j) turns a different rounding of it into a
#: relative error of that order: the chunked forms measure up to 9e-6
#: against the JAX kernel, the sequential forms ~1e-7
REL_TOL = 5e-5

#: (B, H, G, S, P, N): the SSD_CASES shapes of tests/test_kernels.py
SSD_SHAPES = [(2, 4, 2, 256, 32, 16), (1, 8, 1, 128, 64, 32), (1, 2, 2, 384, 32, 16)]


def _kernel_inputs(B, H, G, S, P, N, seed, nonzero_state=False):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, H, S, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H, S)))).astype(f32)  # softplus
    Bm = (rng.standard_normal((B, G, S, N)) * 0.5).astype(f32)
    Cm = (rng.standard_normal((B, G, S, N)) * 0.5).astype(f32)
    A = (-np.exp(rng.uniform(0.0, 1.5, H))).astype(f32)
    s0 = (rng.standard_normal((B, H, N, P)) * (0.5 if nonzero_state else 0.0)).astype(f32)
    return x, dt, Bm, Cm, A, s0


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


#: the three shapes from a zero state, and the first from a non-zero one
CHUNKED_CASES = [(*s, False) for s in SSD_SHAPES] + [(*SSD_SHAPES[0], True)]


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=str)
def test_chunked_ref_matches_jax_kernel(case):
    *shape, nonzero_state = case
    inputs = _kernel_inputs(*shape, seed=sum(shape), nonzero_state=nonzero_state)
    y_j, s_j = jax_ssd_kernel(*map(jnp.asarray, inputs), interpret=True)
    y, s = ssd_chunked_ref(*_torch(*inputs))
    err_y, err_s = _rel(y, y_j), _rel(s, s_j)
    print(f"{case}: y rel err {err_y:.3g}, state rel err {err_s:.3g}")
    assert err_y < REL_TOL and err_s < REL_TOL, (err_y, err_s)


@pytest.mark.parametrize("nonzero_state", [False, True])
def test_sequential_ref_matches_jax_ref(nonzero_state):
    inputs = _kernel_inputs(2, 4, 2, 128, 32, 16, seed=7, nonzero_state=nonzero_state)
    y_j, s_j = jax_ssd_ref(*map(jnp.asarray, inputs))
    y, s = ssd_ref(*_torch(*inputs))
    err_y, err_s = _rel(y, y_j), _rel(s, s_j)
    print(f"sequential: y rel err {err_y:.3g}, state rel err {err_s:.3g}")
    assert err_y < REL_TOL and err_s < REL_TOL
    # and the chunked form is the same recurrence
    y_c, s_c = ssd_chunked_ref(*_torch(*inputs))
    assert _rel(y_c, y) < REL_TOL and _rel(s_c, s) < REL_TOL


def _model_inputs(S: int, seed: int, nonzero_state=False):
    """Model-layout SSD inputs at the reduced mamba2 config's widths."""
    cfg = get_config("mamba2-1.3b", reduced=True)
    g, r = cfg.ssm_ngroups, cfg.ssm_nheads // cfg.ssm_ngroups
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((2, S, g, r, cfg.ssm_headdim)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((2, S, g, r)))).astype(f32)
    Bm = (rng.standard_normal((2, S, g, cfg.ssm_state)) * 0.5).astype(f32)
    Cm = (rng.standard_normal((2, S, g, cfg.ssm_state)) * 0.5).astype(f32)
    A = (-np.exp(rng.uniform(0.0, 1.0, (g, r)))).astype(f32)
    s0 = None
    if nonzero_state:
        s0 = (rng.standard_normal((2, g, r, cfg.ssm_state, cfg.ssm_headdim)) * 0.5).astype(f32)
    return cfg, (x, dt, Bm, Cm, A), s0


@pytest.mark.parametrize("S,nonzero_state", [(64, False), (200, False), (200, True)])
def test_adapter_matches_jax_adapter(S, nonzero_state):
    """`ops.ssd` on the CPU (S padded up to 128 or 256 with dt = 0) against
    the JAX package's adapter running its Pallas kernel in interpret mode."""
    cfg, inputs, s0 = _model_inputs(S, seed=S, nonzero_state=nonzero_state)
    jcfg = jax_get_config("mamba2-1.3b", reduced=True)
    init_j = None if s0 is None else jnp.asarray(s0)
    y_j, s_j = jax_ssd_op(jcfg, *map(jnp.asarray, inputs), init_j, impl="interpret")
    before = ssd.launches
    y, s = ssd(cfg, *_torch(*inputs), None if s0 is None else torch.from_numpy(s0))
    assert ssd.launches == before  # the CPU takes the plain version
    assert tuple(y.shape) == inputs[0].shape and tuple(s.shape) == tuple(s_j.shape)
    err_y, err_s = _rel(y, y_j), _rel(s, s_j)
    print(f"adapter S={S}: y rel err {err_y:.3g}, state rel err {err_s:.3g}")
    assert err_y < REL_TOL and err_s < REL_TOL


@pytest.mark.parametrize("S", [64, 200])
def test_ssd_scan_and_sequential_match_jax(S):
    """The XLA path (`ssd_scan`, chunk cfg.ssm_chunk = 32 with a padded
    tail at S = 200) and the sequential oracle, against the JAX package's."""
    cfg, inputs, s0 = _model_inputs(S, seed=S + 1, nonzero_state=True)
    jcfg = jax_get_config("mamba2-1.3b", reduced=True)
    j_in = tuple(map(jnp.asarray, inputs))
    y_j, s_j = jax_ssm.ssd_scan(jcfg, *j_in, jnp.asarray(s0))
    y, s = ssm.ssd_scan(cfg, *_torch(*inputs), torch.from_numpy(s0))
    print(f"ssd_scan S={S}: y {_rel(y, y_j):.3g}, state {_rel(s, s_j):.3g}")
    assert _rel(y, y_j) < REL_TOL and _rel(s, s_j) < REL_TOL
    y_jq, s_jq = jax_ssm.ssd_reference_sequential(*j_in, jnp.asarray(s0))
    y_q, s_q = ssm.ssd_reference_sequential(*_torch(*inputs), torch.from_numpy(s0))
    print(f"sequential S={S}: y {_rel(y_q, y_jq):.3g}, state {_rel(s_q, s_jq):.3g}")
    assert _rel(y_q, y_jq) < REL_TOL and _rel(s_q, s_jq) < REL_TOL


def test_wrapper_checks_its_inputs():
    x, dt, Bm, Cm, A, s0 = _torch(*_kernel_inputs(1, 2, 1, 128, 32, 16, seed=3))
    with pytest.raises(ValueError, match="multiple of 128"):
        ssd_chunk_scan(x[:, :, :64].contiguous(), dt[:, :, :64].contiguous(),
                       Bm[:, :, :64].contiguous(), Cm[:, :, :64].contiguous(), A, s0)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk_scan(x.double(), dt, Bm, Cm, A, s0)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk_scan(x, dt, Bm, Cm, A, s0.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="groups"):
        ssd_chunk_scan(x, dt, torch.cat([Bm] * 3, 1), torch.cat([Cm] * 3, 1), A, s0)
    # the kernel's m16n8k8 tiles need N and P divisible by 8, on every device
    with pytest.raises(ValueError, match="divisible by 8"):
        ssd_chunk_scan(x, dt, Bm[..., :12].contiguous(), Cm[..., :12].contiguous(), A,
                       s0[:, :, :12].contiguous())
    with pytest.raises(ValueError, match="divisible by 8"):
        ssd_chunk_scan(x[..., :20].contiguous(), dt, Bm, Cm, A, s0[..., :20].contiguous())
    # a tensor on a device that has no kernel raises instead of falling back
    meta = tuple(t.to("meta") for t in (x, dt, Bm, Cm, A, s0))
    with pytest.raises(ValueError, match="no kernel"):
        ssd_chunk_scan(*meta)


def test_kernel_shared_memory_fits_the_main_path():
    # mamba2-1.3b's N = 128, P = 64 is the widest the kernel holds in one
    # block: the sum csrc/ssd.cu states
    assert ops.smem_bytes(128, 64) == 205_840
    assert ops.smem_bytes(128, 64) <= ops.MAX_SMEM_BYTES
    assert ops.smem_bytes(128, 128) > ops.MAX_SMEM_BYTES


def test_kernel_check_sees_a_wrong_decay_or_mask():
    """The bound that holds the kernel to its plain version on the card
    (`kernels/ssd/testing.py`) rejects a 1% wrong decay rate and a causal
    mask that drops the diagonal, at mamba2's widths (H, P, N = 8, 64, 128
    here to stay small on the CPU)."""
    case = (1, 8, 1, 256, 64, 128, True)
    x, dt, Bm, Cm, A, s0 = kernel_inputs(case, "cpu", seed=5)
    want = ssd_chunked_ref(x, dt, Bm, Cm, A, s0)
    assert_close(ssd_chunked_ref(x.clone(), dt, Bm, Cm, A, s0), want, "same")
    with pytest.raises(AssertionError, match="relative error"):
        assert_close(ssd_chunked_ref(x, dt, Bm, Cm, A * 1.01, s0), want, "decay")
    y_nodiag = want[0] - x * dt[..., None] * (Cm * Bm).sum(-1).repeat_interleave(8, 1)[..., None]
    with pytest.raises(AssertionError, match="relative error"):
        assert_close((y_nodiag, want[1]), want, "mask")


#: (bit pattern in, bit pattern out) of cvt.rna.tf32.f32: round to nearest
#: on the low 13 bits, ties away from zero
TF32_PATTERNS = [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero
    (0x3F803000, 0x3F804000),  # a tie above an odd mantissa: away, not to even
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0xBF800FFF, 0xBF800000),  # a negative value below the tie
    (0x3FFFF000, 0x40000000),  # 2 - 2^-12: the carry runs into the exponent
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x7F800000, 0x7F800000),  # inf
]


@pytest.mark.parametrize("bits_in,bits_out", TF32_PATTERNS, ids=lambda b: f"{b:08x}")
def test_tf32_rna_rounds_as_cvt_rna(bits_in, bits_out):
    signed = bits_in - 2**32 if bits_in >= 2**31 else bits_in
    x = torch.tensor([signed], dtype=torch.int32)
    got = ssd_testing.tf32_rna(x.view(torch.float32)).view(torch.int32).item() & 0xFFFFFFFF
    assert got == bits_out, f"{bits_in:08x} -> {got:08x}, expected {bits_out:08x}"


#: the CASES shapes that run on the CPU in seconds, and one head block at
#: mamba2-1.3b's widths (64 heads, N = 128, P = 64; S = 256, B = 1), from a
#: zero and a non-zero state
EMULATION_CASES = [*ssd_testing.CASES[:4], (1, 64, 1, 256, 64, 128, False),
                   (1, 64, 1, 256, 64, 128, True)]


@pytest.mark.parametrize("case", EMULATION_CASES, ids=ssd_testing.case_name)
def test_3xtf32_emulation_meets_the_kernel_bound(case):
    """The kernel's precision scheme on the CPU: all four products in 3xTF32
    (`ssd_chunked_tf32`) stay within the kernel's REL_TOL of the plain
    version, for y and the final state. One TF32 pass is printed beside it
    (with -s) and not asserted."""
    inputs = kernel_inputs(case, "cpu", seed=EMULATION_CASES.index(case))
    want = ssd_chunked_ref(*inputs)
    report = assert_close(ssd_testing.ssd_chunked_tf32(*inputs), want, "3xTF32")
    one = ssd_testing.ssd_chunked_tf32(*inputs, split=False)
    print(f"{ssd_testing.case_name(case)}: 3xTF32 y {report['y']['rel_err']:.3g}, state "
          f"{report['state']['rel_err']:.3g}; one TF32 pass y "
          f"{ssd_testing.rel_err(one[0], want[0]):.3g}, state "
          f"{ssd_testing.rel_err(one[1], want[1]):.3g}")
