"""PyTorch port: flash attention. The port's plain version (the kernels'
CPU path) against the JAX package's oracle and its Pallas kernel in
interpret mode, the wrapper's dispatch and checks (the model layout read
through strides, and the layout check the card runs before a launch), the
error budget of the bf16 tensor-core kernel's one extra rounding, and the
check that holds the CUDA kernels to their plain version on the card
(`repro_torch.kernels.flash_attention.testing`; the kernels themselves run
in test_torch_gpu.py and chip_smoke.py).

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
from repro_torch.kernels.flash_attention.ops import check_layout

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


@pytest.mark.parametrize("case", [T.FLASH_CASES[0], T.FLASH_CASES[4], T.EDGE_CASES[0]],
                         ids=T.case_name)
def test_kernel_check_sees_a_dropped_diagonal_or_a_wrong_scale(case):
    """The bound that holds the kernel to its plain version on the card
    rejects a causal mask without its diagonal and a 1/hd scale."""
    q, k, v = T.case_inputs(case, "cpu", seed=4)
    want = attention_ref(q, k, v, causal=True)
    T.assert_close(T.variant(q, k, v), want, "same")
    with pytest.raises(AssertionError, match="max abs error"):
        T.assert_close(T.variant(q, k, v, drop_diagonal=True), want, "diagonal")
    with pytest.raises(AssertionError, match="max abs error"):
        T.assert_close(T.variant(q, k, v, scale=1.0 / q.shape[-1]), want, "scale")


def test_plain_in_batches_is_the_plain_version():
    case = (T.PLAIN_BATCH + 3, 2, 1, 64, 64, 32, True, "float32")
    q, k, v = T.case_inputs(case, "cpu", seed=5)
    torch.testing.assert_close(T.plain(q, k, v, True), attention_ref(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_wrapper_reads_the_model_layout_through_strides(dt):
    """q, k, v as [B, n, S, hd] views of [B, S, n, hd] tensors (the model's
    layout) give what their contiguous copies give, and o comes back in
    q's memory order: a [B, S, nq, hd] buffer seen through the same
    transpose."""
    B, nq, nkv, S, hd = 2, 4, 2, 96, 32
    rng = np.random.default_rng(0)
    q_m, k_m, v_m = (torch.from_numpy(rng.standard_normal((B, S, n, hd)).astype(np.float32))
                     .to(_TORCH[dt]) for n in (nq, nkv, nkv))
    q, k, v = q_m.transpose(1, 2), k_m.transpose(1, 2), v_m.transpose(1, 2)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.stride() == q.stride()
    assert got.transpose(1, 2).is_contiguous()
    assert want.is_contiguous()


def test_layout_check_takes_strided_views_and_raises_on_the_rest():
    """The check the CUDA path runs before a launch, on CPU tensors: it
    looks only at shapes, strides and data pointers."""
    B, S, nq, hd = 2, 64, 4, 32
    for dt in (torch.float32, torch.bfloat16):
        model = torch.zeros(B, S, nq, hd, dtype=dt)
        check_layout(model.transpose(1, 2), model.transpose(1, 2).contiguous())
        # hd not contiguous: the kernels read 16-byte vectors along it
        with pytest.raises(ValueError, match="stride 1"):
            check_layout(torch.zeros(B, nq, hd, S, dtype=dt).transpose(2, 3))
        # rows 34 elements apart: 136 bytes in float32, 68 in bf16
        with pytest.raises(ValueError, match="multiples of 16 bytes"):
            check_layout(torch.zeros(B, nq, S, hd + 2, dtype=dt)[..., :hd])
        # a base address 4 bytes past an aligned one
        flat = torch.zeros(B * nq * S * hd + 8, dtype=dt)
        with pytest.raises(ValueError, match="aligned"):
            check_layout(flat[4 // flat.element_size():][:B * nq * S * hd].view(B, nq, S, hd))
    # a dimension of length 1 may have any stride
    check_layout(torch.zeros(1, 8, 5, hd)[:, :1].expand(1, 1, 5, hd))


def _attention_bf16_p(q, k, v, causal: bool) -> torch.Tensor:
    """The tensor-core kernel's arithmetic: scores in float32, p = exp(s -
    max) rounded to bf16 before P V, the row sum and the division in
    float32, the output rounded to bf16."""
    hd = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(group, 1).float(), v.repeat_interleave(group, 1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / hd ** 0.5
    if causal:
        S = q.shape[2]
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v) / p.sum(-1, keepdim=True)
    return o.to(q.dtype)


@pytest.mark.parametrize("case", [T.FLASH_CASES[4], (1, 16, 8, 2048, 2048, 128, True, "bfloat16")],
                         ids=T.case_name)
def test_bf16_probabilities_stay_within_the_error_budget(case):
    """Rounding P to bf16 before P V (the one rounding the tensor-core
    kernel adds) keeps the output within the JAX package's bf16 bound of
    the plain version, at the bf16 FLASH_CASES case and at one sequence of
    qwen3-0.6b's attention; inputs from numpy seed 0."""
    _, (q, k, v) = _inputs(case, seed=0)
    want = attention_ref(q, k, v, causal=case[6])
    err = _err(_attention_bf16_p(q, k, v, case[6]), want.float().numpy())
    print(f"{T.case_name(case)}: P in bf16 vs plain {err:.3g}")
    assert err <= T.ATOL["bfloat16"]


def test_kernel_check_sees_a_one_percent_scale_at_the_main_path_shape():
    """At one sequence of qwen3-0.6b's attention a scale 1% off moves
    outputs past the bf16 bound (the GPU tests hold the kernel's own output
    to the same check)."""
    case = (1, 16, 8, 2048, 2048, 128, True, "bfloat16")
    q, k, v = T.case_inputs(case, "cpu", seed=4)
    want = attention_ref(q, k, v, causal=True)
    with pytest.raises(AssertionError, match="max abs error"):
        T.assert_close(T.variant(q, k, v, scale=1.01 * 128 ** -0.5), want, "scale")


#: small counterparts of the float32 cases (T.F32_CASES): the float32 path's
#: [26, 4, 2, 512, 32] at 2 sequences of 128, and qwen3-0.6b's
#: [2, 16, 8, 2048, 128] at its group size 2, 4 heads and 256 tokens
F32_SMALL_CASES = ((2, 4, 2, 128, 128, 32, True, "float32"),
                   (1, 4, 2, 256, 256, 128, True, "float32"))


@pytest.mark.parametrize("case", F32_SMALL_CASES, ids=T.case_name)
def test_plain_matches_jax_kernel_and_oracle_at_the_float32_cases(case):
    causal = case[6]
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=sum(case[:6]))
    got = flash_attention(q, k, v, causal=causal)
    err_kernel = _err(got, jax_flash(jq, jk, jv, causal=causal, impl="interpret"))
    err_oracle = _err(got, jax_attention_ref(jq, jk, jv, causal=causal))
    print(f"{T.case_name(case)}: vs Pallas interpret {err_kernel:.3g}, vs oracle {err_oracle:.3g}")
    assert err_kernel <= T.ATOL["float32"] and err_oracle <= T.ATOL["float32"]


def _split_tf32(x: np.ndarray):
    """The float32 kernel's split of csrc/flash_attention.cu (ssd.cu's):
    big = x rounded to TF32 (half an ulp added, low 13 bits cleared); small
    = x - big with half an ulp added, of which the tensor core reads the
    top 19 bits. Returns both as the float32 values the tensor core uses."""
    bits = x.astype(np.float32).view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    small_bits = ((x.astype(np.float32) - big).view(np.uint32) + np.uint32(0x1000))
    small = (small_bits & np.uint32(0xFFFFE000)).view(np.float32)
    return big, small


def _mm(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b with TF32 operands: 3 passes (small*big + big*small +
    big*big) or 1 (big*big); each product of two TF32 values is exact in
    float32, the sums are taken in float64 here."""
    (ab, as_), (bb, bs) = _split_tf32(a), _split_tf32(b)
    terms = [(as_, bb), (ab, bs), (ab, bb)] if passes == 3 else [(ab, bb)]
    return sum(x.astype(np.float64) @ y.astype(np.float64) for x, y in terms).astype(np.float32)


def _attention_tf32(q, k, v, passes: int) -> np.ndarray:
    """Causal attention with the kernel's arithmetic: q scaled by
    log2(e) / sqrt(hd) and split, q k^T and P V on TF32 operands, the
    softmax in float32 (exp2), o = acc / l."""
    group = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, group, 1), np.repeat(v, group, 1)
    S, hd = q.shape[2], q.shape[3]
    qs = q * np.float32(1.4426950408889634 / np.sqrt(hd))
    s = _mm(qs, np.swapaxes(k, -1, -2), passes)
    s = np.where(np.tril(np.ones((S, S), bool)), s, np.float32(-1e30))
    p = np.exp2(s - s.max(-1, keepdims=True)).astype(np.float32)
    return _mm(p, v, passes) / p.sum(-1, keepdims=True, dtype=np.float32)


def test_3xtf32_keeps_the_float32_bound_where_one_tf32_pass_misses_it():
    """The float32 kernel's products in 3xTF32 (its split and its three
    passes, emulated in numpy) stay within the float32 bound of the plain
    version at the small counterpart of qwen3-0.6b's width; one TF32 pass
    (big * big) does not, which is why the kernel pays for three."""
    case = F32_SMALL_CASES[1]
    _, (q, k, v) = _inputs(case, seed=7)
    want = attention_ref(q, k, v, causal=True).numpy()
    qn, kn, vn = q.numpy(), k.numpy(), v.numpy()
    err3 = float(np.abs(_attention_tf32(qn, kn, vn, 3) - want).max())
    err1 = float(np.abs(_attention_tf32(qn, kn, vn, 1) - want).max())
    print(f"{T.case_name(case)}: 3xTF32 {err3:.3g}, one TF32 pass {err1:.3g}")
    assert err3 <= T.ATOL["float32"] / 4
    assert err1 > T.ATOL["float32"]


# -- the softmax scale (MLA reaches the kernels with 1/sqrt(96) at hd 128) --


@pytest.mark.parametrize("case", [T.FLASH_CASES[0], T.EDGE_CASES[3]], ids=T.case_name)
def test_plain_version_at_another_scale_matches_the_jax_oracle(case):
    """`attention_ref(scale=s)` is the JAX oracle (fixed at 1/sqrt(hd)) on
    q scaled by s * sqrt(hd); without `scale` it is unchanged."""
    causal, dt = case[6], case[7]
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=11)
    s = 0.37 / np.sqrt(case[5])
    got = attention_ref(q, k, v, causal=causal, scale=s)
    want = jax_attention_ref((jq.astype(jnp.float32) * (s * np.sqrt(case[5]))).astype(jq.dtype),
                             jk, jv, causal=causal)
    err = _err(got, want.astype(jnp.float32))
    print(f"{T.case_name(case)} at scale {s:.4g}: vs oracle {err:.3g}")
    assert err <= T.ATOL[dt]
    torch.testing.assert_close(attention_ref(q, k, v, causal=causal, scale=None),
                               attention_ref(q, k, v, causal=causal), rtol=0, atol=0)


def test_wrapper_passes_the_scale_and_checks_it():
    q, k, v = T.case_inputs((1, 4, 2, 64, 64, 32, True, "float32"), "cpu", seed=3)
    for s in (0.1, 0.5):
        torch.testing.assert_close(flash_attention(q, k, v, scale=s),
                                   attention_ref(q, k, v, scale=s), rtol=0, atol=0)
    for bad in (0.0, -0.2, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="scale"):
            flash_attention(q, k, v, scale=bad)


class _FakeLib:
    """A kernel library whose entry points record their arguments."""

    def __init__(self):
        self.calls = []
        lib = self

        class Entry:
            def __call__(self, *args):
                lib.calls.append(args)
                return 0

        self.flash_attention_fwd = Entry()
        self.flash_attention_wgmma_fwd = Entry()


@pytest.mark.parametrize("stem", ["flash_attention", "flash_attention_wgmma"])
def test_c_entry_points_take_the_scale_as_a_double(monkeypatch, stem):
    """Both C entry points are declared with a double `scale` right before
    the stream, and `launch` passes 1/sqrt(hd) unless told otherwise."""
    import ctypes
    import types

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    fake = _FakeLib()
    monkeypatch.setattr(ops, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    fn = ops._kernel(stem)
    assert fn.argtypes[-2:] == [ctypes.c_double, ctypes.c_void_p]
    assert fn.argtypes[-3] == ctypes.c_int  # causal
    q = torch.zeros(1, 2, 16, 128, dtype=torch.bfloat16)
    ops.launch(stem, q, q, q, torch.empty_like(q), True)
    ops.launch(stem, q, q, q, torch.empty_like(q), True, 1 / np.sqrt(96))
    assert [c[-2] for c in fake.calls] == [1 / np.sqrt(128), 1 / np.sqrt(96)]


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_default_scale_gives_the_kernels_their_old_constant(hd):
    """The kernels fold the scale into log2(e) * scale in float32; at every
    head dim they are built for, 1/sqrt(hd) gives the bits of the constant
    log2(e) / sqrt(hd) they fixed before the scale was an argument, so a
    default call computes what it computed, bit for bit."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, default_scale

    assert hd in HEAD_DIMS
    log2e = 1.4426950408889634
    assert np.float32(log2e * default_scale(hd)) == np.float32(log2e / np.sqrt(hd))


@pytest.mark.parametrize("arch", list(T.ZOO_CASES))
def test_zoo_cases_and_their_padding(arch):
    """The LM zoo's cases at one sequence and 128 tokens: the padded
    columns are zero, and the padded MLA case is the same function as MLA at
    its own widths (96 and 64 columns) at scale 1/sqrt(96); the check sees a
    kernel that ignores the scale (1/sqrt(128))."""
    zoo = T.ZOO_CASES[arch]
    B, nq, nkv, Sq, Sk, hd, causal, _ = zoo.case
    case = (1, nq, nkv, 128, 128 if causal else 100, hd, causal, "float32")
    q, k, v = T.case_inputs(case, "cpu", seed=2, widths=zoo.widths)
    got = T.plain(q, k, v, causal, zoo.scale)
    if zoo.widths is None:
        torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal), rtol=0, atol=0)
        return
    dqk, dv = zoo.widths
    assert not q[..., dqk:].any() and not k[..., dqk:].any() and not v[..., dv:].any()
    assert zoo.scale == 1 / np.sqrt(dqk)
    native = attention_ref(q[..., :dqk], k[..., :dqk], v[..., :dv].contiguous(), causal=causal,
                           scale=zoo.scale)
    torch.testing.assert_close(got[..., :dv], native, rtol=1e-6, atol=1e-6)
    assert not got[..., dv:].any()
    with pytest.raises(AssertionError, match="max abs error"):
        T.assert_close(T.plain(q, k, v, causal), got, "scale")


def test_library_name_covers_the_shared_header(tmp_path, monkeypatch):
    """A kernel library's name hashes its source, its flags and the headers
    its `#include "..."` lines name: both wgmma kernels (forward and
    backward) include `csrc/wgmma_tma.cuh`, so an edited header rebuilds
    each of them, and a source beside it that does not include it keeps its
    library."""
    from repro_torch.kernels import _build

    for stem in ("flash_attention_wgmma", "flash_attention_bwd_wgmma"):
        src = _build.sources()[stem]
        assert '#include "wgmma_tma.cuh"' in src.read_text()
        assert (src.parent / "wgmma_tma.cuh").is_file()
    csrc = tmp_path / "flash" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n#include "h.cuh"\n')
    (csrc / "b.cu").write_text("#include <cuda_runtime.h>\n")
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    assert _build.local_headers(csrc / "a.cu") == [csrc / "h.cuh"]
    before = {s: _build.library_path(s) for s in ("a", "b")}
    assert {s: _build.library_path(s) for s in ("a", "b")} == before
    (csrc / "h.cuh").write_text("// two\n")
    assert _build.library_path("a") != before["a"]
    assert _build.library_path("b") == before["b"]
