"""PyTorch port: the flash-attention gradient on the CPU.

`ref.attention_bwd_ref`, the plain version of the backward kernels
(`csrc/flash_attention_bwd_wgmma.cu` for bf16,
`csrc/flash_attention_bwd_3xbf16.cu` for float32), against `torch.autograd`
through
`attention_ref` and against `jax.vjp` of the JAX package's oracle
(`repro/kernels/flash_attention/ref.py::attention_ref`): in float64 under
`jax.enable_x64` within 1e-12 (the oracle casts its inputs to float32, so
its own code runs with float32 read as float64), and in float32 within
2e-5 of each gradient's largest element (two float32 implementations
summing in other orders; measured <= 4e-7). GQA, causal and full attention
with Sq != Sk, the default and a given scale, a ragged causal S. Then the
wrapper's dispatch (the library of each dtype, the launch counters' kernel
names) and its autograd
Function (`ops.FlashAttention`): its log-sum-exp is `logsumexp` of the
scaled scores, its gradients are `attention_bwd_ref`'s, it works under
`torch.func.vjp`, and a call without grad is the forward alone, the same
bits; its backward is once-differentiable (a second derivative through it
raises on every device); `testing.bwd_errors` sees a wrong gradient and `held_to_plain` a
wrong log-sum-exp; `backward_tap` holds each attention call of a training
step; an emulation of the float32 kernel's 3xBF16 products (its operands
split as its first kernel splits them, `ref.bwd_split_ref`) lies within
the float32 bound where one bf16 pass does not, and one of 3xTF32 (ROADMAP
3i's record) closer still where one TF32 pass does not; the plain version
of the float32 kernel's first kernel (the split within 2^-18 |x|, D and the
padded log-sum-exp rows, `ref.bwd_stats_ref`) against float64; the SSD
and RMSNorm wrappers raise under autograd, naming their ROADMAP items. The
kernel itself runs in test_torch_gpu.py and chip_smoke.py.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.flash_attention.ref as jax_ref_mod
from repro_torch.kernels.flash_attention import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as torch_ref
from repro_torch.kernels.flash_attention import testing as T
from repro_torch.kernels.rmsnorm import rmsnorm_fused
from repro_torch.kernels.ssd import ssd_chunk_scan

#: (B, nq, nkv, Sq, Sk, hd, causal, scale)
CASES = (
    (2, 4, 2, 16, 16, 8, True, None),
    (1, 4, 4, 24, 24, 16, True, 0.3),
    (1, 6, 2, 12, 20, 8, False, None),
    (2, 4, 1, 9, 31, 16, False, 1.0 / math.sqrt(12)),
    (1, 4, 2, 37, 37, 32, True, None),
)


def _case_id(c):
    B, nq, nkv, Sq, Sk, hd, causal, scale = c
    return f"B{B}_nq{nq}_nkv{nkv}_Sq{Sq}_Sk{Sk}_hd{hd}_{'causal' if causal else 'full'}" + (
        "" if scale is None else f"_scale{scale:.3f}")


def _arrays(case, seed, dtype=np.float64):
    B, nq, nkv, Sq, Sk, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, nq, Sq, hd), (B, nkv, Sk, hd), (B, nkv, Sk, hd), (B, nq, Sq, hd))]


def _jax_oracle_f64():
    """The JAX oracle's own code with its float32 casts read as float64."""
    shim = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("_")})
    shim.float32 = jnp.float64
    fn = jax_ref_mod.attention_ref
    return types.FunctionType(fn.__code__, {**fn.__globals__, "jnp": shim}, fn.__name__,
                              fn.__defaults__)


def _jax_vjp(oracle, q, k, v, do, causal, scale):
    """jax.vjp of the oracle, whose scale is 1/sqrt(hd): another scale goes
    in through q (scale * sqrt(hd) * q), and the gradient of q back out."""
    hd = q.shape[-1]
    mult = 1.0 if scale is None else scale * math.sqrt(hd)
    out, vjp = jax.vjp(lambda q_, k_, v_: oracle(q_ * mult, k_, v_, causal=causal), q, k, v)
    return [np.asarray(g) for g in vjp(do)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bwd_ref_matches_jax_vjp_float64(case):
    causal, scale = case[6], case[7]
    q, k, v, do = _arrays(case, seed=sum(case[:6]))
    with jax.enable_x64(True):
        want = _jax_vjp(_jax_oracle_f64(), *(jnp.asarray(a) for a in (q, k, v, do)), causal,
                        scale)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = attention_lse_ref(tq, tk, tv, causal, scale)
    assert o.dtype == lse.dtype == torch.float64
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal, scale)
    errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    print(f"{_case_id(case)} float64 vs jax.vjp: {errs}")
    assert max(errs) <= 1e-12


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bwd_ref_matches_jax_vjp_and_autograd_float32(case):
    causal, scale = case[6], case[7]
    q, k, v, do = _arrays(case, seed=1 + sum(case[:6]), dtype=np.float32)
    want = _jax_vjp(jax_ref_mod.attention_ref, *(jnp.asarray(a) for a in (q, k, v, do)),
                    causal, scale)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = attention_lse_ref(tq, tk, tv, causal, scale)
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal, scale)
    # autograd through the plain forward
    aq, ak, av = (t.clone().requires_grad_() for t in (tq, tk, tv))
    auto = torch.autograd.grad(attention_ref(aq, ak, av, causal, scale), (aq, ak, av), tdo)
    errs_jax = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    errs_auto = [_rel(g.numpy(), a.numpy()) for g, a in zip(got, auto)]
    print(f"{_case_id(case)} float32: vs jax.vjp {errs_jax}, vs autograd {errs_auto}")
    assert max(errs_jax) <= 2e-5 and max(errs_auto) <= 2e-5
    assert all(g.dtype == torch.float32 for g in got)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_function_lse_and_gradients(case):
    causal, scale = case[6], case[7]
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(case, seed=2, dtype=np.float32))
    o, lse = ops.FlashAttention.apply(q, k, v, causal, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(q.shape[1] // k.shape[1], 1))
    s = s * (scale if scale is not None else 1 / math.sqrt(q.shape[-1]))
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(o, attention_ref(q, k, v, causal, scale), rtol=0, atol=0)
    # through the public wrapper under autograd: the Function, not detached
    aq, ak, av = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(aq, ak, av, causal=causal, scale=scale)
    assert out.requires_grad and out.grad_fn is not None
    got = torch.autograd.grad(out, (aq, ak, av), do)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal, scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # without grad: the forward alone, the same bits
    with torch.no_grad():
        torch.testing.assert_close(flash_attention(aq, ak, av, causal=causal, scale=scale), o,
                                   rtol=0, atol=0)
    # torch.func goes through the setup_context-style Function
    _, vjp = torch.func.vjp(lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal,
                                                                scale=scale), q, k, v)
    for g, w in zip(vjp(do), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES[:3])
def test_second_derivative_through_the_kernel_path_raises(case):
    """`FlashAttention.backward` is once-differentiable on every device. On
    the card its kernels fill fresh tensors that carry no graph, so a
    second derivative would silently drop every attention term; the CPU's
    plain backward would carry one. A `create_graph=True` backward through
    it now raises on both, while
    `torch.func.vjp` still reaches the Function and matches
    `attention_bwd_ref` bit for bit (ROADMAP queue 3)."""
    B, nq, nkv, Sq, Sk, hd, causal, scale = case
    q, k, v, do = (torch.from_numpy(a)
                   for a in _arrays((B, nq, nkv, Sq, Sk, hd), 11, np.float32))
    aq, ak, av = (t.clone().requires_grad_() for t in (q, k, v))
    for loss_of in (lambda o: (o * do).sum(), lambda o: (o * do).square().sum()):
        with pytest.raises(RuntimeError, match="once-differentiable"):
            torch.autograd.grad(loss_of(flash_attention(aq, ak, av, causal=causal, scale=scale)),
                                (aq, ak, av), create_graph=True)
        with pytest.raises(RuntimeError, match="once-differentiable"):
            loss_of(flash_attention(aq, ak, av, causal=causal, scale=scale)).backward(
                create_graph=True)
    # the first derivative as before
    loss = (flash_attention(aq, ak, av, causal=causal, scale=scale) * do).square().sum()
    got = torch.autograd.grad(loss, (aq, ak, av))
    # the plain attention (the Hessian action's route) differentiates twice
    rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
    ref_loss = (attention_ref(rq, rk, rv, causal, scale) * do).square().sum()
    gq, gk, gv = torch.autograd.grad(ref_loss, (rq, rk, rv), create_graph=True)
    for g, w in zip(got, (gq, gk, gv)):
        torch.testing.assert_close(g, w.detach(), rtol=1e-5, atol=1e-5)
    second = torch.autograd.grad(gq.square().sum() + gk.sum() + gv.sum(), (rq, rk, rv))
    assert all(bool(g.abs().max() > 0) for g in second)
    o, lse = attention_lse_ref(q, k, v, causal=causal, scale=scale)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal, scale)
    _, vjp = torch.func.vjp(lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal,
                                                                scale=scale), q, k, v)
    for g, w in zip(vjp(do), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_grad_of_the_model_layout():
    """The model passes transposed views and cuts o's columns: the gradient
    of a strided, partly used output."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((1, 4, 2, 16, 16, 32), 3, np.float32))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = flash_attention(*views, causal=True)[..., :24]
    got = torch.autograd.grad(out.sum(), views)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*refs, causal=True)[..., :24].sum(), refs)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= 2e-5


def test_bwd_check_sees_a_wrong_gradient():
    z = T.ZooCase((1, 4, 2, 32, 32, 32, True, "float32"))
    q, k, v, do = T.bwd_inputs(z, "cpu")
    o, lse = ops._forward(q, k, v, True, None, want_lse=True)
    right = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    T.bwd_errors(right, T.plain_bwd(q, k, v, o, lse, do, True), "float32", "right")
    for i, wrong in ((0, right[0] * 1.001), (1, right[1] * 0.0), (2, torch.roll(right[2], 1, 2))):
        bad = list(right)
        bad[i] = wrong
        with pytest.raises(AssertionError, match="largest element"):
            T.bwd_errors(bad, right, "float32", "wrong")
    # the wrong scale or a dropped diagonal in the gradient
    with pytest.raises(AssertionError):
        T.bwd_errors(flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=0.2), right,
                     "float32", "scale")
    with pytest.raises(AssertionError):
        T.bwd_errors(flash_attention_bwd(q, k, v, o, lse, do, causal=False), right, "float32",
                     "mask")


def test_bwd_check_sees_a_wrong_lse():
    """The forward's log-sum-exp is held to the plain forward's, and the
    plain backward runs from the plain forward's own o and log-sum-exp: a
    backward fed a wrong log-sum-exp agrees with a plain backward fed the
    same one (the comparison on shared saved tensors is blind to it), but
    `held_to_plain` fails it, by the LSE bound and by the gradients."""
    z = T.ZooCase((1, 4, 2, 32, 32, 32, True, "float32"))
    q, k, v, do = T.bwd_inputs(z, "cpu")
    report = T.check_bwd(q, k, v, do, True, None, "right")
    assert report["lse_max_abs_err"] <= T.LSE_ATOL and report["lse_bound"] == T.LSE_ATOL
    o, lse = ops._forward(q, k, v, True, None, want_lse=True)
    for offset in (1e-3, 0.05):
        bad = flash_attention_bwd(q, k, v, o, lse + offset, do, causal=True)
        T.bwd_errors(bad, T.plain_bwd(q, k, v, o, lse + offset, do, True), "float32", "blind")
        with pytest.raises(AssertionError, match="lse: max abs error"):
            T.held_to_plain(q, k, v, lse + offset, do, bad, True)
    # past the LSE bound's reach too: the gradients alone see the offset
    bad = flash_attention_bwd(q, k, v, o, lse + 0.05, do, causal=True)
    with pytest.raises(AssertionError, match="largest element"):
        T.bwd_errors(bad, T.plain_bwd(q, k, v, *T.plain_forward(q, k, v, True), do, True),
                     "float32", "own")
    with pytest.raises(AssertionError, match="lse"):
        T.lse_error(lse[:, :1], lse, "shape")


def test_backward_tap_holds_every_attention_call(monkeypatch):
    """`testing.backward_tap` (chip_smoke.py's in-situ check of a training
    step) sees each attention call of a reduced qwen3 step once, on the
    kernel path's `FlashAttention` under `remat="full"` (whose checkpoint
    lets a backward unpack its saved tensors only once), and flags a wrong
    backward without stopping the step."""
    from repro_torch.configs import get_config
    from repro_torch.models import model

    cfg = get_config("qwen3-0.6b", reduced=True).replace(remat="full")  # as published
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    batch = model.make_synth_batch(cfg, 2, 32, torch.Generator().manual_seed(1))
    with T.backward_tap() as seen:
        _, _, grads = model.loss_and_grads(cfg, params, batch)
    assert len(seen) == cfg.n_layers
    assert all("error" not in e and max(e[g]["rel"] for g in ("dq", "dk", "dv")) <= 1e-6
               for e in seen), seen
    assert ops.FlashAttention.backward is ops.FlashAttention.__dict__["backward"].__func__
    real = ops.flash_attention_bwd

    def wrong(*a, **kw):
        dq, dk, dv = real(*a, **kw)
        return dq * 1.01, dk, dv

    monkeypatch.setattr(ops, "flash_attention_bwd", wrong)
    with T.backward_tap() as seen:
        model.loss_and_grads(cfg, params, batch)
    assert len(seen) == cfg.n_layers and all("dq" in e["error"] for e in seen)


def _split_bf16(x):
    """x = hi + lo within 2^-17 |x|: the float32 backward kernel's 3xBF16
    operands, as its first kernel writes them (`ref.bwd_split_ref`)."""
    return tuple(t.float() for t in torch_ref.bwd_split_ref(x))


def _mm_3xbf16(a, b):
    (ah, al), (bh, bl) = _split_bf16(a), _split_bf16(b)
    return ah @ bh + (ah @ bl + al @ bh)


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    (ab, bb) = _tf32(a), _tf32(b)
    (asm, bsm) = _tf32(a - ab), _tf32(b - bb)
    return ab @ bb + (ab @ bsm + asm @ bb)


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _mm_1xbf16(a, b):
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def _bwd_emulated(q, k, v, o, lse, do, scale, mm):
    """`attention_bwd_ref`'s arithmetic (causal, GQA) with each of its five
    products done by `mm`: the float32 backward kernel's on the tensor
    cores."""
    g = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(g, 1) for t in (k, v))
    s = mm(q, kr.transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - lse[..., None])
    d = (do * o).sum(-1, keepdim=True)
    dv = mm(p.transpose(-1, -2), do)
    ds = p * (mm(do, vr.transpose(-1, -2)) - d)
    dk = mm(ds.transpose(-1, -2), q) * scale
    dq = mm(ds, kr) * scale
    B, nkv, Sk, hd = k.shape
    fold = lambda t: t.reshape(B, nkv, g, Sk, hd).sum(2)  # noqa: E731
    return dq, fold(dk), fold(dv)


def test_float32_bwd_precision_3xbf16_and_its_control():
    """The float32 backward kernel multiplies in 3xBF16 (hi*hi + hi*lo +
    lo*hi, ~2^-16 of each term, coarser than the forward's 3xTF32). An
    emulation of that arithmetic at the hd-128 float32 case's small
    counterpart lies within BWD_RTOL["float32"] (1e-4) of the plain
    backward; the control, one bf16 pass for every product, does not: the
    bound tells float32-grade products from bf16 ones."""
    z = T.ZooCase((1, 4, 2, 256, 256, 128, True, "float32"))
    q, k, v, do = T.bwd_inputs(z, "cpu", seed=5)
    o, lse = attention_lse_ref(q, k, v, True)
    want = attention_bwd_ref(q, k, v, o, lse, do, True)
    scale = 1.0 / math.sqrt(128)
    three = _bwd_emulated(q, k, v, o, lse, do, scale, _mm_3xbf16)
    one = _bwd_emulated(q, k, v, o, lse, do, scale, _mm_1xbf16)
    e3 = [_rel(g.numpy(), w.numpy()) for g, w in zip(three, want)]
    e1 = [_rel(g.numpy(), w.numpy()) for g, w in zip(one, want)]
    print(f"float32 backward, 3xBF16 {e3}, one bf16 pass {e1} (bound {T.BWD_RTOL['float32']})")
    assert max(e3) <= T.BWD_RTOL["float32"] / 4
    assert min(e1) > T.BWD_RTOL["float32"]


def test_float32_bwd_precision_3xtf32_record():
    """ROADMAP 3i's record: at the same case, 3xTF32 products (big*big +
    big*small + small*big, each part rounded to TF32) lie an order of
    magnitude closer to the plain backward than the kernel's 3xBF16 (~1e-6
    against ~1.4e-5), and one TF32 pass misses the float32 bound as one
    bf16 pass does. The kernel stays 3xBF16: wgmma reads a tf32 operand
    K-major only, and the backward's transposed operands would need a
    second float32 copy of each tile (flash_attention_bwd_3xbf16.cu's
    note)."""
    z = T.ZooCase((1, 4, 2, 256, 256, 128, True, "float32"))
    q, k, v, do = T.bwd_inputs(z, "cpu", seed=5)
    o, lse = attention_lse_ref(q, k, v, True)
    want = attention_bwd_ref(q, k, v, o, lse, do, True)
    scale = 1.0 / math.sqrt(128)
    errs = {name: [_rel(g.numpy(), w.numpy()) for g, w in
                   zip(_bwd_emulated(q, k, v, o, lse, do, scale, mm), want)]
            for name, mm in (("3xtf32", _mm_3xtf32), ("3xbf16", _mm_3xbf16),
                             ("1xtf32", _mm_1xtf32))}
    print(f"float32 backward: {errs} (bound {T.BWD_RTOL['float32']})")
    assert max(errs["3xtf32"]) <= T.BWD_RTOL["float32"] / 20
    assert max(errs["3xtf32"]) < max(errs["3xbf16"]) / 4
    assert min(errs["1xtf32"]) > T.BWD_RTOL["float32"]


def test_bwd_split_ref_within_its_bound():
    """The float32 backward's first kernel's split (`ref.bwd_split_ref`):
    hi = bf16(x), lo = bf16(x - hi) with x - hi exact in float32, hi + lo
    within 2^-17 |x| of x over magnitudes from 1e-25 to 1e25 (the bound in
    flash_attention_bwd_3xbf16.cu's note; it holds while |x| is above
    ~2^-116, where a subnormal lo part still lies within it), and within
    2^-8 |x| with hi alone, which the lo part exists to close. The bound is
    reached: x = 1 + 2^-9 + 2^-17 splits into hi = 1 and lo = 2^-9 (a tie to
    even), 2^-17 short."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(20000) * 10.0 ** rng.integers(-25, 26, 20000)
    tight = 1 + 2.0 ** -9 + 2.0 ** -17
    x = torch.from_numpy(np.concatenate([x, [0.0, 1.0, -3.0, 2.0 ** -100, tight]])).float()
    hi, lo = torch_ref.bwd_split_ref(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert torch.equal(lo, (xd - hd).float().to(torch.bfloat16))  # x - hi exact in float32
    err = (hd + ld - xd).abs()
    assert bool((err <= 2.0 ** -17 * xd.abs()).all())
    assert bool(((hd - xd).abs() <= 2.0 ** -8 * xd.abs()).all())
    assert float(err[-1]) == 2.0 ** -17 and (float(hd[-1]), float(ld[-1])) == (1.0, 2.0 ** -9)
    assert float(((hd - xd).abs() / xd.abs().clamp_min(1e-300)).max()) > 2.0 ** -10


@pytest.mark.parametrize("case", [(2, 4, 2, 37, 37, 32), (1, 2, 1, 128, 96, 64),
                                  (1, 2, 2, 129, 129, 16)], ids=str)
def test_bwd_stats_ref_rows_and_padding(case):
    """The rows' statistics of the backward's first kernel
    (`ref.bwd_stats_ref`): [2, B, nq, Sq_pad] float32 with Sq rounded up to
    BWD_ROW_PAD (128); row i < Sq holds the log-sum-exp times log2(e) (the
    same float32 product as the kernel's) and D = rowsum(do * o) (within
    float32 rounding of float64); every padding row +inf and 0, so a kernel
    reading a whole tile past Sq gets P = 0 and dS = 0 there."""
    B, nq, nkv, Sq, Sk, hd = case
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(case, 12, np.float32))
    o, lse = attention_lse_ref(q, k, v, False)
    st = torch_ref.bwd_stats_ref(o, do, lse)
    pad = -(-Sq // torch_ref.BWD_ROW_PAD) * torch_ref.BWD_ROW_PAD
    assert st.shape == (2, B, nq, pad) and st.dtype == torch.float32
    assert torch.equal(st[0, ..., :Sq], lse * np.float32(1.4426950408889634))
    dsum = (do.double() * o.double()).sum(-1)
    assert float((st[1, ..., :Sq].double() - dsum).abs().max()) <= 1e-5 * float(
        dsum.abs().max())
    assert bool(torch.isinf(st[0, ..., Sq:]).all()) and bool((st[0, ..., Sq:] > 0).all())
    assert bool((st[1, ..., Sq:] == 0).all())
    # P = exp2(scale log2(e) s - lse2) on a padding row: 0 whatever the score
    assert float(torch.exp2(torch.tensor(5.0) - st[0, 0, 0, -1])) == 0.0 or Sq == pad


def test_bwd_wrapper_checks():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((1, 2, 1, 8, 8, 8), 4, np.float32))
    o, lse = ops._forward(q, k, v, True, None, want_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd(q, k, v, o[:, :1], lse, do)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, o, lse, do.double())
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention_bwd(q, k[:, :, :4], v[:, :, :4], o, lse, do, causal=True)
    assert [n for names in ops.BWD_KERNELS.values() for n in names] == \
        list(flash_attention_bwd.launches_by_kernel)


def test_bwd_dispatch_by_dtype():
    """The card's backward library by dtype, as a pure function: bf16 to the
    wgmma library, float32 to the 3xBF16 wgmma one, any other dtype raises
    (no fallback); each is a kernel source of the port built with its ptxas
    log, and the mma.sync float32 source is gone."""
    from repro_torch.kernels import _build

    assert ops.bwd_stem(torch.bfloat16) == "flash_attention_bwd_wgmma"
    assert ops.bwd_stem(torch.float32) == "flash_attention_bwd_3xbf16"
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ops.bwd_stem(dtype)
    assert set(ops.BWD_KERNEL_OF) == set(ops.KERNEL_OF)
    sources = _build.sources()
    for stem in ops.BWD_KERNEL_OF.values():
        assert stem in sources and "-v" in _build.flags(stem)
    assert "flash_attention_bwd" not in sources
    assert '#include "wgmma_tma.cuh"' in sources["flash_attention_bwd_3xbf16"].read_text()


def test_bwd_launch_counter_names():
    """The launch counters name each library's three kernels, in launch
    order (the rows' statistics, dK/dV, dQ), after their library; the bf16
    path counts only the wgmma library's, so a run shows which one it took.
    CPU calls count nothing."""
    assert set(ops.BWD_KERNELS) == set(ops.BWD_KERNEL_OF.values())
    assert ops.BWD_KERNELS["flash_attention_bwd_wgmma"] == (
        "flash_attention_bwd_wgmma_stats", "flash_attention_bwd_wgmma_dkdv",
        "flash_attention_bwd_wgmma_dq")
    assert ops.BWD_KERNELS["flash_attention_bwd_3xbf16"] == (
        "flash_attention_bwd_3xbf16_split", "flash_attention_bwd_3xbf16_dkdv",
        "flash_attention_bwd_3xbf16_dq")
    for stem, names in ops.BWD_KERNELS.items():
        assert len(names) == 3 and all(n.startswith(stem + "_") for n in names)
        assert [n.removeprefix(stem + "_") for n in names][1:] == ["dkdv", "dq"]
    names = [n for ns in ops.BWD_KERNELS.values() for n in ns]
    assert len(set(names)) == 6 and set(flash_attention_bwd.launches_by_kernel) == set(names)
    before = dict(flash_attention_bwd.launches_by_kernel), flash_attention_bwd.launches
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((1, 2, 1, 8, 8, 8), 6, np.float32))
    o, lse = ops._forward(q, k, v, True, None, want_lse=True)
    flash_attention_bwd(q, k, v, o, lse, do)
    assert (dict(flash_attention_bwd.launches_by_kernel), flash_attention_bwd.launches) == before


def test_ssd_and_rmsnorm_raise_under_autograd():
    x = torch.randn(1, 2, 128, 8, requires_grad=True)
    dt = torch.rand(1, 2, 128)
    Bm, Cm = torch.randn(1, 1, 128, 8), torch.randn(1, 1, 128, 8)
    A, s0 = -torch.rand(2), torch.zeros(1, 2, 8, 8)
    with pytest.raises(RuntimeError, match="13e"):
        ssd_chunk_scan(x, dt, Bm, Cm, A, s0)
    with torch.no_grad():
        y, _ = ssd_chunk_scan(x, dt, Bm, Cm, A, s0)  # no grad wanted: the plain version
    assert not y.requires_grad
    w = torch.ones(16, requires_grad=True)
    with pytest.raises(RuntimeError, match="4a"):
        rmsnorm_fused(torch.randn(4, 16), w)
    with torch.no_grad():
        rmsnorm_fused(torch.randn(4, 16), w)


class _FakeBwdLib:
    """Both backward libraries' C entry points and scratch getters,
    recording their arguments; each getter answers `scratch` values."""

    def __init__(self, scratch: int):
        self.calls, self.asked = [], []
        lib = self

        class Entry:
            argtypes = restype = None

            def __call__(self, *args):
                lib.calls.append(args)
                return 0

        class Scratch:
            argtypes = restype = None

            def __call__(self, *args):
                lib.asked.append(args)
                return scratch

        for stem in ops.BWD_KERNELS:
            setattr(self, stem, Entry())
            setattr(self, f"{stem}_scratch", Scratch())


@pytest.mark.parametrize("stem", ["flash_attention_bwd_3xbf16", "flash_attention_bwd_wgmma"])
def test_launch_bwd_takes_the_library_scratch_and_counts_three(monkeypatch, stem):
    """`ops._launch_bwd` asks the dtype's library for its scratch size
    (`<stem>_scratch`: bf16 `(B, nq, Sq)`, float32 `(B, nq, Sq, nkv, Sk,
    hd)`, whose scratch also holds the bf16 parts of q, k, v and dO; the
    layout lives in the .cu file alone), hands the entry point a float32
    scratch of that size, the scale (1/sqrt(hd) unless told otherwise) and
    then the stream, and counts each of that library's three kernels once
    and no other."""
    import ctypes

    from repro_torch.kernels import _build

    fake = _FakeBwdLib(scratch=4321)
    monkeypatch.setattr(ops, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    sizes = []
    empty = torch.empty

    def recording_empty(*args, **kw):
        t = empty(*args, **kw)
        sizes.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    dtype = torch.bfloat16 if stem.endswith("wgmma") else torch.float32
    q = torch.zeros(1, 2, 16, 64, dtype=dtype)
    k = torch.zeros(1, 1, 24, 64, dtype=dtype)
    lse = torch.zeros(1, 2, 16)
    before = dict(flash_attention_bwd.launches_by_kernel)
    dq, dk, dv = ops._launch_bwd(q, k, k, q, lse, q, False, None)
    asked = (1, 2, 16, 1, 24, 64)[:ops.BWD_SCRATCH_ARGS[stem]]
    assert fake.asked == [asked] and sizes == [((4321,), torch.float32)]
    assert ops._fns[f"{stem}_scratch"].argtypes == [ctypes.c_int] * len(asked)
    assert ops._fns[stem].argtypes[-3:] == [ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
    assert fake.calls[-1][-2] == 1 / math.sqrt(64) and fake.calls[-1][-3] == 0
    assert fake.calls[-1][10:16] == (1, 2, 1, 16, 24, 64)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert {n: c - before[n] for n, c in flash_attention_bwd.launches_by_kernel.items()} == \
        {n: int(n in ops.BWD_KERNELS[stem]) for n in before}
