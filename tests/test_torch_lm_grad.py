"""PyTorch port: `LMUQModel`'s derivative surface against the JAX package
(checks and bounds in `_torch_lm_grad.py`), for qwen3-0.6b on both port
paths (`attn_impl="kernel"`: on the CPU the flash wrapper's autograd
Function, `attention_lse_ref` forward and `attention_bwd_ref` backward;
`"plain"`), mamba2-1.3b (its first derivatives on the plain SSD) and
minicpm3-4b (MLA). Also: a central finite difference of `evaluate_batch`
against the gradient, independent of either autodiff; which kernels each
wave reaches (the gradient wave the flash forward once a layer, twice under
`remat="full"`, and its backward once; the Hessian wave and mamba2's
gradient no flash and no SSD kernel); `remat="full"` gives the derivatives
of `"none"` bit for bit. The deepseek, zamba2 and llama families are in
`test_torch_lm_grad_zoo.py`.
"""
import numpy as np
import pytest
import torch

import _torch_lm_grad as G
from repro_torch.apps.lm_model import LMUQModel

torch.set_num_threads(1)

CASES = [("qwen3-0.6b", "kernel"), ("qwen3-0.6b", "plain"), ("mamba2-1.3b", "kernel"),
         ("minicpm3-4b", "kernel")]
#: central differences of the float32 NLL at step 2^-7: truncation and
#: round-off measured 2.1e-4 of the largest gradient (2^-6: 6.8e-4, 2^-8:
#: 3.3e-4)
FD_STEP = 2.0 ** -7
FD_RTOL = 2e-3

_REFS: dict = {}


def _ref(arch: str) -> dict:
    if arch not in _REFS:
        _REFS[arch] = G.reference(arch)
    return _REFS[arch]


@pytest.mark.parametrize("arch,impl", CASES)
def test_capabilities_match_jax(arch, impl):
    G.check_capabilities(_ref(arch), impl)


@pytest.mark.parametrize("arch,impl", CASES)
def test_batched_derivatives_match_jax(arch, impl):
    G.check_batched(_ref(arch), arch, impl)


@pytest.mark.parametrize("arch,impl", CASES)
def test_point_derivatives_match_jax(arch, impl):
    G.check_points(_ref(arch), arch, impl)


def test_gradient_matches_central_differences():
    pm = G.port_model(_ref("qwen3-0.6b"), "kernel")
    grads = pm.gradient_batch(G.THETAS, np.ones((len(G.THETAS), 1)))
    shifted = []
    for t in G.THETAS:
        for i in range(2):
            for sign in (1.0, -1.0):
                p = t.copy()
                p[i] += sign * FD_STEP
                shifted.append(p)
    ys = pm.evaluate_batch(np.array(shifted))[:, 0].reshape(len(G.THETAS), 2, 2)
    fd = (ys[..., 0] - ys[..., 1]) / (2 * FD_STEP)
    err = float(np.abs(fd - grads).max() / np.abs(grads).max())
    print(f"central differences vs gradient_batch: {err:.3g} (bound {FD_RTOL})")
    assert err < FD_RTOL


def test_waves_reach_the_kernels_they_should(monkeypatch):
    """qwen3's gradient wave: the flash forward once a layer (twice under
    remat "full": forward and recompute) and its backward once; the Hessian
    wave: no flash call at all (it runs plain attention); mamba2's gradient
    and Hessian waves: no SSD kernel (the plain SSD), where its evaluate wave
    calls it once a layer."""
    calls = G.KernelCalls(monkeypatch)
    pm = G.port_model(_ref("qwen3-0.6b"), "kernel")
    L = pm.cfg.n_layers
    args = (G.THETAS[:2], G.SENSS[:2])
    g = pm.gradient_batch(*args)
    assert calls.take() == {"flash": L, "flash_bwd": L, "ssd": 0}
    h = pm.apply_hessian_batch(*args, G.VECS[:2])
    assert calls.take() == {"flash": 0, "flash_bwd": 0, "ssd": 0}
    pm.cfg = pm.cfg.replace(remat="full")
    np.testing.assert_array_equal(pm.gradient_batch(*args), g)
    assert calls.take() == {"flash": 2 * L, "flash_bwd": L, "ssd": 0}
    np.testing.assert_array_equal(pm.apply_hessian_batch(*args, G.VECS[:2]), h)
    assert calls.take() == {"flash": 0, "flash_bwd": 0, "ssd": 0}
    mm = G.port_model(_ref("mamba2-1.3b"), "kernel")
    mm.evaluate_batch(G.THETAS[:2])
    assert calls.take() == {"flash": 0, "flash_bwd": 0, "ssd": mm.cfg.n_layers}
    mm.gradient_batch(*args)
    mm.apply_hessian_batch(*args, G.VECS[:2])
    assert calls.take() == {"flash": 0, "flash_bwd": 0, "ssd": 0}


def test_gradient_wave_needs_no_weight_gradients():
    """The weights take no gradient: they keep requires_grad False, and
    weights that require grad get no .grad from a derivative wave (its
    reverse pass goes to theta alone) and give the same gradients; the
    evaluate wave's numbers are the same before and after."""
    from repro_torch.models.params import tree_leaves

    pm = G.port_model(_ref("qwen3-0.6b"), "kernel")
    before = pm.evaluate_batch(G.THETAS)
    grads = pm.gradient_batch(G.THETAS, G.SENSS)
    pm.apply_hessian_batch(G.THETAS, G.SENSS, G.VECS)
    leaves = tree_leaves(pm.params)
    assert leaves and not any(t.requires_grad or t.grad is not None for t in leaves)
    np.testing.assert_array_equal(pm.evaluate_batch(G.THETAS), before)
    for t in leaves:
        t.requires_grad_(True)
    try:
        np.testing.assert_array_equal(pm.gradient_batch(G.THETAS, G.SENSS), grads)
        assert all(t.grad is None for t in leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)


def test_the_model_serves_all_eight_operations_without_jax_weights():
    """A model drawn from its own seed (no carried weights) answers every
    operation with finite values of the UM-Bridge shapes."""
    pm = LMUQModel("qwen3-0.6b", reduced=True, seq=32, device="cpu")
    t = [[1.0, 1.0]]
    assert np.isfinite(pm(t)[0]).all() and len(pm(t)[0]) == 1
    assert len(pm.gradient(0, 0, t, [1.0])) == 2
    assert len(pm.apply_jacobian(0, 0, t, [1.0, 0.0])) == 1
    assert len(pm.apply_hessian(0, 0, 0, t, [1.0], [1.0, 0.0])) == 2


def test_a_second_derivative_through_the_flash_kernel_path_raises():
    """The reverse-over-reverse wave of `apply_hessian_batch`, run on the
    kernel path by hand, stops at the flash backward's create_graph check:
    before it was once-differentiable, the CPU gave 0.0530 here against the
    plain path's 0.0528, and the card would have dropped every attention
    term."""
    pm = G.port_model(_ref("qwen3-0.6b"), "kernel")
    theta = pm._theta(G.THETAS[:1]).requires_grad_()
    nll = pm._nll(pm.cfg, pm._hidden(pm.cfg, theta), theta[0])
    with pytest.raises(RuntimeError, match="once-differentiable"):
        torch.autograd.grad(nll, theta, create_graph=True)


def test_plain_ssd_gradient_is_finite_where_the_decay_overflows():
    """The plain chunked SSD (`models/ssm.py::ssd_chunk_body`), which takes
    mamba2's and zamba2's derivatives, against autograd of the O(S)
    sequential recurrence in float64, at decays whose masked upper triangle
    exp(cum_i - cum_j) overflows (dt * A summed over a 128-step chunk up to
    ~2,000, past float64's 709; at mamba2-1.3b's width in float32 the
    threshold is 88). The mask is applied before the exp: applied after it,
    exp's backward gave 0 * inf = NaN in dt (full-width mamba2 on the
    card: a NaN embedding-scale gradient)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("mamba2-1.3b", reduced=True).replace(ssm_chunk=128)
    gen = torch.Generator().manual_seed(0)
    B, S, g, r, P, N = 1, 256, 1, 2, 8, 4
    f64 = dict(generator=gen, dtype=torch.float64)
    x, Bm, Cm = (torch.randn(B, S, g, *shape, **f64) for shape in ((r, P), (N,), (N,)))
    dt = 2.0 * torch.rand(B, S, g, r, **f64)
    A = torch.tensor([[-1.0, -8.0]], dtype=torch.float64)
    state0 = torch.zeros(B, g, r, N, P, dtype=torch.float64)
    grads = []
    for scan in (lambda *a: ssm.ssd_scan(cfg, *a), ssm.ssd_reference_sequential):
        leaves = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm)]
        y, state = scan(*leaves, A, state0)
        grads.append((y.detach(), torch.autograd.grad(y.square().sum() + state.sum(), leaves)))
    (y, got), (y_seq, want) = grads
    assert float((y - y_seq).abs().max() / y_seq.abs().max()) < 1e-12
    for gr, w in zip(got, want):
        assert torch.isfinite(gr).all()
        assert float((gr - w).abs().max() / w.abs().max()) < 1e-10
    # the hazard itself: exp, then the mask, differentiated
    big = torch.tensor([1000.0, -1.0], dtype=torch.float64, requires_grad=True)
    (d_after,) = torch.autograd.grad(torch.exp(big).masked_fill(big > 0, 0.0).sum(), big)
    (d_before,) = torch.autograd.grad(torch.exp(big.masked_fill(big > 0, float("-inf"))).sum(),
                                      big)
    assert torch.isnan(d_after[0]) and d_before[0] == 0 and d_before[1] == d_after[1]
