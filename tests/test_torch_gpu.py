"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version. The SWE step and the SWE solve (a whole wave in one launch, at
every thread block cluster size, a refused size raising), and whole waves
through `solve_batch`, bit for bit (the bound and its reason:
`repro_torch.kernels.swe.testing`); the SSD chunk scan within its
relative bound (`repro_torch.kernels.ssd.testing`), alone and inside a
reduced mamba2 forward; flash attention and RMSNorm within theirs
(`repro_torch.kernels.{flash_attention,rmsnorm}.testing`), at every case and
main-path shape. Flash attention runs bf16 on the tensor-core kernel and
float32 on the CUDA-core kernel (the per-kernel launch counts show which),
through strides at the model's layout, and inside reduced qwen3-0.6b
forwards in float32 and in bf16; its check rejects the tensor-core
kernel's output against a 1%-off scale or a dropped diagonal. The tsunami
derivative waves (PyTorch ops, no kernel, each step a replayed CUDA graph)
compute the kernel wave's values bit for bit and a finite HVP, equal the
eager loop bit for bit, agree with the same waves on the CPU within the
float32 bounds of `kernels.swe.testing`, and survive evaluate waves run
from another thread while their graphs are captured, and derivative
waves from several threads at once equal the serial wave. The GP level
(`uq/gp.py`: float32 Adam and Matérn matrices on the card) predicts what
the same fit predicts on the CPU within `_torch_parity.FIT_TOL`, and an
online GP screen trains on the card from a fabric's collector thread while
a three-stage sampler predicts from its own. The fused sampler blocks
(`uq/fused.py`: S steps a CUDA-graph replay) equal their per-step
reference and their eager step body bit for bit, resume a killed run bit
for bit, hold S `swe_solve` launches a replay on the coarse tsunami, and
survive evaluate waves run from another thread while they are captured.
A port server on the card answers /EvaluateBatch bit for bit like the
in-process model (one launch a served wave). The composite app (`apps/composite.py`:
a CG whose iterations replay as a CUDA graph) equals its graph-free loop
bit for bit and the CPU within float32 bounds, gradient waves included;
`ModelPool` serves a `TorchModel` on the card. The race detector's stress
harness passes with its tap's online GP on the card. Every test here is marked `gpu` and skips without a CUDA device. The file imports neither JAX nor the JAX package, so it also
runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import FIT_TOL, cuda_or_skip
from repro_torch.apps import tsunami
from repro_torch.apps.tsunami import level_grid, solve_batch
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import testing as flash_testing
from repro_torch.kernels.flash_attention.ops import KERNEL_OF
from repro_torch.kernels.rmsnorm import rmsnorm_fused, rmsnorm_ref
from repro_torch.kernels.rmsnorm import testing as rms_testing
from repro_torch.kernels.ssd import ssd, ssd_chunk_scan, ssd_chunked_ref
from repro_torch.kernels.ssd import testing as ssd_testing
from repro_torch.core.fabric import EvaluationFabric
from repro_torch.models import model, transformer
from repro_torch.uq.gp import GP
from repro_torch.uq.mlda import ensemble_mlda
from repro_torch.uq.surrogate import SurrogateScreen
from repro_torch.kernels.swe import (
    swe_solve,
    swe_solve_ref,
    swe_step,
    swe_step_ref,
    swe_step_ref_into,
)
from repro_torch.kernels.swe import ops as swe_ops
from repro_torch.kernels.swe.testing import (
    CASES,
    CLUSTER_SIZES,
    H100_PLAN,
    REFUSED_CLUSTER,
    SOLVE_CASES,
    TIMED_SHAPES,
    assert_solve_equal,
    assert_step_equal,
    case_inputs,
    derivative_errors,
    solve_case_inputs,
    sources,
)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_cuda(case):
    dev = cuda_or_skip()
    h, hu, b, dt_dx = case_inputs(case, dev)
    before = swe_step.launches
    got = swe_step(h, hu, b, dt_dx=dt_dx)
    torch.cuda.synchronize()
    assert swe_step.launches == before + 1
    assert_step_equal(got, swe_step_ref(h, hu, b, dt_dx), (h, hu), case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SOLVE_CASES)
def test_solve_kernel_matches_plain_on_cuda(case):
    """One launch of the solve kernel against the plain loop
    (`swe_solve_ref`), bit for bit: the limiter cases over 300 steps, whole
    waves at both published levels, and a 2,047-cell wave with its buoy rows
    on a slice edge; at the plan's cluster size and at every cluster size
    the kernel runs (`CLUSTER_SIZES`, those at most C), one launch each, h
    and hu untouched."""
    dev = cuda_or_skip()
    kw = solve_case_inputs(case, dev)
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    h0, hu0 = h.clone(), hu.clone()
    want = swe_solve_ref(h, hu, b, **kw)
    for cluster in (None, *(cs for cs in CLUSTER_SIZES if cs <= h.shape[0])):
        before = swe_solve.launches
        got = swe_solve(h, hu, b, **kw, cluster=cluster)
        torch.cuda.synchronize()
        assert swe_solve.launches == before + 1
        assert_solve_equal(got, want, f"{case}, cluster {cluster}")
    assert torch.equal(h, h0) and torch.equal(hu, hu0)


@pytest.mark.gpu
def test_refused_cluster_raises_on_cuda():
    """A cluster size the card refuses (16 blocks: not portable, and the
    kernel does not opt in) raises with the launch's cudaError and counts no
    launch: no retry at another size, no plain version."""
    dev = cuda_or_skip()
    kw = solve_case_inputs("wave_512x16", dev)
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    before = swe_solve.launches
    with pytest.raises(RuntimeError, match=f"cluster {REFUSED_CLUSTER}.*cudaError"):
        swe_solve(h, hu, b, **kw, cluster=REFUSED_CLUSTER)
    assert swe_solve.launches == before
    # the failed launch left no error behind for the next kernel
    got = swe_solve(h, hu, b, **kw)
    torch.cuda.synchronize()
    assert_solve_equal(got, swe_solve_ref(h, hu, b, **kw), "after a refused launch")


@pytest.mark.gpu
def test_cluster_plan_on_cuda():
    """The plan at the timed shapes: cached per shape, 1 at 512 lanes
    (every SM already has a lane), otherwise a size whose clusters are all
    resident at once and whose blocks own a warp of cells; on an H100 of
    132 SMs, the plan recorded in `testing.H100_PLAN`."""
    cuda_or_skip()
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    for C, N in TIMED_SHAPES:
        cs = swe_ops.cluster_plan(C, N)
        assert swe_ops.cluster_plan(C, N) == cs
        if N >= props.multi_processor_count:
            assert cs == 1
        elif cs > 1:
            assert C // cs >= swe_ops.MIN_SLICE
            assert swe_ops.max_active_clusters(C, cs) >= N
        if props.multi_processor_count == 132 and "H100" in props.name:
            assert cs == H100_PLAN[C, N], (C, N, cs)


def _solve_kernel_path_matches_plain_path(n_cells: int, smoothed: bool):
    dev = cuda_or_skip()
    thetas = torch.as_tensor(sources(16, 11), device=dev)
    solves, steps = swe_solve.launches, swe_step.launches
    got = solve_batch(thetas, n_cells, smoothed).cpu().numpy()
    # the whole wave is one launch of the solve kernel
    assert swe_solve.launches - solves == 1 and swe_step.launches == steps
    want = solve_batch(thetas, n_cells, smoothed, step=swe_step_ref_into).cpu().numpy()
    # every step is bit for bit, and so is the buoy reduction
    np.testing.assert_array_equal(got, want)
    # and the per-step kernel path: one step-kernel launch per step
    per_step = solve_batch(thetas, n_cells, smoothed, step=swe_step).cpu().numpy()
    assert swe_step.launches - steps == level_grid(n_cells)[1]
    np.testing.assert_array_equal(per_step, want)


@pytest.mark.gpu
def test_coarse_solve_kernel_path_matches_plain_path():
    _solve_kernel_path_matches_plain_path(512, True)


@pytest.mark.gpu
def test_fine_solve_kernel_path_matches_plain_path():
    _solve_kernel_path_matches_plain_path(2048, False)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ssd_testing.CASES, ids=ssd_testing.case_name)
def test_ssd_kernel_matches_plain_on_cuda(case):
    dev = cuda_or_skip()
    inputs = ssd_testing.kernel_inputs(case, dev, seed=1)
    before = ssd.launches
    got = ssd_chunk_scan(*inputs)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    ssd_testing.assert_close(got, ssd_chunked_ref(*inputs), ssd_testing.case_name(case))


@pytest.mark.gpu
def test_ssd_adapter_pads_on_cuda():
    """S = 200 at mamba2's widths from a non-zero state: the adapter pads to
    256 with dt = 0 on the card as on the CPU."""
    dev = cuda_or_skip()
    cfg = get_config("mamba2-1.3b")
    args = ssd_testing.padded_adapter_inputs(dev, seed=2)
    got = ssd(cfg, *args)
    want = ssd(cfg, *(t.cpu() for t in args))  # the plain version on the CPU
    ssd_testing.assert_close(tuple(t.cpu() for t in got), want, "adapter S=200")


@pytest.mark.gpu
def test_reduced_forward_kernel_path_matches_plain_path():
    """The reduced mamba2 config (float32) on the card: the kernel path
    launches the SSD kernel once per layer and gives the plain path's logits
    within the kernel's bound; only the SSD differs between the two."""
    dev = cuda_or_skip()
    cfg = get_config("mamba2-1.3b", reduced=True)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = model.make_synth_batch(cfg, 2, 200, torch.Generator(device=dev).manual_seed(1))["tokens"]
    before = ssd.launches
    got, _, _ = transformer.forward(cfg, params, tokens)
    torch.cuda.synchronize()
    assert ssd.launches == before + cfg.n_layers
    want, _, _ = transformer.forward(cfg.replace(attn_impl="plain"), params, tokens)
    assert ssd.launches == before + cfg.n_layers
    err = ssd_testing.rel_err(got, want)
    assert err <= ssd_testing.REL_TOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("case", flash_testing.CASES, ids=flash_testing.case_name)
def test_flash_kernel_matches_plain_on_cuda(case):
    dev = cuda_or_skip()
    q, k, v = flash_testing.case_inputs(case, dev, seed=1)
    causal = case[6]
    kernel = KERNEL_OF[q.dtype]  # bf16: the tensor-core kernel; float32: the CUDA-core one
    before, by_kernel = flash_attention.launches, dict(flash_attention.launches_by_kernel)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_kernel == {**by_kernel, kernel: by_kernel[kernel] + 1}
    flash_testing.assert_close(got, flash_testing.plain(q, k, v, causal),
                               flash_testing.case_name(case))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [flash_testing.MODEL_CASES[0], flash_testing.FLASH_CASES[0],
                                  flash_testing.EDGE_CASES[1]], ids=flash_testing.case_name)
def test_flash_kernel_reads_the_model_layout_on_cuda(case):
    """q, k, v as transposed views of [B, S, n, hd] tensors (qwen3-0.6b's
    layout, no copy): the kernel gives the plain version's result on the
    contiguous copies, and o comes back in q's memory order."""
    dev = cuda_or_skip()
    B, nq, nkv, S, _, hd, causal, dt = case
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in flash_testing.case_inputs(case, dev, seed=2))
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    flash_testing.assert_close(got, flash_testing.plain(q.contiguous(), k.contiguous(),
                                                        v.contiguous(), causal),
                               flash_testing.case_name(case))


@pytest.mark.gpu
@pytest.mark.parametrize("wrong", ["scale_1pct", "dropped_diagonal"])
def test_wgmma_kernel_check_sees_a_wrong_result(wrong):
    """The bound that holds the tensor-core kernel to its plain version
    rejects the kernel's own output against attention with a scale 1% off
    (at qwen3-0.6b's shape, one point) or without the diagonal."""
    dev = cuda_or_skip()
    case = flash_testing.MODEL_CASES[0] if wrong == "scale_1pct" else flash_testing.FLASH_CASES[4]
    q, k, v = flash_testing.case_inputs(case, dev, seed=4)
    got = flash_attention(q, k, v, causal=True)
    hd = q.shape[-1]
    flash_testing.assert_close(got, flash_testing.variant(q, k, v), "same")
    bad = (flash_testing.variant(q, k, v, scale=1.01 * hd ** -0.5) if wrong == "scale_1pct"
           else flash_testing.variant(q, k, v, drop_diagonal=True))
    with pytest.raises(AssertionError, match="max abs error"):
        flash_testing.assert_close(got, bad, wrong)


@pytest.mark.gpu
def test_flash_kernel_raises_for_causal_with_sq_ne_sk_on_cuda():
    dev = cuda_or_skip()
    q = torch.zeros(1, 2, 64, 32, device=dev)
    kv = torch.zeros(1, 1, 128, 32, device=dev)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, kv, kv, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", rms_testing.CASES, ids=rms_testing.case_name)
def test_rmsnorm_kernel_matches_plain_on_cuda(case):
    dev = cuda_or_skip()
    x, w = rms_testing.case_inputs(case, dev, seed=1)
    before = rmsnorm_fused.launches
    got = rmsnorm_fused(x, w)
    torch.cuda.synchronize()
    assert rmsnorm_fused.launches == before + 1
    rms_testing.assert_close(got, rmsnorm_ref(x, w), rms_testing.case_name(case))


@pytest.mark.gpu
def test_reduced_qwen3_forward_kernel_path_matches_plain_path():
    """The reduced qwen3-0.6b (float32, hd 32) on the card, at a sequence
    that is no multiple of the kernel's tiles: the kernel path launches the
    flash kernel once per layer and gives the plain path's logits within
    float32 reordering (measured ~1e-6 against the JAX package on the CPU,
    tests/test_torch_dense.py)."""
    dev = cuda_or_skip()
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = model.make_synth_batch(cfg, 2, 200, torch.Generator(device=dev).manual_seed(1))["tokens"]
    before = flash_attention.launches
    f32_before = flash_attention.launches_by_kernel["flash_attention"]
    got, _, _ = transformer.forward(cfg, params, tokens)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    assert flash_attention.launches_by_kernel["flash_attention"] == f32_before + cfg.n_layers
    want, _, _ = transformer.forward(cfg.replace(attn_impl="plain"), params, tokens)
    assert flash_attention.launches == before + cfg.n_layers
    err = ssd_testing.rel_err(got, want)
    assert err <= 1e-5, err


@pytest.mark.gpu
def test_reduced_qwen3_bf16_forward_runs_the_wgmma_kernel():
    """The reduced qwen3-0.6b in bf16 (hd 32) on the card, at a sequence
    that is no multiple of the kernel's tiles: one launch of the tensor-core
    kernel per layer, and a mean NLL within `LM_NLL_RTOL` (1e-3, the bound
    chip_smoke.py holds the full model's kernel path to) of the plain
    path's."""
    dev = cuda_or_skip()
    cfg = get_config("qwen3-0.6b", reduced=True).replace(param_dtype="bfloat16",
                                                          act_dtype="bfloat16")
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = model.make_synth_batch(cfg, 2, 200, torch.Generator(device=dev).manual_seed(1))

    def nll(c):
        logits, _, _ = transformer.forward(c, params, batch["tokens"])
        return float(torch.nn.functional.cross_entropy(
            logits.float().flatten(0, 1), batch["targets"].flatten()))

    before = dict(flash_attention.launches_by_kernel)
    got = nll(cfg)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_kernel == {
        **before, "flash_attention_wgmma": before["flash_attention_wgmma"] + cfg.n_layers}
    want = nll(cfg.replace(attn_impl="plain"))
    assert abs(got / want - 1.0) <= 1e-3, (got, want)


@pytest.mark.gpu
def test_fused_wave_primal_equals_the_kernel_wave_on_cuda():
    """A coarse 16-lane fused value-and-gradient wave (PyTorch ops under
    autograd, no kernel launch) computes the evaluate wave's values (one
    launch of the solve kernel) bit for bit, and a finite gradient."""
    from repro_torch.apps.tsunami import TsunamiModel

    dev = cuda_or_skip()
    model = TsunamiModel(device=dev)
    thetas = sources(16, 11)
    solves = swe_solve.launches
    ev = model.evaluate_batch(thetas, {"level": 0})
    assert swe_solve.launches == solves + 1
    data = torch.as_tensor(ev[0] + 0.1, dtype=torch.float32, device=dev)
    ys, gs = model.value_and_gradient_batch(thetas, lambda y: -(y - data), {"level": 0})
    assert swe_solve.launches == solves + 1 and model.waves[0] == 1
    np.testing.assert_array_equal(ys, ev)
    assert gs.shape == (16, 2) and np.isfinite(gs).all()


@pytest.mark.gpu
def test_hvp_wave_is_finite_on_cuda():
    from repro_torch.apps.tsunami import TsunamiModel

    dev = cuda_or_skip()
    model = TsunamiModel(device=dev)
    rng = np.random.default_rng(0)
    hv = model.apply_hessian_batch(sources(4, 11), rng.normal(size=(4, 4)),
                                   rng.normal(size=(4, 2)), {"level": 0})
    assert hv.shape == (4, 2) and np.isfinite(hv).all() and np.abs(hv).max() > 0


class _SmallTsunami(tsunami.TsunamiModel):
    N_CELLS = {0: 64, 1: 128}


def _derivative_waves(model, thetas, senss, vecs, level):
    """The model's gradient, JVP, HVP and fused-gradient waves, by op."""
    c = {"level": level}
    data = model.evaluate_batch(thetas[:1], c)[0] + 0.1
    data_t = torch.as_tensor(data, dtype=torch.float32, device=model.device)
    return {
        "gradient": model.gradient_batch(thetas, senss, c),
        "apply_jacobian": model.apply_jacobian_batch(thetas, vecs, c),
        "apply_hessian": model.apply_hessian_batch(thetas, senss, vecs, c),
        "value_and_gradient": model.value_and_gradient_batch(
            thetas, lambda y: -(y - data_t), c)[1],
    }


def _wave_inputs(lanes):
    rng = np.random.default_rng(3)
    return sources(lanes, 11), rng.normal(size=(lanes, 4)), rng.normal(size=(lanes, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("level", [0, 1])
def test_derivative_waves_on_cuda_match_the_cpu(level):
    """The card's waves step through captured CUDA graphs, the CPU's run the
    same step eagerly (the path the JAX-parity tests pin): on the same
    float32 inputs they agree within the float32 bounds, the HVP lane by
    lane against the float64 HVP."""
    dev = cuda_or_skip()
    thetas, senss, vecs = _wave_inputs(5)
    got = _derivative_waves(_SmallTsunami(device=dev), thetas, senss, vecs, level)
    want = _derivative_waves(_SmallTsunami(device="cpu"), thetas, senss, vecs, level)
    f64 = [torch.as_tensor(a.astype(np.float32).astype(float)) for a in (thetas, senss, vecs)]
    hvp64 = tsunami._hvp_batch(*f64, _SmallTsunami.N_CELLS[level], level == 0).numpy()
    derivative_errors(got, want, hvp64)


@pytest.mark.gpu
@pytest.mark.parametrize("level", [0, 1])
def test_captured_sweeps_equal_the_eager_loop_on_cuda(monkeypatch, level):
    """Replaying one captured graph a step computes what running the step's
    ops eagerly computes, bit for bit, in every derivative wave."""
    dev = cuda_or_skip()
    thetas, senss, vecs = _wave_inputs(4)
    model = _SmallTsunami(device=dev)
    graphed = _derivative_waves(model, thetas, senss, vecs, level)

    def eager(body, n, mutated):
        for _ in range(n):
            body()

    monkeypatch.setattr(tsunami, "_replay", eager)
    for op, want in _derivative_waves(model, thetas, senss, vecs, level).items():
        np.testing.assert_array_equal(graphed[op], want, err_msg=op)


@pytest.mark.gpu
def test_evaluate_waves_from_another_thread_during_a_derivative_wave():
    """The fabric runs evaluate waves (a synchronous copy to the card, a
    kernel launch) from its collector thread while a caller thread runs a
    derivative wave, whose step graphs are captured meanwhile: neither
    breaks the other, and both compute what they compute alone."""
    dev = cuda_or_skip()
    model = tsunami.TsunamiModel(device=dev)
    thetas, senss, vecs = _wave_inputs(16)
    alone = model.apply_hessian_batch(thetas, senss, vecs)
    evaluated = model.evaluate_batch(thetas)
    stop, ys, errors = threading.Event(), [], []

    def evaluate_meanwhile():
        try:
            while not stop.is_set():
                ys.append(model.evaluate_batch(thetas))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    worker = threading.Thread(target=evaluate_meanwhile)
    worker.start()
    try:
        hv = model.apply_hessian_batch(thetas, senss, vecs)
    finally:
        stop.set()
        worker.join()
    assert not errors, errors
    assert len(ys) >= 10
    np.testing.assert_array_equal(hv, alone)
    for y in ys:
        np.testing.assert_array_equal(y, evaluated)


@pytest.mark.gpu
def test_derivative_waves_from_threads_at_once_equal_serial():
    """A server answers each request on its own thread, so derivative waves
    of one model, and of another model in the same process, capture their
    step graphs at once. Entering a capture synchronizes the device, which
    broke a capture under way on another thread (an H100 run failed with
    cudaErrorStreamCaptureUnsupported); `core.device.CAPTURE_LOCK` makes
    the captures take turns. Three rounds of three threads (two on one
    model, one on a second) each equal the serial wave bit for bit."""
    dev = cuda_or_skip()
    models = [tsunami.TsunamiModel(device=dev), tsunami.TsunamiModel(device=dev)]
    thetas, senss, _ = _wave_inputs(16)
    want = models[0].gradient_batch(thetas, senss)
    for _ in range(3):
        got, errors = [None] * 3, []

        def run(i):
            try:
                got[i] = models[i // 2].gradient_batch(thetas, senss)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        for g in got:
            np.testing.assert_array_equal(g, want)


def _gp_set(n: int = 128):
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (n, 2))
    return X, np.sin(2 * X[:, 0]) + X[:, 1] ** 2, rng.uniform(-1.2, 1.2, (48, 2))


@pytest.mark.gpu
def test_gp_fit_on_cuda_matches_the_cpu():
    """GP.fit with its Adam loop and Matérn matrices on the card, against
    the same fit on the CPU: predictive mean and sd within `FIT_TOL` of y's
    sd (two float32 trajectories, cuSOLVER's Cholesky against LAPACK's)."""
    dev = cuda_or_skip()
    X, y, Xq = _gp_set()
    card = GP.fit(X, y, n_iters=250, device=dev)
    cpu = GP.fit(X, y, n_iters=250, device="cpu")
    assert card.device.type == "cuda" and card._Xt.is_cuda and card._ls_t.is_cuda
    assert card.fit_steps == cpu.fit_steps == 250
    m_card, v_card = card.predict(Xq, return_var=True)
    m_cpu, v_cpu = cpu.predict(Xq, return_var=True)
    assert np.all(v_card > 0) and np.isfinite(m_card).all()
    np.testing.assert_allclose(m_card, m_cpu, rtol=0, atol=FIT_TOL * y.std())
    np.testing.assert_allclose(np.sqrt(v_card), np.sqrt(v_cpu), rtol=0, atol=FIT_TOL * y.std())
    # fixed hyperparameters: one float32 Matérn matrix on each device
    fixed = GP.from_params(X, y, cpu.log_params, device=dev)
    np.testing.assert_allclose(fixed.predict(Xq), m_cpu, rtol=0, atol=FIT_TOL * y.std())


@pytest.mark.gpu
def test_gp_default_device_is_the_card():
    cuda_or_skip()
    X, y, _ = _gp_set(16)
    assert GP.fit(X, y, n_iters=5).device.type == "cuda"


@pytest.mark.gpu
def test_online_gp_screen_trains_and_screens_on_cuda():
    """The three-stage sampler over a toy two-level fabric: the screen's GP
    (default device, the card) trains from the collector thread's waves,
    then screens each step with one batched prediction."""
    cuda_or_skip()
    shifts = {0: -0.5, 1: 1.0}

    def level_model(thetas, config):
        return ((np.asarray(thetas) - shifts[config["level"]]) ** 2).sum(1, keepdims=True)

    def loglik(y):
        return -0.5 * float(y[0])

    fab = EvaluationFabric(level_model, cache_size=4096)
    fab.label_config({"level": 0}, "coarse")
    screen = SurrogateScreen.from_fabric(
        fab, target=lambda th, y: loglik(y), config={"level": 0},
        window=256, min_train=48, hyper_iters=60, refit_every=64)
    kw = dict(fabric=fab, loglik=loglik, level_configs=[{"level": 0}, {"level": 1}])
    rng = np.random.default_rng(0)
    try:
        warm = ensemble_mlda(None, rng.standard_normal((8, 2)) * 0.3 + 1.0, 20, [3],
                             0.7 * np.eye(2), rng, surrogate=screen, **kw)
        assert screen.active and screen.gp.device.type == "cuda"
        screen.freeze()
        res = ensemble_mlda(None, warm.samples[:, -1, :], 60, [3], 0.7 * np.eye(2), rng,
                            surrogate=screen, **kw)
        tel = fab.telemetry()
    finally:
        fab.shutdown()
    assert screen.gp._gp.device.type == "cuda" and screen.gp.n_hyper_fits >= 1
    assert screen.store.n_points == tel["per_label"]["coarse"]["points"]
    assert np.isfinite(res.samples).all()
    assert res.surrogate["screened"] > 0 and 0.0 < tel["screen_pass_rate"] < 1.0


# -- the fused sampler blocks (`uq.fused`): S steps a CUDA-graph replay ---------

MEAN2 = np.array([1.0, -0.5])
COV2 = np.array([[0.8, 0.3], [0.3, 0.5]])
X0S = np.random.default_rng(3).normal(size=(6, 2))


def _fused_run(kind: str, dev, seed: int, **kw):
    from repro_torch.uq import fused

    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "rwm":
        return fused.fused_ensemble_rwm(fused.gaussian_target(MEAN2, COV2), X0S, 30,
                                        0.4 * COV2, gen, fused_steps=5, **kw)
    if kind == "pcn":
        return fused.fused_ensemble_pcn(fused.gaussian_target(MEAN2), X0S, 24, 0.3, gen,
                                        fused_steps=6, **kw)
    return fused.fused_ensemble_mala(fused.gaussian_target(MEAN2, COV2), X0S, 30, 0.6, gen,
                                     fused_steps=5, adapt_steps=15, precond=COV2, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rwm", "pcn", "mala"])
def test_fused_block_equals_per_step_on_cuda(kind):
    """One S-step graph replayed per block draws the generator's Philox
    stream at the offsets S replays of the one-step graph draw: fused ==
    per-step bit for bit, MALA's adapted step size included; and the
    caller's generator ends where the stream ends."""
    dev = cuda_or_skip()
    got = _fused_run(kind, dev, 7)
    want = _fused_run(kind, dev, 7, per_step=True)
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.logposts, want.logposts)
    np.testing.assert_array_equal(got.accept_rates, want.accept_rates)
    assert got.final_step_size == want.final_step_size
    assert np.all(got.accept_rates > 0) and np.isfinite(got.samples).all()
    # a repeat call replays the memoised graph and reproduces the run
    np.testing.assert_array_equal(_fused_run(kind, dev, 7).samples, got.samples)


@pytest.mark.gpu
def test_fused_graph_draws_what_the_eager_body_draws():
    """The captured block against its own step body run eagerly on the card
    from the same generator state: the same samples bit for bit."""
    from repro_torch.uq import fused

    dev = cuda_or_skip()
    lp = fused.gaussian_target(MEAN2, COV2)
    got = fused.fused_ensemble_rwm(lp, X0S, 10, 0.4 * COV2,
                                   torch.Generator(device=dev).manual_seed(3), fused_steps=5)
    gen = torch.Generator(device=dev).manual_seed(3)
    step = fused._rwm_step(lp, np.linalg.cholesky(0.4 * COV2), dev)
    xs = torch.as_tensor(X0S, dtype=torch.float32, device=dev)
    carry = {"xs": xs, "lps": lp(xs), "acc": torch.zeros_like(xs[:, 0])}
    eager = []
    for _ in range(10):
        carry, (xs, _) = step(carry, gen)
        eager.append(xs.cpu().numpy())
    np.testing.assert_array_equal(got.samples, np.stack(eager, 1).astype(float))


@pytest.mark.gpu
def test_fused_kill_and_resume_on_cuda(tmp_path):
    """tests/test_fused.py's MALA kill-and-resume on the card: the generator
    state packed after k replays is the state block k + 1 starts from."""
    from repro_torch.core.fleet import CampaignCheckpoint

    dev = cuda_or_skip()
    want = _fused_run("mala", dev, 23)

    class Killed(RuntimeError):
        pass

    class DieAfter:
        def __init__(self, ckpt):
            self.ckpt, self.saves = ckpt, 0

        def resume(self):
            return self.ckpt.resume()

        def save(self, step, arrays, meta):
            self.ckpt.save(step, arrays, meta)
            self.saves += 1
            if self.saves == 2:
                raise Killed

    with pytest.raises(Killed):
        _fused_run("mala", dev, 23, checkpoint=DieAfter(CampaignCheckpoint(str(tmp_path))),
                   checkpoint_every=10)
    _, meta, step = CampaignCheckpoint(str(tmp_path)).resume()
    assert step == 20 and meta["key_device"] == "cuda"
    got = _fused_run("mala", dev, 999, checkpoint=CampaignCheckpoint(str(tmp_path)),
                     checkpoint_every=10)
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.logposts, want.logposts)
    assert got.final_step_size == want.final_step_size


def _coarse_tsunami_target(dev):
    from functools import partial

    from repro_torch.kernels.swe.testing import SOURCE_BOX
    from repro_torch.uq.fused import gaussian_likelihood_target

    forward = partial(solve_batch, n_cells=512, smoothed=True)
    data = forward(torch.tensor([[90.0, 2.5]], device=dev))[0].cpu().numpy()
    return gaussian_likelihood_target(forward, data, [0.5, 0.05, 0.5, 0.05], SOURCE_BOX)


@pytest.mark.gpu
def test_fused_tsunami_block_is_one_graph_of_S_launches():
    """A fused RWM block over the coarse tsunami (512 cells, 16 lanes): the
    capture counts nothing, its warm-up S launches, and each replay adds S
    `swe_solve` launches; none of `swe_step`. Fused == per-step bit for
    bit through the kernel too."""
    from repro_torch.uq import fused

    dev = cuda_or_skip()
    lp = _coarse_tsunami_target(dev)
    x0s, S = sources(16, 11).astype(float), 5
    prop = np.diag([8.0**2, 0.25**2])

    def run(n, **kw):
        return fused.fused_ensemble_rwm(lp, x0s, n, prop,
                                        torch.Generator(device=dev).manual_seed(5),
                                        fused_steps=S, **kw)

    fused._BLOCK_MEMO.clear()  # the first run captures its graph
    before = (swe_solve.launches, swe_step.launches)
    first = run(2 * S)
    (block,) = [b for b in fused._BLOCK_MEMO.values() if isinstance(b, fused._Block)]
    # the initial wave, the warm-up's S, two replays of S; the capture none
    assert block.graph is not None and block.held == {(swe_solve, None): S}
    assert (swe_solve.launches - before[0], swe_step.launches - before[1]) == (1 + 3 * S, 0)
    before = swe_solve.launches
    again = run(2 * S)  # memoised: no warm-up, no capture
    assert swe_solve.launches - before == 1 + 2 * S
    np.testing.assert_array_equal(again.samples, first.samples)
    per_step = run(2 * S, per_step=True)
    np.testing.assert_array_equal(per_step.samples, first.samples)
    assert np.isfinite(first.samples).all()
    assert np.all((first.accept_rates > 0) & (first.accept_rates <= 1))


@pytest.mark.gpu
def test_fused_capture_survives_evaluate_waves_from_another_thread():
    """The fabric runs evaluate waves of the same model (a synchronous copy
    to the card, a kernel launch) from its collector thread while a fused
    block is captured: neither breaks the other, and both compute what they
    compute alone."""
    from repro_torch.uq import fused

    dev = cuda_or_skip()
    model = tsunami.TsunamiModel(device=dev)
    lp = _coarse_tsunami_target(dev)
    x0s, prop = sources(16, 11).astype(float), np.diag([8.0**2, 0.25**2])
    thetas = sources(16, 3)
    evaluated = model.evaluate_batch(thetas)

    def run():
        return fused.fused_ensemble_rwm(lp, x0s, 8, prop,
                                        torch.Generator(device=dev).manual_seed(9),
                                        fused_steps=4)

    stop, ys, errors = threading.Event(), [], []

    def evaluate_meanwhile():
        try:
            while not stop.is_set():
                ys.append(model.evaluate_batch(thetas))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    fused._BLOCK_MEMO.clear()  # the run below captures its graph
    worker = threading.Thread(target=evaluate_meanwhile)
    worker.start()
    try:
        deadline = time.monotonic() + 60
        while not ys and not errors and time.monotonic() < deadline:
            time.sleep(0.001)  # the worker's waves are under way
        started = len(ys)
        during = run()
        waves_during = len(ys) - started
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and not errors, errors
    assert started >= 1 and waves_during >= 1
    for y in ys:
        np.testing.assert_array_equal(y, evaluated)
    np.testing.assert_array_equal(run().samples, during.samples)  # a replay, alone


@pytest.mark.gpu
@pytest.mark.parametrize("level", [0, 1])
def test_served_tsunami_model_answers_bit_for_bit(level):
    """A port server on the card: /EvaluateBatch of a 13-lane wave (not a
    power of two) equals the in-process wave bit for bit, and the server
    counts no error (a model exception, a CUDA fault included, would answer
    HTTP 400 and count there)."""
    cuda_or_skip()
    from _torch_parity import serving
    from repro_torch.core.client import HTTPModel, probe_health
    from repro_torch.core.server import serve_models
    from repro_torch.kernels.swe.testing import sources

    thetas = sources(13, 5).astype(float)
    served = tsunami.TsunamiModel()
    launches0 = swe_solve.launches
    with serving(serve_models, served) as url:
        got = HTTPModel(url).evaluate_batch(thetas, {"level": level})
        assert probe_health(url)["stats"]["errors"] == 0
    assert swe_solve.launches - launches0 == 1  # the served wave: one launch
    assert served.waves[level] == 1 and served.stats[level] == 13
    want = tsunami.TsunamiModel().evaluate_batch(thetas, {"level": level})
    assert got.shape == (13, 4) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_composite_full_and_gradient_waves_on_cuda():
    """The composite app on the card: a full-mode wave of 5 lanes (CG
    iterations a CUDA-graph replay) equals the graph-free per-iteration CG
    bit for bit in x and every lane's count, and so does another system of
    that shape, which replays the same cached graph; the wave's energies
    equal the CPU's within float32 summation-order noise (1e-5); a
    smooth-mode gradient wave equals the CPU's within
    tests/test_capabilities.py's FD-vs-AD bounds."""
    dev = cuda_or_skip()
    from repro_torch.apps import composite as tc

    thetas = np.array([[77.5, 210.0, 10.0], [78.0, 180.0, 30.0], [70.0, 205.0, 8.0],
                       [0.0, 0.0, 0.0], [76.0, 250.0, 45.0]])
    card, cpu = tc.CompositeModel(), tc.CompositeModel(device="cpu")
    assert card.device.type == "cuda" and card.rom.fx0.is_cuda
    ks = [tc.coefficient_field(t) for t in thetas]
    fx, fy = tc._face_coeffs(card._t(np.stack([k[0] for k in ks])),
                             card._t(np.stack([k[1] for k in ks])))
    rhs = tc._rhs_from_lifting(fx, fy, tc._lifting(fx.dtype, dev))
    x, k = tc.cg(fx, fy, rhs)
    x1, k1 = tc.cg(fx, fy, rhs, check_every=1)
    assert torch.equal(k, k1) and torch.equal(x, x1)
    assert (k < tc.CG_MAXITER).all() and len(set(k.tolist())) > 1
    # another system of the shape replays the cached graph, and the first
    # solve's results are the caller's own
    graphs = {key: s.graph for key, s in tc._SOLVERS.items()}
    x2, k2 = tc.cg(fx.flip(0), fy.flip(0), rhs.flip(0))
    x3, k3 = tc.cg(fx.flip(0), fy.flip(0), rhs.flip(0), check_every=1)
    assert torch.equal(k2, k3) and torch.equal(x2, x3) and torch.equal(k2, k.flip(0))
    assert all(tc._SOLVERS[key].graph is g for key, g in graphs.items())
    assert torch.equal(x, x1) and torch.equal(k, k1)
    full = {"mode": "full"}
    np.testing.assert_allclose(card.evaluate_batch(thetas, full),
                               cpu.evaluate_batch(thetas, full), rtol=1e-5)
    cfg = {"mode": "full", "defect_softness": 1.0}
    got = card.gradient_batch(thetas[:3], np.ones((3, 1)), cfg)
    want = cpu.gradient_batch(thetas[:3], np.ones((3, 1)), cfg)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=5e-2)
    np.testing.assert_allclose(got, want, atol=5e-3 * np.abs(want).max())
    np.testing.assert_allclose(card.evaluate_batch(thetas[:3]), cpu.evaluate_batch(thetas[:3]),
                               rtol=1e-4)


@pytest.mark.gpu
def test_model_pool_on_cuda_is_the_models_batched_program():
    """`ModelPool` over a `TorchModel` on the card: one instance per card,
    and 24 per-point submits through `BatchingExecutor` equal the model's
    own wave bit for bit, unpadded."""
    cuda_or_skip()
    from repro_torch.core.interface import TorchModel
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.scheduler import BatchingExecutor

    tm = TorchModel(lambda th: torch.stack([th[0] ** 2 + th[1] * th[2],
                                            torch.sin(th[0]) * th[1]]), 3, 2)
    pool = ModelPool(tm)
    assert pool.n_instances == torch.cuda.device_count()
    thetas = np.random.default_rng(4).standard_normal((24, 3))
    with BatchingExecutor(pool, linger_s=0.01) as ex:
        got = np.stack([f.result() for f in [ex.submit(t) for t in thetas]])
    np.testing.assert_array_equal(got, tm.evaluate_batch(thetas))
    assert pool.stats["evaluations"] == 24 and pool.stats["padded"] == 0


@pytest.mark.gpu
def test_stress_harness_on_cuda():
    """The race detector's stress harness with the tap's online GP on the
    card (the default device): every scenario passes, with no lock-order
    cycle and no unguarded write, and the tap ingests every computed row
    exactly once."""
    cuda_or_skip()
    from repro_torch.analysis.stress import run_stress

    report = run_stress(n_threads=8, seed=0)
    assert report["passed"], report
    assert report["monitor"]["lock_order_cycles"] == []
    assert report["monitor"]["unguarded_writes"] == []
    tap = report["scenarios"]["tap_exactly_once"]
    assert tap["rows_observed"] == tap["rows_computed"]
    assert tap["gp_device"].startswith("cuda")
