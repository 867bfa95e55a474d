"""PyTorch port: the SWE solve's reverse mode on the CPU. The plain adjoint
(`kernels/swe/ref.py::swe_step_vjp_ref`, `swe_solve_vjp_ref`: the plain
version of csrc/swe_solve_vjp.cu, derived by hand) against torch autograd of
`apps.tsunami._ad_step` step by step, and against the tsunami's VJP wave
(`_Sweep`) and the JAX package's `_vjp_batch`, all in float64, where a wrong
term or a wrong rule at a kink shows far above rounding; `swe_solve`'s
autograd rule (`SweSolve`) through `torch.autograd.grad`; fused MALA over a
tsunami target, fused against per step bit for bit, its drift gradient
against the JAX package's. The adjoint kernel's cluster schedule
(`testing.swe_solve_vjp_clustered`: the blocks' extended slices, their
ghost states' and ghost cotangents' rounds) against the plain adjoint bit
for bit, its plan and its slices, `cluster=`'s checks. The card's kernel:
tests/test_torch_gpu.py."""
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.tsunami as jax_tsunami
import repro.uq.fused as jax_fused
import repro_torch.apps.tsunami as tsunami
import repro_torch.kernels.swe.ops as ops
import repro_torch.kernels.swe.ref as ref
import repro_torch.uq.fused as fused
import repro_torch.uq.mcmc as mcmc
from repro_torch.kernels.swe import SweSolve, swe_solve, swe_solve_vjp_ref, swe_step_vjp_ref
from repro_torch.kernels.swe.testing import (
    CASE_DT_DX,
    CLUSTER_SIZES,
    GRAD_RTOL32,
    SOURCE_BOX,
    SWE_KINDS,
    VJP_GHOST,
    assert_vjp_close,
    slices,
    solve_case_inputs,
    solve_vjp,
    sweep_vjp,
    swe_solve_vjp_clustered,
    swe_state,
    vjp_case_inputs,
    vjp_extended_slices,
    vjp_ghost_cells,
)

# the waves here run [cells, <= 16] states: one thread keeps the xdist
# workers from oversubscribing the cores they share with the JAX tests
torch.set_num_threads(1)

#: float64 bound of one step's adjoint against autograd of `_ad_step`, on
#: the largest entry (the two sum the same terms in other orders; measured
#: <= 3e-16)
STEP_RTOL64 = 1e-12
#: float64 bound of a whole wave's adjoint against the VJP waves (measured
#: <= 7e-16), the bound tests/test_torch_tsunami_grad.py holds those waves
#: to against the JAX package
WAVE_RTOL64 = 1e-8
#: (n_cells, smoothed) of the small waves
LEVELS = [(16, True), (64, False)]
THETAS = np.array([[90.0, 2.5], [60.0, 1.2], [110.0, 3.0]])
SENSS = np.random.default_rng(7).normal(size=(3, 4))


def _t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _ad_step_vjp(h, hu, b, dt_dx, gh, ghu):
    """The cotangents of one step's input by torch autograd of `_ad_step`."""
    x = [h.clone().requires_grad_(), hu.clone().requires_grad_()]
    return torch.autograd.grad(tsunami._ad_step(*x, b, dt_dx), x, [gh, ghu])


# -- one step -------------------------------------------------------------------


@pytest.mark.parametrize("kind", SWE_KINDS)
def test_step_vjp_matches_autograd_of_the_step(kind):
    """Five consecutive steps of each limiter case (`testing.swe_state`),
    float64, random cotangents: the hand-derived transpose equals autograd
    of the differentiable step within STEP_RTOL64 of the largest entry."""
    h, hu, b = (_t64(a) for a in swe_state(kind))
    rng = np.random.default_rng(1)
    for _ in range(5):
        gh, ghu = _t64(rng.normal(size=h.shape)), _t64(rng.normal(size=h.shape))
        got = swe_step_vjp_ref(h, hu, b, CASE_DT_DX, gh, ghu)
        want = _ad_step_vjp(h, hu, b, CASE_DT_DX, gh, ghu)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64
            assert _rel(g, w) <= STEP_RTOL64
        h, hu = ref.swe_step_ref(h, hu, b, CASE_DT_DX)


def _kink_state():
    """[12, 3] float64 state on a beach, on every kink at once: dry cells
    (h == 0: reconstructed depths tie with 0), still water (hu == 0: u == 0
    at |u|'s kink), a cell at the dry threshold (max(h, h_dry) ties), two
    cells whose wave speeds tie, and cotangents non-zero everywhere."""
    rng = np.random.default_rng(11)
    C, N = 12, 3
    b = np.concatenate([np.full(6, -10.0), np.linspace(-2.0, 3.0, 6)])[:, None]
    h = np.maximum(-b + 0.3 * np.sin(np.arange(C))[:, None] * np.ones((1, N)), 0.0)
    h[9:] = 0.0  # dry beach
    h[8] = ref.H_DRY
    h[0:2] = 10.0  # equal depths at rest: equal wave speeds at their face
    hu = rng.normal(size=(C, N)) * (h > 0.05)
    hu[0:4] = 0.0  # still water
    return h, hu, b, 0.01, rng.normal(size=(2, C, N))


def _kink_errors() -> float:
    h, hu, b, dt_dx, (gh, ghu) = _kink_state()
    args = (_t64(h), _t64(hu), _t64(b), dt_dx, _t64(gh), _t64(ghu))
    got, want = swe_step_vjp_ref(*args), _ad_step_vjp(*args)
    return max(_rel(g, w) for g, w in zip(got, want))


def test_step_vjp_matches_autograd_at_the_kinks():
    h, hu, *_ = _kink_state()
    assert (h == 0).sum() >= 6 and ((hu == 0) & (h > 0)).sum() >= 6 and (h == ref.H_DRY).any()
    assert _kink_errors() <= STEP_RTOL64


def _slope_one_at_ties(x, y, g):
    return torch.where(x >= y, g, torch.zeros_like(g))


def _slope_zero_at_ties(x, y, g):
    return torch.where(x > y, g, torch.zeros_like(g))


def _torch_abs_slope(u, g):
    return torch.where(u > 0, g, torch.where(u < 0, -g, torch.zeros_like(g)))


def _uncapped_sqrt_slope(r, g):
    return g * 0.5 / r


@pytest.mark.parametrize("name,patch", [
    ("_tie", _slope_one_at_ties),  # torch.clamp_min's slope 1 at a tie
    ("_tie", _slope_zero_at_ties),  # and 0 the other way
    ("_abs_vjp", _torch_abs_slope),  # torch.abs: slope 0 at u == 0 (jnp.abs: 1)
    ("_sqrt_vjp", _uncapped_sqrt_slope),  # sqrt'(0) = inf at a dry face
])
def test_torch_tie_rules_break_the_step_vjp_parity(monkeypatch, name, patch):
    """The kink cases of tests/test_torch_tsunami_grad.py's
    `test_torch_tie_rules_break_the_float64_parity`, on the plain adjoint:
    each other rule at a kink moves the adjoint far outside rounding (or to
    inf / NaN)."""
    monkeypatch.setattr(ref, name, patch)
    worst = _kink_errors()
    assert np.isnan(worst) or worst > 1e3 * STEP_RTOL64, worst


# -- a whole wave ---------------------------------------------------------------

_JAX64: dict = {}


def _jax64_vjp(n_cells, smoothed):
    key = (n_cells, smoothed)
    if key not in _JAX64:
        with jax.enable_x64(True):
            _, g = jax_tsunami._vjp_batch(jnp.asarray(THETAS), jnp.asarray(SENSS), n_cells,
                                          smoothed)
            _JAX64[key] = np.asarray(g)
    return _JAX64[key]


def _wave_vjp64(n_cells, smoothed, k):
    """sens^T J per lane through `swe_solve_vjp_ref` (checkpoints every k
    steps) and autograd of `initial_state`, float64."""
    th = _t64(THETAS).requires_grad_()
    h0, hu0, b = tsunami.initial_state(th, n_cells, smoothed)
    b = b.to(h0.dtype)
    dt, n_steps, rows = tsunami.level_grid(n_cells)
    gh, _ = swe_solve_vjp_ref(
        h0.detach(), hu0.detach(), b, _t64(SENSS)[:, 1::2].T.contiguous(),
        dt_dx=dt / (tsunami.L_DOMAIN / n_cells), n_steps=n_steps, rows=rows,
        h0_rows=torch.clamp_min(-b[:, 0], 0.0)[list(rows)], k=k)
    (g,) = torch.autograd.grad(h0, th, gh)
    return g, n_steps


@pytest.mark.parametrize("n_cells,smoothed", LEVELS)
@pytest.mark.parametrize("k", [None, 1, 5, "n_steps"])
def test_solve_vjp_matches_the_vjp_waves(n_cells, smoothed, k):
    """The plain adjoint of a whole wave (16 cells: 69 steps; 64 cells: 278),
    checkpoints every k steps (None: ceil(sqrt(n_steps)); 5 divides
    neither; all the steps in one segment), against the port's VJP wave
    (`_Sweep`) and the JAX package's `_vjp_batch` under x64, within the
    float64 wave bound."""
    n_steps = tsunami.level_grid(n_cells)[1]
    got, n = _wave_vjp64(n_cells, smoothed, n_steps if k == "n_steps" else k)
    assert n % 5 != 0 and ref.checkpoint_every(n) ** 2 >= n
    _, sweep = tsunami._vjp_batch(_t64(THETAS), _t64(SENSS), n_cells, smoothed)
    assert _rel(got, sweep) <= WAVE_RTOL64
    np.testing.assert_allclose(got.numpy(), _jax64_vjp(n_cells, smoothed),
                               rtol=WAVE_RTOL64, atol=0)


def test_checkpoint_every_is_the_ceiling_of_the_square_root():
    assert [ref.checkpoint_every(n) for n in (0, 1, 2, 4, 5, 69, 2224, 8899)] == \
        [1, 1, 2, 2, 3, 9, 48, 95]


@pytest.mark.parametrize("case", ["solve_dam_break", "solve_dry_bed"])
def test_solve_vjp_float32_matches_the_sweep(case):
    """The limiter cases over 300 steps in float32: the plain adjoint and
    the plain differentiable solver (`_Sweep`) walk the same states and
    agree within GRAD_RTOL32 (`testing.assert_vjp_close`, the card's
    bound; measured here ~1e-6)."""
    kw = solve_case_inputs(case, "cpu")
    cot = torch.as_tensor(np.random.default_rng(5).standard_normal((2, kw["h"].shape[1])),
                          dtype=torch.float32)
    args = (kw.pop("h"), kw.pop("hu"), kw.pop("b"), cot)
    assert_vjp_close(solve_vjp(*args, **kw), sweep_vjp(*args, **kw), case)


# -- the autograd rule -----------------------------------------------------------


def _wave32(n_cells=64, lanes=3):
    thetas = torch.as_tensor(THETAS[:lanes], dtype=torch.float32)
    h, hu, b = tsunami.initial_state(thetas, n_cells, True)
    dt, n_steps, rows = tsunami.level_grid(n_cells)
    return h, hu, b, dict(dt_dx=dt / (tsunami.L_DOMAIN / n_cells), n_steps=n_steps,
                          rows=rows, h0_rows=torch.clamp_min(-b[:, 0], 0.0)[list(rows)])


def test_swe_solve_autograd_rule_on_the_cpu():
    """Under autograd `swe_solve` goes through `SweSolve`: its primal is the
    solve without grad bit for bit, mx has the gradient the plain adjoint
    gives (the same code, bit for bit), within GRAD_RTOL32 of `_Sweep`'s,
    and the arrival index none; a second derivative raises."""
    h, hu, b, kw = _wave32()
    cot = torch.as_tensor(SENSS[:, 1::2].T, dtype=torch.float32).contiguous()
    x = [h.clone().requires_grad_(), hu.clone().requires_grad_()]
    mx, arr = swe_solve(*x, b, **kw)
    plain = swe_solve(h, hu, b, **kw)
    assert torch.equal(mx.detach(), plain[0]) and torch.equal(arr, plain[1])
    assert mx.requires_grad and not arr.requires_grad and mx.grad_fn.name() == "SweSolveBackward"
    gh, ghu = torch.autograd.grad(mx, x, cot)
    want = swe_solve_vjp_ref(h, hu, b, cot, **kw)
    assert torch.equal(gh, want[0]) and torch.equal(ghu, want[1])
    assert_vjp_close((gh, ghu), sweep_vjp(h, hu, b, cot, **kw), "SweSolve")
    mx, _ = swe_solve(*x, b, **kw)
    with pytest.raises(RuntimeError, match="once-differentiable"):
        torch.autograd.grad(mx, x[0], cot, create_graph=True)


def test_swe_solve_without_grad_keeps_no_checkpoints():
    """No input requiring grad (or grad disabled): the solve is the plain
    call, no `SweSolve` node."""
    h, hu, b, kw = _wave32(lanes=2)
    mx, _ = swe_solve(h, hu, b, **kw)
    assert mx.grad_fn is None
    with torch.no_grad():
        mx, _ = swe_solve(h.clone().requires_grad_(), hu, b, **kw)
    assert mx.grad_fn is None
    out = SweSolve.apply(h, hu, b, kw["h0_rows"], kw["dt_dx"], kw["n_steps"],
                         kw["rows"], None)
    assert [t.numel() for t in out[2:]] == [0, 0]  # the CPU keeps none


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers' CUDA
    branches on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Stream:
    cuda_stream = 7


def test_autograd_rule_on_a_faked_card_launches_the_solve_and_its_adjoint(monkeypatch):
    """On the card (faked: the kernels' entry points recorded), `swe_solve`
    under autograd is one solve launch that keeps checkpoints (non-null
    pointers, k = ceil(sqrt(n_steps))), and its backward one adjoint launch
    on those checkpoints with the wave's arguments and the current stream;
    without grad the solve keeps none. The plain versions never run."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    calls = []

    def fake(name):
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(ops, "swe_solve_ref", plain)
    monkeypatch.setattr(ops, "swe_solve_vjp_ref", plain)
    monkeypatch.setattr(ops, "_solve_kernel", lambda: fake("solve"))
    monkeypatch.setattr(ops, "_vjp_kernel", lambda: fake("vjp"))
    monkeypatch.setattr(ops, "cluster_plan", lambda C, N: 4)
    monkeypatch.setattr(ops, "vjp_cluster_plan", lambda C, N: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    kw = solve_case_inputs("solve_dam_break", "cpu")
    h, hu, b, h0_rows = (kw.pop(k).as_subclass(_OnCuda) for k in ("h", "hu", "b", "h0_rows"))
    kw["h0_rows"] = h0_rows
    solves, vjps = ops.swe_solve.launches, ops.swe_solve_vjp.launches
    x = h.clone().requires_grad_()
    mx, _ = ops.swe_solve(x, hu, b, **kw)
    torch.autograd.grad(mx, x, torch.ones_like(mx))
    assert [c[0] for c in calls] == ["solve", "vjp"]
    assert (ops.swe_solve.launches - solves, ops.swe_solve_vjp.launches - vjps) == (1, 1)
    k = ref.checkpoint_every(kw["n_steps"])
    solve, vjp = calls[0][1], calls[1][1]
    C, N = h.shape
    assert solve[6:11] == (C, N, kw["n_steps"], *kw["rows"]) and solve[15] == 4
    assert solve[16] and solve[17] and solve[18] == k and solve[19] == _Stream.cuda_stream
    # the adjoint reads the checkpoints the solve wrote
    assert (vjp[2], vjp[3]) == (solve[16], solve[17])
    # ... at the adjoint's plan (2 here), ck lane-major [N, n_seg, 2, C]
    assert vjp[10:] == (C, N, kw["n_steps"], k, *kw["rows"], kw["dt_dx"],
                        pytest.approx(ref.G), pytest.approx(ref.H_DRY), 2,
                        _Stream.cuda_stream)
    calls.clear()
    ops.swe_solve(h, hu, b, **kw)
    assert calls[0][1][16] is None and calls[0][1][17] is None
    with pytest.raises(ValueError, match="no kernel"):
        ops.swe_solve_vjp(b.as_subclass(torch.Tensor), torch.zeros(N, 17, 2, C),
                          torch.zeros(17, 2, N), torch.zeros(2, N),
                          **dict(kw, h0_rows=h0_rows.as_subclass(torch.Tensor)))
    with pytest.raises(ValueError, match="checkpoints"):
        ops.swe_solve_vjp(b, torch.zeros(N, 3, 2, C).as_subclass(_OnCuda),
                          torch.zeros(3, 2, N).as_subclass(_OnCuda),
                          torch.zeros(2, N).as_subclass(_OnCuda), **kw)
    # the old layout [n_seg, 2, C, N] is refused
    with pytest.raises(ValueError, match="ck must be"):
        ops.swe_solve_vjp(b, torch.zeros(17, 2, C, N).as_subclass(_OnCuda),
                          torch.zeros(17, 2, N).as_subclass(_OnCuda),
                          torch.zeros(2, N).as_subclass(_OnCuda), **kw)
    # cluster= forces the size, the plan is not asked
    calls.clear()
    monkeypatch.setattr(ops, "vjp_cluster_plan", lambda C, N: pytest.fail("planned"))
    ops.swe_solve_vjp(b, torch.zeros(N, 17, 2, C).as_subclass(_OnCuda),
                      torch.zeros(17, 2, N).as_subclass(_OnCuda),
                      torch.zeros(2, N).as_subclass(_OnCuda), **kw, cluster=8)
    assert calls[0][1][19] == 8


# -- the adjoint kernel's cluster schedule, plan and slices ----------------------

#: the schedule's cases: the two limiter cases (their running max is
#: attained early) and the fast dam break, whose gradient sees a wrong
#: schedule (`testing.FAST_DAM_BREAK`)
SCHEDULE_CASES = ("solve_dam_break", "solve_dry_bed", "solve_fast_dam_break")


@pytest.mark.parametrize("cs", [1, 4, 16])
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_cluster_schedule_is_the_plain_adjoint_bit_for_bit(case, cs):
    """csrc/swe_solve_vjp.cu's schedule at cluster size cs
    (`testing.swe_solve_vjp_clustered`: each block's extended slice with
    walls at its ends, ghost states every k_g recomputed steps, ghost
    cotangents every k_g - 1 reverse steps) gives the plain adjoint's bits
    in every owned cell. 16 blocks of 48 cells keep 3 ghost cells a side:
    a round of 2 reverse steps."""
    kw = vjp_case_inputs(case, "cpu")
    args = (kw.pop("h"), kw.pop("hu"), kw.pop("b"), kw.pop("cot_mx"))
    want = swe_solve_vjp_ref(*args, **kw)
    got = swe_solve_vjp_clustered(*args, **kw, cs=cs)
    assert torch.isfinite(want[0]).all() and want[0].abs().max() > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w), (case, cs, float((g - w).abs().max()))


@pytest.mark.parametrize("C", [2, 3, 48, 512, 2047, 2048])
@pytest.mark.parametrize("cs", [*CLUSTER_SIZES, 16])
def test_adjoint_slices_extend_the_solves_by_the_ghost_cells(C, cs):
    """Each adjoint block owns the solve's slice (`slices`) and computes
    k_g = min(VJP_GHOST, C // cs) cells more on each side that has a
    neighbour, within the column; every cluster size the wrapper takes
    keeps k_g >= 2 (a round of k_g - 1 >= 1 reverse steps), and k_g never
    exceeds a neighbour's own slice."""
    valid = cs == 1 or 2 * cs <= C
    if not valid:
        with pytest.raises(ValueError, match="power of two"):
            ops._check_cluster(cs, C, "swe_solve_vjp", max(1, C // 2))
        return
    assert ops._check_cluster(cs, C, "swe_solve_vjp", max(1, C // 2)) == cs
    kg = vjp_ghost_cells(C, cs)
    assert kg == (0 if cs == 1 else min(VJP_GHOST, C // cs))
    cuts = vjp_extended_slices(C, cs)
    assert [(lo, hi) for _, lo, hi, _ in cuts] == slices(C, cs)
    for r, (elo, lo, hi, ehi) in enumerate(cuts):
        assert lo - elo == (kg if r > 0 else 0) and ehi - hi == (kg if r < cs - 1 else 0)
        assert 0 <= elo and ehi <= C and ehi - elo <= -(-C // cs) + 2 * kg
        assert hi - lo >= kg
    if cs > 1:
        assert kg >= 2
    # the kernel's own width
    src = (Path(ops.__file__).parent / "csrc" / "swe_solve_vjp.cu").read_text()
    assert f"constexpr int kGhost = {VJP_GHOST};" in src


def test_adjoint_plan_is_the_solves_rule_on_its_own_occupancy(monkeypatch):
    """`vjp_cluster_plan` is `_cluster_plan` on the card's SM count and the
    ADJOINT's occupancy (`vjp_max_active_clusters`), cached per (device, C,
    N) apart from the solve's plan."""
    asked = []

    def occupancy(fn, table):
        def query(C, cs):
            asked.append((fn, C, cs))
            return table[cs]
        return query

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(ops, "max_active_clusters",
                        occupancy("swe_solve", {8: 16, 4: 99, 2: 99}))
    monkeypatch.setattr(ops, "vjp_max_active_clusters",
                        occupancy("swe_solve_vjp", {8: 15, 4: 16, 2: 99}))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props())
    monkeypatch.setattr(ops, "_plans", {})
    monkeypatch.setattr(ops, "_vjp_plans", {})
    assert ops.vjp_cluster_plan(2048, 16) == 4
    assert ops.cluster_plan(2048, 16) == 8
    assert {fn for fn, _, _ in asked} == {"swe_solve", "swe_solve_vjp"}
    asked.clear()
    assert (ops.vjp_cluster_plan(2048, 16), ops.cluster_plan(2048, 16)) == (4, 8)
    assert asked == []
    # the lanes fill the card: one block a lane, no query
    assert ops.vjp_cluster_plan(512, 512) == 1 and asked == []


BAD_VJP_CLUSTERS = {0: ValueError, -2: ValueError, 3: ValueError, 6: ValueError,
                    32: ValueError, True: TypeError, 2.0: TypeError, "8": TypeError}


@pytest.mark.parametrize("cluster", list(BAD_VJP_CLUSTERS), ids=repr)
def test_vjp_cluster_checks_raise_on_cpu(cluster):
    """`swe_solve_vjp`'s `cluster=` is None, 1 or a power of two in
    [2, C / 2] (48 cells here: 32 is too many), checked before the device;
    a valid one on a CPU tensor meets "no kernel"."""
    kw = solve_case_inputs("solve_moving", "cpu")
    C, N = kw.pop("h").shape
    kw.pop("hu")
    b = kw.pop("b")
    k = ref.checkpoint_every(kw["n_steps"])
    ck = torch.zeros(N, -(-kw["n_steps"] // k), 2, C)
    args = (b, ck, torch.zeros(ck.shape[1], 2, N), torch.zeros(2, N))
    with pytest.raises(BAD_VJP_CLUSTERS[cluster], match="cluster"):
        ops.swe_solve_vjp(*args, **kw, cluster=cluster)
    for good in (None, 1, 16):
        with pytest.raises(ValueError, match="no kernel"):
            ops.swe_solve_vjp(*args, **kw, cluster=good)


def test_reverse_mode_on_the_cpu_stays_on_the_sweep(monkeypatch):
    """`_reverse_mode` takes the kernel's rule only for float32 on the card:
    a CPU wave, float32 or float64, runs `_Sweep`, and its float32 gradient
    equals the gradient through `solve_batch` under autograd (the plain
    adjoint) within GRAD_RTOL32."""
    calls = []
    pull = tsunami._Sweep.pull

    def counted(self, *a):
        calls.append(1)
        return pull(self, *a)

    monkeypatch.setattr(tsunami._Sweep, "pull", counted)
    th = torch.as_tensor(THETAS, dtype=torch.float32)
    senss = torch.as_tensor(SENSS, dtype=torch.float32)
    y, g = tsunami._vjp_batch(th, senss, 64, True)
    assert len(calls) == 1
    x = th.clone().requires_grad_()
    (g_rule,) = torch.autograd.grad(tsunami.solve_batch(x, 64, True), x, senss)
    assert len(calls) == 1
    assert _rel(g_rule, g) <= GRAD_RTOL32


# -- fused MALA over the tsunami ---------------------------------------------------

DATA = np.array([10.0, 1.0, 20.0, 0.8])
NOISE = np.array([0.5, 0.05, 0.5, 0.05])
X0S = np.array([[84.0, 2.3], [97.0, 2.7], [60.0, 1.5], [120.0, 3.2]])


def _target():
    return fused.gaussian_likelihood_target(
        partial(tsunami.solve_batch, n_cells=16, smoothed=True), DATA, NOISE, SOURCE_BOX)


@pytest.mark.parametrize("adapt_steps", [0, 4])
def test_fused_mala_over_the_tsunami_equals_per_step(adapt_steps):
    """Fused MALA over a 16-cell tsunami target (its drift through
    `SweSolve`): blocks of 3 steps equal the per-step reference bit for bit,
    the adapted step size included."""
    kw = dict(fused_steps=3, adapt_steps=adapt_steps, precond=np.diag([4.0, 0.01]))
    lp = _target()
    got = fused.fused_ensemble_mala(lp, X0S, 6, 1.0, torch.Generator().manual_seed(2), **kw)
    want = fused.fused_ensemble_mala(lp, X0S, 6, 1.0, torch.Generator().manual_seed(2),
                                     per_step=True, **kw)
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.logposts, want.logposts)
    np.testing.assert_array_equal(got.accept_rates, want.accept_rates)
    assert got.final_step_size == want.final_step_size
    assert np.isfinite(got.samples).all() and 0 < got.accept_rate <= 1


def test_fused_mala_drift_matches_jax():
    """The start of a fused MALA run: the log-posteriors and their gradients
    (`_value_and_grad_rows`) against the JAX package's over the same target
    (float32 in both; the two solvers round differently, measured 1.0e-4
    on the log-posteriors), within GRAD_RTOL32 of the largest entry; a row
    out of the prior box gives -inf and a zero gradient, never NaN."""
    xs = np.vstack([X0S, [[170.0, 2.0]]])  # the last row out of the box
    lps, grads = fused._value_and_grad_rows(_target())(torch.as_tensor(xs, dtype=torch.float32))
    jax_lp = jax_fused.gaussian_likelihood_target(
        partial(jax_tsunami._solve_batch, n_cells=16, smoothed=True), DATA, NOISE, SOURCE_BOX)
    want_lps, want_grads = jax_fused._value_and_grad_rows(jax_lp)(jnp.asarray(xs, jnp.float32))
    want_lps, want_grads = np.asarray(want_lps), np.asarray(want_grads)
    lps, grads = lps.numpy(), grads.numpy()
    assert lps[-1] == want_lps[-1] == -np.inf
    assert np.array_equal(grads[-1], np.zeros(2)) and np.array_equal(want_grads[-1], np.zeros(2))
    np.testing.assert_allclose(lps[:-1], want_lps[:-1], rtol=GRAD_RTOL32)
    err = np.max(np.abs(grads - want_grads)) / np.max(np.abs(want_grads))
    assert err <= GRAD_RTOL32, err


def test_ensemble_mala_takes_the_fused_tsunami_path():
    """`uq/mcmc.py::ensemble_mala(fused_steps=S)` reaches the fused block over
    a tsunami target unchanged, and returns its run."""
    lp = _target()
    got = mcmc.ensemble_mala(lp, X0S, 4, 1.0, np.random.default_rng(0), fused_steps=2,
                             precond=np.diag([4.0, 0.01]),
                             fused_key=torch.Generator().manual_seed(9))
    want = fused.fused_ensemble_mala(lp, X0S, 4, 1.0, torch.Generator().manual_seed(9),
                                     fused_steps=2, precond=np.diag([4.0, 0.01]))
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.n_grad_waves == want.n_grad_waves == 3


def test_fused_mala_raises_for_a_target_without_gradient():
    """A log-posterior that gives no gradient in its parameters (here one
    computed from detached values) still raises, naming why."""
    def detached(xs):
        return -0.5 * (xs.detach() ** 2).sum(-1)

    with pytest.raises(NotImplementedError, match="no gradient in its parameters"):
        fused.fused_ensemble_mala(detached, X0S, 2, 0.5, torch.Generator().manual_seed(0),
                                  fused_steps=2)
