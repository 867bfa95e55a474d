"""PyTorch port: the SWE solve, a whole tsunami wave in one call
(`kernels.swe.swe_solve`) — its plain version against the per-step loop
`apps.tsunami.solve_batch` ran before it, and against the JAX package's
solver; the wrapper's checks and dispatch (a CUDA tensor never takes the
plain version); and the check that holds the kernel to its plain version on
the card (`testing.assert_solve_equal`) seeing a wrong solve; and the
kernel's cluster plan (`ops._cluster_plan`, `testing.slices`): how a column is
cut over a cluster's blocks, who owns each buoy row, which cluster size a
wave gets, and the wrapper's `cluster=` checks. The kernel itself is held
against its plain version on the card, at every cluster size, in
test_torch_gpu.py.

Run on the CPU:

    PYTHONPATH=src python -m pytest -q tests/test_torch_swe_solve.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.tsunami as jax_tsunami
import repro_torch.apps.tsunami as tsunami
from _torch_parity import SOLVE_THETAS, SOLVE_TOL
from repro_torch.apps.tsunami import L_DOMAIN, initial_state, level_grid, solve_batch
from repro_torch.kernels.swe import ops, swe_solve, swe_step, swe_step_ref_into
from repro_torch.kernels.swe.ref import ARRIVAL_THRESH
from repro_torch.kernels.swe.testing import (
    CLUSTER_SIZES,
    EDGE_ROWS,
    EDGE_SHAPE,
    H100_MAX_ACTIVE_CLUSTERS,
    H100_PLAN,
    SWE_KINDS,
    TIMED_SHAPES,
    assert_solve_equal,
    slices,
    solve_case_inputs,
    sources,
)

# [cells, <= 64] states: one thread keeps the xdist workers from
# oversubscribing the cores they share with the JAX tests
torch.set_num_threads(1)

LEVELS = [(0, 512, True), (1, 2048, False)]


def _old_loop(h, hu, b, dt_dx, n_steps, rows):
    """The time loop of `apps.tsunami.solve_batch` before the solve kernel,
    verbatim: one plain step, then the buoy reduction, per step."""
    N = h.shape[1]
    rows = torch.as_tensor(rows, device=h.device)
    h0_buoy = torch.clamp_min(-b, 0.0).index_select(0, rows)  # [2, 1]
    mx = torch.full((2, N), -torch.inf, device=h.device)
    arr = torch.full((2, N), -1.0, device=h.device)
    h_nxt, hu_nxt = torch.empty_like(h), torch.empty_like(hu)
    for i in range(n_steps):
        swe_step_ref_into(h, hu, b, dt_dx=dt_dx, g=tsunami.G, h_dry=tsunami.H_DRY,
                          out=(h_nxt, hu_nxt))
        h, h_nxt, hu, hu_nxt = h_nxt, h, hu_nxt, hu
        eta_b = h.index_select(0, rows) - h0_buoy  # [2, N]
        torch.maximum(mx, eta_b, out=mx)
        arr.masked_fill_((torch.abs(eta_b) > ARRIVAL_THRESH) & (arr < 0), float(i))
    return mx, arr


def _old_solve_batch(thetas, n_cells, smoothed):
    dt, n_steps, buoy_rows = level_grid(n_cells)
    h, hu, b = initial_state(thetas.to(torch.float32), n_cells, smoothed)
    N = h.shape[1]
    mx, arr = _old_loop(h, hu, b, dt / (L_DOMAIN / n_cells), n_steps, buoy_rows)
    arrival = torch.where(arr >= 0, arr * (dt / 60.0), tsunami.T_END / 60.0)
    return torch.stack([arrival, mx], dim=2).transpose(0, 1).reshape(N, 4)


@pytest.mark.parametrize("kind", SWE_KINDS)
def test_solve_equals_the_old_loop_bit_for_bit(kind):
    """300 steps of each limiter case with buoy rows (5, 40), through the
    wrapper on the CPU: the same bits as the old loop, and the inputs left
    as they were. Bound: bit equality (the same operations in the same
    order)."""
    kw = solve_case_inputs(f"solve_{kind}", "cpu")
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    h0, hu0 = h.clone(), hu.clone()
    got = swe_solve(h, hu, b, **kw)
    assert torch.equal(h, h0) and torch.equal(hu, hu0)
    want = _old_loop(h.clone(), hu.clone(), b, kw["dt_dx"], kw["n_steps"], kw["rows"])
    assert got[0].shape == got[1].shape == (2, h.shape[1])
    assert_solve_equal(got, want, kind)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("level,n_cells,smoothed", LEVELS)
def test_solve_batch_paths_agree_and_match_jax(level, n_cells, smoothed):
    """A whole wave of 4 sources at each published level: `solve_batch`'s
    default path (`swe_solve`) equals the old `solve_batch` and the per-step
    path (`step=swe_step`, on the CPU its plain version) bit for bit, and
    matches the JAX package's solver within `SOLVE_TOL` (the bounds of
    tests/test_torch_tsunami.py, on its sources, and their reason)."""
    thetas = torch.as_tensor(SOLVE_THETAS)
    got = solve_batch(thetas, n_cells, smoothed)
    assert got.shape == (4, 4) and got.dtype == torch.float32
    assert torch.equal(got, _old_solve_batch(thetas, n_cells, smoothed))
    assert torch.equal(got, solve_batch(thetas, n_cells, smoothed, step=swe_step))
    want = np.asarray(jax_tsunami._solve_batch(jnp.asarray(thetas.numpy()), n_cells, smoothed))
    got = got.numpy()
    tol = SOLVE_TOL[level]
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], atol=tol["arrival"])
    np.testing.assert_allclose(got[:, [1, 3]], want[:, [1, 3]], rtol=tol["height_rtol"])


def _bad_inputs(which: str):
    kw = solve_case_inputs("solve_moving", "cpu")
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    C = h.shape[0]
    if which == "dtype":
        h = h.double()
    elif which == "shape":
        hu = hu[:, :4].contiguous()
    elif which == "contiguity":
        hu = hu.t().contiguous().t()
    elif which == "h0_shape":
        kw["h0_rows"] = kw["h0_rows"][:1]
    elif which == "row_high":
        kw["rows"] = (5, C)
    elif which == "row_negative":
        kw["rows"] = (-1, 5)
    elif which == "too_many_rows":
        kw["rows"] = (5, 40, 41)
    elif which == "steps_negative":
        kw["n_steps"] = -1
    elif which == "steps_2_24":
        kw["n_steps"] = 2**24
    elif which == "one_cell":
        h, hu, b = h[:1].contiguous(), hu[:1].contiguous(), b[:1].contiguous()
    elif which == "no_lane":
        h, hu = h[:, :0].contiguous(), hu[:, :0].contiguous()
    elif which == "device":
        h, hu, b, kw["h0_rows"] = (t.to("meta") for t in (h, hu, b, kw["h0_rows"]))
    return h, hu, b, kw


BAD = {
    "dtype": (TypeError, "float32"),
    "shape": (ValueError, "shape"),
    "contiguity": (ValueError, "contiguous"),
    "h0_shape": (ValueError, "h0_rows has shape"),
    "row_high": (ValueError, r"lie in \[0, 48\)"),
    "row_negative": (ValueError, r"lie in \[0, 48\)"),
    "too_many_rows": (ValueError, "buoy rows, expected"),
    "steps_negative": (ValueError, r"n_steps -1 must lie in \[0, 2\*\*24\)"),
    "steps_2_24": (ValueError, r"n_steps 16777216 must lie"),
    "one_cell": (ValueError, "C >= 2"),
    "no_lane": (ValueError, "N >= 1"),
    "device": (ValueError, "no kernel"),
}


@pytest.mark.parametrize("which", list(BAD))
def test_wrapper_checks_raise(which):
    exc, match = BAD[which]
    h, hu, b, kw = _bad_inputs(which)
    with pytest.raises(exc, match=match):
        swe_solve(h, hu, b, **kw)


def test_zero_steps_and_bathymetry_as_a_vector():
    kw = solve_case_inputs("solve_dam_break", "cpu")
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    mx, arr = swe_solve(h, hu, b[:, 0], **dict(kw, n_steps=0))
    assert torch.equal(mx, torch.full((2, h.shape[1]), -torch.inf))
    assert torch.equal(arr, torch.full((2, h.shape[1]), -1.0))
    assert_solve_equal(swe_solve(h, hu, b[:, 0], **kw), swe_solve(h, hu, b, **kw), "b [C]")


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper's CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Stream:
    cuda_stream = 0


def test_cuda_tensor_never_takes_plain_version(monkeypatch):
    """One `solve_batch` on a (faked) CUDA state is one `swe_solve` launch,
    no `swe_step` launch, and never the plain loop; a non-zero
    cudaGetLastError() raises and is not counted."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    launched = []

    def fake_kernel(*args):
        launched.append(args)
        return fake_kernel.err

    fake_kernel.err = 0
    state = tsunami.initial_state
    monkeypatch.setattr(ops, "swe_solve_ref", plain)
    monkeypatch.setattr(tsunami, "swe_solve_ref", plain)
    monkeypatch.setattr(ops, "swe_step_ref", plain)
    monkeypatch.setattr(ops, "_solve_kernel", lambda: fake_kernel)
    monkeypatch.setattr(ops, "_kernel", lambda: plain)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    # the plan of an H100: what its occupancy query answered
    monkeypatch.setattr(ops, "_plans", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: type("Props", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(ops, "max_active_clusters",
                        lambda C, cs: H100_MAX_ACTIVE_CLUSTERS[C][cs])
    monkeypatch.setattr(tsunami, "initial_state",
                        lambda *a: tuple(t.as_subclass(_OnCuda) for t in state(*a)))
    solves, steps = swe_solve.launches, swe_step.launches
    out = solve_batch(torch.as_tensor(sources(16, 3)), 512, True)
    assert out.shape == (16, 4)
    assert len(launched) == 1 and swe_solve.launches == solves + 1
    assert swe_step.launches == steps
    _, n_steps, rows = level_grid(512)
    C, N, n, r0, r1 = launched[0][6:11]
    assert (C, N, n) == (512, 16, n_steps)
    assert (r0, r1) == rows
    assert launched[0][15] == H100_PLAN[512, 16]  # the plan's cluster size
    assert ops._plans == {(0, 512, 16): H100_PLAN[512, 16]}
    # a forced cluster size goes to the kernel as it is
    h, hu, b = (t.as_subclass(_OnCuda) for t in state(torch.as_tensor(sources(4, 3)), 512, True))
    swe_solve(h, hu, b, dt_dx=0.1, n_steps=3, rows=rows,
              h0_rows=torch.zeros(2).as_subclass(_OnCuda), cluster=16)
    assert launched[-1][15] == 16 and swe_solve.launches == solves + 2
    solves += 1
    fake_kernel.err = 9
    with pytest.raises(RuntimeError, match="cudaError 9"):
        solve_batch(torch.as_tensor(sources(16, 3)), 512, True)
    assert swe_solve.launches == solves + 1


@pytest.mark.parametrize("wrong", ["dt_dx_1e-6", "one_step_fewer", "buoy_row_off_by_one"])
def test_solve_check_sees_a_wrong_solve(wrong):
    """The check that holds the solve kernel to its plain version on the
    card rejects, on the dam-break case, a solve with dt/dx 1e-6 too large,
    one step fewer, or each buoy row one cell off."""
    kw = solve_case_inputs("solve_dam_break", "cpu")
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    want = swe_solve(h, hu, b, **kw)
    assert_solve_equal(want, want, "same")
    bad = dict(kw)
    if wrong == "dt_dx_1e-6":
        bad["dt_dx"] = kw["dt_dx"] * (1 + 1e-6)
    elif wrong == "one_step_fewer":
        bad["n_steps"] = kw["n_steps"] - 1
    else:
        bad["rows"] = tuple(r + 1 for r in kw["rows"])
        bad["h0_rows"] = torch.clamp_min(-b, 0.0)[list(bad["rows"]), 0]
    with pytest.raises(AssertionError, match="differs from the plain version"):
        assert_solve_equal(swe_solve(h, hu, b, **bad), want, wrong)


def test_solve_check_matches_nan_to_nan():
    """A NaN matches a NaN at the same place and nothing else."""
    a = torch.tensor([[1.0, float("nan")], [-torch.inf, 2.0]])
    assert_solve_equal((a, a), (a.clone(), a.clone()), "nan")
    b = a.clone()
    b[0, 1] = 0.0
    with pytest.raises(AssertionError, match="mx"):
        assert_solve_equal((b, a), (a, a), "nan")


@pytest.mark.parametrize("C", [2, 3, 48, 512, 2047, 2048])
@pytest.mark.parametrize("cs", CLUSTER_SIZES)
def test_slices_own_every_cell_once(C, cs):
    """A column of C cells cut over a cluster of cs blocks: contiguous
    slices, in rank order, that cover [0, C) once, C // cs cells each and
    one more in the first C % cs."""
    if cs > C:
        with pytest.raises(ValueError, match="power of two"):
            ops._check_cluster(cs, C, "swe_solve", C)
        return
    cuts = slices(C, cs)
    assert len(cuts) == cs
    owned = [i for lo, hi in cuts for i in range(lo, hi)]
    assert owned == list(range(C))
    sizes = [hi - lo for lo, hi in cuts]
    assert sizes == [C // cs + (r < C % cs) for r in range(cs)]


def test_slice_bounds_when_cs_does_not_divide_C():
    assert slices(2047, 8) == [(0, 256), (256, 512), (512, 768), (768, 1024),
                                   (1024, 1280), (1280, 1536), (1536, 1792), (1792, 2047)]
    assert slices(50, 4) == [(0, 13), (13, 26), (26, 38), (38, 50)]
    assert slices(2047, 2) == [(0, 1024), (1024, 2047)]
    assert slices(512, 1) == [(0, 512)]


def _owner(C, cs, row):
    (rank,) = [r for r, (lo, hi) in enumerate(slices(C, cs)) if lo <= row < hi]
    return rank


@pytest.mark.parametrize("cs", [c for c in CLUSTER_SIZES if c > 1])
def test_buoy_rows_of_the_edge_case_straddle_a_slice_edge(cs):
    """The 2,047-cell case's buoy rows are the last cell of one block and
    the first of the next at every cluster size above 1, so the reduction
    is read by two blocks; the published levels' rows each have one owner."""
    C = EDGE_SHAPE[0]
    r0, r1 = EDGE_ROWS
    left, right = _owner(C, cs, r0), _owner(C, cs, r1)
    assert right == left + 1
    assert slices(C, cs)[left][1] == r1 == slices(C, cs)[right][0]
    for n_cells in (512, 2048):
        for row in level_grid(n_cells)[2]:
            lo, hi = slices(n_cells, cs)[_owner(n_cells, cs, row)]
            assert lo <= row < hi


def test_plan_is_one_when_the_lanes_fill_the_card():
    """At N >= the SM count every SM already has a lane: cluster size 1,
    without asking the card."""
    def never(cs):
        raise AssertionError("queried")

    assert ops._cluster_plan(2048, 512, 132, never) == 1
    assert ops._cluster_plan(512, 132, 132, never) == 1


def test_plan_takes_the_largest_resident_cluster():
    """The largest of PLAN_CLUSTERS whose N clusters are all resident, whose
    N x cs blocks each get an SM and whose blocks own a warp of cells; 1 if
    none."""
    asked = []

    def resident(table):
        def f(cs):
            asked.append(cs)
            return table[cs]
        return f

    assert ops._cluster_plan(2048, 16, 132, resident({8: 16, 4: 99, 2: 99})) == 8
    assert ops._cluster_plan(2048, 16, 132, resident({8: 15, 4: 16, 2: 99})) == 4
    assert ops._cluster_plan(2048, 64, 132, resident({8: 63, 4: 63, 2: 64})) == 2
    assert ops._cluster_plan(2048, 64, 132, resident({8: 1, 4: 1, 2: 1})) == 1
    # a block an SM: 20 lanes x 8 blocks would need 160 of the 132
    assert ops._cluster_plan(2048, 20, 132, resident({8: 999, 4: 999, 2: 999})) == 4
    # a block keeps at least a warp of cells: 48 cells never split, 64 in 2
    asked.clear()
    assert ops._cluster_plan(48, 4, 132, resident({8: 99, 4: 99, 2: 99})) == 1
    assert asked == []
    assert ops._cluster_plan(64, 4, 132, resident({8: 99, 4: 99, 2: 99})) == 2
    assert ops.MIN_SLICE == 32 and max(ops.PLAN_CLUSTERS) <= max(CLUSTER_SIZES)


@pytest.mark.parametrize("C,N", TIMED_SHAPES)
def test_plan_on_an_h100(C, N):
    """On the occupancy an H100 reported (`testing.H100_MAX_ACTIVE_CLUSTERS`),
    the plan is `testing.H100_PLAN`: 1 at 512 lanes."""
    got = ops._cluster_plan(C, N, 132, lambda cs: H100_MAX_ACTIVE_CLUSTERS[C][cs])
    assert got == H100_PLAN[C, N]
    if N == 512:
        assert got == 1


BAD_CLUSTERS = {0: ValueError, -2: ValueError, 3: ValueError, 6: ValueError,
                64: ValueError, True: TypeError, 2.0: TypeError, "8": TypeError}


@pytest.mark.parametrize("cluster", list(BAD_CLUSTERS), ids=repr)
def test_cluster_checks_raise_on_cpu(cluster):
    """`cluster=` is None or a power of two in [1, C], checked on every
    device (48 cells here)."""
    kw = solve_case_inputs("solve_moving", "cpu")
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    with pytest.raises(BAD_CLUSTERS[cluster], match="cluster"):
        swe_solve(h, hu, b, **kw, cluster=cluster)


def test_cluster_on_cpu_takes_the_plain_version(monkeypatch):
    """A valid `cluster=` on a CPU tensor still runs the plain version: the
    same bits at every size, no kernel, no plan."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel or its plan was reached on the CPU")

    monkeypatch.setattr(ops, "_solve_kernel", no_kernel)
    monkeypatch.setattr(ops, "cluster_plan", no_kernel)
    kw = solve_case_inputs("solve_dry_bed", "cpu")
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    want = swe_solve(h, hu, b, **kw)
    for cluster in (1, 2, 16, 32):
        assert_solve_equal(swe_solve(h, hu, b, **kw, cluster=cluster), want, f"{cluster}")


@pytest.mark.parametrize("case", ["solve_dam_break", "solve_dry_bed", "wave_512x13"])
def test_replayed_plain_loop_equals_the_plain_solve(case):
    """`testing.swe_solve_ref_replayed` (chip_smoke.py's width check: one
    replayed graph a step on the card, the same body eagerly here) is
    `swe_solve_ref`, bit for bit, NaN matching NaN."""
    from repro_torch.kernels.swe import swe_solve_ref
    from repro_torch.kernels.swe.testing import swe_solve_ref_replayed

    kw = solve_case_inputs(case, "cpu")
    h, hu, b = kw.pop("h"), kw.pop("hu"), kw.pop("b")
    if case.startswith("wave_"):
        kw["n_steps"] = 200
    before = (h.clone(), hu.clone())
    got = swe_solve_ref_replayed(h, hu, b, **kw)
    assert_solve_equal(got, swe_solve_ref(h, hu, b, **kw), case)
    assert torch.equal(h, before[0]) and torch.equal(hu, before[1])  # inputs untouched
    assert (got[1] >= 0).any()  # some buoy saw the wave arrive
