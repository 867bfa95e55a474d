"""Inputs and the checks that hold the SWE kernels against their plain
versions: the step kernel against `swe_step_ref`, the solve kernel against
`swe_solve_ref`; and the float32 bounds of the tsunami derivative waves
(`derivative_errors`). `chip_smoke.py` and the port's tests both use them,
so the card and the test suite run the same cases against the same bound.

The bound is bit equality. The kernel repeats the plain version's
operations term by term and in the same order. It is compiled with
`-fmad=false`, so no multiply-add is contracted, and it uses IEEE division
and square root. The plain version runs one PyTorch operation per kernel.
Nothing can therefore round differently, and on an H100 every case and
shape has measured 0 ulp (PERF.md). A looser bound would be blind where it
matters: at the main path's ~4,000 m depths one float32 ulp of `h` is
2.4e-4 m, which is more than a mass flux that is 1% wrong moves `h` in one
step. Only an exact comparison sees such a fault there
(tests/test_torch_swe.py checks that it does). A solve is held the same
way: its (mx, arr) outputs bit for bit, a NaN matching a NaN
(tests/test_torch_swe_solve.py checks that the check sees a dt 1e-6 off,
one step fewer and a buoy row off by one).

The solve kernel splits each lane's column over a thread block cluster
(`ops.cluster_plan`), and every cluster size gives the same bits: each is
held at every case (`CLUSTER_SIZES`), one case (`edge_2047x13`) with a C
that no cluster size divides and its buoy rows on either side of a slice
edge. `H100_MAX_ACTIVE_CLUSTERS` and `H100_PLAN` are the occupancy the card
reported and the plan it gives at the timed shapes (`TIMED_SHAPES`).

The solve's adjoint (`ops.swe_solve_vjp`, through the autograd rule
`ops.SweSolve`) is held to the same reverse mode computed another way: the
plain differentiable solver `apps.tsunami._Sweep` (PyTorch ops under
autograd, float32) on the same inputs, within GRAD_RTOL32 of each
cotangent's largest entry (`assert_vjp_close`), at `VJP_CASES`. The two
walk the same float32 states (the solve's steps are the plain step's, bit
for bit), so they differ only by the reverse sweep's own rounding.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.apps.tsunami import L_DOMAIN, initial_state, level_grid
from repro_torch.convert import swe_state_from_numpy
from repro_torch.kernels.swe.ref import (
    ARRIVAL_THRESH,
    _tie,
    checkpoint_every,
    swe_step_ref,
    swe_step_ref_into,
    swe_step_vjp_ref,
)

#: the `_swe_state` cases of the JAX package's tests/test_kernels.py
SWE_KINDS = ("lake_at_rest", "dam_break", "dry_bed", "moving")
#: dt/dx of one step of those cases
CASE_DT_DX = 0.02
#: [cells, lanes] of the steps the main path runs: both published levels,
#: waves of the campaign's 16 chains, the narrower waves left after cache
#: hits, 64 lanes, and 512 lanes
MAIN_PATH_SHAPES = tuple((C, N) for C in (512, 2048) for N in (4, 8, 16, 64, 512))
#: [cells, lanes] of ragged steps: C one less and one more than a strip of
#: the deepest depth and than a whole column of them at the fine level, and
#: lane counts that fill no warp (and 513, one past the widest wave)
RAGGED_SHAPES = tuple((C, N) for C in (7, 9, 2047, 2049) for N in (1, 3, 5, 513))
#: every case of the check, by name; each is held at every strip depth of
#: the step kernel (`ops.STRIP_DEPTHS`) and at the plan's
CASES = (*SWE_KINDS, *(f"main_{C}x{N}" for C, N in MAIN_PATH_SHAPES),
         *(f"ragged_{C}x{N}" for C, N in RAGGED_SHAPES))
#: the limiter cases' solve: steps and buoy rows (dam-break and dry-bed
#: cross the limiter branches for many steps)
CASE_SOLVE_STEPS, CASE_SOLVE_ROWS = 300, (5, 40)
#: [cells, lanes] of the whole waves the solve kernel is held at, at both
#: published levels: one source (a point call), 4, 8, 13 (not a power of
#: two), the campaign's 16, and 64. The model's waves run unpadded, so a
#: campaign gives other widths too (cache hits, a router's split):
#: chip_smoke.py records them and holds each one as it was launched
SOLVE_SHAPES = tuple((C, N) for C in (512, 2048) for N in (1, 4, 8, 13, 16, 64))
#: [cells, lanes] of a wave whose C no cluster size divides (slices of two
#: sizes), its buoy rows the last cell of one slice and the first of the
#: next at every cluster size above 1 (the edge at cell 1,024), and its
#: steps: enough for every source's wave to pass the rows
EDGE_SHAPE, EDGE_ROWS, EDGE_STEPS = (2047, 13), (1023, 1024), 3000
#: every case of the solve check, by name
SOLVE_CASES = (*(f"solve_{k}" for k in SWE_KINDS),
               *(f"wave_{C}x{N}" for C, N in SOLVE_SHAPES),
               "edge_{}x{}".format(*EDGE_SHAPE))
#: every cluster size the solve kernel runs on a Hopper card (the portable
#: sizes), each held at every case where it is at most C
CLUSTER_SIZES = (1, 2, 4, 8)
#: a cluster size the wrapper passes on and a Hopper card refuses (16 blocks
#: are not portable, and the kernel does not opt in): its launch must raise,
#: not fall back
REFUSED_CLUSTER = 16
#: [cells, lanes] of the waves chip_smoke.py's `solve_times` times at every
#: cluster size
TIMED_SHAPES = tuple((C, N) for C in (512, 2048) for N in (16, 64, 512))
#: clusters of each size an H100 (132 SMs) holds at once, by cells
#: (`ops.max_active_clusters`, chip_smoke.py's `solve_times`)
H100_MAX_ACTIVE_CLUSTERS = {512: {1: 528, 2: 264, 4: 248, 8: 124},
                            2048: {1: 132, 2: 132, 4: 62, 8: 62}}
#: the plan's cluster size at each timed shape on that card
H100_PLAN = {(512, 16): 8, (512, 64): 2, (512, 512): 1,
             (2048, 16): 8, (2048, 64): 2, (2048, 512): 1}
#: the §4.3 campaign's uniform prior box: x0 [km], amplitude [m]
SOURCE_BOX = ((30.0, 150.0), (0.5, 4.0))
#: the adjoint's cases: whole waves at both published levels at 16 lanes
#: and at the coarse level at 512, and two limiter cases of 48 cells (a
#: block of 64 threads, 16 of them idle) and 32 lanes over CASE_SOLVE_STEPS
#: steps, where cells dry and wet and the wave speeds tie
VJP_CASES = ("wave_512x16", "wave_2048x16", "wave_512x512", "solve_dam_break",
             "solve_dry_bed", "solve_fast_dam_break")
#: a limiter case whose gradient sees the adjoint's cluster schedule: the
#: dam break of 48 cells x 32 lanes at 7.5 x CASE_DT_DX over 200 steps, its
#: front reaching the buoy rows mid-wave (a running max attained late), so
#: a ghost cell's error would reach the owned cells through the sweep
#: (`swe_solve_vjp_clustered` with rounds one step longer than the ghost
#: width, or none, gives other bits at cluster sizes 4 to 16)
FAST_DAM_BREAK = dict(kind="dam_break", dt_dx=0.15, n_steps=200)
#: float32 bound of a first-order derivative wave (gradient, JVP, the fused
#: gradient) against the same wave computed another way, on the largest
#: entry: two float32 solvers that round differently drift apart over the
#: steps. Measured between the port and the JAX package (whose XLA scan
#: contracts multiply-adds) over 278 / 556 steps: up to 3.8e-4 (gradient,
#: JVP; 128 cells) and 1.25e-3 (the fused wave, whose sensitivity also
#: reads the drifted heights); 5e-3 is 4x that
GRAD_RTOL32 = 5e-3
#: A float32 HVP is not that close to the exact one: a float32 rounding can
#: move the step at which a buoy's running max is attained, and with it the
#: second derivative. Measured against the float64 HVP (which the port and
#: the JAX package agree on to 1e-14): up to 8.1e-2 relative to the largest
#: entry in both packages, lane by lane; in one lane the JAX package is
#: 4.2e-2 off where the port is 3e-7 off. So each lane of a float32 HVP is
#: held to the float64 HVP within twice the other float32 HVP's error in
#: that lane, plus this
HVP32_FLOOR = 1e-5


def swe_state(kind: str, C: int = 48, N: int = 32):
    """[cells, batch] float32 numpy states that exercise the limiter
    branches: the `_swe_state` cases of the JAX package's tests."""
    x = np.linspace(0.0, 1.0, C)[:, None]
    batch = 1.0 + 0.1 * np.arange(N)[None, :] / N
    b = 0.1 * np.sin(3 * np.pi * x[:, 0])[:, None]  # [C, 1] bathymetry
    if kind == "lake_at_rest":
        h = np.maximum(0.8 - b, 0.0) * np.ones((1, N))
        hu = np.zeros((C, N))
    elif kind == "dam_break":
        h = np.where(x < 0.5, 1.2, 0.4) * batch
        hu = np.zeros((C, N))
    elif kind == "dry_bed":
        h = np.where(x < 0.5, 0.6 * batch, 1e-4)
        hu = np.where(x < 0.5, 0.05 * batch, 0.0)
    elif kind == "moving":
        h = 0.7 + 0.2 * np.sin(2 * np.pi * x) * batch
        hu = 0.1 * np.cos(2 * np.pi * x) * batch
    else:
        raise ValueError(f"unknown SWE case {kind!r}; expected one of {SWE_KINDS}")
    return (np.asarray(h, np.float32), np.asarray(hu, np.float32),
            np.asarray(b, np.float32))


def sources(n: int, seed: int) -> np.ndarray:
    """[n, 2] float32 tsunami sources drawn uniformly from the prior box."""
    rng = np.random.default_rng(seed)
    (x_lo, x_hi), (a_lo, a_hi) = SOURCE_BOX
    return np.stack(
        [rng.uniform(x_lo, x_hi, n), rng.uniform(a_lo, a_hi, n)], axis=1
    ).astype(np.float32)


def main_path_state(n_cells: int, N: int, device) -> tuple:
    """(h, hu, b, dt_dx) of N real sources on the published `n_cells` grid,
    20 plain steps in, so that `hu` is non-zero wherever the wave is."""
    device = torch.device(device)
    h, hu, b = initial_state(
        torch.as_tensor(sources(N, 7), device=device), n_cells,
        smoothed=(n_cells == 512),
    )
    dt_dx = level_grid(n_cells)[0] / (L_DOMAIN / n_cells)
    for _ in range(20):
        h, hu = swe_step_ref(h, hu, b, dt_dx)
    return h.contiguous(), hu.contiguous(), b, dt_dx


def wave_inputs(n_cells: int, N: int, device) -> dict:
    """`swe_solve`'s inputs for one whole wave of N sources on the published
    `n_cells` grid, as `apps.tsunami.solve_batch` builds them."""
    device = torch.device(device)
    h, hu, b = initial_state(
        torch.as_tensor(sources(N, 11), device=device), n_cells,
        smoothed=(n_cells == 512),
    )
    dt, n_steps, rows = level_grid(n_cells)
    return dict(h=h, hu=hu, b=b, dt_dx=dt / (L_DOMAIN / n_cells), n_steps=n_steps,
                rows=rows, h0_rows=torch.clamp_min(-b, 0.0)[list(rows), 0])


def slices(C: int, cs: int) -> list[tuple[int, int]]:
    """The cells [lo, hi) that each block of a `cs`-block cluster owns in a
    C-cell column, by cluster rank: C // cs each, the first C % cs ranks
    one more, as csrc/swe_solve.cu cuts it."""
    q, rem = divmod(C, cs)
    bounds = [r * q + min(r, rem) for r in range(cs + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


#: ghost cells a side of a cluster's block in the adjoint, at most
#: (`kGhost` in csrc/swe_solve_vjp.cu)
VJP_GHOST = 32


def vjp_ghost_cells(C: int, cs: int) -> int:
    """k_g, the ghost cells on each side of an adjoint block that has a
    neighbour: min(VJP_GHOST, C // cs), none at cs = 1. A block reloads its
    ghost states every k_g recomputed steps and its ghost cotangents every
    k_g - 1 reverse steps, so a cluster above 1 needs k_g >= 2."""
    return 0 if cs == 1 else min(VJP_GHOST, C // cs)


def vjp_extended_slices(C: int, cs: int) -> list[tuple[int, int, int, int]]:
    """(elo, lo, hi, ehi) of each block of the adjoint's cs-block cluster, by
    rank: it owns [lo, hi) (`slices`) and computes [elo, ehi), k_g ghost
    cells more on each side that has a neighbour, as
    csrc/swe_solve_vjp.cu cuts it."""
    kg = vjp_ghost_cells(C, cs)
    return [(lo - (kg if lo > 0 else 0), lo, hi, hi + (kg if hi < C else 0))
            for lo, hi in slices(C, cs)]


def swe_solve_vjp_clustered(h0, hu0, b, cot_mx, *, dt_dx: float, n_steps: int, rows,
                            h0_rows: torch.Tensor, cs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """csrc/swe_solve_vjp.cu's schedule at cluster size `cs`, in plain
    PyTorch: each block recomputes and sweeps its extended slice
    (`vjp_extended_slices`) with `swe_step_ref` and `swe_step_vjp_ref`,
    whose column ends are walls as the kernel's extended ends are; every
    k_g recomputed steps a block reloads its ghost states from the
    scratch of the owners, its sweep reads every extended cell's state
    from that scratch, and every k_g - 1 reverse steps (and at each
    segment's start) it reloads its ghost cotangents from the owners'. The
    buoy rows' running max is recorded by their owner and its cotangent
    added in every block whose extended slice holds the row. Returns the
    owned cells' (gh, ghu) [C, N]: `ref.swe_solve_vjp_ref`'s bits wherever
    the ghost widths and the rounds keep the owned cells exact."""
    C, N = h0.shape
    k = checkpoint_every(n_steps)
    kg = vjp_ghost_cells(C, cs)
    cuts = vjp_extended_slices(C, cs)
    rows = [int(r) for r in rows]
    h0_buoy = h0_rows.to(h0.dtype).reshape(-1, 1)
    rows_t = torch.as_tensor(rows, device=h0.device)
    # the forward's checkpoints: the whole column's state and running max
    checkpoints = []
    h, hu = h0, hu0
    mx = h0.new_full((len(rows), N), -torch.inf)
    for s in range(n_steps):
        if s % k == 0:
            checkpoints.append((h, hu, mx))
        h, hu = swe_step_ref(h, hu, b, dt_dx)
        mx = torch.maximum(mx, h.index_select(0, rows_t) - h0_buoy)
    lam = [(torch.zeros_like(h0[elo:ehi]), torch.zeros_like(hu0[elo:ehi]))
           for elo, _, _, ehi in cuts]
    gmx = cot_mx.to(h0.dtype).clone()

    def owned(parts):
        # every block's owned cells of its extended arrays, as one column
        return torch.cat([p[lo - elo:hi - elo] for p, (elo, lo, hi, _) in zip(parts, cuts)])

    for seg in range(len(checkpoints) - 1, -1, -1):
        h, hu, mx = checkpoints[seg]
        cnt = min(k, n_steps - seg * k)
        blocks = [(h[elo:ehi], hu[elo:ehi]) for elo, _, _, ehi in cuts]
        scratch, buoys = [], []
        for j in range(cnt):
            scratch.append((owned([x[0] for x in blocks]), owned([x[1] for x in blocks])))
            if cs > 1 and j > 0 and j % kg == 0:
                blocks = [(scratch[j][0][elo:ehi], scratch[j][1][elo:ehi])
                          for elo, _, _, ehi in cuts]
            blocks = [swe_step_ref(bh, bhu, b[elo:ehi], dt_dx)
                      for (bh, bhu), (elo, _, _, ehi) in zip(blocks, cuts)]
            eta = owned([x[0] for x in blocks]).index_select(0, rows_t) - h0_buoy
            buoys.append((mx, eta))
            mx = torch.maximum(mx, eta)
        for r, j in enumerate(range(cnt - 1, -1, -1)):
            if cs > 1 and r % (kg - 1) == 0:
                full = (owned([x[0] for x in lam]), owned([x[1] for x in lam]))
                lam = [(full[0][elo:ehi], full[1][elo:ehi]) for elo, _, _, ehi in cuts]
            # the running max's reverse (`ref._buoy_vjp`), its rows' shares
            # added in every block that holds them
            mx_before, eta = buoys[j]
            shares = [_tie(eta[r], mx_before[r], gmx[r]) for r in range(len(rows))]
            new = []
            for (gh, ghu), (elo, _, _, ehi) in zip(lam, cuts):
                gh = gh.clone()
                for row, share in zip(rows, shares):
                    if elo <= row < ehi:
                        gh[row - elo] += share
                new.append(swe_step_vjp_ref(scratch[j][0][elo:ehi], scratch[j][1][elo:ehi],
                                            b[elo:ehi], dt_dx, gh, ghu))
            lam, gmx = new, _tie(mx_before, eta, gmx)
    return owned([x[0] for x in lam]), owned([x[1] for x in lam])


def strips(C: int, depth: int) -> list[tuple[int, int]]:
    """The cells [lo, hi) of each strip of a C-cell lane at strip depth
    `depth`, as csrc/swe_step.cu cuts it: thread s owns [s T, min(s T + T,
    C)), for s < ceil(C / T)."""
    return [(lo, min(lo + depth, C)) for lo in range(0, C, depth)]


def swe_solve_ref_replayed(h, hu, b, *, dt_dx: float, n_steps: int, rows,
                           h0_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`ref.swe_solve_ref` with its plain step and buoy reduction, the same
    operations in the same order, each step one replay of a CUDA graph
    captured once (`apps.tsunami._replay`): the eager loop's step costs the
    host ~40 launches, the replay one. One captured step serves every step,
    so the new state is copied back into the carried pair (no ping-pong),
    the step index is a device scalar that the step adds 1 to, and the
    arrival is written by `torch.where` on it (`masked_fill_` with a tensor
    value reads it on the host, which a capture forbids); none of these
    changes a value. On the CPU the same body runs eagerly."""
    from repro_torch.apps.tsunami import _replay

    N = h.shape[1]
    rows = torch.as_tensor(rows, device=h.device)
    h0_buoy = h0_rows.reshape(-1, 1)  # [R, 1]
    mx = torch.full((len(rows), N), -torch.inf, device=h.device)
    arr = torch.full((len(rows), N), -1.0, device=h.device)
    h, hu = h.clone(), hu.clone()
    h_nxt, hu_nxt = torch.empty_like(h), torch.empty_like(hu)
    step = torch.zeros((), device=h.device)

    def body():
        swe_step_ref_into(h, hu, b, dt_dx=dt_dx, out=(h_nxt, hu_nxt))
        h.copy_(h_nxt)
        hu.copy_(hu_nxt)
        eta_b = h.index_select(0, rows) - h0_buoy  # [R, N]
        torch.maximum(mx, eta_b, out=mx)
        torch.where((torch.abs(eta_b) > ARRIVAL_THRESH) & (arr < 0), step, arr, out=arr)
        step.add_(1.0)

    _replay(body, n_steps, [h, hu, mx, arr, step])
    return mx, arr


def solve_case_inputs(case: str, device) -> dict:
    """`swe_solve`'s keyword inputs of one entry of `SOLVE_CASES` on `device`."""
    if case.startswith("wave_"):
        C, N = (int(v) for v in case[len("wave_"):].split("x"))
        return wave_inputs(C, N, device)
    if case.startswith("edge_"):
        kw = wave_inputs(*EDGE_SHAPE, device)
        b = kw["b"]
        return dict(kw, n_steps=EDGE_STEPS, rows=EDGE_ROWS,
                    h0_rows=torch.clamp_min(-b, 0.0)[list(EDGE_ROWS), 0])
    h, hu, b = swe_state_from_numpy(*swe_state(case[len("solve_"):]), device)
    return dict(h=h, hu=hu, b=b, dt_dx=CASE_DT_DX, n_steps=CASE_SOLVE_STEPS,
                rows=CASE_SOLVE_ROWS,
                h0_rows=torch.clamp_min(-b, 0.0)[list(CASE_SOLVE_ROWS), 0])


def case_inputs(case: str, device) -> tuple:
    """(h, hu, b, dt_dx) of one entry of `CASES` on `device`."""
    if case.startswith("main_"):
        C, N = (int(v) for v in case[len("main_"):].split("x"))
        return main_path_state(C, N, device)
    if case.startswith("ragged_"):
        # "moving": every cell's update is non-trivial
        C, N = (int(v) for v in case[len("ragged_"):].split("x"))
        return (*swe_state_from_numpy(*swe_state("moving", C, N), device), CASE_DT_DX)
    return (*swe_state_from_numpy(*swe_state(case), device), CASE_DT_DX)


def step_errors(got: torch.Tensor, want: torch.Tensor, old: torch.Tensor) -> dict:
    """How far the float32 step result `got` lies from `want`: the largest
    absolute and relative errors, the largest in units of the float32
    spacing at the larger of the old and the new value, and the step's own
    largest change |want - old|, which puts the error in scale."""
    scale = torch.maximum(old.abs(), want.abs()).float()
    spacing = (torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale).double()
    err = (got.double() - want.double()).abs()
    return {
        "max_abs": float(err.max()),
        "max_rel": float((err / want.double().abs().clamp_min(1e-30)).max()),
        "max_ulp": float((err / spacing).max()),
        "max_change": float((want.double() - old.double()).abs().max()),
    }


def assert_step_equal(got: tuple, want: tuple, old: tuple, what: str) -> dict:
    """Hold one step's `got = (h_new, hu_new)` to `want` bit for bit; `old`
    is the step's input `(h, hu)`. Returns `step_errors` for h and hu and
    raises AssertionError, naming the array, if either differs."""
    report = {}
    for key, g, w, o in zip(("h", "hu"), got, want, old):
        report[key] = step_errors(g, w, o)
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(
                f"{what}, {key}: the kernel differs from the plain version: "
                f"{report[key]}"
            )
    return report


def assert_solve_equal(got: tuple, want: tuple, what: str) -> dict:
    """Hold one solve's `got = (mx, arr)` to `want` bit for bit, a NaN
    matching a NaN. Returns, for mx and arr, the largest absolute difference
    where both are numbers and the count of NaNs, and raises AssertionError,
    naming the output, if either differs."""
    report = {}
    for key, g, w in zip(("mx", "arr"), got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{what}, {key}: shape {tuple(g.shape)}, "
                                 f"expected {tuple(w.shape)}")
        g_nan, w_nan = torch.isnan(g), torch.isnan(w)
        both = ~(g_nan | w_nan)
        g_num, w_num = g[both], w[both]
        diff = torch.where(g_num == w_num, 0.0, (g_num.double() - w_num.double()).abs())
        report[key] = {"max_abs": float(diff.max()) if diff.numel() else 0.0,
                       "nan": int(g_nan.sum())}
        if not (torch.equal(g_nan, w_nan) and torch.equal(g_num, w_num)):
            raise AssertionError(
                f"{what}, {key}: the kernel differs from the plain version: {report[key]}"
            )
    return report


def derivative_errors(got: dict, want: dict, hvp64: np.ndarray) -> dict:
    """Hold float32 derivative waves `got` to `want`, the same waves on the
    same inputs computed another way, both {op: [N, .] array}: every
    first-order op ("gradient", "apply_jacobian", "value_and_gradient",
    whichever `want` has) within GRAD_RTOL32 of its largest entry, and each
    lane of "apply_hessian" to `hvp64`, the float64 HVP, within twice
    `want`'s own error in that lane plus HVP32_FLOOR. Returns the errors
    and raises AssertionError, naming the op, if one is out of bounds."""
    errors = {}
    for op in ("gradient", "apply_jacobian", "value_and_gradient"):
        if op not in want:
            continue
        g, w = np.asarray(got[op], float), np.asarray(want[op], float)
        if g.shape != w.shape:
            raise AssertionError(f"{op}: shape {g.shape}, expected {w.shape}")
        err = float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
        errors[op] = err
        if not err <= GRAD_RTOL32:
            raise AssertionError(f"{op}: error {err:.3g} of the largest entry "
                                 f"(bound {GRAD_RTOL32})")
    scale = np.max(np.abs(hvp64))
    e_got = np.max(np.abs(np.asarray(got["apply_hessian"]) - hvp64), axis=1) / scale
    e_want = np.max(np.abs(np.asarray(want["apply_hessian"]) - hvp64), axis=1) / scale
    errors["apply_hessian_vs_float64"] = e_got.tolist()
    errors["apply_hessian_reference_vs_float64"] = e_want.tolist()
    if not np.all(e_got <= 2 * e_want + HVP32_FLOOR):
        raise AssertionError(f"apply_hessian: lane errors {e_got} vs the float64 HVP, "
                             f"bound 2 x {e_want} + {HVP32_FLOOR}")
    return errors


def vjp_case_inputs(case: str, device) -> dict:
    """`solve_case_inputs` of one entry of `VJP_CASES`, with a cotangent
    `cot_mx` [2, N] of the running max (standard normals, seeded)."""
    if case == "solve_fast_dam_break":
        kw = dict(solve_case_inputs("solve_dam_break", device),
                  dt_dx=FAST_DAM_BREAK["dt_dx"], n_steps=FAST_DAM_BREAK["n_steps"])
    else:
        kw = solve_case_inputs(case, device)
    N = kw["h"].shape[1]
    cot = np.random.default_rng(5).standard_normal((2, N)).astype(np.float32)
    return dict(kw, cot_mx=torch.as_tensor(cot, device=torch.device(device)))


def solve_vjp(h, hu, b, cot_mx, *, dt_dx: float, n_steps: int, rows,
              h0_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gh, ghu): the cotangents of a wave's initial state for `cot_mx`,
    through `swe_solve`'s autograd rule (on the card its checkpointing
    launch and one launch of the adjoint kernel; on the CPU the plain
    adjoint)."""
    x = [h.detach().clone().requires_grad_(), hu.detach().clone().requires_grad_()]
    from repro_torch.kernels.swe.ops import swe_solve

    with torch.enable_grad():
        mx, _ = swe_solve(*x, b, dt_dx=dt_dx, n_steps=n_steps, rows=rows, h0_rows=h0_rows)
        gh, ghu = torch.autograd.grad(mx, x, cot_mx)
    return gh, ghu


def sweep_vjp(h, hu, b, cot_mx, *, dt_dx: float, n_steps: int, rows,
              h0_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same (gh, ghu) through the plain differentiable solver,
    `apps.tsunami._Sweep` over `_ad_wave_step` (PyTorch ops under autograd,
    a kept state a step, each step a replayed CUDA graph on the card), in
    h's dtype."""
    from repro_torch.apps.tsunami import _ad_wave_step, _Sweep

    rows_t = torch.as_tensor(rows, device=h.device)
    step = partial(_ad_wave_step, b=b.to(h.dtype), dt_dx=dt_dx, rows=rows_t,
                   h0_buoy=h0_rows.to(h.dtype).reshape(-1, 1))
    z = torch.stack([h.detach(), hu.detach()]).requires_grad_()
    carry0 = (z[0], z[1], h.new_full((len(rows), h.shape[1]), -torch.inf))
    sweep = _Sweep(step, carry0, n_steps, keep=True)
    sweep.forward(1.0)
    cot = [torch.zeros_like(h), torch.zeros_like(hu), cot_mx.to(h.dtype)]
    gh, ghu = sweep.pull(cot, carry0, z)
    return gh, ghu


def assert_vjp_close(got: tuple, want: tuple, what: str) -> dict:
    """Hold the adjoint's `got = (gh, ghu)` to `want`, the same cotangents
    computed another way: each within GRAD_RTOL32 of its largest entry, all
    finite. Returns each one's error relative to its largest entry (and the
    largest absolute error) and raises AssertionError, naming it, if one is
    out of bounds."""
    report = {}
    for key, g, w in zip(("gh", "ghu"), got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{what}, {key}: shape {tuple(g.shape)}, "
                                 f"expected {tuple(w.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}, {key}: non-finite cotangents")
        diff = (g.double() - w.double()).abs().max()
        scale = w.double().abs().max()
        report[key] = {"max_abs": float(diff), "rel_to_largest": float(diff / scale)
                       if scale > 0 else float(diff)}
        if not report[key]["rel_to_largest"] <= GRAD_RTOL32:
            raise AssertionError(f"{what}, {key}: {report[key]} (bound {GRAD_RTOL32} of "
                                 "the largest entry)")
    return report
