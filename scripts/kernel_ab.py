#!/usr/bin/env python3
"""The float32 flash-attention kernel, the bf16 flash-attention backward,
the SWE step kernel and the SWE solve's adjoint of this checkout beside
those of another checkout, timed in turns on one GPU.

    python3 scripts/kernel_ab.py --parent DIR [--parts step flash bwd path vjp]
                                 [--out build/kernel_ab.jsonl]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with `git archive`). Its `flash_attention.cu`,
`flash_attention_bwd.cu` and `swe_step.cu` are built with this checkout's
nvcc flags into `build/repro_torch_kernels/`; the parent's step goes through
the parent's own wrapper (its `kernels/swe/ops.py`), its flash kernel is
bound as `ops.launch` binds this one, and its backward as the parent's
`ops.flash_attention_bwd` called it (`bind_bwd`); this checkout's kernels go
through their wrappers. Both sides get the same inputs and must agree: the
step bit for bit, at every strip depth; flash attention within the float32
bound of `kernels/flash_attention/testing.py`, each side also held to the
plain version; the backward, each side held to the plain backward run from
the plain forward's own o and log-sum-exp within `BWD_RTOL`. Every time is
the median device time of chip_smoke.py's `_device_ms`, taken parent, this,
this, parent, and each side's two readings are kept. `--parts` picks what
runs (default all; the first line printed names it): a change to one
kernel needs only its part (`--parts bwd` for the backward alone, a few
minutes of the card where the whole A/B takes longer). Measured:

* `swe_step`: one step at the main path's eight [cells, lanes] shapes and
  at [2, 1] (the floor: one launch of the smallest step), the plan's strip
  depth and every depth, beside the bytes bound;
* the step kernel's own path, `solve_batch(step=...)`: the wall of a 16-
  and a 512-lane wave at both levels (host clock to a device sync);
* float32 flash attention at the float32 FLASH_CASES shapes, the float32
  path's `[26, 4, 2, 512, 32]` and qwen3-0.6b's `[2, 16, 8, 2048, 128]`,
  beside both bounds (3xTF32 on the tensor cores and float32 on the CUDA
  cores) and `F.scaled_dot_product_attention`; and the kernel's bf16
  instance at qwen3-0.6b's shape (its model layout), the yardstick of the
  bf16 tensor-core kernel;
* the flash-attention backward (`flash_attention_bwd`: this checkout's
  library of `ops.bwd_stem` against the parent's `flash_attention_bwd.cu`,
  `bind_bwd`) at every `testing.BWD_CASES` shape of a dtype the parent's
  library takes (the older form took both, the later float32 only), at the model
  layout, beside the bound of chip_smoke.py's `flash_bwd_work` (the five
  products at the bf16 peak; float32 three times them, 3xBF16), with
  whether the two sides' gradients are the same bits
  (`bit_for_bit_with_parent`);
* the SWE solve's adjoint (`vjp`: the parent's `swe_solve_vjp.cu` and
  `swe_solve.cu` through the parent's own wrappers, `parent_swe_ops`, each
  side's adjoint on its own checkpoints, whose layout may differ) at
  chip_smoke.py's `VJP_TIMED` shapes, the adjoint at each side's plan
  beside chip_smoke.py's `vjp_work` bound, and the solve with and without
  checkpoints; the two sides' (gh, ghu), (mx, arr) and the limiter cases'
  cotangents must be the same bits.

Prints one JSON line per measurement, writes them all to --out, and exits
non-zero without a CUDA device or on any disagreement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: [cells, lanes] of the timed steps: the main path's and the floor's
STEP_SHAPES = tuple((C, N) for C in (512, 2048) for N in (4, 16, 64, 512)) + ((2, 1),)
#: (cells, lanes) of the step path's timed waves
PATH_WAVES = ((2048, 16), (2048, 512), (512, 16), (512, 512))


#: the parent's libraries each part needs: (stem, kernels/ subdirectory)
PARENT_LIBS = {"step": [("swe_step", "swe")], "path": [("swe_step", "swe")],
               "flash": [("flash_attention", "flash_attention")],
               "bwd": [("flash_attention_bwd", "flash_attention")],
               "vjp": [("swe_solve", "swe"), ("swe_solve_vjp", "swe")]}
#: the adjoint's cases held bit for bit between the sides, untimed
VJP_BITS_ONLY = ("solve_dam_break", "solve_dry_bed", "solve_fast_dam_break")


def build_parent(parent: Path, stems) -> dict:
    """The parent's kernel libraries `stems` ((stem, kernels/ subdirectory)
    pairs), built together with this checkout's flags; returns {stem:
    CDLL}, each with its source text as `.source`."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, sub in stems:
        src = parent / "src" / "repro_torch" / "kernels" / sub / "csrc" / f"{stem}.cu"
        so = _build.BUILD_DIR / f"lib{stem}_parent.so"
        procs[stem] = (src, so, subprocess.Popen(
            [_build.nvcc(), *_build.flags(stem), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (src, so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {stem}: nvcc exited {proc.returncode}\n{out}")
        libs[stem] = ctypes.CDLL(str(so))
        libs[stem].source = src.read_text()
    return libs


def parent_swe_ops(parent: Path, libs: dict):
    """The parent's own `kernels/swe/ops.py` (loaded under another name
    beside this checkout's modules), its `_build.load` giving the parent's
    libraries `libs` by stem, so that both sides pay their own wrapper."""
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location(
        "parent_swe_ops", parent / "src" / "repro_torch" / "kernels" / "swe" / "ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(load=lambda stem: libs[stem])
    return mod


def parent_step(parent: Path, lib):
    """The parent's own wrapper `swe_step` launching the parent's library."""
    return parent_swe_ops(parent, {"swe_step": lib}).swe_step


def bind_flash(lib):
    """The flash kernel of `lib` (its `flash_attention_fwd`), called as
    `ops.launch` calls this checkout's, at the default scale 1 / sqrt(hd):
    passed as an argument where the library's entry point takes one (its
    source declares `double scale`), fixed inside it where it does not; a
    null log-sum-exp pointer where it takes one (`void* lse`)."""
    import math

    import torch

    from repro_torch.kernels.flash_attention import ops

    fn = lib.flash_attention_fwd
    scaled = "double scale" in lib.source
    lse = [None] if "void* lse" in lib.source else []
    fn.argtypes = [ctypes.c_void_p] * (4 + len(lse)) + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        *([ctypes.c_double] if scaled else []), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(q, k, v, o, causal):
        B, nq, Sq, hd = q.shape
        strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, o) for s in ops._strides(t)])
        scale = [1.0 / math.sqrt(hd)] if scaled else []
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *lse, B, nq, k.shape[1], Sq,
                 k.shape[2], hd, ops._CODES[q.dtype], strides, int(causal), *scale,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{lib._name}: flash_attention_fwd: cudaError {err}")

    return launch


def bind_bwd(lib):
    """The parent's backward entry point (`flash_attention_bwd` of its
    `flash_attention_bwd.cu`), called as the parent's
    `ops.flash_attention_bwd` called it: outputs and its D scratch
    ([B, nq, Sq] float32) allocated per call, the default scale 1 / sqrt(hd)
    where none is given. Its form comes from its source: the older one took
    both dtypes through an `int dtype` argument (code 1 bf16, 0 float32),
    the later one float32 alone and no such argument. -> (backward, the
    dtype names it takes)."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    both = "int dtype" in lib.source
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * (7 if both else 6) + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def bwd(q, k, v, o, lse, do, causal, scale):
        B, nq, Sq, hd = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dsum = torch.empty_like(lse)
        strides = (ctypes.c_longlong * 24)(
            *[s for t in (q, k, v, o, do, dq, dk, dv) for s in ops._strides(t)])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, nq, k.shape[1], Sq, k.shape[2], hd, *([codes[q.dtype]] if both else []),
                 strides, int(causal), ops.default_scale(hd) if scale is None else scale,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{lib._name}: flash_attention_bwd: cudaError {err}")
        return dq, dk, dv

    return bwd, ("float32", "bfloat16") if both else ("float32",)


def in_turns(torch, chip_smoke, parent_fn, this_fn, calls: int) -> dict:
    """Device ms of one call: parent, this, this, parent."""
    p1 = chip_smoke._device_ms(torch, parent_fn, calls)
    t1 = chip_smoke._device_ms(torch, this_fn, calls)
    t2 = chip_smoke._device_ms(torch, this_fn, calls)
    p2 = chip_smoke._device_ms(torch, parent_fn, calls)
    return {"parent_ms": [p1, p2], "ms": [t1, t2]}


def step_times(torch, chip_smoke, step) -> list:
    from repro_torch.convert import swe_state_from_numpy
    from repro_torch.kernels.swe import ops, swe_step
    from repro_torch.kernels.swe.testing import main_path_state, swe_state

    rows = []
    for C, N in STEP_SHAPES:
        if (C, N) == (2, 1):
            h, hu, b = swe_state_from_numpy(*swe_state("moving", C, N), "cuda")
            dt_dx = 0.02
        else:
            h, hu, b, dt_dx = main_path_state(C, N, "cuda")
        mine, theirs = (torch.empty_like(h), torch.empty_like(hu)), (torch.empty_like(h),
                                                                     torch.empty_like(hu))
        step(h, hu, b, dt_dx=dt_dx, out=theirs)
        for strip in (None, *ops.STRIP_DEPTHS):
            swe_step(h, hu, b, dt_dx=dt_dx, out=mine, strip=strip)
            torch.cuda.synchronize()
            if not (torch.equal(mine[0], theirs[0]) and torch.equal(mine[1], theirs[1])):
                raise AssertionError(f"swe_step {C}x{N}, strip {strip}: differs from the parent")
        row = {"shape": [C, N], "plan": ops.strip_plan(C, N),
               **in_turns(torch, chip_smoke, lambda: step(h, hu, b, dt_dx=dt_dx, out=theirs),
                          lambda: swe_step(h, hu, b, dt_dx=dt_dx, out=mine), 200)}
        row["ms_by_strip"] = {
            str(s): chip_smoke._device_ms(
                torch, lambda s=s: swe_step(h, hu, b, dt_dx=dt_dx, out=mine, strip=s), 200)
            for s in ops.STRIP_DEPTHS}
        row["bytes_bound_ms"] = (4 * C * N + C) * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3
        rows.append(row)
        emit("step", **row)
    return rows


def path_walls(torch, step) -> list:
    from repro_torch.apps.tsunami import solve_batch
    from repro_torch.kernels.swe import swe_step
    from repro_torch.kernels.swe.testing import sources

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    rows = []
    for n_cells, lanes in PATH_WAVES:
        thetas = torch.as_tensor(sources(lanes, 11), device="cuda")
        theirs = lambda: solve_batch(thetas, n_cells, n_cells == 512, step=step)  # noqa: E731
        mine = lambda: solve_batch(thetas, n_cells, n_cells == 512, step=swe_step)  # noqa: E731
        theirs(), mine()  # warm-up
        p1, want = wall(theirs)
        t1, got = wall(mine)
        t2, _ = wall(mine)
        p2, _ = wall(theirs)
        if not torch.equal(got, want):
            raise AssertionError(f"step path {n_cells}x{lanes}: differs from the parent")
        row = {"wave": [n_cells, lanes], "parent_wall_s": [p1, p2], "wall_s": [t1, t2]}
        rows.append(row)
        emit("step_path", **row)
    return rows


def flash_times(torch, chip_smoke, launch) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import testing as T

    qwen3 = (2, T.QWEN3_HEADS, T.QWEN3_KV_HEADS, T.MAIN_PATH_SEQ, T.MAIN_PATH_SEQ, T.QWEN3_HD,
             True)
    cases = [c for c in T.FLASH_CASES if c[7] == "float32"] + [
        chip_smoke.F32_PATH_CASE, (*qwen3, "float32"), (*qwen3, "bfloat16")]
    rows = []
    for i, case in enumerate(cases):
        B, nq, nkv, Sq, Sk, hd, causal, dt = case
        q, k, v = T.case_inputs(case, "cuda", seed=i)
        if dt == "bfloat16":
            q, k, v = chip_smoke._model_layout(q, k, v)
        mine, theirs = torch.empty_like(q), torch.empty_like(q)
        ops.launch("flash_attention", q, k, v, mine, causal)
        launch(q, k, v, theirs, causal)
        torch.cuda.synchronize()
        want = T.plain(q, k, v, causal)
        name = T.case_name(case)
        errs = {"max_abs_err": T.assert_close(mine, want, name)["max_abs_err"],
                "parent_max_abs_err": T.assert_close(theirs, want, f"parent {name}")["max_abs_err"]}
        work = chip_smoke.flash_work(B, nq, nkv, Sq, Sk, hd, causal, q.element_size())
        calls = 10 if work["flops"] > 1e10 else 50
        row = {"shape": [B, nq, nkv, Sq, hd], "causal": causal, "dtype": dt, **errs,
               **in_turns(torch, chip_smoke, lambda: launch(q, k, v, theirs, causal),
                          lambda: ops.launch("flash_attention", q, k, v, mine, causal), calls)}
        row["library_ms"] = chip_smoke._device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), calls)
        t_bytes = work["bytes"] / chip_smoke.HBM_BYTES_PER_S
        row["tf32x3_bound_ms"] = max(t_bytes, 3 * work["flops"] / chip_smoke.TF32_FLOPS) * 1e3
        row["fp32_bound_ms"] = max(t_bytes, work["flops"] / chip_smoke.FP32_FLOPS) * 1e3
        rows.append(row)
        emit("flash", **row)
        del q, k, v, mine, theirs, want
        torch.cuda.empty_cache()
    return rows


def bwd_times(torch, chip_smoke, parent_bwd, dtypes) -> list:
    """Each `BWD_CASES` case of a dtype in `dtypes` (those the parent's
    library takes), parent and this checkout in turns."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
    from repro_torch.kernels.flash_attention import testing as T

    rows = []
    for i, (name, zoo) in enumerate(T.BWD_CASES.items()):
        B, nq, nkv, Sq, Sk, hd, causal, dt = zoo.case
        if dt not in dtypes:
            continue
        q, k, v, do = T.bwd_inputs(zoo, "cuda", seed=300 + i)
        o, lse = ops._forward(q, k, v, causal, zoo.scale, want_lse=True)
        mine = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal,  # noqa: E731
                                           scale=zoo.scale)
        theirs = lambda: parent_bwd(q, k, v, o, lse, do, causal, zoo.scale)  # noqa: E731
        got, old = mine(), theirs()
        torch.cuda.synchronize()
        want = T.plain_bwd(q, k, v, *T.plain_forward(q, k, v, causal, zoo.scale), do, causal,
                           zoo.scale)
        errs = {"errors": T.bwd_errors(got, want, dt, name),
                "parent_errors": T.bwd_errors(old, want, dt, f"parent {name}"),
                "bit_for_bit_with_parent": all(torch.equal(a, b) for a, b in zip(got, old))}
        del got, old, want
        dqk, dv = zoo.widths or (hd, hd)
        work = chip_smoke.flash_bwd_work(B, nq, nkv, Sq, Sk, dqk, causal, q.element_size(),
                                         hd_v=dv)
        t_bytes = work["bytes"] / chip_smoke.HBM_BYTES_PER_S
        # bf16 products at the bf16 peak; float32 as 3xBF16, three times them
        t_ops = work["flops"] / chip_smoke.BF16_FLOPS * (1 if dt == "bfloat16" else 3)
        big = B * nq * Sq * Sk * hd > 2e11
        row = {"case": name, "shape": [B, nq, nkv, Sq, hd], "sk": Sk, "causal": causal,
               "dtype": dt, "scale": zoo.scale, "library": ops.bwd_stem(q.dtype), **errs,
               **in_turns(torch, chip_smoke, theirs, mine, 5 if big else 20),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        row["speedup"] = sum(row["parent_ms"]) / sum(row["ms"])
        row["share_of_bound"] = row["bound_ms"] / statistics.median(row["ms"])
        rows.append(row)
        emit("bwd", **row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def vjp_times(torch, chip_smoke, theirs) -> list:
    """The adjoint and the checkpointing solve at `VJP_TIMED`, this checkout
    and the parent's wrappers `theirs` in turns, each side on its own
    checkpoints; then the limiter cases' cotangents, bits only."""
    from repro_torch.kernels.swe import ops
    from repro_torch.kernels.swe.testing import vjp_case_inputs

    rows = []
    for case in (*chip_smoke.VJP_TIMED, *VJP_BITS_ONLY):
        kw = vjp_case_inputs(case, "cuda")
        h, hu, b, cot = kw.pop("h"), kw.pop("hu"), kw.pop("b"), kw.pop("cot_mx")
        b = b[:, None] if b.dim() == 1 else b
        C, N = h.shape
        args = (h, hu, b, kw["dt_dx"], kw["n_steps"], kw["rows"], kw["h0_rows"], None)
        mine_ck, their_ck = ops._solve(*args, keep=True), theirs._solve(*args, keep=True)
        mine = lambda: ops.swe_solve_vjp(b, *mine_ck[2:], cot, **kw)  # noqa: E731
        their = lambda: theirs.swe_solve_vjp(b, *their_ck[2:], cot, **kw)  # noqa: E731
        got, old = mine(), their()
        torch.cuda.synchronize()
        row = {"case": case, "shape": [C, N], "n_steps": kw["n_steps"],
               "bit_for_bit_with_parent": all(torch.equal(a, b_) for a, b_ in zip(got, old)),
               "primal_bit_for_bit_with_parent": all(
                   torch.equal(a, b_) for a, b_ in zip(mine_ck[:2], their_ck[:2]))}
        if case in chip_smoke.VJP_TIMED:
            calls = 1 if C * N > 16 * 512 else 3
            work = chip_smoke.vjp_work(C, N, kw["n_steps"], len(kw["rows"]))
            t_bytes = work["bytes"] / chip_smoke.HBM_BYTES_PER_S
            t_ops = work["ops"] / chip_smoke.FP32_FLOPS
            row.update(
                cluster=ops.vjp_cluster_plan(C, N),
                adjoint=in_turns(torch, chip_smoke, their, mine, calls),
                solve_with_checkpoints=in_turns(
                    torch, chip_smoke, lambda: theirs._solve(*args, keep=True),
                    lambda: ops._solve(*args, keep=True), 5),
                solve=in_turns(torch, chip_smoke, lambda: theirs._solve(*args, keep=False),
                               lambda: ops._solve(*args, keep=False), 5),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            row["speedup"] = sum(row["adjoint"]["parent_ms"]) / sum(row["adjoint"]["ms"])
            row["share_of_bound"] = row["bound_ms"] / statistics.median(row["adjoint"]["ms"])
        rows.append(row)
        emit("vjp", **row)
        del mine_ck, their_ck, got, old
        torch.cuda.empty_cache()
    return rows


_out = None


def emit(what: str, **fields) -> None:
    line = json.dumps({"measure": what, **fields})
    print(line, flush=True)
    if _out is not None:
        with _out.open("a") as f:
            f.write(line + "\n")


def main() -> int:
    global _out
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--parts", nargs="+", choices=tuple(PARENT_LIBS), default=list(PARENT_LIBS))
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_ab.jsonl")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("")
    _out = args.out
    libs = build_parent(args.parent.resolve(),
                        sorted({lib for p in args.parts for lib in PARENT_LIBS[p]}))
    emit("card", card=chip_smoke.nvidia_smi(), device=torch.cuda.get_device_name(0),
         parts=args.parts)
    if {"step", "path"} & set(args.parts):
        step = parent_step(args.parent.resolve(), libs["swe_step"])
    if "step" in args.parts:
        step_times(torch, chip_smoke, step)
    if "flash" in args.parts:
        flash_times(torch, chip_smoke, bind_flash(libs["flash_attention"]))
    if "bwd" in args.parts:
        bwd_times(torch, chip_smoke, *bind_bwd(libs["flash_attention_bwd"]))
    if "path" in args.parts:
        path_walls(torch, step)
    if "vjp" in args.parts:
        rows = vjp_times(torch, chip_smoke, parent_swe_ops(args.parent.resolve(), libs))
        if not all(r["bit_for_bit_with_parent"] and r["primal_bit_for_bit_with_parent"]
                   for r in rows):
            print("kernel_ab: the adjoint differs from the parent's", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
