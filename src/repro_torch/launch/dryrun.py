"""Dry run of the LM's cells on a fake process group (counterpart of
`repro.launch.dryrun`).

Each (arch x shape x mesh) cell is traced as one rank of the mesh would run
it, with nothing allocated: a `"fake"` process group of 256, 512 or 8
ranks (PyTorch's `FakeStore`; its collectives return at once and move
nothing), the parameters, optimizer moments, batch and caches as DTensors
whose local shards are meta tensors (shapes and dtypes, no data), placed by
their `PartitionSpec`s (`sanitize_spec`), and the step function
(`models.model.train_step`, `prefill_step` or `decode_step`, with `ctx=`)
run on the plain path (`attn_impl="plain"`, as the reference's dry run
compiles its XLA path), its operations recorded by
`hlo_analysis.OpRecorder`. (Meta tensors, not `FakeTensorMode`: DTensor's
sharding propagation reads a value from a small tensor of its own under
strided shards, which a fake tensor cannot give.) The numbers are
ANALYSIS of that op stream (predicted flops, bytes and collectives of one
rank of the mesh), reckoned against the `types.H100` datasheet peaks; no
card runs anything.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
Test: PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh tiny --reduced --out DIR

One JSON per cell, ``<arch>__<shape>__<mesh>.json``. Its keys are the
reference's wherever the quantity is the same: `total_params`,
`active_params`, `model_flops_per_device` (6 N D for a training step, 2 N D
for a forward, over the ranks), `param_local_bytes` and `cache_local_bytes`
(one rank's shards), `collectives` (`per_device_bytes` and `counts` per
class, ring model), `collective_bytes_per_device`, `roofline_terms_s`
(`compute_s`, `memory_s`, `collective_s` against `H100`), `dominant`,
`memory_ideal_s` and `useful_flops_fraction`. The HLO-only keys have port
names: the reference's `hlo_flops_per_device` is `flops_per_device` (the
recorded matmul flops on local shapes), `hlo_bytes_per_device` is
`bytes_per_device` (unfused operand + result bytes, an upper bound where
the reference counts fusion boundaries), and its `t_lower_s` +
`t_compile_s` is `t_trace_s`. `memory.peak_bytes` is null:
`torch.distributed._tools.mem_tracker.MemTracker` counts the bytes of real
and fake tensors, and the meta tensors of the dry run have none (the
reference's `argument/output/temp_bytes` come from XLA's buffer
assignment, which the port does not have).

If PyTorch's fake process group cannot be imported, the dry run raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import ShardingCtx, sanitize_spec, shard_size_bytes
from repro_torch.launch.hlo_analysis import OpRecorder, analyze
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.adamw import adamw_init_abstract, opt_state_specs
from repro_torch.types import H100, SHAPES, TrainConfig

# per-arch dry-run overrides: the trillion-parameter MoE keeps its optimizer
# moments in bf16, as the reference's dry run does
OPT_DTYPE = {"kimi-k2-1t-a32b": "bfloat16"}

#: the CLI's meshes: (shape, axis names)
MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    "tiny": ((2, 2, 2), ("pod", "data", "model")),
}


def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A `DeviceMesh` over a fake process group of prod(shape) ranks, this
    process being rank 0 (a group of another size, or a real one, is torn
    down first)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # the dry run has no other way to trace a mesh
        raise RuntimeError("the dry run needs PyTorch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from e
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if dist.is_initialized() and (dist.get_world_size() != n
                                  or str(dist.get_backend()) != "fake"):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def _meta_dtensors(abstract, specs, ctx: ShardingCtx):
    """DTensors for a tree of meta stand-ins, each placed by its spec
    (sanitized), its local shard a meta tensor of this rank's shape:
    nothing allocated."""
    from torch.distributed.tensor import DTensor

    def make(a, spec):
        spec = sanitize_spec(spec, a.shape, ctx)
        local = list(a.shape)
        for i, entry in enumerate(spec):
            for name in (() if entry is None else entry if isinstance(entry, tuple)
                         else (entry,)):
                local[i] //= ctx.axis_sizes[name]
        return DTensor.from_local(torch.empty(local, dtype=a.dtype, device="meta"), ctx.mesh,
                                  ctx.placements(spec, a.shape), run_check=False,
                                  shape=a.shape, stride=torch.empty(a.shape, device="meta")
                                  .stride())

    return tree_map(make, abstract, specs)


def _local_bytes(abstract, specs, ctx: ShardingCtx) -> int:
    """One rank's bytes of a tree placed by its (sanitized) specs."""
    sizes = tree_map(lambda a, s: shard_size_bytes(a.shape, a.dtype,
                                                   sanitize_spec(s, a.shape, ctx), ctx),
                     abstract, specs)
    return sum(tree_leaves(sizes))


def build_cell(cfg, shape, ctx: ShardingCtx, tc: TrainConfig):
    """The cell's step as a function of nothing: its parameters, moments,
    batch and caches made as meta DTensors on `ctx`'s mesh."""
    p_abs, p_spec = M.abstract_params(cfg), M.param_specs(cfg)
    params = _meta_dtensors(p_abs, p_spec, ctx)
    b_abs, b_spec = M.batch_specs(cfg, shape, ctx)
    if shape.kind == "train":
        opt = _meta_dtensors(adamw_init_abstract(p_abs, tc), opt_state_specs(p_spec), ctx)
        opt["step"] = torch.zeros((), dtype=torch.int32, device="meta")
        batch = _meta_dtensors(b_abs, b_spec, ctx)
        return lambda: M.train_step(cfg, tc, params, opt, batch, ctx)
    if shape.kind == "prefill":
        batch = _meta_dtensors(b_abs, b_spec, ctx)
        return lambda: M.prefill_step(cfg, params, batch["tokens"],
                                      ctx_embed=batch.get("ctx_embed"), ctx=ctx)
    cache = _meta_dtensors(b_abs["cache"], b_spec["cache"], ctx)
    token = _meta_dtensors(b_abs["token"], b_spec["token"], ctx)
    # the last position: attention reads every cached row, as the
    # reference's masked decode does
    return lambda: M.decode_step(cfg, params, cache, token, shape.seq_len - 1, ctx=ctx)


def run_cell(arch: str, shape_name: str, mesh, *, reduced: bool = False,
             overrides: dict | None = None) -> dict:
    """One cell's analysis (module docstring) on `mesh`, a `DeviceMesh` over
    a fake group (`fake_mesh`) or a name of `MESHES`."""
    if isinstance(mesh, str):
        mesh = fake_mesh(*MESHES[mesh])
    cfg = get_config(arch, reduced=reduced)
    if overrides:
        cfg = cfg.replace(**overrides)
    cfg = cfg.replace(attn_impl="plain")
    shape = SHAPES[shape_name]
    if reduced:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 128),
            global_batch=max(math.prod(mesh.shape[:-1]), 2) if shape.global_batch > 16
            else shape.global_batch)
    tc = TrainConfig(opt_state_dtype=OPT_DTYPE.get(arch, "float32"))
    ctx = ShardingCtx(mesh)
    n_dev = mesh.size()
    recorder = OpRecorder()
    step = build_cell(cfg, shape, ctx, tc)
    t0 = time.time()
    with recorder:
        step()
    t_trace = time.time() - t0
    parsed = analyze(recorder.ops, n_dev)
    flops, bytes_accessed = parsed["flops"], parsed["bytes_accessed"]
    coll = {"per_device_bytes": parsed["collective_per_device_bytes"],
            "counts": parsed["collective_counts"]}
    coll_bytes = sum(coll["per_device_bytes"].values())
    terms = {
        "compute_s": flops / H100.peak_flops_bf16,
        "memory_s": bytes_accessed / H100.hbm_bandwidth,
        "collective_s": coll_bytes / H100.ici_link_bandwidth,
    }
    total_params, active_params = cfg.param_count()
    param_local_bytes = _local_bytes(M.abstract_params(cfg), M.param_specs(cfg), ctx)
    cache_local_bytes = 0
    if shape.kind == "decode":
        decls = transformer.cache_decl(cfg, shape.global_batch, shape.seq_len, ctx)
        cache_local_bytes = sum(
            shard_size_bytes(d.shape, d.dtype, sanitize_spec(d.spec, d.shape, ctx), ctx)
            for d in tree_leaves(decls))
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * active_params * tokens / n_dev
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_devices": n_dev,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "reduced": reduced,
        "overrides": dict(overrides) if overrides else {},
        "hardware": H100.name,
        "t_trace_s": round(t_trace, 2),
        "memory": {"peak_bytes": None},
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "ops_recorded": parsed["ops"],
        "collectives": coll,
        "collective_bytes_per_device": coll_bytes,
        "roofline_terms_s": terms,
        "dominant": max(terms, key=terms.get),
        "model_flops_per_device": model_flops,
        "useful_flops_fraction": (model_flops / flops) if flops else None,
        "total_params": total_params,
        "active_params": active_params,
        "param_local_bytes": param_local_bytes,
        "cache_local_bytes": cache_local_bytes,
        "memory_ideal_s": (param_local_bytes + 2 * cache_local_bytes) / H100.hbm_bandwidth,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both", "tiny"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    names = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    for mesh_name in names:
        mesh = fake_mesh(*MESHES[mesh_name])
        for arch in archs:
            cfg = get_config(arch)
            for shape_name in shapes:
                if shape_name == "long_500k" and not cfg.sub_quadratic:
                    print(f"SKIP {arch} x long_500k (full attention)")
                    continue
                tag = f"{arch}__{shape_name}__{mesh_name}"
                fp = outdir / f"{tag}.json"
                if fp.exists():
                    print(f"cached {tag}")
                    continue
                print(f"=== {tag} ===", flush=True)
                try:
                    res = run_cell(arch, shape_name, mesh, reduced=args.reduced)
                    fp.write_text(json.dumps(res, indent=1))
                    print(f"  ok: trace={res['t_trace_s']}s "
                          f"flops/dev={res['flops_per_device']:.3e} "
                          f"coll/dev={res['collective_bytes_per_device']:.3e}B "
                          f"dominant={res['dominant']} (analysis, {H100.name} datasheet peaks)",
                          flush=True)
                except Exception as e:  # noqa: BLE001 - every cell is tried, then the run fails
                    failures.append((tag, repr(e)[:500]))
                    print(f"  FAIL: {e!r}"[:600], flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print("\nFAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
