"""Multi-rank harness of the port's mesh tests (tests/test_torch_mesh.py
and the `ctx=` tests of test_torch_pool.py, test_torch_mlda.py and
test_torch_checkpoint.py).

`run_ranks(world, scenario, tmp_path, timeout_s=..., **kw)` starts `world`
`gloo` ranks on the CPU with `torch.multiprocessing` (spawn: the test
process has JAX loaded and threads running), each joining one process
group through a `FileStore` in a fresh directory under `tmp_path` (never a
fixed TCP port: the suite runs under xdist), and runs the function
`scenario` of this module on every rank as ``scenario(rank, **kw)``. It
returns every rank's result, in rank order. A rank that raises, or a run
that outlasts `timeout_s` (a collective that hangs), fails the test with
the rank's traceback; every process is gone when it returns.

`one_rank_mesh()` is the in-process counterpart: a world of one `gloo` rank
and its 1x1 CPU mesh as a `ShardingCtx`, torn down on exit.

The scenarios import torch, numpy and the port only, never JAX: what a test
compares them with, it computes in the test process and passes as numpy.
"""
from __future__ import annotations

import contextlib
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

#: the reduced tsunami of the port's hierarchy tests (64 / 128 cells)
N_CELLS = {0: 64, 1: 128}


def run_ranks(world: int, scenario: str, tmp_path: Path, *, timeout_s: float = 120.0,
              **kw) -> list:
    where = Path(tmp_path) / f"ranks_{scenario}_{world}"
    where.mkdir(parents=True)
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=_rank_main, args=(r, world, str(where), scenario, kw),
                           daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = {r: (where / f"rank{r}.err").read_text() for r in range(world)
              if (where / f"rank{r}.err").exists()}
    if errors:
        raise AssertionError("\n".join(f"rank {r} of {world} raised:\n{tb}"
                                       for r, tb in errors.items()))
    if hung:
        raise AssertionError(f"ranks {hung} of {world} ran past {timeout_s} s ({scenario})")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"{scenario}: exit codes {codes}")
    return [pickle.loads((where / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _rank_main(rank: int, world: int, where: str, scenario: str, kw: dict) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_ranks, init_ranks

    torch.set_num_threads(1)  # a batched solve hangs with more (verify skill)
    try:
        init_ranks("gloo", rank=rank, world_size=world, timeout_s=60.0,
                   store=dist.FileStore(str(Path(where) / "store"), world))
        out = globals()[scenario](rank, **kw)
        (Path(where) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    except BaseException:
        (Path(where) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        destroy_ranks()


def _mesh(shape, axes=("data", "model")):
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import make_mesh

    return ShardingCtx(make_mesh(shape, axes, backend="gloo", device="cpu"))


@contextlib.contextmanager
def one_rank_mesh():
    """A `ShardingCtx` over a 1x1 CPU mesh of this process alone."""
    from repro_torch.launch.mesh import destroy_ranks

    try:
        yield _mesh((1, 1))
    finally:
        destroy_ranks()


# -- what the ranks run ---------------------------------------------------------


def quad(th):
    return torch.stack([torch.sum(th ** 2), th[0] * th[1]])


def tsunami_model():
    """The port's TsunamiModel on the CPU at the reduced levels."""
    from repro_torch.apps import tsunami

    model = tsunami.TsunamiModel(device="cpu")
    model.N_CELLS = N_CELLS
    return model


def pool_waves(ctx, waves: dict) -> dict:
    """Each named wave (quad: [N, 2]; tsunami levels: [N, 2] sources)
    through `ModelPool(model, ctx)`: (outputs, the pool's stats)."""
    from repro_torch.core.interface import TorchModel
    from repro_torch.core.pool import ModelPool

    out = {}
    quad_pool = ModelPool(TorchModel(quad, 2, 2, device="cpu"), ctx=ctx)
    tsunami_pool = ModelPool(tsunami_model(), ctx=ctx)
    for name, thetas in waves.items():
        if name.startswith("quad"):
            out[name] = quad_pool.evaluate(thetas)
        else:
            out[name] = tsunami_pool.evaluate(thetas, {"level": int(name[-1])})
    out["quad_stats"] = dict(quad_pool.stats)
    out["n_instances"] = quad_pool.n_instances
    return out


def fused_rwm(ctx, x0s, n_steps: int, S: int, seed: int, per_step: bool = False,
              checkpoint_dir: str | None = None):
    """A fused RWM over a row-wise Gaussian target on the CPU: (samples,
    logposts, accept rates)."""
    from repro_torch.core.fleet import CampaignCheckpoint
    from repro_torch.uq.fused import fused_ensemble_rwm, gaussian_target

    d = x0s.shape[1]
    ckpt = None if checkpoint_dir is None else CampaignCheckpoint(checkpoint_dir, keep_last=8)
    res = fused_ensemble_rwm(gaussian_target(np.linspace(-1.0, 1.0, d)), x0s, n_steps,
                             0.5 * np.eye(d), torch.Generator().manual_seed(seed),
                             fused_steps=S, per_step=per_step, ctx=ctx, checkpoint=ckpt,
                             checkpoint_every=S if ckpt is not None else 0)
    return res.samples, res.logposts, res.accept_rates


def fused_mala(ctx, x0s, n_steps: int, S: int, seed: int):
    """A fused MALA with step-size adaptation over the whole run, on a
    correlated Gaussian: (samples, logposts, final step size)."""
    from repro_torch.uq.fused import fused_ensemble_mala, gaussian_target

    d = x0s.shape[1]
    cov = 0.5 * np.eye(d) + 0.25
    res = fused_ensemble_mala(gaussian_target(np.zeros(d), cov), x0s, n_steps, 0.8,
                              torch.Generator().manual_seed(seed), fused_steps=S,
                              adapt_steps=n_steps, precond=cov, ctx=ctx)
    return res.samples, res.logposts, res.final_step_size


def lm_nlls(ctx, arch: str, params: dict, batch: dict, thetas) -> np.ndarray:
    """The reduced LMUQModel on carried weights, `ctx=`: its wave's NLLs."""
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy

    weights = lm_params_from_numpy(get_config(arch, True), params, "cpu")
    lm = LMUQModel(arch, reduced=True, device="cpu", params=weights, batch=batch, ctx=ctx)
    return lm.evaluate_batch(thetas)


def restore_sharded(ctx, directory: str, like: dict, specs: dict) -> dict:
    """`restore(like, shardings=sanitized_shardings(ctx, like, specs))`:
    each leaf's full tensor, local shape and placements (a leaf without a
    spec: its value and type)."""
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import sanitized_shardings

    got, step = CheckpointManager(directory).restore(
        like, shardings=sanitized_shardings(ctx, like, specs), device="cpu")
    out = {"step": step}
    for k, v in got.items():
        if specs.get(k) is None:
            out[k] = (type(v).__name__, v.numpy())
        else:
            out[k] = (v.full_tensor().numpy(), tuple(v.to_local().shape),
                      tuple(repr(p) for p in v.placements))
    return out


def two_rank_suite(rank: int, *, waves, fused, lm, restore, checkpoint_dir) -> dict:
    """Everything the 2-rank tests check, in one process group: the pool's
    waves on a 2x1 mesh, the fused RWM (fused, per step, and with a
    checkpoint every block, written by rank 0), the fused MALA with its
    step-size adaptation, the LM's wave and a restore onto the same mesh."""
    ctx = _mesh((2, 1))
    out = {"rows": ctx.rows(4), "pool": pool_waves(ctx, waves)}
    out["fused"] = fused_rwm(ctx, **fused)
    out["per_step"] = fused_rwm(ctx, **{**fused, "per_step": True})
    out["checkpointed"] = fused_rwm(ctx, **fused, checkpoint_dir=checkpoint_dir)
    out["mala"] = fused_mala(ctx, **fused)
    out["lm"] = lm_nlls(ctx, **lm)
    out["restore"] = restore_sharded(ctx, **restore)
    return out


def four_rank_suite(rank: int, *, waves, restore) -> dict:
    """The pool's waves on a 4x1 mesh and on a 2x2 mesh (two model-axis
    replicas of each row shard), and a restore onto the 2x2 mesh."""
    ctx41, ctx22 = _mesh((4, 1)), _mesh((2, 2))
    return {"pool41": pool_waves(ctx41, waves), "pool22": pool_waves(ctx22, waves),
            "restore": restore_sharded(ctx22, **restore),
            "coordinate": ctx22.coordinate, "batch_index": ctx22.batch_index}


# -- the LM's layout on the mesh (tests/test_torch_lm_mesh.py) -----------------------


def lm_case(arch: str, B: int, S: int, **replace):
    """The reduced `arch` (fields `replace`d), its weights from seed 0 and a
    [B, S] batch from seed 1, on the CPU: the same on every rank and in the
    test process."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch, reduced=True).replace(**replace)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params, M.make_synth_batch(cfg, B, S, torch.Generator().manual_seed(1))


def _full(tree):
    """A tree of DTensors (or tensors) as numpy leaves, in tree order."""
    from repro_torch.models.params import tree_leaves

    return [(t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()
            for t in tree_leaves(tree)]


def mesh_nlls(ctx, archs, B: int, S: int) -> dict:
    """Each reduced arch's per-sequence NLLs [B] on the mesh, its weights
    sharded by `param_specs` (`eval_nll(..., ctx)`), gathered."""
    from repro_torch.models import model as M

    out = {}
    for arch in archs:
        cfg, params, batch = lm_case(arch, B, S)
        sharded = M.shard_params(cfg, params, ctx)
        out[arch] = M.eval_nll(cfg, sharded, batch, ctx).full_tensor().numpy()
    return out


def mesh_train_step(ctx, arch: str, B: int, S: int) -> dict:
    """A training step of the reduced arch on the mesh: `loss_and_grads`'
    gradients, then `train_step`'s metrics and updated weights (from the
    same sharded weights), all gathered."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.types import TrainConfig

    cfg, params, batch = lm_case(arch, B, S)
    tc = TrainConfig(warmup_steps=0)
    _, _, grads = M.loss_and_grads(cfg, M.shard_params(cfg, params, ctx), batch, ctx)
    sharded = M.shard_params(cfg, params, ctx)
    opt = adamw_init(sharded, tc)
    sharded, opt, metrics = M.train_step(cfg, tc, sharded, opt, batch, ctx)
    return {"grads": _full(grads), "params": _full(sharded),
            "metrics": {k: float(_full([v])[0]) for k, v in metrics.items()},
            "sharded": any(p.is_shard() for leaf in _leaves(sharded) for p in leaf.placements)}


def _leaves(tree):
    from repro_torch.models.params import tree_leaves

    return tree_leaves(tree)


def lm_mesh_waves(ctx, arch: str, params: dict, batch: dict, thetas, senss, vecs) -> dict:
    """The reduced LMUQModel on carried weights, sharded over the mesh: its
    evaluate, gradient and Hessian-action waves and its capabilities."""
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy

    weights = lm_params_from_numpy(get_config(arch, True), params, "cpu")
    lm = LMUQModel(arch, reduced=True, device="cpu", params=weights, batch=batch, ctx=ctx)
    out = {"evaluate": lm.evaluate_batch(thetas), "gradient": lm.gradient_batch(thetas, senss),
           "hessian": lm.apply_hessian_batch(thetas, senss, vecs),
           "capabilities": lm.capabilities().to_json(),
           "sharded": any(p.is_shard() for t in _leaves(lm.params) for p in t.placements)}
    return out


def _dtensor_rules_local_map(self, fn, out_specs, in_specs, in_grad_specs=None):
    """`ShardingCtx.local_map` on DTensor's own autograd rules (PyTorch's
    `local_map`), as the port ran it before its twice-differentiable rules."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import P, placements_of

    def place(spec):
        return placements_of(spec, self.mesh.mesh_dim_names) if isinstance(spec, P) else spec

    single = isinstance(out_specs, P) or all(isinstance(s, Placement) for s in out_specs)
    outs = (place(out_specs),) if single else tuple(place(s) for s in out_specs)
    grads = None if in_grad_specs is None else tuple(place(s) for s in in_grad_specs)
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(place(s) for s in in_specs),
                     in_grad_placements=grads, redistribute_inputs=True, device_mesh=self.mesh)


def rule_collectives(ctx, archs, B: int, S: int) -> dict:
    """Each reduced arch's training-step backward (`loss_and_grads`) on the
    mesh, on the port's twice-differentiable DTensor rules and on DTensor's
    own (`sharding.redistribute` and `ShardingCtx.local_map` swapped for
    theirs): the collectives it runs by kind (DTensor's `CommDebugMode`)
    and its gradients, keyed (arch, "port" or "dtensor")."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed import sharding
    from repro_torch.models import model as M

    port = sharding.redistribute, sharding.ShardingCtx.local_map
    theirs = (lambda t, placements: t.redistribute(t.device_mesh, placements),
              _dtensor_rules_local_map)
    out = {}
    try:
        for arch in archs:
            cfg, params, batch = lm_case(arch, B, S)
            for name, rules in (("port", port), ("dtensor", theirs)):
                sharding.redistribute, sharding.ShardingCtx.local_map = rules
                sharded = M.shard_params(cfg, params, ctx)
                with CommDebugMode() as comm:
                    _, _, grads = M.loss_and_grads(cfg, sharded, batch, ctx)
                out[arch, name] = {"counts": {str(k): n for k, n in comm.get_comm_counts().items()},
                                   "grads": _full(grads)}
    finally:
        sharding.redistribute, sharding.ShardingCtx.local_map = port
    return out


def lm_mesh_suite(rank: int, *, meshes, nll, train, lm, collectives) -> dict:
    """On each mesh shape of `meshes` (over this world's ranks): the zoo's
    NLLs, a training step, the LMUQModel waves and the training step's
    collectives on the port's DTensor rules and on DTensor's own."""
    out = {}
    for shape in meshes:
        ctx = _mesh(tuple(shape))
        out["x".join(map(str, shape))] = {
            "nll": mesh_nlls(ctx, **nll), "train": mesh_train_step(ctx, **train),
            "lm": lm_mesh_waves(ctx, **lm), "batch_index": ctx.batch_index,
            "collectives": rule_collectives(ctx, **collectives)}
    return out


# -- the trainer on a mesh (tests/test_torch_train_mesh.py) --------------------------

#: the train loop's settings in tests/test_torch_train_mesh.py (a failure at
#: step 3 retried once, a NaN at step 6 restored from step 3's checkpoint)
TRAIN_TC = dict(lr=1e-3, warmup_steps=1, total_steps=12, checkpoint_every=4,
                max_step_retries=1)


def train_case(arch: str = "qwen3-0.6b", **tc_kw):
    """(reduced config, TrainConfig) of a trainer test (the ssm family on
    the plain SSD, as `launch.train.main` runs it)."""
    from repro_torch.configs import get_config
    from repro_torch.types import TrainConfig

    cfg = get_config(arch, reduced=True)
    if cfg.family in ("ssm", "hybrid"):
        cfg = cfg.replace(attn_impl="plain")
    return cfg, TrainConfig(**{**TRAIN_TC, **tc_kw})


def mesh_train(ctx, ckpt_dir: str, steps: int, B: int, S: int, arch: str = "qwen3-0.6b",
               fail=(), nan=(), tc_kw=None) -> dict:
    """`launch.train.train(..., ctx=)` of the reduced arch on the CPU: its
    history, the actions of its attempts, and the final weights gathered."""
    from repro_torch.launch import train as T

    cfg, tc = train_case(arch, **(tc_kw or {}))
    log = []
    params, _, hist = T.train(cfg, tc, steps, B, S, ckpt_dir, inject_fail=tuple(fail),
                              inject_nan=tuple(nan), log_every=10_000, device="cpu",
                              log=log, ctx=ctx)
    return {"hist": hist, "actions": [(e["step"], e["action"]) for e in log if "action" in e],
            "params": _full(params)}


def train_two_ranks(rank: int, *, where: str, B: int, S: int, steps: int, fail, nan,
                    elastic_steps: int, data_step: int) -> dict:
    """The 2-rank trainer checks: the fault loop on (2, 1) and (1, 2);
    int8 error feedback on (2, 1); mamba2 on the plain SSD on (2, 1); each
    rank's rows of `SyntheticLMData(ctx=)`; and the elastic restart: a run
    of `elastic_steps` written on (2, 1) (copied by rank 0 for a restore
    without a mesh), continued on (1, 2) to `steps`."""
    import shutil

    import torch.distributed as dist

    from repro_torch.data.pipeline import SyntheticLMData

    root = Path(where)
    out = {}
    ctx21, ctx12 = _mesh((2, 1)), _mesh((1, 2))
    for name, ctx in (("2x1", ctx21), ("1x2", ctx12)):
        out[name] = mesh_train(ctx, str(root / name), steps, B, S, fail=fail, nan=nan)
    out["int8_ef"] = mesh_train(ctx21, str(root / "int8"), 4, B, S,
                                tc_kw={"grad_compression": "int8_ef"})
    out["mamba2"] = mesh_train(ctx21, str(root / "mamba2"), 3, B, S, arch="mamba2-1.3b")
    cfg, tc = train_case()
    data = SyntheticLMData(cfg, B, S, seed=tc.seed, device="cpu", ctx=ctx21).batch(data_step)
    rows = ctx21.rows(B)
    out["data"] = {"rows": (rows.start, rows.stop),
                   "local": {k: v.to_local().numpy() for k, v in data.items()},
                   "placements": {k: [repr(p) for p in v.placements] for k, v in data.items()}}
    first = mesh_train(ctx21, str(root / "elastic"), elastic_steps, B, S)
    if rank == 0:
        shutil.copytree(root / "elastic", root / "elastic_copy")
    dist.barrier()
    out["elastic"] = {"first": first,
                      "then": mesh_train(ctx12, str(root / "elastic"), steps, B, S)}
    out["by_sum"] = elastic_by_sum(ctx21, ctx12, str(root / "by_sum"), elastic_steps, steps,
                                   B, S)
    return out


def elastic_by_sum(ctx21, ctx12, ckpt_dir: str, first: int, steps: int, B: int, S: int):
    """The card's two-rank path on the CPU: every gather made a sum
    (`sharding.sum_gloo_cuda_gathers`, here for CPU tensors too), the
    trainer on (2, 1) for `first` steps, then continued on (1, 2) to
    `steps` from its checkpoint: the histories, the all-gathers left in
    the op stream (`stream_gathers`) and the gathers made sums."""
    from repro_torch.distributed import sharding

    sharding.SUM_GATHER_DEVICES.add("cpu")
    sharding.sum_gloo_cuda_gathers()
    try:
        before = sharding.GATHERS_BY_SUM["n"]
        a, n_a = stream_gathers(lambda: mesh_train(ctx21, ckpt_dir, first, B, S))
        b, n_b = stream_gathers(lambda: mesh_train(ctx12, ckpt_dir, steps, B, S))
        return {"hist": a["hist"] + b["hist"], "all_gathers": n_a + n_b,
                "by_sum": sharding.GATHERS_BY_SUM["n"] - before}
    finally:
        sharding.restore_gathers()
        sharding.SUM_GATHER_DEVICES.discard("cpu")


def train_four_ranks(rank: int, *, where: str, B: int, S: int, steps: int, fail, nan,
                     jax_ckpt: str, jax_batch: dict) -> dict:
    """The 4-rank trainer checks: the fault loop on (2, 2), and a checkpoint
    the JAX package wrote restored onto (2, 2) (`state_shardings`) with the
    next `train_step` on the JAX package's batch."""
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves

    ctx = _mesh((2, 2))
    out = {"2x2": mesh_train(ctx, str(Path(where) / "2x2"), steps, B, S, fail=fail, nan=nan)}
    cfg, tc = train_case(total_steps=10, checkpoint_every=2)
    like = T.init_state(cfg, tc, seed=123, device="cpu", ctx=ctx)
    (params, opt), step = CheckpointManager(jax_ckpt).restore(
        like, shardings=T.state_shardings(cfg, tc, ctx), device="cpu")
    placed = all(type(t).__name__ == "DTensor" for t in tree_leaves((params, opt["mu"])))
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in jax_batch.items()}
    _, opt, metrics = M.train_step(cfg, tc, params, opt, batch, ctx)
    out["jax"] = {"step": step, "placed": placed, "opt_step": int(opt["step"]),
                  "metrics": {k: T.scalar(v) for k, v in metrics.items()},
                  "mu": _full(opt["mu"])}
    return out


# -- serving on sharded caches (tests/test_torch_decode_mesh.py) ---------------------


def stream_gathers(fn):
    """(fn(), the all-gathers in its op stream): the functional collectives
    `launch.hlo_analysis.OpRecorder` sees, every one DTensor's
    redistribution issues."""
    from repro_torch.launch.hlo_analysis import OpRecorder, analyze

    with OpRecorder() as rec:
        out = fn()
    return out, analyze(rec.ops, 1)["collective_counts"]["all-gather"]


def all_gathers(fn):
    """(fn(), the all-gathers it asked for), counted twice over: those of
    its op stream (`stream_gathers`), plus the calls of PyTorch's
    functional all-gather functions, patched for the duration
    (`sharding.sum_gloo_cuda_gathers`, here for CPU tensors too, which
    makes each a sum and counts it in `GATHERS_BY_SUM`)."""
    from repro_torch.distributed import sharding

    sharding.SUM_GATHER_DEVICES.add("cpu")
    sharding.sum_gloo_cuda_gathers()
    before = sharding.GATHERS_BY_SUM["n"]
    try:
        out, n = stream_gathers(fn)
    finally:
        sharding.restore_gathers()
        sharding.SUM_GATHER_DEVICES.discard("cpu")
    return out, n + sharding.GATHERS_BY_SUM["n"] - before


def mesh_serve(ctx, arch: str, replace: dict, params: dict, tokens, prompt: int,
               cache_len: int, steps: int) -> dict:
    """The reduced arch (fields `replace`d; carried numpy weights) on the
    mesh: `init_cache(ctx=)`'s placements and local shapes, `prefill_step`
    of the first `prompt` tokens at `cache_len` rows (its last logits and
    caches, gathered, and its caches' placements), then `steps`
    `decode_step`s of the next tokens (each one's logits gathered, the
    all-gathers they issue counted), and the caches after them."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    from repro_torch.models.params import tree_leaves

    cfg = get_config(arch, reduced=True).replace(**replace)
    weights = M.shard_params(cfg, lm_params_from_numpy(cfg, params, "cpu"), ctx)
    tokens = torch.from_numpy(tokens)
    B = tokens.shape[0]
    zeros = transformer.init_cache(cfg, B, cache_len, device="cpu", ctx=ctx)
    specs = [d.spec for d in tree_leaves(transformer.cache_decl(cfg, B, cache_len, ctx))]
    out = {"init": [(tuple(t.shape), tuple(t.to_local().shape), [repr(p) for p in t.placements],
                     ctx.placements(sp, t.shape) == tuple(t.placements), bool(t.to_local().any()))
                    for t, sp in zip(tree_leaves(zeros), specs)]}
    last, cache = M.prefill_step(cfg, weights, tokens[:, :prompt], cache_len=cache_len, ctx=ctx)
    out["prefill"] = {"logits": last.full_tensor().numpy(), "cache": _full(cache),
                      "placements": [repr(tuple(t.placements)) for t in tree_leaves(cache)],
                      "as_declared": [ctx.placements(sp, t.shape) == tuple(t.placements)
                                      for t, sp in zip(tree_leaves(cache), specs)]}
    logits, gathers = [], []
    for j in range(steps):
        (step_logits, cache), n = all_gathers(lambda: M.decode_step(
            cfg, weights, cache, tokens[:, prompt + j:prompt + j + 1], prompt + j, ctx=ctx))
        gathers.append(n)
        logits.append(step_logits)
    # the count's control: gathering the logits (vocabulary over 'model') is an all-gather
    full, control = all_gathers(lambda: [l.full_tensor().numpy() for l in logits])
    out["decode"] = {"logits": full, "all_gathers": gathers, "control": control,
                     "cache": _full(cache)}
    return out


def decode_mesh_suite(rank: int, *, meshes, cases: dict) -> dict:
    """`mesh_serve` of every case on each mesh shape of `meshes`."""
    out = {}
    for shape in meshes:
        ctx = _mesh(tuple(shape))
        out["x".join(map(str, shape))] = {name: mesh_serve(ctx, **case)
                                          for name, case in cases.items()}
    return out
