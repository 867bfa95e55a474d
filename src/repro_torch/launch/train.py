"""Fault-tolerant trainer (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 8 --batch 4 --seq 4096                       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 20 --batch 2 --seq 32 --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2,2 ...

Kept from the reference (and tested in tests/test_torch_train_loop.py and,
on a mesh, tests/test_torch_train_mesh.py):
  * deterministic data replay (`data.pipeline.SyntheticLMData`: a batch is a
    function of (seed, step), so a restart or a replay sees the same tokens,
    on every mesh shape);
  * a checkpoint every `tc.checkpoint_every` steps (snapshot to the host,
    written on a thread, published atomically, the last few kept), in the
    directory format the JAX package writes and reads;
  * step retry -> checkpoint restore -> replay on a failure or a
    non-finite loss (`distributed.fault.FaultPolicy`), with failures
    injected by `FlakyStep` (`--inject-fail`);
  * optional int8 error-feedback gradient compression
    (`--grad-compression int8_ef`);
  * the device mesh (`ctx=`, `--mesh DATA,MODEL`): the parameters, moments
    and error state as DTensors placed by `state_shardings` (FSDP over
    'data', TP over 'model'), each batch over the batch axes; the elastic
    restart: a checkpoint written on any mesh, on none, or by the JAX
    package restores onto this one (`restore(shardings=)`).
There is no jit: a step runs eagerly (on the card unless `--device` says
otherwise), and `models.model.train_step` updates the parameters and
moments IN PLACE where the reference donates them to its jitted step.
Either way a step's inputs are consumed, which is why a non-finite loss is
answered by a restore and not by a retry. A restore first waits for a
checkpoint still being written (the reference looks only at complete ones,
and re-initializes when the newest is still in flight: at full width a
checkpoint takes seconds to write).

On a mesh every rank runs this loop. Its decisions must agree, or the next
collective hangs: `FlakyStep` fires at the same step on every rank, the
loss is a replicated scalar (the same bits everywhere), and a checkpoint is
saved, waited for and restored at the same points on every rank (rank 0
writes it; `distributed.checkpoint`).
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import FaultPolicy, FlakyStep, StepFailure, loss_is_bad
from repro_torch.distributed.sharding import (
    ShardingCtx,
    is_dtensor,
    on_mesh,
    reduce_partial,
    sanitized_shardings,
)
from repro_torch.launch.mesh import destroy_ranks, make_mesh, rank_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init, adamw_update, opt_state_specs
from repro_torch.optim.compression import compress_with_feedback, init_error_state
from repro_torch.types import TrainConfig


def build_train_step(cfg, tc: TrainConfig, ctx: ShardingCtx | None = None):
    """step_fn(params, opt_state, batch) -> (params, opt_state, metrics):
    `models.model.train_step`, or with `tc.grad_compression == "int8_ef"`
    the gradient through int8 error-feedback compression before AdamW (the
    residual in `opt_state["err"]`); on `ctx`'s mesh, if given."""
    if tc.grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"grad_compression must be 'none' or 'int8_ef', got "
                         f"{tc.grad_compression!r}")
    if tc.grad_compression == "none":
        return lambda params, opt_state, batch: M.train_step(cfg, tc, params, opt_state, batch,
                                                             ctx=ctx)

    def step_fn(params, opt_state, batch):
        loss, metrics, grads = M.loss_and_grads(cfg, params, batch, ctx)
        grads, new_err = compress_with_feedback(grads, opt_state["err"])
        inner = {k: opt_state[k] for k in ("mu", "nu", "step")}
        with on_mesh(ctx):
            params, inner, opt_stats = adamw_update(params, grads, inner, tc)
        return params, dict(inner, err=new_err), dict(metrics, loss=loss, **opt_stats)

    return step_fn


def state_shardings(cfg, tc: TrainConfig, ctx: ShardingCtx):
    """The (params, opt_state) tree of `Sharding`s on `ctx`'s mesh (the
    reference's `p_sh`, with the moments' and error state's): each leaf by
    `param_specs`, sanitized for its shape; the moments and the error state
    as their parameters; the step counter None (a plain tensor, as
    `adamw_init` makes it). What `restore(shardings=)` re-shards onto."""
    p_abs, p_spec = M.abstract_params(cfg), M.param_specs(cfg)
    p_sh = sanitized_shardings(ctx, p_abs, p_spec)
    o_spec = dict(opt_state_specs(p_spec), step=None)
    if tc.grad_compression == "int8_ef":
        o_spec["err"] = p_spec
    o_abs = {k: (None if k == "step" else p_abs) for k in o_spec}
    return p_sh, sanitized_shardings(ctx, o_abs, o_spec)


def init_state(cfg, tc: TrainConfig, seed: int, device=None, ctx: ShardingCtx | None = None):
    """(params, opt_state) on `device` (default: the card; on a mesh, the
    rank's): weights drawn from a generator seeded with `seed`, zero
    moments (and a zero error state for int8_ef). On `ctx`'s mesh every
    rank draws the whole weights (the same values as one process), keeps
    its shards (`shard_params`) and makes the moments and error state on
    them, placed as their parameters."""
    device = rank_device(device) if ctx is not None else resolve_device(device)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    if ctx is not None:
        params = M.shard_params(cfg, params, ctx)
    opt = adamw_init(params, tc)
    if tc.grad_compression == "int8_ef":
        opt = dict(opt, err=init_error_state(params))
    return params, opt


def scalar(x) -> float:
    """A 0-d metric as a Python float; on a mesh a replicated DTensor (a
    partial sum reduced first, an all-reduce), the same on every rank."""
    if is_dtensor(x):
        x = reduce_partial(x).to_local()
    return float(x)


def train(
    cfg,
    tc: TrainConfig,
    steps: int,
    global_batch: int,
    seq_len: int,
    ckpt_dir: str,
    inject_fail: tuple = (),
    inject_nan: tuple = (),
    log_every: int = 10,
    resume: bool = True,
    device=None,
    log: list | None = None,
    ctx: ShardingCtx | None = None,
):
    """Train `steps` steps (resuming from the newest checkpoint in
    `ckpt_dir` unless `resume` is False); returns (params, opt_state,
    history), history a list of (step, loss). `log`, where given, gets one
    dict an attempt: step, loss, grad_norm, the attempt's wall seconds (to
    the loss on the host) and what the loop did ("ok", "retry", "restore"),
    and one dict a checkpoint saved (its seconds on this thread). On `ctx`'s
    mesh (every rank calls this; `device` is the rank's) the state is
    DTensors, and a checkpoint from any mesh restores onto this one."""
    device = rank_device(device) if ctx is not None else resolve_device(device)
    data = SyntheticLMData(cfg, global_batch, seq_len, seed=tc.seed, device=device, ctx=ctx)
    mgr = CheckpointManager(ckpt_dir, keep_last=tc.keep_checkpoints)
    step_fn = build_train_step(cfg, tc, ctx)
    if inject_fail or inject_nan:
        step_fn = FlakyStep(step_fn, tuple(inject_fail), tuple(inject_nan))
    policy = FaultPolicy(max_retries_per_step=tc.max_step_retries)
    note = log.append if log is not None else (lambda entry: None)
    say = print if ctx is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    shardings = None if ctx is None else state_shardings(cfg, tc, ctx)

    def restored(params, opt):
        return mgr.restore((params, opt), device=device, shardings=shardings)

    params, opt = init_state(cfg, tc, tc.seed, device, ctx)
    start = 0
    if resume and mgr.latest_step() is not None:
        (params, opt), start = restored(params, opt)
        start += 1
        say(f"[train] resumed from step {start - 1}")

    def restore_or_reinit(params, opt):
        mgr.wait()  # a checkpoint still being written is the one to restore
        if mgr.latest_step() is not None:
            (params, opt), rstep = restored(params, opt)
            say(f"[fault] restored step {rstep}, replaying from {rstep + 1}")
            return params, opt, rstep + 1
        say("[fault] no checkpoint; re-initializing")
        p, o = init_state(cfg, tc, tc.seed, device, ctx)
        return p, o, 0

    def save(step, blocking):
        t0 = time.perf_counter()
        (mgr.save if blocking else mgr.save_async)(step, (params, opt))
        note({"checkpoint": step, "blocking": blocking, "s": time.perf_counter() - t0})

    history = []
    step = start
    while step < steps:
        batch = data.batch(step)
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                if isinstance(step_fn, FlakyStep):
                    params_n, opt_n, metrics = step_fn(params, opt, batch, step)
                else:
                    params_n, opt_n, metrics = step_fn(params, opt, batch)
                loss = scalar(metrics["loss"])
                if loss_is_bad(loss):
                    # the step updated its inputs in place: the only safe
                    # recovery is checkpoint-restore + replay (SDC / numerics
                    # policy; see distributed/fault.py)
                    note({"step": step, "loss": loss, "wall_s": time.perf_counter() - t0,
                          "action": "restore"})
                    say(f"[fault] step {step}: non-finite loss -> restore")
                    params, opt, step = restore_or_reinit(params_n, opt_n)
                    batch = data.batch(step)
                    attempt = 0
                    continue
                params, opt = params_n, opt_n
                note({"step": step, "loss": loss, "grad_norm": scalar(metrics["grad_norm"]),
                      "wall_s": time.perf_counter() - t0, "action": "ok"})
                break
            except StepFailure as e:
                # raised before the step touched its inputs
                action = policy.handle(step, attempt, e)
                attempt += 1
                note({"step": step, "loss": None, "wall_s": time.perf_counter() - t0,
                      "action": action})
                say(f"[fault] step {step}: {e} -> {action}")
                if action == "restore":
                    params, opt, step = restore_or_reinit(params, opt)
                    batch = data.batch(step)
                    attempt = 0
        history.append((step, loss))
        if step % log_every == 0 or step == steps - 1:
            say(f"step {step:5d} loss {loss:.4f} gnorm {scalar(metrics['grad_norm']):.3f}")
        if tc.checkpoint_every and (step + 1) % tc.checkpoint_every == 0:
            save(step, blocking=False)
        step += 1
    mgr.wait()
    save(steps - 1, blocking=True)
    return params, opt, history


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fault-tolerant training of one LM of the zoo.")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--inject-fail", default="", help="comma-separated steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train on a (data, model) device mesh over torchrun's ranks (or a "
                         "world of one)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the mesh's process-group backend (default: nccl on the card, "
                         "gloo with --device cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family in ("ssm", "hybrid") and cfg.attn_impl == "kernel":
        # the SSD kernel has no backward yet (ROADMAP queue 1, item 13e)
        cfg = cfg.replace(attn_impl="plain")
        print(f"[train] {cfg.name}: attn_impl='plain' (the SSD kernel has no backward)")
    tc = TrainConfig(
        lr=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 1),
        checkpoint_every=args.checkpoint_every,
        grad_compression=args.grad_compression,
    )
    fails = tuple(int(s) for s in args.inject_fail.split(",") if s)
    ctx = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split(","))
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        backend = args.backend or ("gloo" if cpu else "nccl")
        ctx = ShardingCtx(make_mesh(shape, ("data", "model"), backend=backend,
                                    device=args.device))
    t0 = time.time()
    try:
        _, _, hist = train(
            cfg, tc, args.steps, args.batch, args.seq, args.ckpt_dir,
            inject_fail=fails, device=args.device, ctx=ctx,
        )
    finally:
        if ctx is not None:
            destroy_ranks()
    dt = time.time() - t0
    mesh = f" on mesh {args.mesh}" if ctx is not None else ""
    print(f"done: {args.steps} steps{mesh} in {dt:.1f}s; loss {hist[0][1]:.3f} -> "
          f"{hist[-1][1]:.3f}")
    return hist


if __name__ == "__main__":
    main()
