"""Fault-tolerant trainer (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 8 --batch 4 --seq 4096                       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 20 --batch 2 --seq 32 --device cpu

Kept from the reference (and tested in tests/test_torch_train_loop.py):
  * deterministic data replay (`data.pipeline.SyntheticLMData`: a batch is a
    function of (seed, step), so a restart or a replay sees the same tokens);
  * a checkpoint every `tc.checkpoint_every` steps (snapshot to the host,
    written on a thread, published atomically, the last few kept), in the
    directory format the JAX package writes and reads;
  * step retry -> checkpoint restore -> replay on a failure or a
    non-finite loss (`distributed.fault.FaultPolicy`), with failures
    injected by `FlakyStep` (`--inject-fail`);
  * optional int8 error-feedback gradient compression
    (`--grad-compression int8_ef`).
There is no jit and no mesh: a step runs eagerly on one device (the card
unless `--device` says otherwise), and `models.model.train_step` updates
the parameters and moments IN PLACE where the reference donates them to
its jitted step. Either way a step's inputs are consumed, which is why a
non-finite loss is answered by a restore and not by a retry. A restore
first waits for a checkpoint still being written on the save thread (the
reference looks only at complete ones, and re-initializes when the newest
is still in flight: at full width a checkpoint takes seconds to write).
The loop on a mesh, and elastic restarts onto another one, wait for ROADMAP
queue 1 item 14d (`models.model.train_step(..., ctx=)` is one step on a
mesh).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import FaultPolicy, FlakyStep, StepFailure, loss_is_bad
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.compression import compress_with_feedback, init_error_state
from repro_torch.types import TrainConfig


def build_train_step(cfg, tc: TrainConfig):
    """step_fn(params, opt_state, batch) -> (params, opt_state, metrics):
    `models.model.train_step`, or with `tc.grad_compression == "int8_ef"`
    the gradient through int8 error-feedback compression before AdamW (the
    residual in `opt_state["err"]`)."""
    if tc.grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"grad_compression must be 'none' or 'int8_ef', got "
                         f"{tc.grad_compression!r}")
    if tc.grad_compression == "none":
        return lambda params, opt_state, batch: M.train_step(cfg, tc, params, opt_state, batch)

    def step_fn(params, opt_state, batch):
        loss, metrics, grads = M.loss_and_grads(cfg, params, batch)
        grads, new_err = compress_with_feedback(grads, opt_state["err"])
        inner = {k: opt_state[k] for k in ("mu", "nu", "step")}
        params, inner, opt_stats = adamw_update(params, grads, inner, tc)
        return params, dict(inner, err=new_err), dict(metrics, loss=loss, **opt_stats)

    return step_fn


def init_state(cfg, tc: TrainConfig, seed: int, device=None):
    """(params, opt_state) on `device` (default: the card): weights drawn
    from a generator seeded with `seed`, zero moments (and a zero error
    state for int8_ef)."""
    device = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    opt = adamw_init(params, tc)
    if tc.grad_compression == "int8_ef":
        opt = dict(opt, err=init_error_state(params))
    return params, opt


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
):
    """Train `steps` steps (resuming from the newest checkpoint in
    `ckpt_dir` unless `resume` is False); returns (params, opt_state,
    history), history a list of (step, loss). `log`, where given, gets one
    dict an attempt: step, loss, grad_norm, the attempt's wall seconds (to
    the loss on the host) and what the loop did ("ok", "retry", "restore"),
    and one dict a checkpoint saved (its seconds on this thread)."""
    device = resolve_device(device)
    data = SyntheticLMData(cfg, global_batch, seq_len, seed=tc.seed, device=device)
    mgr = CheckpointManager(ckpt_dir, keep_last=tc.keep_checkpoints)
    step_fn = build_train_step(cfg, tc)
    if inject_fail or inject_nan:
        step_fn = FlakyStep(step_fn, tuple(inject_fail), tuple(inject_nan))
    policy = FaultPolicy(max_retries_per_step=tc.max_step_retries)
    note = log.append if log is not None else (lambda entry: None)

    params, opt = init_state(cfg, tc, tc.seed, device)
    start = 0
    if resume and mgr.latest_step() is not None:
        (params, opt), start = mgr.restore((params, opt), device=device)
        start += 1
        print(f"[train] resumed from step {start - 1}")

    def restore_or_reinit(params, opt):
        mgr.wait()  # a checkpoint still being written is the one to restore
        if mgr.latest_step() is not None:
            (params, opt), rstep = mgr.restore((params, opt), device=device)
            print(f"[fault] restored step {rstep}, replaying from {rstep + 1}")
            return params, opt, rstep + 1
        print("[fault] no checkpoint; re-initializing")
        p, o = init_state(cfg, tc, tc.seed, device)
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
                loss = float(metrics["loss"])
                if loss_is_bad(loss):
                    # the step updated its inputs in place: the only safe
                    # recovery is checkpoint-restore + replay (SDC / numerics
                    # policy; see distributed/fault.py)
                    note({"step": step, "loss": loss, "wall_s": time.perf_counter() - t0,
                          "action": "restore"})
                    print(f"[fault] step {step}: non-finite loss -> restore")
                    params, opt, step = restore_or_reinit(params_n, opt_n)
                    batch = data.batch(step)
                    attempt = 0
                    continue
                params, opt = params_n, opt_n
                note({"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                      "wall_s": time.perf_counter() - t0, "action": "ok"})
                break
            except StepFailure as e:
                # raised before the step touched its inputs
                action = policy.handle(step, attempt, e)
                attempt += 1
                note({"step": step, "loss": None, "wall_s": time.perf_counter() - t0,
                      "action": action})
                print(f"[fault] step {step}: {e} -> {action}")
                if action == "restore":
                    params, opt, step = restore_or_reinit(params, opt)
                    batch = data.batch(step)
                    attempt = 0
        history.append((step, loss))
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f}")
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
    t0 = time.time()
    _, _, hist = train(
        cfg, tc, args.steps, args.batch, args.seq, args.ckpt_dir,
        inject_fail=fails, device=args.device,
    )
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s; loss {hist[0][1]:.3f} -> {hist[-1][1]:.3f}")
    return hist


if __name__ == "__main__":
    main()
