"""PyTorch port: the trainer on a device mesh (`launch.train.train(...,
ctx=)`, `SyntheticLMData(ctx=)`, `compress_with_feedback` on DTensors,
`state_shardings` and the elastic restart), on `gloo` ranks on the CPU
(tests/_torch_mesh.py starts them: one 2-rank world on the (2, 1) and
(1, 2) meshes, one 4-rank world on (2, 2)), held to the one-process
trainer of the reduced qwen3-0.6b:

* the fault loop (a `StepFailure` at step 3 retried, a NaN at step 6
  restored from step 3's checkpoint, written by rank 0 alone): the same
  actions, the history bit for bit on a 1x1 mesh and within
  `HIST_RTOL` (relative) elsewhere (FSDP and TP sum the gradients in
  another order), and the replay of steps 4 and 5 bit for bit within each
  run;
* int8 error feedback on (2, 1) (the scale from the global maximum) and
  mamba2 on the plain SSD on (2, 1), within `HIST_RTOL` of one process;
* each rank's rows of `SyntheticLMData(ctx=)` are the one-process batch's
  rows, which the JAX package's formula gives from the same uniforms;
* elastic: a checkpoint written on (2, 1) continues on (1, 2) and without a
  mesh, each within `HIST_RTOL` of an uninterrupted run (also with every
  gather made a sum, as two ranks on one card run it); a checkpoint the
  JAX package's `train` writes restores onto (2, 2), and the next step
  matches the JAX package's `train_step` within test_torch_train.py's
  bounds;
* `main(["--mesh", "1,1", "--device", "cpu", ...])`.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import one_rank_mesh, run_ranks, train_case
from _torch_zoo import rel
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.models import model as jax_model
from repro.types import TrainConfig as JaxTrainConfig
from repro_torch.data import pipeline
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch import train as T
from repro_torch.models.params import tree_leaves

torch.set_num_threads(1)

B, S, STEPS, FAIL, NAN = 4, 32, 8, (3,), (6,)
ELASTIC_STEPS, DATA_STEP = 4, 5
#: a mesh's losses against one process's (another summation order of the
#: sharded products and of the gradient's reductions)
HIST_RTOL = 1e-5
#: test_torch_train.py's bounds for qwen3-0.6b: loss, NLL and gradient norm
#: relative; the first moments against their largest element
LOSS_RTOL, MU_RTOL = 1e-5, 1e-4
JAX_TC = dict(lr=1e-3, warmup_steps=1, total_steps=10, checkpoint_every=2)


def _one_process(tmp, steps=STEPS, arch="qwen3-0.6b", fail=FAIL, nan=NAN, **tc_kw) -> dict:
    cfg, tc = train_case(arch, **tc_kw)
    log = []
    params, _, hist = T.train(cfg, tc, steps, B, S, str(tmp), inject_fail=fail,
                              inject_nan=nan, log_every=10_000, device="cpu", log=log)
    return {"hist": hist, "actions": [(e["step"], e["action"]) for e in log if "action" in e],
            "params": [t.detach().numpy() for t in tree_leaves(params)]}


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    return {"faults": _one_process(tmp / "faults"),
            "int8_ef": _one_process(tmp / "int8", 4, fail=(), nan=(),
                                    grad_compression="int8_ef"),
            "mamba2": _one_process(tmp / "mamba2", 3, "mamba2-1.3b", fail=(), nan=()),
            "plain": _one_process(tmp / "plain", fail=(), nan=())}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory, ctx11):
    """A checkpoint of the JAX package's `train` (3 steps, saved at 2) and
    the JAX package's next step from it, on its batch 3."""
    from repro.distributed.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro.launch.train import train as jax_train

    where = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = jax_get_config("qwen3-0.6b", reduced=True)
    jtc = JaxTrainConfig(**JAX_TC)
    jparams, jopt, _ = jax_train(jcfg, ctx11, jtc, steps=3, global_batch=2, seq_len=S,
                                 ckpt_dir=str(where), log_every=100)
    step = JaxCheckpointManager(str(where)).latest_step()
    jbatch = jax_pipeline.synth_batch_fn(jcfg, 0, 2, S)(3)
    with ctx11.mesh:
        _, jopt_n, jm = jax_model.train_step(jcfg, ctx11, jtc, jparams, jopt, jbatch)
    return {"dir": str(where), "step": step, "batch": jax.tree.map(np.asarray, jbatch),
            "metrics": {k: float(v) for k, v in jm.items()}, "opt_step": int(jopt_n["step"]),
            "mu": [np.asarray(m) for m in jax.tree.leaves(jopt_n["mu"])]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_ckpt):
    kw = dict(B=B, S=S, steps=STEPS, fail=FAIL, nan=NAN)
    where2 = tmp_path_factory.mktemp("train_two")
    two = run_ranks(2, "train_two_ranks", where2, timeout_s=400.0, where=str(where2),
                    elastic_steps=ELASTIC_STEPS, data_step=DATA_STEP, **kw)
    where4 = tmp_path_factory.mktemp("train_four")
    four = run_ranks(4, "train_four_ranks", where4, timeout_s=400.0, where=str(where4),
                     jax_ckpt=jax_ckpt["dir"], jax_batch=jax_ckpt["batch"], **kw)
    return {"two": two, "four": four, "elastic_copy": where2 / "elastic_copy"}


def _replayed(run) -> None:
    """The NaN at step 6 restored step 3: steps 4 and 5 ran twice, the
    replays bit for bit."""
    hist = run["hist"]
    first = dict(hist[:6])
    replay = [(s, l) for s, l in hist[6:] if s in (4, 5)]
    assert [s for s, _ in replay] == [4, 5]
    assert all(first[s] == l for s, l in replay), (first, replay)


def _close(got, want, bound=HIST_RTOL) -> float:
    assert [s for s, _ in got] == [s for s, _ in want]
    err = max(rel(np.array([l for _, l in got]), np.array([l for _, l in want])), 0.0)
    assert err <= bound, (got, want)
    return err


def test_train_on_a_1x1_mesh_is_the_one_process_trainer_bit_for_bit(tmp_path, one):
    with one_rank_mesh() as ctx:
        cfg, tc = train_case()
        log = []
        params, opt, hist = T.train(cfg, tc, STEPS, B, S, str(tmp_path), inject_fail=FAIL,
                                    inject_nan=NAN, log_every=10_000, device="cpu", log=log,
                                    ctx=ctx)
        assert all(type(t).__name__ == "DTensor" for t in tree_leaves((params, opt["mu"])))
        local = [t.to_local().numpy() for t in tree_leaves(params)]
    assert hist == one["faults"]["hist"]
    assert [(e["step"], e["action"]) for e in log if "action" in e] == one["faults"]["actions"]
    for got, want in zip(local, one["faults"]["params"]):
        np.testing.assert_array_equal(got, want)
    # its last checkpoint restores without a mesh, leaf for leaf bit for bit
    (p, _), step = CheckpointManager(str(tmp_path)).restore(
        T.init_state(cfg, tc, 7, device="cpu"), device="cpu")
    assert step == STEPS - 1
    for got, want in zip(tree_leaves(p), local):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
def test_fault_loop_on_a_mesh_matches_one_process(worlds, one, mesh):
    runs = worlds["four" if mesh == "2x2" else "two"]
    want = one["faults"]
    for rank, run in enumerate(r[mesh] for r in runs):
        assert run["actions"] == want["actions"]
        assert [a for _, a in run["actions"]].count("restore") == 1
        _replayed(run)
        err = _close(run["hist"], want["hist"])
        print(f"train on {mesh}, rank {rank}: losses within {err:.3g} of one process")
        assert run["hist"] == runs[0][mesh]["hist"]  # every rank the same numbers
        for got, w in zip(run["params"], want["params"]):
            assert np.abs(got - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("case", ["int8_ef", "mamba2"])
def test_int8_ef_and_mamba2_on_2x1_match_one_process(worlds, one, case):
    for run in worlds["two"]:
        err = _close(run[case]["hist"], one[case]["hist"])
        print(f"{case} on 2x1: losses within {err:.3g} of one process")


def test_synthetic_data_rows_on_the_mesh(worlds, monkeypatch):
    """Each rank's rows are its rows of the one-process global batch, which
    the JAX package's formula gives from the port's own uniforms."""
    cfg, tc = train_case()
    whole = pipeline.SyntheticLMData(cfg, B, S, seed=tc.seed, device="cpu").batch(DATA_STEP)
    for run in worlds["two"]:
        lo, hi = run["data"]["rows"]
        assert hi - lo == B // 2
        for k, v in run["data"]["local"].items():
            np.testing.assert_array_equal(v, whole[k][lo:hi].numpy())
            assert run["data"]["placements"][k] == ["Shard(dim=0)", "Replicate()"]
    assert [r["data"]["rows"] for r in worlds["two"]] == [(0, 2), (2, 4)]
    gen = pipeline._generator(torch.device("cpu"), tc.seed, DATA_STEP, 0)
    draws = [pipeline._uniform((B, S + 1), gen, 1e-6).numpy(),
             pipeline._uniform((B, S + 1), gen).numpy()]
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(draws.pop(0)))
    jcfg = jax_get_config("qwen3-0.6b", reduced=True)
    jbatch = jax_pipeline.synth_batch_fn(jcfg, tc.seed, B, S)(DATA_STEP)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(np.asarray(jbatch[k]), whole[k].numpy())


def test_elastic_restart_continues_on_another_mesh_and_without_one(worlds, one, tmp_path):
    want = one["plain"]["hist"]
    for run in worlds["two"]:
        first, then = run["elastic"]["first"]["hist"], run["elastic"]["then"]["hist"]
        _close(first, want[:ELASTIC_STEPS])
        assert [s for s, _ in then] == list(range(ELASTIC_STEPS, STEPS))  # resumed on (1, 2)
        err = _close(then, want[ELASTIC_STEPS:])
        print(f"written on 2x1, continued on 1x2: within {err:.3g} of the uninterrupted run")
    copy = tmp_path / "copy"
    shutil.copytree(worlds["elastic_copy"], copy)
    cfg, tc = train_case()
    _, _, hist = T.train(cfg, tc, STEPS, B, S, str(copy), log_every=10_000, device="cpu")
    err = _close(hist, want[ELASTIC_STEPS:])
    print(f"written on 2x1, continued without a mesh: within {err:.3g}")


def test_fsdp_then_tp_with_every_gather_a_sum(worlds, one):
    """The card's path (two `gloo` ranks on one card, whose all-gathers of
    CUDA tensors crash: `sharding.sum_gloo_cuda_gathers`) on the CPU: FSDP on
    (2, 1), then TP on (1, 2) from its checkpoint, no all-gather left, the
    losses within HIST_RTOL of one process."""
    for run in worlds["two"]:
        got = run["by_sum"]
        assert got["all_gathers"] == 0 and got["by_sum"] > 0
        err = _close(got["hist"], one["plain"]["hist"])
        print(f"FSDP -> TP, gathers as sums ({got['by_sum']}): within {err:.3g}")


def test_jax_checkpoint_restores_onto_2x2_and_the_next_step_matches(worlds, jax_ckpt):
    for run in worlds["four"]:
        got = run["jax"]
        assert got["step"] == jax_ckpt["step"] == 2 and got["placed"]
        assert got["opt_step"] == jax_ckpt["opt_step"] == 4
        for name in ("loss", "nll", "grad_norm", "lr"):
            assert got["metrics"][name] == pytest.approx(jax_ckpt["metrics"][name],
                                                         rel=LOSS_RTOL), name
        for m, j in zip(got["mu"], jax_ckpt["mu"]):
            assert np.abs(m - j).max() <= MU_RTOL * np.abs(j).max()


def test_main_on_a_1x1_mesh(tmp_path, capsys):
    hist = T.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "4", "--batch", "2",
                   "--seq", "32", "--checkpoint-every", "2", "--ckpt-dir", str(tmp_path),
                   "--device", "cpu", "--inject-fail", "1", "--mesh", "1,1"])
    out = capsys.readouterr().out
    assert "done: 4 steps on mesh 1,1" in out and "injected failure at step 1" in out
    assert [s for s, _ in hist] == [0, 1, 2, 3] and all(np.isfinite([l for _, l in hist]))
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
