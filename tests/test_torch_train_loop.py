"""PyTorch port: the fault-tolerant train loop (`repro_torch.launch.train`)
on the CPU, mirroring the JAX package's loop tests
(tests/test_substrate.py): it survives an injected `StepFailure` and a NaN
loss and still learns; it resumes from its checkpoint; a checkpoint the
JAX package's `train` writes restores in the port bit for bit, and the
port's next `train_step` on the same numpy batch matches the JAX package's
(loss and NLL within 1e-5, the gradient norm 1e-5, the learning rate, and
the new first moments within 1e-4 of their largest: `test_torch_train.py`'s
bounds for qwen3-0.6b); bfloat16 parameters and moments cross between the
packages' checkpoints bit for bit, both ways; `main()` runs from its command line with `--device
cpu`, with int8 error-feedback compression, and for mamba2 on the plain
path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synth_batch_fn as jax_synth_batch_fn
from repro.distributed.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.models import model as jax_model
from repro.types import TrainConfig as JaxTrainConfig
from repro_torch.configs import get_config
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch import train as T
from repro_torch.models import model
from repro_torch.models.params import tree_leaves
from repro_torch.types import TrainConfig

torch.set_num_threads(1)


def test_train_loop_survives_failures_and_nans(tmp_path):
    cfg = get_config("qwen3-0.6b", reduced=True)
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=12, checkpoint_every=4,
                     max_step_retries=1)
    log = []
    _, _, hist = T.train(cfg, tc, steps=12, global_batch=2, seq_len=32,
                         ckpt_dir=str(tmp_path), inject_fail=(3,), inject_nan=(6,),
                         log_every=100, device="cpu", log=log)
    steps_seen = [h[0] for h in hist]
    assert steps_seen[-1] == 11
    losses = [h[1] for h in hist]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # still learning through the faults
    actions = [e["action"] for e in log if "action" in e]
    assert actions.count("retry") == 1 and actions.count("restore") == 1
    # the NaN at step 6 restored step 3's checkpoint: steps 4 and 5 replayed,
    # bit for bit (same parameters, same batch)
    first = {s: l for s, l in hist[:6]}
    replay = [(s, l) for s, l in hist[6:] if s in (4, 5)]
    assert [s for s, _ in replay] == [4, 5]
    assert all(first[s] == l for s, l in replay)
    assert any("checkpoint" in e for e in log)


def test_train_loop_resumes_from_checkpoint(tmp_path):
    cfg = get_config("qwen3-0.6b", reduced=True)
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10, checkpoint_every=5)
    T.train(cfg, tc, steps=5, global_batch=2, seq_len=32, ckpt_dir=str(tmp_path),
            log_every=100, device="cpu")
    _, _, hist = T.train(cfg, tc, steps=10, global_batch=2, seq_len=32,
                         ckpt_dir=str(tmp_path), log_every=100, device="cpu")
    assert hist[0][0] == 5  # resumed, not restarted


def test_jax_checkpoint_restores_and_next_step_matches(tmp_path, ctx11):
    from repro.launch.train import train as jax_train

    jcfg = jax_get_config("qwen3-0.6b", reduced=True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, checkpoint_every=2)
    jparams, jopt, _ = jax_train(jcfg, ctx11, JaxTrainConfig(**kw), steps=3, global_batch=2,
                                 seq_len=32, ckpt_dir=str(tmp_path), log_every=100)
    assert JaxCheckpointManager(str(tmp_path)).latest_step() == 2
    cfg, tc = get_config("qwen3-0.6b", reduced=True), TrainConfig(**kw)
    like = T.init_state(cfg, tc, seed=123, device="cpu")  # structure and dtypes only
    (params, opt), step = CheckpointManager(str(tmp_path)).restore(like, device="cpu")
    assert step == 2
    leaves, jleaves = tree_leaves((params, opt)), jax.tree.leaves((jparams, jopt))
    assert len(leaves) == len(jleaves)
    for t, j in zip(leaves, jleaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))  # bit for bit
    # the next step, on the JAX package's batch 3 in both
    jbatch = jax_synth_batch_fn(jcfg, 0, 2, 32)(3)
    batch = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in jbatch.items()}
    with ctx11.mesh:
        _, jopt_n, jm = jax_model.train_step(jcfg, ctx11, JaxTrainConfig(**kw), jparams, jopt,
                                             jbatch)
    _, opt_n, m = model.train_step(cfg, tc, params, opt, batch)
    for name in ("loss", "nll", "grad_norm", "lr"):
        assert float(m[name]) == pytest.approx(float(jm[name]), rel=1e-5), name
    assert int(opt_n["step"]) == int(jopt_n["step"]) == 4
    for t, j in zip(tree_leaves(opt_n["mu"]), jax.tree.leaves(jopt_n["mu"])):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def _bits(a: np.ndarray) -> np.ndarray:
    """The bits of a 2-byte float array (bfloat16 of either package)."""
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def test_bf16_checkpoints_cross_packages_bit_for_bit(tmp_path, ctx11):
    """The published configs keep bfloat16 parameters: a checkpoint the JAX
    package writes from bfloat16 parameters and moments (on disk a 2-byte
    void type) restores in the port bit for bit, on the device and with
    `host=True` (as float32); the port saves them back, and the JAX
    package restores those bit for bit."""
    from repro.launch.train import train as jax_train

    jcfg = jax_get_config("qwen3-0.6b", reduced=True).replace(param_dtype="bfloat16")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, checkpoint_every=2,
              opt_state_dtype="bfloat16")
    jparams, jopt, _ = jax_train(jcfg, ctx11, JaxTrainConfig(**kw), steps=3, global_batch=2,
                                 seq_len=32, ckpt_dir=str(tmp_path / "jax"), log_every=100)
    jleaves = [np.asarray(j) for j in jax.tree.leaves((jparams, jopt))]
    assert any(j.dtype.name == "bfloat16" for j in jleaves)
    cfg = get_config("qwen3-0.6b", reduced=True).replace(param_dtype="bfloat16")
    like = T.init_state(cfg, TrainConfig(**kw), seed=123, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "jax"))
    (params, opt), step = mgr.restore(like, device="cpu")
    host, _ = mgr.restore(like, host=True)
    assert step == 2
    leaves = tree_leaves((params, opt))
    assert len(leaves) == len(jleaves)
    for t, h, j in zip(leaves, tree_leaves(host), jleaves):
        assert tuple(t.shape) == j.shape and t.dtype == getattr(torch, j.dtype.name)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), _bits(j))
            assert h.dtype == np.float32
            np.testing.assert_array_equal(h, j.astype(np.float32))
        else:
            np.testing.assert_array_equal(t.numpy(), j)
            np.testing.assert_array_equal(h, j)
    CheckpointManager(str(tmp_path / "port")).save(step, (params, opt))
    (jp, jo), jstep = JaxCheckpointManager(str(tmp_path / "port")).restore((jparams, jopt))
    assert jstep == step
    for r, j in zip(jax.tree.leaves((jp, jo)), jleaves):
        r = np.asarray(r)
        assert r.dtype == j.dtype
        np.testing.assert_array_equal(_bits(r), _bits(j))


@pytest.mark.parametrize("arch,extra", [("qwen3-0.6b", []),
                                        ("qwen3-0.6b", ["--grad-compression", "int8_ef"]),
                                        ("mamba2-1.3b", [])])
def test_main_runs_on_the_cpu(tmp_path, capsys, arch, extra):
    hist = T.main(["--arch", arch, "--reduced", "--steps", "4", "--batch", "2", "--seq", "32",
                   "--checkpoint-every", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu",
                   "--inject-fail", "1", *extra])
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "injected failure at step 1" in out
    assert [s for s, _ in hist] == [0, 1, 2, 3]
    assert all(np.isfinite([l for _, l in hist]))
    if arch == "mamba2-1.3b":
        assert "attn_impl='plain'" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
