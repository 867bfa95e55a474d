"""PyTorch port: the checkpoint (`distributed.checkpoint.CheckpointManager`)
and the campaign checkpoint on it (`core.fleet.CampaignCheckpoint`) against
the JAX package's. A step directory written by either package restores in
the other (the same leaf order as `jax.tree.flatten`, the same files, the
same META.json); torn directories are skipped; and a host MLDA campaign
killed under the JAX package's checkpoint resumes in the port and gives the
JAX package's uninterrupted samples bit for bit."""
import json
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

import repro.core.fabric as jax_fabric
import repro.core.fleet as jax_fleet
import repro.distributed.checkpoint as jax_checkpoint
import repro.uq.mlda as jax_mlda
import repro_torch.core.fabric as fabric
import repro_torch.core.fleet as fleet
import repro_torch.distributed.checkpoint as checkpoint
import repro_torch.uq.mlda as mlda


def _state():
    """A tree with every node kind: dicts (keys out of order), an
    OrderedDict, a list, a tuple, None, tensors of three dtypes, arrays
    and a scalar."""
    rng = np.random.default_rng(0)
    return {
        "z": torch.as_tensor(rng.normal(size=(3, 2))),
        "a": [np.arange(4, dtype=np.int32), (torch.ones(2, dtype=torch.float32), None)],
        "m": OrderedDict([("y", np.float64(2.5)), ("b", torch.tensor(7, dtype=torch.int64))]),
        "b": {"k": rng.normal(size=5).astype(np.float32), "c": np.array(True)},
    }


def _host(tree):
    return jax.tree.map(lambda l: l.numpy() if isinstance(l, torch.Tensor) else np.asarray(l),
                        tree, is_leaf=lambda l: isinstance(l, torch.Tensor))


def test_leaf_order_matches_jax_tree_flatten():
    state = _state()
    got, rebuild = checkpoint._flatten(state)
    want = jax.tree.leaves(_host(state))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    back = rebuild(got)
    # jax.tree.unflatten also rebuilds a dict in sorted key order
    assert list(back) == sorted(state) and back["a"][1][1] is None
    assert back["z"] is state["z"] and isinstance(back["a"][1], tuple)
    assert isinstance(back["m"], OrderedDict) and list(back["m"]) == ["y", "b"]


def test_port_checkpoint_restores_in_jax_package(tmp_path):
    state = _state()
    checkpoint.CheckpointManager(str(tmp_path)).save(3, state, manifest={"note": "port"})
    got, step = jax_checkpoint.CheckpointManager(str(tmp_path)).restore(_host(state), host=True)
    assert step == 3
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(_host(state))):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert jax_checkpoint.CheckpointManager(str(tmp_path)).meta()["manifest"] == {"note": "port"}


def test_jax_checkpoint_restores_in_port(tmp_path):
    state = _state()
    jax_checkpoint.CheckpointManager(str(tmp_path)).save(5, _host(state), manifest={"n": 1})
    port = checkpoint.CheckpointManager(str(tmp_path))
    host, step = port.restore(state, host=True)
    assert step == 5 and port.meta()["manifest"] == {"n": 1}
    on_cpu, _ = port.restore(state, device="cpu")
    want = checkpoint._flatten(state)[0]
    for h, t, w in zip(checkpoint._flatten(host)[0], checkpoint._flatten(on_cpu)[0], want):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert isinstance(h, np.ndarray) and h.dtype == w.dtype
        np.testing.assert_array_equal(h, w)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), w)
    # a tensor leaf comes back in its state_like dtype, float64 kept
    assert on_cpu["z"].dtype == torch.float64 and on_cpu["m"]["b"].dtype == torch.int64
    # the same META.json fields as the JAX package writes
    doc = json.loads((tmp_path / "step_00000005" / "META.json").read_text())
    assert set(doc) == {"step", "n_leaves", "t", "manifest"} and doc["n_leaves"] == 7


def test_restore_defaults_to_the_card_and_refuses_shardings(tmp_path):
    port = checkpoint.CheckpointManager(str(tmp_path))
    port.save(1, {"x": np.zeros(2)})
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        port.restore({"x": np.zeros(2)}, shardings={"x": None})
    if not torch.cuda.is_available():
        # no silent CPU default: the entry points' device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.restore({"x": np.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        port.restore({"x": np.zeros(2), "y": np.zeros(1)}, host=True)


def _tear(d, how: str) -> None:
    leaf = d / "leaf_00001.npy"
    if how == "missing_leaf":
        leaf.unlink()
    elif how == "truncated_leaf":
        leaf.write_bytes(leaf.read_bytes()[:-8])
    else:
        (d / "META.json").unlink()


@pytest.mark.parametrize("how", ["missing_leaf", "truncated_leaf", "missing_meta"])
def test_torn_directories_are_skipped(tmp_path, how):
    port = checkpoint.CheckpointManager(str(tmp_path), keep_last=5)
    like = {"a": np.zeros(3), "b": np.zeros(4)}
    for step in (1, 2):
        port.save(step, {"a": np.full(3, step), "b": np.full(4, 10.0 * step)})
    _tear(tmp_path / "step_00000002", how)
    assert port.completed_steps() == [1] and port.latest_step(complete_only=False) == 2
    got, step = port.restore(like, host=True)
    assert step == 1 and np.array_equal(got["b"], np.full(4, 10.0))
    with pytest.raises(ValueError, match="incomplete"):
        port.restore(like, step=2, host=True)
    # the JAX package's manager agrees on what is torn
    assert jax_checkpoint.CheckpointManager(str(tmp_path), keep_last=5).completed_steps() == [1]


def test_keep_last_and_async_save(tmp_path):
    port = checkpoint.CheckpointManager(str(tmp_path), keep_last=2)
    for step in range(1, 5):
        port.save_async(step, {"x": torch.full((2,), float(step))})
    port.wait()
    assert port.completed_steps() == [3, 4]
    got, step = port.restore({"x": torch.zeros(2)}, device="cpu")
    assert step == 4 and torch.equal(got["x"], torch.full((2,), 4.0))


# -- campaigns across packages ------------------------------------------------


def _levels():
    mu, sig = np.array([0.5, -0.3]), np.array([0.8, 0.5])

    def level(shift, scale):
        def lp(X):
            X = np.atleast_2d(X)
            return -0.5 * np.sum(((X - mu - shift) / (sig * scale)) ** 2, axis=1)

        return lp

    return [level(0.1, 1.2), level(0.0, 1.0)]


class _DieAfter:
    """Checkpoint wrapper that kills the campaign after `n` saves."""

    def __init__(self, ckpt, n):
        self.ckpt, self.n, self.saves = ckpt, n, 0

    def resume(self):
        return self.ckpt.resume()

    def save(self, step, arrays, meta):
        self.ckpt.save(step, arrays, meta)
        self.saves += 1
        if self.saves >= self.n:
            raise RuntimeError("simulated preemption")


@pytest.mark.parametrize("adaptive", [False, True])
def test_campaign_killed_in_jax_package_resumes_in_port(tmp_path, adaptive):
    x0s = np.random.default_rng(5).standard_normal((8, 2))
    kw = dict(n_samples=40, subsampling=[3], prop_cov=np.diag([0.6, 0.4]) ** 2,
              adaptive=adaptive, adapt_start=10, checkpoint_every=10)
    want = jax_mlda.ensemble_mlda(_levels(), x0s, rng=np.random.default_rng(9), **kw)
    bomb = _DieAfter(jax_fleet.CampaignCheckpoint(str(tmp_path)), 2)
    with pytest.raises(RuntimeError, match="preemption"):
        jax_mlda.ensemble_mlda(_levels(), x0s, rng=np.random.default_rng(9),
                               checkpoint=bomb, **kw)
    # a fresh rng in another state: the checkpoint's stream wins
    got = mlda.ensemble_mlda(_levels(), x0s, rng=np.random.default_rng(123),
                             checkpoint=fleet.CampaignCheckpoint(str(tmp_path)), **kw)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.n_waves == want.n_waves
    assert got.evals_per_level == want.evals_per_level
    assert got.accept_rates == want.accept_rates
    if adaptive:
        np.testing.assert_array_equal(got.proposal_cov, want.proposal_cov)


def test_port_campaign_checkpoint_resumes_in_jax_package(tmp_path):
    x0s = np.random.default_rng(6).standard_normal((4, 2))
    kw = dict(n_samples=30, subsampling=[2], prop_cov=0.3 * np.eye(2), checkpoint_every=10)
    want = mlda.ensemble_mlda(_levels(), x0s, rng=np.random.default_rng(1), **kw)
    bomb = _DieAfter(fleet.CampaignCheckpoint(str(tmp_path), campaign_id="c7"), 1)
    with pytest.raises(RuntimeError, match="preemption"):
        mlda.ensemble_mlda(_levels(), x0s, rng=np.random.default_rng(1), checkpoint=bomb, **kw)
    arrays, meta, step = jax_fleet.CampaignCheckpoint(str(tmp_path)).resume()
    assert step == 10 and meta["campaign_id"] == "c7" and arrays["samples"].shape == (4, 10, 2)
    got = jax_mlda.ensemble_mlda(_levels(), x0s, rng=np.random.default_rng(2),
                                 checkpoint=jax_fleet.CampaignCheckpoint(str(tmp_path)), **kw)
    np.testing.assert_array_equal(got.samples, want.samples)


def _router(pkg, n: int = 2):
    backends = [pkg.CallableBackend(lambda thetas, cfg=None: np.asarray(thetas).sum(1))
                for _ in range(n)]
    return pkg.FabricRouter(backends)


def test_router_state_rides_along(tmp_path):
    learned = {"ewma_point_s": [0.004, 0.0125],
               "ewma_op_point_s": [{"evaluate": 0.004}, {"evaluate": 0.0125, "gradient": 0.03}],
               "admin": [None, "drained"]}
    router = _router(fabric)
    router.load_state(learned)
    fab = fabric.EvaluationFabric(router)
    try:
        ckpt = fleet.CampaignCheckpoint(str(tmp_path)).attach(router=fab)
        ckpt.save(4, {"xs": np.ones((2, 2))}, {"i_next": 4})
    finally:
        fab.shutdown()
    saved = router.state_dict()
    # the port's fresh router takes the learned state back on resume
    fresh = _router(fabric)
    arrays, meta, step = fleet.CampaignCheckpoint(str(tmp_path), router=fresh).resume()
    assert step == 4 and meta["i_next"] == 4 and np.array_equal(arrays["xs"], np.ones((2, 2)))
    assert fresh.state_dict() == saved == meta["router"]
    # and so does the JAX package's, from the same directory
    jax_fresh = _router(jax_fabric)
    jax_fleet.CampaignCheckpoint(str(tmp_path), router=jax_fresh).resume()
    assert jax_fresh.state_dict() == saved
