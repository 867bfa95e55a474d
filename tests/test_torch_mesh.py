"""PyTorch port: the device mesh on the UQ path, across `gloo` ranks on the
CPU (tests/_torch_mesh.py starts them): `ModelPool(ctx=)` on 2 and 4 ranks
(the quadratic model and the reduced tsunami, each equal bit for bit to the
port's unsharded wave; the quadratic one also to the JAX package's
`ModelPool(model, ctx11)`; a 3-point wave padded on 2 ranks), the fused RWM
on 2 ranks, fused and per step, equal bit for bit to the one-rank `ctx` run
with the same padded chain count (the counterpart of
tests/test_fused.py's fused == per-step test), the fused MALA's step-size
adaptation pooled over both ranks' chains, a fused checkpoint written by
2 ranks and resumed on 1, `restore(shardings=)` of a checkpoint written by
one process onto 2- and 4-rank meshes (the counterpart of
tests/test_substrate.py's elastic restore), and the reduced qwen3-0.6b
`LMUQModel(ctx=)` on 2 ranks against the JAX package's `LMUQModel(...,
ctx=ctx11)` within `_torch_zoo.NLL_RTOL`.

Each world of ranks runs once per module (one spawn each: a rank imports
torch and the port in ~5 s), with its own time limit."""
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.apps.lm_model as jax_lm
import repro.core.pool as jax_pool
from _torch_mesh import fused_mala, fused_rwm, one_rank_mesh, quad, run_ranks, tsunami_model
from _torch_zoo import NLL_RTOL
from repro.core.interface import JAXModel
from repro_torch.core.interface import TorchModel
from repro_torch.core.pool import ModelPool
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import P
from repro_torch.kernels.swe.testing import sources

torch.set_num_threads(1)

ARCH = "qwen3-0.6b"
SEQ = 32
#: 5 points: padded to 6 on 2 ranks
THETAS = np.array([[1.0, 1.0], [0.7, 1.0], [1.3, 1.0], [0.8, 1.2], [1.25, 0.75]])
_rng = np.random.default_rng(5)
#: named waves: quad* through the quadratic model, tsunami<level> sources
WAVES = {"quad8": _rng.standard_normal((8, 2)), "quad3": _rng.standard_normal((3, 2)),
         "tsunami0": sources(6, 21).astype(float), "tsunami1": sources(3, 22).astype(float)}
#: 6 chains: padded to 8 (the next power of two) on any mesh of <= 8 batch ranks
FUSED = dict(x0s=_rng.standard_normal((6, 3)), n_steps=20, S=5, seed=11)
SPECS = {"w": P("data", "model"), "b": P("data"), "kv": P(None, "model"),
         "odd": P("data", "model"), "c": None}


def _unsharded(name: str, thetas) -> np.ndarray:
    if name.startswith("quad"):
        return ModelPool(TorchModel(quad, 2, 2, device="cpu")).evaluate(thetas)
    return tsunami_model().evaluate_batch(thetas, {"level": int(name[-1])})


@pytest.fixture(scope="module")
def restore_case(tmp_path_factory):
    """A checkpoint written by this one process, and the tree to restore it
    into (tensors, numpy, one leaf with no spec)."""
    rng = np.random.default_rng(9)
    state = {"w": rng.standard_normal((8, 12)).astype(np.float32),
             "b": rng.integers(0, 100, 6), "kv": rng.standard_normal((4, 8)).astype(np.float32),
             "odd": rng.standard_normal((3, 5)), "c": rng.standard_normal(3)}
    directory = tmp_path_factory.mktemp("mesh_restore") / "ckpt"
    CheckpointManager(str(directory)).save(7, state)
    like = {"w": torch.zeros(8, 12), "b": torch.zeros(6, dtype=torch.int64),
            "kv": torch.zeros(4, 8), "odd": torch.zeros(3, 5, dtype=torch.float64),
            "c": np.zeros(3)}
    return state, {"directory": str(directory), "like": like, "specs": SPECS}


@pytest.fixture(scope="module")
def carried():
    """The JAX package's reduced qwen3-0.6b LMUQModel (seed 0, a [2, SEQ]
    batch from seed 1) and its weights and batch as numpy."""
    jm = jax_lm.LMUQModel(ARCH, reduced=True, batch=2, seq=SEQ)
    return jm, {"arch": ARCH, "params": jax.tree.map(np.asarray, jm.params),
                "batch": jax.tree.map(np.asarray, jm.batch), "thetas": THETAS}


@pytest.fixture(scope="module")
def fused_ckpt(tmp_path_factory):
    """Where the 2-rank fused RWM writes a checkpoint every block."""
    return str(tmp_path_factory.mktemp("fused_ckpt"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, carried, restore_case, fused_ckpt):
    return run_ranks(2, "two_rank_suite", tmp_path_factory.mktemp("two_ranks"),
                     timeout_s=150.0, waves=WAVES, fused=FUSED, lm=carried[1],
                     restore=restore_case[1], checkpoint_dir=fused_ckpt)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, restore_case):
    return run_ranks(4, "four_rank_suite", tmp_path_factory.mktemp("four_ranks"),
                     timeout_s=150.0, waves=WAVES, restore=restore_case[1])


def _pool_runs(two_ranks, four_ranks, which):
    if which == "2x1":
        return [r["pool"] for r in two_ranks]
    return [r["pool41" if which == "4x1" else "pool22"] for r in four_ranks]


@pytest.mark.parametrize("which", ["2x1", "4x1", "2x2"])
def test_sharded_pool_waves_equal_the_unsharded_wave(two_ranks, four_ranks, which):
    """Every rank gets the whole wave, and it is the unsharded wave bit for
    bit: the quadratic model's vmapped rows and the tsunami's lanes are
    independent of the wave's width."""
    runs = _pool_runs(two_ranks, four_ranks, which)
    for name, thetas in WAVES.items():
        want = _unsharded(name, thetas)
        for rank, run in enumerate(runs):
            assert run[name].shape == want.shape
            np.testing.assert_array_equal(run[name], want, err_msg=f"{which} rank {rank} {name}")


@pytest.mark.parametrize("which", ["2x1", "4x1", "2x2"])
def test_sharded_pool_pads_to_an_instance_multiple(two_ranks, four_ranks, which):
    n_data = {"2x1": 2, "4x1": 4, "2x2": 2}[which]
    pads = sum((-len(WAVES[k])) % n_data for k in ("quad8", "quad3"))
    for run in _pool_runs(two_ranks, four_ranks, which):
        assert run["n_instances"] == n_data
        assert run["quad_stats"] == {"batches": 2, "evaluations": 11, "padded": pads,
                                     "bucket_shapes": 2}
    if which == "2x1":
        assert pads == 1  # N = 3 pads 1 on 2 ranks
        assert [r["rows"] for r in two_ranks] == [slice(0, 2), slice(2, 4)]


def test_four_rank_mesh_coordinates(four_ranks):
    """On the 2x2 mesh rank r sits at (data, model) = divmod(r, 2), and the
    two model-axis replicas of a row shard share its batch index."""
    for rank, run in enumerate(four_ranks):
        assert run["coordinate"] == dict(zip(("data", "model"), divmod(rank, 2)))
        assert run["batch_index"] == rank // 2


def test_quadratic_pool_matches_the_jax_package(two_ranks, four_ranks, ctx11):
    jm = JAXModel(lambda th: jax.numpy.array([jax.numpy.sum(th**2), th[0] * th[1]]), 2, 2)
    for name in ("quad8", "quad3"):
        want = jax_pool.ModelPool(jm, ctx=ctx11).evaluate(WAVES[name])
        for run in [r["pool"] for r in two_ranks] + [r["pool41"] for r in four_ranks]:
            np.testing.assert_allclose(run[name], want, rtol=1e-6, atol=1e-7)


def test_fused_rwm_on_two_ranks_equals_the_one_rank_run(two_ranks):
    """The 6 chains are padded to 8 on both meshes, every Philox array drawn
    at [8, ...]: 2 ranks of 4 chains give the 1-rank run's samples,
    log-densities and acceptance rates bit for bit, fused and per step."""
    with one_rank_mesh() as ctx:
        want = fused_rwm(ctx, **FUSED)
        per_step = fused_rwm(ctx, **{**FUSED, "per_step": True})
    for a, b in zip(want, per_step):
        np.testing.assert_array_equal(a, b)
    assert want[0].shape == (6, FUSED["n_steps"], 3) and np.all(want[2] > 0)
    for rank, run in enumerate(two_ranks):
        for key in ("fused", "per_step", "checkpointed"):
            for got, w in zip(run[key], want):
                np.testing.assert_array_equal(got, w, err_msg=f"rank {rank} {key}")


def test_fused_mala_adapts_on_the_chains_of_both_ranks(two_ranks):
    """Robbins-Monro pools the acceptance over all 6 chains: on 2 ranks each
    step gathers the ranks' counts, and the run is the one-rank run's."""
    with one_rank_mesh() as ctx:
        want = fused_mala(ctx, **FUSED)
    assert want[2] != 0.8
    for rank, run in enumerate(two_ranks):
        np.testing.assert_array_equal(run["mala"][0], want[0], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(run["mala"][1], want[1], err_msg=f"rank {rank}")
        assert run["mala"][2] == want[2]


def test_fused_checkpoint_written_on_two_ranks_resumes_on_one(two_ranks, fused_ckpt):
    """Rank 0 wrote a checkpoint every block, the chains gathered: resumed
    on one rank from step 10, the run ends where the 2-rank run ended, bit
    for bit."""
    where = fused_ckpt
    steps = CheckpointManager(where).completed_steps()
    assert steps == [5, 10, 15, 20]
    for s in (15, 20):
        shutil.rmtree(f"{where}/step_{s:08d}")
    with one_rank_mesh() as ctx:
        got = fused_rwm(ctx, **{**FUSED, "seed": 999}, checkpoint_dir=where)
    for a, b in zip(got, two_ranks[0]["fused"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_restore_reshards_onto_two_and_four_ranks(two_ranks, four_ranks, restore_case, world):
    """A checkpoint written by one process comes back on a 2x1 and a 2x2
    mesh as DTensors whose `full_tensor()` is the saved array bit for bit;
    a spec whose axes do not divide the leaf (3 rows over data = 2) is
    sanitized to replicate; a leaf without a spec comes back as a tensor."""
    state, _ = restore_case
    runs = two_ranks if world == 2 else four_ranks
    model = 1 if world == 2 else 2
    local = {"w": (4, 12 // model), "b": (3,), "kv": (4, 8 // model), "odd": (3, 5)}
    for run in runs:
        got = run["restore"]
        assert got["step"] == 7
        for k, shape in local.items():
            full, local_shape, placements = got[k]
            np.testing.assert_array_equal(full, state[k])
            assert full.dtype == (np.float64 if k == "odd" else state[k].dtype)
            assert local_shape == shape, (k, local_shape)
        assert got["odd"][2] == ("Replicate()", "Replicate()" if world == 4 else "Shard(dim=1)")
        kind, value = got["c"]
        assert kind == "Tensor"
        np.testing.assert_array_equal(value, state["c"])


def test_lm_wave_on_two_ranks_matches_jax(two_ranks, carried):
    """5 points padded to 6, 3 a rank: every rank's NLLs against the JAX
    package's LMUQModel on a 1x1 mesh (the same weights and batch)."""
    jm, _ = carried
    want = np.array([jm([list(t)])[0][0] for t in THETAS])
    for run in two_ranks:
        got = run["lm"][:, 0]
        assert got.shape == (len(THETAS),)
        np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
    np.testing.assert_array_equal(two_ranks[0]["lm"], two_ranks[1]["lm"])
