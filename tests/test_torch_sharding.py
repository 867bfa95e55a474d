"""PyTorch port: the sharding arithmetic of `distributed/sharding.py` and
`types.MeshConfig` against the JAX package's, in process and without a
process group: on the 16x16 and 2x16x16 production meshes and a 2x2x2 one,
the logical rules, specs, DTensor placements, `sanitize_spec` (kv_heads = 8
over model = 16 replicates) and `shard_size_bytes`; the rows a rank keeps
and the shard `local_shard` cuts. The JAX side's `ShardingCtx` reads only
a mesh's axis names and shape, so it runs on a stand-in with those two.
Across ranks: tests/test_torch_mesh.py."""
import pickle
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

import repro.distributed.sharding as jax_sharding
import repro.types as jax_types
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, AbstractMesh, ShardingCtx
from repro_torch.types import MeshConfig

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LOGICAL = [("batch", None, "tp"), ("fsdp", "tp"), ("batch", "seq", None, "tp"),
           ("expert", "fsdp", None), (None,), ()]
#: (spec in mesh axes, shape): kv_heads = 8 over model = 16, a vocab that
#: divides, a batch of 2 over pod x data, a leaf with no sharded axis
CASES = [((None, "model"), (1024, 8)), (("data", "model"), (4096, 151936)),
         ((("pod", "data"), None), (2, 4096)), ((("pod", "data"), "model"), (512, 1024)),
         (("data", None, "model"), (96, 7, 64)), ((), (3, 5))]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16), (np.int8, jnp.int8)]


def _ctxs(name):
    """(the port's ctx on an AbstractMesh, the JAX package's on a stand-in)."""
    shape, axes = MESHES[name]
    jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    return ShardingCtx(AbstractMesh(shape, axes)), jax_sharding.ShardingCtx(jmesh)


def _usable(spec, axes) -> bool:
    names = [n for e in spec if e is not None for n in (e if isinstance(e, tuple) else (e,))]
    return set(names) <= set(axes)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_config_matches_jax(multi_pod):
    got, want = MeshConfig(multi_pod), jax_types.MeshConfig(multi_pod)
    assert (got.shape, got.axes, got.n_devices) == (want.shape, want.axes, want.n_devices)
    assert MESHES["2x16x16" if multi_pod else "16x16"] == (got.shape, got.axes)


@pytest.mark.parametrize("name", list(MESHES))
def test_rules_specs_and_sizes_match_jax(name):
    ctx, jctx = _ctxs(name)
    assert sharding.logical_to_mesh(ctx.mesh) == jax_sharding.logical_to_mesh(jctx.mesh)
    assert ctx.axis_sizes == jctx.axis_sizes
    assert (ctx.n_data, ctx.n_model, ctx.batch_axes) == (jctx.n_data, jctx.n_model,
                                                        jctx.batch_axes)
    for logical in LOGICAL:
        assert tuple(ctx.spec(*logical)) == tuple(jctx.spec(*logical)), logical


@pytest.mark.parametrize("name", list(MESHES))
def test_sanitize_spec_and_shard_size_match_jax(name):
    ctx, jctx = _ctxs(name)
    axes = MESHES[name][1]
    for spec, shape in CASES:
        if not _usable(spec, axes):
            continue
        got = sharding.sanitize_spec(P(*spec), shape, ctx)
        want = jax_sharding.sanitize_spec(JP(*spec), shape, jctx)
        assert tuple(got) == tuple(want), (spec, shape)
        for dtype, jdtype in DTYPES:
            assert sharding.shard_size_bytes(shape, dtype, got, ctx) == \
                jax_sharding.shard_size_bytes(shape, jdtype, want, jctx), (spec, shape, dtype)
    # kv_heads = 8 over model = 16 replicates; over model = 2 it shards
    kv = tuple(sharding.sanitize_spec(P(None, "model"), (1024, 8), ctx))
    assert kv == ((None, None) if ctx.n_model == 16 else (None, "model"))


def test_placements_of_the_batch_and_model_axes():
    ctx, _ = _ctxs("2x16x16")
    assert ctx.sharding("batch", None, "tp").placements == (Shard(0), Shard(0), Shard(2))
    assert ctx.replicated().placements == (Replicate(),) * 3
    assert sharding.placements_of(P(None, "model"), ("data", "model")) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.placements_of(P(("data", "pod")), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="shards two dimensions"):
        sharding.placements_of(P("data", "data"), ("data", "model"))


@pytest.mark.parametrize("name", list(MESHES))
def test_chain_carry_and_tree_shardings_match_jax(name, ctx11):
    """The fused carry's leaves with a chain axis shard over batch, the
    rest replicate (JAX: on its 1x1 mesh, whose specs are the same)."""
    ctx, jctx = _ctxs(name)
    K = 8
    carry = {"xs": torch.zeros(K, 2), "lps": torch.zeros(K), "eps": torch.tensor(0.5),
             "i": torch.tensor(0)}
    got = sharding.chain_carry_shardings(ctx, carry, K)
    want = jax_sharding.chain_carry_shardings(
        ctx11, {k: jnp.asarray(v.numpy()) for k, v in carry.items()}, K)
    batch_keys = {k for k, w in want.items() if tuple(w.spec)}
    assert batch_keys == {"xs", "lps"}
    assert {k: tuple(v.spec) for k, v in got.items()} == \
        {k: tuple(jctx.spec("batch")) if k in batch_keys else () for k in carry}
    tree = sharding.tree_shardings(ctx, {"a": P("data"), "b": [P(None, "model"), None]})
    assert tree["a"].spec == P("data") and tree["b"][0].mesh is ctx.mesh and tree["b"][1] is None
    like = {"w": torch.zeros(16, 8), "v": [np.zeros((3, 4))], "n": torch.zeros(2)}
    sane = sharding.sanitized_shardings(ctx, like, {"w": P("data", "model"),
                                                    "v": [P("data", None)], "n": None})
    assert sane["n"] is None
    assert tuple(sane["v"][0].spec) == (None, None)  # 3 rows do not split
    assert tuple(sane["w"].spec) == tuple(sharding.sanitize_spec(P("data", "model"), (16, 8),
                                                                  ctx))


@pytest.mark.parametrize("n,parts", [(8, 2), (8, 4), (6, 2), (16, 16)])
def test_row_shards_tile_the_wave(n, parts):
    rows = [sharding.row_shard(n, i, parts) for i in range(parts)]
    np.testing.assert_array_equal(np.concatenate([np.arange(n)[r] for r in rows]), np.arange(n))
    assert {r.stop - r.start for r in rows} == {n // parts}
    with pytest.raises(ValueError, match="equal parts"):
        sharding.row_shard(n + 1, 0, parts)


def test_local_shard_cuts_contiguous_blocks():
    """On 2x2x2 a [8, 6] leaf under P(("pod", "data"), "model") is cut into
    4 row blocks (pod the slower) and 2 column blocks."""
    full = np.arange(48).reshape(8, 6)
    sizes = {"pod": 2, "data": 2, "model": 2}
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                got = sharding.local_shard(full, P(("pod", "data"), "model"), sizes,
                                           {"pod": pod, "data": data, "model": model})
                block = 2 * pod + data
                np.testing.assert_array_equal(
                    got, full[2 * block:2 * block + 2, 3 * model:3 * model + 3])


def test_a_rankless_mesh_has_rows_only_at_size_one():
    ctx1 = ShardingCtx(AbstractMesh((1, 1), ("data", "model")))
    assert ctx1.rows(5) == slice(0, 5) and ctx1.batch_index == 0
    np.testing.assert_array_equal(ctx1.gather_rows(np.ones(3)), np.ones(3))
    with pytest.raises(ValueError, match="has no ranks"):
        ShardingCtx(AbstractMesh((2, 1), ("data", "model"))).rows(4)
    assert repr(P("data", None)) == "P('data', None)"
    assert pickle.loads(pickle.dumps(P(("pod", "data"), None))) == P(("pod", "data"), None)
