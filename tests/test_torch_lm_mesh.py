"""PyTorch port: the LM's layout on the device mesh.

* The layout against the JAX package's, in process and without a process
  group (an `AbstractMesh`; the JAX side's `ShardingCtx` on a stand-in with
  the mesh's axis names and shape, as tests/test_torch_sharding.py does),
  for all ten configs, full and reduced, on 1x1, 16x16 and 2x16x16:
  `param_specs`, `cache_decl`'s specs and `batch_specs` leaf by leaf, each
  also after `sanitize_spec` for its leaf's shape (what the DTensors are
  placed by).
* Across `gloo` ranks on the CPU (tests/_torch_mesh.py starts them; one
  2-rank world on the (2, 1) and (1, 2) meshes, one 4-rank world on
  (2, 2)), with the weights sharded by `param_specs` (FSDP over 'data', TP
  and EP over 'model'):
  - the reduced qwen3-0.6b, deepseek-moe-16b (EP over model = 2) and
    mamba2-1.3b NLLs against the one-process port within
    `_torch_zoo.NLL_RTOL`. A MoE routes each rank's tokens on their own
    with a capacity from the rank's token count (the JAX package's
    `_expert_shard_body`), so the one-process run it is held to evaluates
    each batch rank's rows on their own;
  - a reduced qwen3-0.6b `train_step`: loss, NLL and gradient norm within
    `test_torch_train.py`'s `LOSS_RTOL` and `GNORM_RTOL`, every gradient
    leaf within its `GRAD_RTOL`, and the updated weights equal to
    `adamw_update` applied on one process to the mesh's own gradients
    (within `GRAD_RTOL` of the largest update: the gradient norm is summed
    in another order);
  - `LMUQModel(ctx=)`'s evaluate wave against the JAX package's
    `LMUQModel(..., ctx=ctx11)` within `NLL_RTOL`, its gradient wave
    within `_torch_lm_grad.grad_rtol`, its Hessian-action wave within
    `_torch_lm_grad.hess_rtol` of the JAX package's and of the one-process
    port's, every rank the same numbers (and its capabilities advertise
    the Hessian action).
Each world has its own time limit.
* In the test process, on a 1x1 mesh of one rank: the reduced
  deepseek-moe-16b's Hessian action equals the one-process port's bit for
  bit (reverse over reverse lost the MoE dispatch's output gradient
  through `local_map` before the port's own DTensor rules), and so do
  qwen3-0.6b's and deepseek-moe-16b's while DTensor's `to_local` and
  `redistribute` build their gradients off the graph, as torch 2.11's
  do."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from types import SimpleNamespace

import repro.apps.lm_model as jax_lm
import repro.distributed.sharding as jax_sharding
import repro.models.model as jax_model
import repro.models.transformer as jax_transformer
from _torch_lm_grad import grad_rtol, hess_rtol
from _torch_mesh import lm_case, one_rank_mesh, run_ranks
from _torch_zoo import NLL_RTOL, carry, jax_lm_model, rel
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro_torch.apps.lm_model import LMUQModel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.sharding import P, AbstractMesh, ShardingCtx, sanitize_spec
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.types import SHAPES, TrainConfig

torch.set_num_threads(1)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: test_torch_train.py's bounds
LOSS_RTOL, GNORM_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
NLL_ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "mamba2-1.3b")
NLL = dict(archs=NLL_ARCHS, B=4, S=16)
TRAIN = dict(arch="qwen3-0.6b", B=4, S=16)
LM_ARCH, LM_SEQ = "qwen3-0.6b", 32
THETAS = np.array([[1.0, 1.0], [0.7, 1.0], [1.3, 1.0], [0.8, 1.2], [1.25, 0.75]])
SENSS = np.array([[1.0], [0.5], [-2.0], [1.5], [1.0]])
#: the training steps whose collectives are counted on the port's DTensor
#: rules and on DTensor's own (a MoE's dispatch returns a partial sum)
COLLECTIVES = dict(archs=["deepseek-moe-16b", "qwen3-0.6b"], B=4, S=16)
VECS = np.array([[1.0, 0.0], [0.3, -0.7], [0.0, 1.0], [-0.6, 0.4], [1.0, 1.0]])


def _ctxs(name):
    """(the port's ctx on an AbstractMesh, the JAX package's on a stand-in)."""
    shape, axes = MESHES[name]
    jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    return ShardingCtx(AbstractMesh(shape, axes)), jax_sharding.ShardingCtx(jmesh)


def _canon(spec) -> tuple:
    """A spec as a tuple of None, an axis name or a tuple of names, a tuple
    of one name being that name."""
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else (None if not e else e)
        out.append(e)
    return tuple(out)


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _assert_specs_equal(got, want, shapes, ctx, jctx, what):
    g, w = _spec_leaves(got), _jleaves(want)
    assert len(g) == len(w) == len(shapes), what
    for i, (gs, ws, shape) in enumerate(zip(g, w, shapes)):
        assert _canon(gs) == _canon(ws), (what, i, gs, ws)
        assert (_canon(sanitize_spec(gs, shape, ctx))
                == _canon(jax_sharding.sanitize_spec(ws, shape, jctx))), (what, i, shape)


def _spec_leaves(tree) -> list:
    """The PartitionSpec leaves of a tree in `jax.tree.leaves` order (a
    spec is a tuple, so the port's tree walkers would descend into it)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _spec_leaves(tree[k])]
    return [leaf for t in tree for leaf in _spec_leaves(t)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layout_matches_jax(arch, reduced, mesh):
    """`param_specs`, `cache_decl`'s specs and `batch_specs` of every shape
    equal the JAX package's leaf by leaf, raw and sanitized."""
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    ctx, jctx = _ctxs(mesh)
    cfg, jcfg = get_config(arch, reduced=reduced), jax_get_config(arch, reduced=reduced)
    shapes = [tuple(a.shape) for a in tree_leaves(M.abstract_params(cfg))]
    assert shapes == [a.shape for a in jax.tree.leaves(jax_model.abstract_params(jcfg))]
    _assert_specs_equal(M.param_specs(cfg), jax_model.param_specs(jcfg), shapes, ctx, jctx,
                        "params")
    for name, shape in SHAPES.items():
        B, S = shape.global_batch, min(shape.seq_len, 4096)
        decls = transformer.cache_decl(cfg, B, S, ctx)
        _, jspecs = jax_transformer.cache_decl(jcfg, B, S, jctx)
        _assert_specs_equal(transformer.cache_specs(decls), jspecs,
                            [d.shape for d in tree_leaves(decls)], ctx, jctx, f"cache {name}")
        abstract, specs = M.batch_specs(cfg, shape, ctx)
        jabstract, jspecs = jax_model.batch_specs(jcfg, shape, jctx)
        _assert_specs_equal(specs, jspecs, [tuple(a.shape) for a in tree_leaves(abstract)],
                            ctx, jctx, f"batch {name}")
        assert ([tuple(a.shape) for a in tree_leaves(abstract)]
                == [a.shape for a in jax.tree.leaves(jabstract)])


def test_cache_decl_without_a_ctx_is_the_one_device_layout():
    cfg = get_config("qwen3-0.6b")
    ctx, _ = _ctxs("1x1")
    assert transformer.cache_decl(cfg, 4, 64) == transformer.cache_decl(cfg, 4, 64, ctx)


@pytest.fixture(scope="module")
def carried():
    """The JAX package's reduced qwen3-0.6b LMUQModel (seed 0, a [2, LM_SEQ]
    batch from seed 1): its waves, and the one-process port's Hessian
    action on the same weights; the weights and batch as numpy."""
    jm = jax_lm.LMUQModel(LM_ARCH, reduced=True, batch=2, seq=LM_SEQ)
    lm = {"arch": LM_ARCH, "params": jax.tree.map(np.asarray, jm.params),
          "batch": jax.tree.map(np.asarray, jm.batch), "thetas": THETAS, "senss": SENSS,
          "vecs": VECS}
    one = LMUQModel(LM_ARCH, reduced=True, device="cpu", batch=lm["batch"],
                    params=lm_params_from_numpy(get_config(LM_ARCH, True), lm["params"], "cpu"))
    want = {"evaluate": jm.evaluate_batch(THETAS), "gradient": jm.gradient_batch(THETAS, SENSS),
            "hessian": jm.apply_hessian_batch(THETAS, SENSS, VECS),
            "hessian_one": one.apply_hessian_batch(THETAS, SENSS, VECS)}
    return want, lm


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, carried):
    kw = dict(nll=NLL, train=TRAIN, lm=carried[1], collectives=COLLECTIVES)
    two = run_ranks(2, "lm_mesh_suite", tmp_path_factory.mktemp("lm_two"), timeout_s=240.0,
                    meshes=[(2, 1), (1, 2)], **kw)
    four = run_ranks(4, "lm_mesh_suite", tmp_path_factory.mktemp("lm_four"), timeout_s=240.0,
                     meshes=[(2, 2)], **kw)
    return {"2x1": two, "1x2": two, "2x2": four}


MESH_RUNS = ["2x1", "1x2", "2x2"]


def _one_process_nlls(arch: str, n_data: int) -> np.ndarray:
    """The one-process NLLs of NLL's batch, each of `n_data` batch ranks'
    rows evaluated on their own (a MoE's capacity is per rank)."""
    cfg, params, batch = lm_case(arch, NLL["B"], NLL["S"])
    per = NLL["B"] // n_data
    with torch.no_grad():
        return np.concatenate([
            M.eval_nll(cfg, params, {k: v[i * per:(i + 1) * per] for k, v in batch.items()})
            .numpy() for i in range(n_data)])


@pytest.mark.parametrize("arch", NLL_ARCHS)
@pytest.mark.parametrize("mesh", MESH_RUNS)
def test_sharded_nlls_match_the_one_process_run(worlds, arch, mesh):
    n_data = int(mesh.split("x")[0])
    want = _one_process_nlls(arch, n_data)
    for rank, run in enumerate(worlds[mesh]):
        got = run[mesh]["nll"][arch]
        err = rel(got, want)
        print(f"{arch} on {mesh}, rank {rank}: NLL rel err {err:.3g} (bound {NLL_RTOL})")
        assert got.shape == want.shape and err < NLL_RTOL


@pytest.mark.parametrize("mesh", MESH_RUNS)
def test_sharded_train_step_matches_the_one_process_step(worlds, mesh):
    cfg, params, batch = lm_case(**TRAIN)
    tc = TrainConfig(warmup_steps=0)
    loss, metrics, grads = M.loss_and_grads(cfg, params, batch)
    want = dict(metrics, loss=loss, grad_norm=adamw.global_norm(grads))
    for rank, run in enumerate(worlds[mesh]):
        got = run[mesh]["train"]
        assert got["sharded"]
        for k in ("loss", "nll", "grad_norm"):
            bound = GNORM_RTOL if k == "grad_norm" else LOSS_RTOL
            assert rel(got["metrics"][k], float(want[k])) <= bound, (mesh, rank, k)
        worst = max(rel(g, w) for g, w in zip(got["grads"], _numpy(grads))
                    if np.abs(w.numpy() if hasattr(w, "numpy") else w).max() > 0)
        print(f"train step on {mesh}, rank {rank}: worst gradient leaf {worst:.3g}")
        assert worst <= GRAD_RTOL
        # the update: adamw_update on one process from the mesh's gradients
        mesh_grads = tree_map(lambda t: t, grads)
        for leaf, g in zip(tree_leaves(mesh_grads), got["grads"]):
            leaf.copy_(torch.from_numpy(g))
        updated = tree_map(torch.clone, params)
        adamw.adamw_update(updated, mesh_grads, adamw.adamw_init(updated, tc), tc)
        for new, old, mesh_new in zip(tree_leaves(updated), tree_leaves(params), got["params"]):
            step = (new - old).numpy()
            if np.abs(step).max() > 0:
                assert np.abs(mesh_new - new.numpy()).max() <= GRAD_RTOL * np.abs(step).max()


def _numpy(tree):
    return [t.numpy() for t in tree_leaves(tree)]


@pytest.mark.parametrize("mesh", MESH_RUNS)
def test_sharded_lm_waves_match_jax(worlds, carried, mesh):
    want, _ = carried
    runs = [run[mesh]["lm"] for run in worlds[mesh]]
    for rank, run in enumerate(runs):
        assert run["sharded"]
        e, g = rel(run["evaluate"], want["evaluate"]), rel(run["gradient"], want["gradient"])
        h, h1 = rel(run["hessian"], want["hessian"]), rel(run["hessian"], want["hessian_one"])
        print(f"LMUQModel on {mesh}, rank {rank}: evaluate {e:.3g}, gradient {g:.3g}, "
              f"Hessian {h:.3g} (one process {h1:.3g})")
        assert run["evaluate"].shape == (len(THETAS), 1) and e < NLL_RTOL
        assert run["gradient"].shape == (len(THETAS), 2) and g < grad_rtol(LM_ARCH)
        assert run["hessian"].shape == (len(THETAS), 2)
        assert h < hess_rtol(LM_ARCH) and h1 < hess_rtol(LM_ARCH)
        assert run["capabilities"]["ApplyHessian"]
        for k in ("evaluate", "gradient", "hessian"):
            np.testing.assert_array_equal(run[k], runs[0][k])


def test_hessian_on_a_one_rank_mesh_is_the_one_process_hessian():
    """The reduced deepseek-moe-16b on a 1x1 mesh: no collective runs, so
    its Hessian action equals the one-process port's bit for bit, and the
    JAX package's within `hess_rtol`. The direction is the embedding scale
    (every path through the stack). Before the port's own DTensor rules
    (`sharding._FromLocal`) the second backward lost the MoE dispatch's
    output gradient (a partial sum that `from_local`'s backward
    redistributed outside the graph): 5.3e-3 relative here, on any
    mesh."""
    arch = "deepseek-moe-16b"
    c = carry(arch, seq=LM_SEQ)
    jm = jax_lm_model(c, seq=LM_SEQ)
    batch = jax.tree.map(np.asarray, jm.batch)
    vecs = np.tile([1.0, 0.0], (len(THETAS), 1))
    want = jm.apply_hessian_batch(THETAS, SENSS, vecs)
    one = LMUQModel(arch, reduced=True, device="cpu", params=c.params, batch=batch)
    one_process = one.apply_hessian_batch(THETAS, SENSS, vecs)
    with one_rank_mesh() as ctx:
        lm = LMUQModel(arch, reduced=True, device="cpu", params=c.params, batch=batch, ctx=ctx)
        got = lm.apply_hessian_batch(THETAS, SENSS, vecs)
        assert lm.capabilities().apply_hessian_batch
    print(f"{arch} on 1x1: Hessian against the one process {rel(got, one_process):.3g}, "
          f"against JAX {rel(got, want):.3g}")
    np.testing.assert_array_equal(got, one_process)
    assert rel(got, want) < hess_rtol(arch)



def _off_graph(backward):
    """A DTensor autograd rule's backward whose gradients are built off the
    autograd graph, as torch 2.11's `to_local` and `redistribute` build
    theirs (with the DTensor constructor: a leaf that requires grad where
    the incoming gradient does)."""
    def rule(ctx, *grads):
        return tuple(g.detach().requires_grad_(g.requires_grad) if isinstance(g, torch.Tensor)
                     else g for g in backward(ctx, *grads))

    return staticmethod(rule)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b"])
def test_hessian_on_a_one_rank_mesh_needs_no_twice_differentiable_dtensor_rule(arch,
                                                                                 monkeypatch):
    """The reduced arch's Hessian action in the embedding scale's direction
    on a 1x1 mesh equals the one-process port's bit for bit while DTensor's
    `to_local` and `redistribute` build their gradients off the autograd
    graph, as torch 2.11's do: the port's own rules (`sharding.redistribute`,
    `_ToLocal`, `_FromLocal`) carry reverse over reverse. Through
    PyTorch's `local_map` and `redistribute` it was 2.3e-3 (qwen3-0.6b)
    and 1.0 (deepseek-moe-16b) relative off."""
    from torch.distributed.tensor import _api
    from torch.distributed.tensor._redistribute import Redistribute

    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    vecs = np.tile([1.0, 0.0], (len(THETAS), 1))
    one = LMUQModel(arch, reduced=True, device="cpu", params=params, seq=LM_SEQ)
    want = one.apply_hessian_batch(THETAS, SENSS, vecs)
    monkeypatch.setattr(_api._ToTorchTensor, "backward", _off_graph(_api._ToTorchTensor.backward))
    monkeypatch.setattr(Redistribute, "backward", _off_graph(Redistribute.backward))
    with one_rank_mesh() as ctx:
        lm = LMUQModel(arch, reduced=True, device="cpu", params=params, seq=LM_SEQ, ctx=ctx)
        got = lm.apply_hessian_batch(THETAS, SENSS, vecs)
    print(f"{arch} on 1x1, DTensor's rules off the graph: Hessian against the one process "
          f"{rel(got, want):.3g}")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", MESH_RUNS)
def test_twice_differentiable_rules_add_no_collective(worlds, mesh):
    """The port's DTensor rules (`sharding.redistribute`, `_ToLocal`,
    `_FromLocal`) redistribute every gradient on the autograd graph to the
    placements that DTensor's own rules redistribute it to off the graph,
    so a training step's backward runs the same collectives on them as on
    DTensor's own, and gives the same bits."""
    for rank, run in enumerate(worlds[mesh]):
        got = run[mesh]["collectives"]
        for arch in COLLECTIVES["archs"]:
            port, theirs = got[arch, "port"], got[arch, "dtensor"]
            print(f"{arch} training step on {mesh}, rank {rank}: collectives {port['counts']} "
                  f"on the port's rules, {theirs['counts']} on DTensor's")
            assert port["counts"] and port["counts"] == theirs["counts"]
            for a, b in zip(port["grads"], theirs["grads"], strict=True):
                np.testing.assert_array_equal(a, b)
