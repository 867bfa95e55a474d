"""PyTorch port: serving on sharded caches (`transformer.init_cache(...,
ctx=)`, `models.model.prefill_step` and `decode_step` with `ctx=`, flash
decoding in `models/attention.py`), on `gloo` ranks on the CPU
(tests/_torch_mesh.py starts them: a 2-rank world on the (1, 2) mesh, a
4-rank world on (2, 2)), for three reduced configs whose caches the mesh
places three ways:

* qwen3-0.6b (2 kv heads): the kv heads split over 'model';
* qwen3-0.6b with one kv head, which does not divide 'model': the cache
  split over its rows;
* minicpm3-4b (MLA): the latent cache split over its rows.

Held: `init_cache(ctx=)`'s leaves are zeros placed as `cache_decl`'s
specs say; `prefill_step`'s caches come back so placed; its last logits
and caches, STEPS decode steps' logits and the caches after them (every
leaf gathered) match the one-process steps and the JAX package's prefill
and `decode_step`, within `_torch_zoo.LOGITS_RTOL[arch]` (the decode
tests' bounds); where the rows are split, a decode step issues no
all-gather (`_torch_mesh.all_gathers`: the functional collectives of its
op stream, and the calls of PyTorch's functional all-gathers through a
patch; a gather of the logits shows both counts see one); and a
prompt of PROMPT tokens in CACHE_LEN rows leaves the second 'model' rank
with no row <= pos at the first steps (every row it holds masked), whose
output is still finite and right.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import run_ranks
from _torch_zoo import LOGITS_RTOL, carry, rel
from repro_torch.models import model, transformer
from repro_torch.models.params import tree_leaves

torch.set_num_threads(1)

PROMPT, STEPS, CACHE_LEN = 4, 6, 16  # rows 8..15 of (1, 2)'s second rank: masked at pos 4..7
CASES = {"qwen3": ("qwen3-0.6b", {}), "qwen3_kv1": ("qwen3-0.6b", {"n_kv_heads": 1}),
         "minicpm3": ("minicpm3-4b", {})}
#: which cases' caches are split over their rows on 'model'
ROWS_SPLIT = {"qwen3": False, "qwen3_kv1": True, "minicpm3": True}
MESHES = ["1x2", "2x2"]


@pytest.fixture(scope="module")
def cases(ctx11):
    """Each case carried from the JAX package (seed 0, a [2, PROMPT + STEPS]
    batch from seed 1), the JAX package's prefill and decode steps on it,
    and the port's one-process steps, as numpy."""
    from repro.models import model as jax_model

    out = {}
    for name, (arch, replace) in CASES.items():
        c = carry(arch, seq=PROMPT + STEPS, **replace)
        toks = jnp.asarray(c.batch["tokens"])
        with ctx11.mesh:
            jlast, jcache = jax_model.prefill_step(c.jcfg, ctx11, c.jparams, toks[:, :PROMPT],
                                                   cache_len=CACHE_LEN)
            jlogits = []
            for j in range(STEPS):
                logits, jcache = jax_model.decode_step(c.jcfg, ctx11, c.jparams, jcache,
                                                       toks[:, PROMPT + j:PROMPT + j + 1],
                                                       PROMPT + j)
                jlogits.append(np.asarray(logits))
        tokens = torch.tensor(c.batch["tokens"])
        last, cache = model.prefill_step(c.cfg, c.params, tokens[:, :PROMPT],
                                         cache_len=CACHE_LEN)
        prefill_cache = [t.clone().numpy() for t in tree_leaves(cache)]
        logits = []
        for j in range(STEPS):
            step, cache = model.decode_step(c.cfg, c.params, cache,
                                            tokens[:, PROMPT + j:PROMPT + j + 1], PROMPT + j)
            logits.append(step.numpy())
        out[name] = {
            "arch": arch,
            "rank_kw": dict(arch=arch, replace=replace,
                            params=jax.tree.map(np.asarray, c.jparams),
                            tokens=np.asarray(c.batch["tokens"]).astype(np.int64),
                            prompt=PROMPT, cache_len=CACHE_LEN, steps=STEPS),
            "jax": {"prefill": np.asarray(jlast), "decode": jlogits,
                    "cache": [np.asarray(t) for t in jax.tree.leaves(jcache)]},
            "one": {"prefill": last.numpy(), "prefill_cache": prefill_cache, "decode": logits,
                    "cache": [t.numpy() for t in tree_leaves(cache)]}}
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, cases):
    kw = {name: c["rank_kw"] for name, c in cases.items()}
    two = run_ranks(2, "decode_mesh_suite", tmp_path_factory.mktemp("decode_two"),
                    timeout_s=300.0, meshes=[(1, 2)], cases=kw)
    four = run_ranks(4, "decode_mesh_suite", tmp_path_factory.mktemp("decode_four"),
                     timeout_s=300.0, meshes=[(2, 2)], cases=kw)
    return {"1x2": two, "2x2": four}


def _runs(worlds, mesh, name):
    return [run[mesh][name] for run in worlds[mesh]]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(CASES))
def test_init_cache_is_placed_as_cache_decl_says(worlds, cases, mesh, name):
    for run in _runs(worlds, mesh, name):
        assert run["init"] and run["prefill"]["as_declared"]
        for shape, local, placements, as_declared, nonzero in run["init"]:
            assert as_declared and not nonzero, (shape, placements)
        assert all(run["prefill"]["as_declared"])
        # a stacked [layers, B, S, ...] leaf's rows are dim 2; 'model' the mesh's last axis
        split = any(p.endswith("Shard(dim=2))") for p in run["prefill"]["placements"])
        assert split == ROWS_SPLIT[name], run["prefill"]["placements"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_on_the_mesh_match_one_process_and_jax(worlds, cases, mesh, name):
    case = cases[name]
    tol = LOGITS_RTOL[case["arch"]]
    for rank, run in enumerate(_runs(worlds, mesh, name)):
        errs = {"prefill_vs_one": rel(run["prefill"]["logits"], case["one"]["prefill"]),
                "prefill_vs_jax": rel(run["prefill"]["logits"], case["jax"]["prefill"]),
                "prefill_cache": max(rel(g, w) for g, w in zip(run["prefill"]["cache"],
                                                              case["one"]["prefill_cache"])),
                "decode_vs_one": max(rel(g, w) for g, w in zip(run["decode"]["logits"],
                                                              case["one"]["decode"])),
                "decode_vs_jax": max(rel(g, w) for g, w in zip(run["decode"]["logits"],
                                                              case["jax"]["decode"])),
                "cache_vs_one": max(rel(g, w) for g, w in zip(run["decode"]["cache"],
                                                             case["one"]["cache"])),
                "cache_vs_jax": max(rel(g, w) for g, w in zip(run["decode"]["cache"],
                                                             case["jax"]["cache"]))}
        print(f"{name} on {mesh}, rank {rank}: " + ", ".join(f"{k} {v:.3g}"
                                                             for k, v in errs.items()))
        assert all(np.isfinite(l).all() for l in run["decode"]["logits"])
        assert max(errs.values()) < tol, (errs, tol)


@pytest.mark.parametrize("name", [n for n, split in ROWS_SPLIT.items() if split])
def test_rows_split_decode_issues_no_all_gather(worlds, name):
    for run in _runs(worlds, "1x2", name):
        assert run["decode"]["all_gathers"] == [0] * STEPS
        assert run["decode"]["control"] >= STEPS  # the count sees the logits' gathers


def test_a_rank_with_every_row_masked_gives_finite_right_output(worlds, cases):
    """On (1, 2) the second rank holds rows 8..15: at pos 4..7 none is <=
    pos, and those steps' logits are finite and within the bounds."""
    assert CACHE_LEN // 2 > PROMPT
    for name in ("qwen3_kv1", "minicpm3"):
        tol = LOGITS_RTOL[cases[name]["arch"]]
        for run in _runs(worlds, "1x2", name):
            for j in range(CACHE_LEN // 2 - PROMPT):
                got = run["decode"]["logits"][j]
                assert np.isfinite(got).all()
                assert rel(got, cases[name]["one"]["decode"][j]) < tol


def test_init_cache_on_a_mesh_refuses_another_device():
    from _torch_mesh import one_rank_mesh

    cfg = carry("qwen3-0.6b", seq=8).cfg
    with one_rank_mesh() as ctx:
        with pytest.raises(ValueError, match="the mesh is on cpu"):
            transformer.init_cache(cfg, 2, 8, device="meta", ctx=ctx)
