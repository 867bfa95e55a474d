"""Shared parts of the serving-step parity tests (`test_torch_decode.py`:
the dense and audio configs and mamba2; `test_torch_decode_zoo.py`: moe,
hybrid, MLA and vlm): the reduced float32 config of an architecture in both
packages with the JAX package's weights carried across
(`_torch_zoo.carry`), the JAX package's own prefill cache and decode step
on it, and the checks each file runs over its architectures.

Bounds (relative: max error over max value; measured values print with -s):

* against the JAX package (the decode step from the JAX package's own
  cache, the prefill step): `_torch_zoo.LOGITS_RTOL[arch]`, 1e-5 for the
  well-conditioned configs, 1e-3 for the random reduced non-qk-norm ones
  (`_torch_zoo.py` says why);
* four decode steps after a prefill against the port's own full forward
  at the same positions: the JAX package's bound for the same check,
  2e-2 of the largest logit (`tests/test_smoke_archs.py:58`). A MoE runs
  all of it with capacity_factor = n_experts / top_k, so that the full
  forward drops no pair, as a decode step of B <= 8 tokens never does
  (`moe.capacity_of`'s floor of 8 slots).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import LOGITS_RTOL, carry, rel
from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_config
from repro_torch.models import model, transformer
from repro_torch.models.params import walk

S = 32  # prompt length
STEPS = 4  # decode steps after it
CACHE_LEN = S + STEPS
FORWARD_RTOL = 2e-2  # tests/test_smoke_archs.py:58
#: (port attn_impl) of the prefill: on the CPU the kernel path runs the
#: kernels' plain versions; both are held to the JAX package's XLA path
IMPLS = ["kernel", "plain"]


def no_drop(cfg):
    """`cfg` at a capacity at which no MoE pair is dropped."""
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k) if cfg.n_experts else cfg


def to_torch(tree):
    """A numpy tree (the JAX package's cache) as writable torch tensors."""
    return jax.tree.map(lambda a: torch.tensor(np.array(a)), tree)


@dataclass
class Served:
    """`carry(arch)` over S + STEPS tokens, and the JAX package's serving
    steps on it, as numpy: its prefill of the first S tokens at CACHE_LEN
    (last logits, cache) and one decode step of token S from that cache."""
    carried: object
    prefill_logits: np.ndarray
    prefill_cache: list
    decode_logits: np.ndarray
    decode_cache: list

    def tokens(self):
        return torch.tensor(self.carried.batch["tokens"])


@pytest.fixture(scope="module")
def served(request, ctx11) -> Served:
    c = carry(request.param, seq=S + STEPS)
    toks = jnp.asarray(c.batch["tokens"])
    ce = jnp.asarray(c.batch["ctx_embed"]) if "ctx_embed" in c.batch else None
    with ctx11.mesh:
        last, cache = jax_model.prefill_step(c.jcfg, ctx11, c.jparams, toks[:, :S], ctx_embed=ce,
                                             cache_len=CACHE_LEN)
        cache = jax.tree.map(np.asarray, cache)  # before decode: the JAX step's input
        logits, new_cache = jax_model.decode_step(c.jcfg, ctx11, c.jparams, cache,
                                                  toks[:, S:S + 1], S)
    return Served(c, np.asarray(last), cache, np.asarray(logits),
                  jax.tree.map(np.asarray, new_cache))


def leaves(tree) -> list:
    """(path, leaf) of a cache tree of either package, in one order."""
    return jax.tree_util.tree_leaves_with_path(tree)


def tree_err(got, want) -> float:
    """The largest relative error over the leaves of two caches of equal
    structure and shapes."""
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    err = 0.0
    for (path, t), (_, j) in zip(g, w):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name, path
        err = max(err, rel(t, j))
    return err


def check_decode_step_matches_jax(s: Served) -> None:
    """One port decode step from the JAX package's own prefill cache: its
    logits and every updated cache leaf against the JAX package's step."""
    c = s.carried
    cache = to_torch(s.prefill_cache)
    logits, out = model.decode_step(c.cfg, c.params, cache, s.tokens()[:, S:S + 1], S)
    tol = LOGITS_RTOL[c.arch]
    err, cache_err = rel(logits, s.decode_logits), tree_err(out, s.decode_cache)
    print(f"{c.arch} decode step vs JAX: logits {err:.3g}, caches {cache_err:.3g} (bound {tol})")
    assert logits.shape == s.decode_logits.shape == (2, c.cfg.padded_vocab)
    assert err < tol and cache_err < tol


def check_prefill_step_matches_jax(s: Served, impl: str) -> None:
    """`prefill_step`'s last logits and caches (padded past S) against the
    JAX package's."""
    c = s.carried
    last, cache = model.prefill_step(c.cfg.replace(attn_impl=impl), c.params,
                                     s.tokens()[:, :S], ctx_embed=c.ctx_embed(),
                                     cache_len=CACHE_LEN)
    tol = LOGITS_RTOL[c.arch]
    err, cache_err = rel(last, s.prefill_logits), tree_err(cache, s.prefill_cache)
    print(f"{c.arch} prefill ({impl}) vs JAX: last logits {err:.3g}, caches {cache_err:.3g} "
          f"(bound {tol})")
    assert err < tol and cache_err < tol


def check_steps_match_the_full_forward(s: Served) -> None:
    """decode(prefill(x[:S]), x[S:S+STEPS]) against the port's own full
    forward over x[:S+STEPS] at positions S..S+STEPS-1 (a MoE at no-drop
    capacity throughout)."""
    c = s.carried
    cfg, toks = no_drop(c.cfg), s.tokens()
    full, _, _ = transformer.forward(cfg, c.params, toks, ctx_embed=c.ctx_embed())
    _, cache = model.prefill_step(cfg, c.params, toks[:, :S], ctx_embed=c.ctx_embed(),
                                  cache_len=CACHE_LEN)
    errs = []
    for j in range(STEPS):
        logits, cache = model.decode_step(cfg, c.params, cache, toks[:, S + j:S + j + 1], S + j)
        errs.append(rel(logits, full[:, S + j]))
    print(f"{c.arch} {STEPS} decode steps vs the full forward: "
          f"{', '.join(f'{e:.3g}' for e in errs)} (bound {FORWARD_RTOL})")
    assert max(errs) < FORWARD_RTOL


def check_cache_decl_matches_jax(arch: str, ctx11, B: int = 4, seq: int = 4096) -> None:
    """`cache_decl`'s tree, shapes and dtypes at full size equal the JAX
    package's abstract cache; nothing is allocated."""
    got = transformer.cache_decl(get_config(arch), B, seq)
    want, _ = jax_transformer.cache_decl(jax_get_config(arch), B, seq, ctx11)
    g = leaves(got)
    w = leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, d), (_, j) in zip(g, w):
        assert isinstance(d, transformer.CacheDecl), path
        assert d.shape == j.shape, path
        assert str(d.dtype).removeprefix("torch.") == np.dtype(j.dtype).name, path
    # init_cache allocates what cache_decl declares (at the reduced size)
    cfg = get_config(arch, reduced=True)
    zeros = transformer.init_cache(cfg, 2, 8, device="cpu")
    for (path, t), (_, d) in zip(leaves(zeros), leaves(transformer.cache_decl(cfg, 2, 8))):
        assert tuple(t.shape) == d.shape and t.dtype == d.dtype and not t.any(), path


def _seq_axis(path: str) -> int | None:
    """The row axis of a cache leaf, by its path in the tree: attention
    caches carry one stacked dim (a vlm group's self-attention two) before
    [B, S, ...]; the SSM and cross caches have no row axis."""
    if "/ssm/" in path or "/cross/" in path:
        return None
    return 3 if "/self/" in path else 2


def check_decode_writes_in_place(s: Served) -> None:
    """A decode step writes its rows into the caller's cache: the same tree
    of the same tensors comes back; every attention cache has row `pos`
    written and the rows before it and after it untouched; every SSM window
    and state moved on; the cross caches untouched."""
    c = s.carried
    _, cache = model.prefill_step(c.cfg, c.params, s.tokens()[:, :S], ctx_embed=c.ctx_embed(),
                                  cache_len=CACHE_LEN)
    before = walk(cache, lambda t, _p: t.clone())
    ptrs = walk(cache, lambda t, _p: t.data_ptr())
    _, out = model.decode_step(c.cfg, c.params, cache, s.tokens()[:, S:S + 1], S)
    assert out is cache
    assert walk(out, lambda t, _p: t.data_ptr()) == ptrs
    checked = []

    def check(t, path):
        old = _get(before, path)
        ax = _seq_axis(path)
        if ax is None:
            moved = not torch.equal(t, old)
            assert moved == ("/ssm/" in path), path
        else:
            row = [slice(None)] * t.dim()
            row[ax] = S
            assert torch.equal(t.narrow(ax, 0, S), old.narrow(ax, 0, S)), path
            assert torch.equal(t.narrow(ax, S + 1, CACHE_LEN - S - 1),
                               old.narrow(ax, S + 1, CACHE_LEN - S - 1)), path
            assert not old[tuple(row)].any() and t[tuple(row)].abs().min() > 0, path
        checked.append(path)

    walk(out, check)
    assert checked


def _get(tree, path: str):
    for key in path.strip("/").split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree
