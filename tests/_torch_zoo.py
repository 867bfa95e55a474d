"""Shared helpers of the parity tests of the LM zoo's families beyond dense
and ssm (`test_torch_{moe,hybrid,mla,vlm}.py`): the reduced float32 config
of an architecture in both packages, with the JAX package's weights
carried across (`convert.lm_params_from_numpy`), the forward's logits, aux,
prefill caches and NLL in both, and the UM-Bridge model of both on the same
weights and batch.

Bounds (relative: max error over max value; measured values print with -s):

* NLL: 1e-5, as for qwen3-0.6b and mamba2-1.3b; measured <= 1.2e-6.
* Logits and caches: `LOGITS_RTOL[arch]`. These random reduced models
  have no qk-norm in their attention (minicpm3-4b's MLA normalises its
  latents), and their float32 forwards are far less well conditioned than
  qwen3-0.6b's: at seq 128 the port's own float32 logits differ from the
  same forward run in float64 by 3.6e-5 (llama-3.2-vision-90b), 1.2e-4
  (deepseek-moe-16b), 2.7e-4 (zamba2-1.2b) and 5.8e-4 (kimi-k2-1t-a32b),
  where qwen3-0.6b's differ by 6e-7; and the JAX package's deepseek caches
  sit as far from that float64 forward as the port's. Two float32
  implementations that sum in another order therefore differ by about that
  much on these models, whatever they do: measured against the JAX package
  8.1e-5 (llama), 7.5e-5 (deepseek), 1.8e-4 (kimi), 2.7e-4 (zamba2) on the
  logits, <= 8.3e-5 on the caches. 1e-3 is 3.7x the largest; minicpm3-4b keeps 1e-5
  (measured 4.2e-6). A wrong scale, mask, layer or route moves them by
  O(1).
* The serving steps (`_torch_decode.py`) hold the other five configs to
  1e-5 (measured <= 3.6e-6), except command-r (35b and plus-104b share
  the reduced config): no qk-norm either, and at the serving tests' 32
  prompt tokens its float32 logits sit 1.6e-5 (the port) and 3.7e-5 (the
  JAX package) from the same forward in float64, 2.1e-5 to 2.6e-5 from
  each other. 1e-4 is 2.7x the JAX package's distance from float64.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.lm_model as jax_lm
from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models import transformer as jax_transformer
from repro.uq import sparse_grid as jax_sg
from repro_torch.apps.lm_model import LMUQModel
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.fabric import EvaluationFabric, ModelBackend
from repro_torch.models import model, transformer
from repro_torch.uq import sparse_grid as sg

SEQ = 128  # above the reduced configs' q_chunk of 64: the chunked plain path runs
CACHE_LEN = SEQ + 32
NLL_RTOL = 1e-5
LOGITS_RTOL = {"deepseek-moe-16b": 1e-3, "kimi-k2-1t-a32b": 1e-3, "zamba2-1.2b": 1e-3,
               "llama-3.2-vision-90b": 1e-3, "minicpm3-4b": 1e-5,
               "qwen3-0.6b": 1e-5, "command-r-35b": 1e-4, "command-r-plus-104b": 1e-4,
               "musicgen-medium": 1e-5, "mamba2-1.3b": 1e-5}
#: port attn_impl -> the JAX package's (its "pallas" reaches the SSD kernel
#: only, in interpret mode; its attention has one path)
IMPLS = {"kernel": "pallas", "plain": "xla"}
THETAS = np.array([[1.0, 1.0], [0.8, 1.2], [1.25, 0.75]])


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@dataclass
class Carried:
    arch: str
    jcfg: object
    jparams: dict
    batch: dict  # numpy
    cfg: object
    params: dict

    def torch_batch(self) -> dict:
        return {k: torch.tensor(v) for k, v in self.batch.items()}

    def ctx_embed(self):
        return torch.tensor(self.batch["ctx_embed"]) if "ctx_embed" in self.batch else None


def carry(arch: str, seq: int = SEQ, B: int = 2, **replace) -> Carried:
    """The JAX package's reduced `arch` (fields `replace`d in both packages)
    from seed 0, its synthetic [B, seq] batch from seed 1, and the same
    weights in the port."""
    jcfg = jax_get_config(arch, reduced=True).replace(**replace)
    jparams = jax_model.init_params(jcfg, jax.random.key(0))
    batch = jax.tree.map(np.asarray, jax_model.make_synth_batch(jcfg, B, seq, jax.random.key(1)))
    cfg = get_config(arch, reduced=True).replace(**replace)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return Carried(arch, jcfg, jparams, batch, cfg, params)


def assert_carried(c: Carried, n_leaves: int) -> None:
    """Every leaf carried across with its value, in float32."""
    jleaves, leaves = jax.tree.leaves(c.jparams), jax.tree.leaves(c.params)
    assert len(leaves) == len(jleaves) == n_leaves
    for t, j in zip(leaves, jleaves):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def jax_outputs(c: Carried, ctx11, jimpl: str = "xla") -> dict:
    """The JAX forward's logits and aux, its prefill caches at CACHE_LEN and
    eval_nll, as numpy."""
    jcfg = c.jcfg.replace(attn_impl=jimpl)
    tokens = jnp.asarray(c.batch["tokens"])
    ce = jnp.asarray(c.batch["ctx_embed"]) if "ctx_embed" in c.batch else None
    with ctx11.mesh:
        logits, _, aux = jax_transformer.forward(jcfg, ctx11, c.jparams, tokens, ctx_embed=ce)
        _, caches, _ = jax_transformer.forward(jcfg, ctx11, c.jparams, tokens, ctx_embed=ce,
                                               mode="prefill", cache_len=CACHE_LEN)
        nll = jax_model.eval_nll(jcfg, ctx11, c.jparams,
                                 {k: jnp.asarray(v) for k, v in c.batch.items()})
    return jax.tree.map(np.asarray, {"logits": logits, "aux": aux, "caches": caches,
                                     "nll": nll})


def port_outputs(c: Carried, impl: str) -> dict:
    cfg = c.cfg.replace(attn_impl=impl)
    tokens = torch.tensor(c.batch["tokens"])
    logits, _, aux = transformer.forward(cfg, c.params, tokens, ctx_embed=c.ctx_embed())
    _, caches, _ = transformer.forward(cfg, c.params, tokens, ctx_embed=c.ctx_embed(),
                                       mode="prefill", cache_len=CACHE_LEN)
    nll = model.eval_nll(cfg, c.params, c.torch_batch())
    return {"logits": logits, "aux": aux, "caches": caches, "nll": nll}


def assert_forward_matches(got: dict, want: dict, arch: str, what: str) -> None:
    """Logits and every prefill cache leaf within LOGITS_RTOL[arch], the
    trees of equal structure and shapes; aux and NLL within NLL_RTOL."""
    tol = LOGITS_RTOL[arch]
    err = rel(got["logits"], want["logits"])
    assert got["logits"].shape == want["logits"].shape
    leaves = jax.tree_util.tree_leaves_with_path(got["caches"])
    jleaves = jax.tree_util.tree_leaves_with_path(want["caches"])
    assert [p for p, _ in leaves] == [p for p, _ in jleaves]
    cache_err = 0.0
    for (path, t), (_, j) in zip(leaves, jleaves):
        assert tuple(t.shape) == j.shape, path
        cache_err = max(cache_err, rel(t, j))
    nll_err = float(np.abs(got["nll"].numpy() / want["nll"] - 1).max())
    print(f"{arch} {what}: logits {err:.3g}, caches {cache_err:.3g} (bound {tol}), "
          f"nll {nll_err:.3g}, aux {float(got['aux'])} vs {float(want['aux'])}")
    assert err < tol and cache_err < tol
    assert nll_err < NLL_RTOL
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]), rtol=NLL_RTOL)


def jax_lm_model(c: Carried, seq: int = SEQ, **replace):
    """The JAX package's LMUQModel of `c.arch` (fields `replace`d), whose
    weights (seed 0) are `c`'s."""
    with pytest.MonkeyPatch.context() as mp:
        # the JAX wrapper reads its config through get_config
        mp.setattr(jax_lm, "get_config",
                   lambda arch, reduced: jax_get_config(arch, reduced).replace(**replace))
        jm = jax_lm.LMUQModel(c.arch, reduced=True, batch=2, seq=seq)
    for t, j in zip(jax.tree.leaves(c.params), jax.tree.leaves(jm.params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return jm


def port_lm_model(c: Carried, jm, impl: str) -> LMUQModel:
    """The port's LMUQModel on `impl` with `c`'s weights and `jm`'s batch
    (the JAX package's, from seed 1)."""
    pm = LMUQModel(c.arch, reduced=True, device="cpu", params=c.params,
                   batch=jax.tree.map(np.asarray, jm.batch))
    pm.cfg = c.cfg.replace(attn_impl=impl)
    return pm


def jax_grid(jm):
    """(reduced grid, the JAX package's level-2 grid values by its model)."""
    Sr = jax_sg.reduce_sparse_grid(
        jax_sg.smolyak_grid(2, 2, [jax_sg.knots_uniform_leja(0.7, 1.3)] * 2))
    return Sr, jax_sg.evaluate_on_sparse_grid(jm, Sr)


def port_grid(pm, jSr):
    """The port's level-2 grid through `EvaluationFabric(ModelBackend(pm))`:
    (values, backend telemetry)."""
    Sr = sg.reduce_sparse_grid(sg.smolyak_grid(2, 2, [sg.knots_uniform_leja(0.7, 1.3)] * 2))
    np.testing.assert_array_equal(Sr.points, jSr.points)
    fabric = EvaluationFabric(ModelBackend(pm))
    try:
        got = sg.evaluate_on_sparse_grid(fabric, Sr)
        backend = fabric.telemetry()["backend"]
    finally:
        fabric.shutdown()
    return got, backend
