"""PyTorch port: the serving steps of the LM zoo's moe (deepseek-moe-16b,
kimi-k2), hybrid (zamba2-1.2b), MLA (minicpm3-4b: the absorbed decode over
the latent cache) and vlm (llama-3.2-vision-90b: the cached cross
attention) configs against the JAX package, reduced, in float32 (the
checks and bounds in `_torch_decode.py`); and a MoE layer at a decode
step's size, which never drops a pair."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode import (
    IMPLS,
    check_cache_decl_matches_jax,
    check_decode_step_matches_jax,
    check_decode_writes_in_place,
    check_prefill_step_matches_jax,
    check_steps_match_the_full_forward,
    served,  # noqa: F401  (the module-scoped fixture, parametrised by arch)
)
from _torch_zoo import LOGITS_RTOL, carry, rel
from repro.models import moe as jax_moe
from repro_torch.models import moe

ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b", "zamba2-1.2b", "minicpm3-4b",
         "llama-3.2-vision-90b"]

torch.set_num_threads(1)


@pytest.mark.parametrize("served", ARCHS, indirect=True)
def test_decode_step_matches_jax_from_its_cache(served):
    check_decode_step_matches_jax(served)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("served", ARCHS, indirect=True)
def test_prefill_step_matches_jax(served, impl):
    check_prefill_step_matches_jax(served, impl)


@pytest.mark.parametrize("served", ARCHS, indirect=True)
def test_decode_steps_match_the_full_forward(served):
    check_steps_match_the_full_forward(served)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_decl_matches_jax(arch, ctx11):
    check_cache_decl_matches_jax(arch, ctx11)


@pytest.mark.parametrize("served", ARCHS, indirect=True)
def test_decode_writes_the_cache_in_place(served):
    check_decode_writes_in_place(served)


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_moe_at_a_decode_step_drops_no_pair(arch, B, mesh11):
    """A decode step sends ``[B, 1, d]`` through `moe_block`: capacity_of
    B tokens is the floor of 8 slots, and an expert takes at most one pair
    of a token, so at B <= 8 no pair is dropped; the output equals the JAX
    package's `moe_block` on the same layer (T_loc = B)."""
    c = carry(arch, seq=4)
    jp = jax.tree.map(lambda a: a[0], c.jparams["groups"][1]["moe"])  # the first MoE layer
    p = {k: (jax.tree.map(lambda t: t[0], v) if isinstance(v, dict) else v[0])
         for k, v in c.params["groups"][1]["moe"].items()}
    x = np.random.default_rng(B).standard_normal((B, 1, c.cfg.d_model)).astype(np.float32)
    assert moe.capacity_of(c.cfg, B) == 8
    _, idx, _ = moe.router_topk(c.cfg, p, torch.from_numpy(x))
    _, pos = moe.dispatch(idx.reshape(B, -1), c.cfg.n_experts, 1, 8)
    assert (pos >= 0).all()
    got, aux = moe.moe_block(c.cfg, p, torch.from_numpy(x))
    with mesh11:
        want, jaux = jax_moe.moe_block(c.jcfg, jp, jnp.asarray(x), mesh11)
    print(f"{arch} moe at B = {B}: {rel(got, want):.3g}")
    assert rel(got, want) < LOGITS_RTOL[arch]
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
