"""PyTorch port: the serving steps (`models.model.prefill_step`,
`decode_step`; `transformer.forward(mode="decode")`, `cache_decl`,
`init_cache`) of the dense and audio configs and of mamba2 against the JAX
package, with the weights carried across, reduced, in float32 (the MoE,
hybrid, MLA and vlm configs are in `test_torch_decode_zoo.py`; the shared
checks and their bounds in `_torch_decode.py`). Also the decode arguments
of `_grouped_attention` and the decode mode's argument checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode import (
    IMPLS,
    S,
    check_cache_decl_matches_jax,
    check_decode_step_matches_jax,
    check_decode_writes_in_place,
    check_prefill_step_matches_jax,
    check_steps_match_the_full_forward,
    served,  # noqa: F401  (the module-scoped fixture, parametrised by arch)
)
from _torch_zoo import rel
from repro.models import attention as jax_attention
from repro_torch.models import attention, model, transformer

ARCHS = ["qwen3-0.6b", "command-r-35b", "command-r-plus-104b", "musicgen-medium",
         "mamba2-1.3b"]

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


@pytest.mark.parametrize("causal,q_offset,kv_len", [(False, 0, 20), (True, 12, None),
                                                    (True, 12, 30), (False, 0, None)])
def test_grouped_attention_decode_arguments_match_jax(causal, q_offset, kv_len):
    """`q_offset` shifts the causal rows; `kv_len` limits the keys to a
    prefix (the JAX package masks the rest, the port reads the prefix
    only): 4 query rows against 32 keys, GQA 4:2, q chunks of 2."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    kw = dict(scale=0.25, causal=causal, q_offset=q_offset, kv_len=kv_len, q_chunk=2)
    want = jax_attention._grouped_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention._grouped_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    print(f"causal {causal}, q_offset {q_offset}, kv_len {kv_len}: {rel(got, want):.3g}")
    assert rel(got, want) < 1e-6


def test_decode_raises_for_what_the_jax_decode_has_not():
    """The JAX package's decode has no embedding scale and no points; a
    decode forward without a cache or a position is an error too."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-0.6b", reduced=True)
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    cache = transformer.init_cache(cfg, 2, 8, device="cpu")
    tok = torch.zeros(2, 1, dtype=torch.long)
    for bad in (dict(embed_scale=torch.ones(2)), dict(points=2)):
        with pytest.raises(ValueError, match="neither embed_scale nor points"):
            transformer.forward(cfg, params, tok, mode="decode", cache=cache, pos=3, **bad)
    with pytest.raises(ValueError, match="needs the cache and pos"):
        transformer.forward(cfg, params, tok, mode="decode", cache=cache)
    with pytest.raises(ValueError, match="mode must be"):
        transformer.forward(cfg, params, tok, mode="serve")
    # a zero cache of init_cache serves too: position 0 attends to itself
    logits, out = model.decode_step(cfg, params, cache, tok, 0)
    assert out is cache and logits.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(logits).all() and cache[0]["attn"]["k"][:, :, 0].abs().sum() > 0
