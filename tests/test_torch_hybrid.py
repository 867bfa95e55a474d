"""PyTorch port: the hybrid family (zamba2-1.2b: a Mamba-2 backbone with ONE
shared attention block applied every `hybrid_period` layers) against the
JAX package, with the weights carried across: the forward's logits and
prefill caches (``{"ssm": [n, p-1, ...], "attn": [n, ...]}`` per hybrid
group), `eval_nll`, `LMUQModel` and a level-2 grid through the fabric, on
both paths (`"kernel"`: the SSD and flash kernels, on the CPU their plain
versions; `"plain"`: `ssd_scan` and `_grouped_attention`). Bounds:
`_torch_zoo`.
"""
import numpy as np
import pytest

from _torch_zoo import (
    IMPLS,
    NLL_RTOL,
    THETAS,
    assert_carried,
    assert_forward_matches,
    carry,
    jax_grid,
    jax_lm_model,
    jax_outputs,
    port_grid,
    port_lm_model,
    port_outputs,
)
from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd
from repro_torch.models import attention, model, transformer

ARCH = "zamba2-1.2b"


def test_full_parameter_count():
    cfg = get_config(ARCH)
    assert model.n_params(cfg) == 1_020_100_608
    assert model.n_params(cfg) == jax_model.n_params(jax_get_config(ARCH))
    # 38 layers of period 6: 2 ssm units, then 6 x (5 ssm units + the
    # shared block): 32 SSD scans and 6 attentions a forward
    assert [(g.kind, g.count) for g in transformer.make_groups(cfg)] == [("ssm", 2),
                                                                       ("hybrid", 6)]


@pytest.fixture(scope="module")
def carried():
    return carry(ARCH)


@pytest.fixture(scope="module")
def jax_out(carried, ctx11):
    return jax_outputs(carried, ctx11)


def test_carried_weights_keep_values_and_dtypes(carried):
    # embedding, head, final norm; an ssm unit (norm + 8) in the ssm group
    # and, stacked [n, p-1], in the hybrid group; the shared dense unit
    assert_carried(carried, 3 + 9 + 9 + 9)
    assert tuple(carried.params["groups"][1]["ssm"]["ssm"]["in_proj"].shape)[:2] == (2, 2)
    assert tuple(carried.params["shared"]["attn"]["wq"].shape) == (128, 4, 32)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_forward_matches_jax(carried, jax_out, monkeypatch, impl):
    shared = []
    real = attention.gqa_full

    def recording(cfg, params, x, **kw):
        shared.append(params is carried.params["shared"]["attn"])
        return real(cfg, params, x, **kw)

    monkeypatch.setattr(attention, "gqa_full", recording)
    before = (flash_attention.launches, ssd.launches)
    got = port_outputs(carried, impl)
    assert (flash_attention.launches, ssd.launches) == before  # plain versions on the CPU
    assert_forward_matches(got, jax_out, ARCH, impl)
    # every attention of the 3 forwards ran the one shared block: 2 hybrid
    # units each
    assert shared == [True] * 6
    ssm_cache, attn_cache = got["caches"][1]["ssm"], got["caches"][1]["attn"]
    assert tuple(ssm_cache["state"].shape) == (2, 2, 2, 1, 8, 16, 32)  # [n, p-1, B, g, r, N, P]
    assert tuple(attn_cache["k"].shape) == (2, 2, 160, 4, 32)  # [n, B, cache_len, nkv, hd]


@pytest.fixture(scope="module")
def jm(carried):
    return jax_lm_model(carried)


@pytest.fixture(scope="module", params=list(IMPLS))
def pm(request, carried, jm):
    return port_lm_model(carried, jm, request.param)


@pytest.fixture(scope="module")
def jax_grid_values(jm):
    return jax_grid(jm)


def test_lm_uq_nll_matches_jax(pm, jm):
    want = np.array([jm([list(t)])[0][0] for t in THETAS])
    got = np.array([pm([list(t)])[0][0] for t in THETAS])
    print(f"{pm.cfg.attn_impl}: NLL {got}, rel err {np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_sparse_grid_through_the_fabric_matches_jax(pm, jax_grid_values):
    jSr, want = jax_grid_values
    got, backend = port_grid(pm, jSr)
    assert backend["native_batches"] == 1 and backend["padded"] == 0
    print(f"{pm.cfg.attn_impl}: {len(jSr.points)} points, rel err "
          f"{np.abs(got / want - 1).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
