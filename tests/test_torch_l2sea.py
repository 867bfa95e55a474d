"""PyTorch port: the L2-Sea analogue (paper §4.1, `apps/l2sea.py`) against
the JAX package's — `resistance` and all eight operations of `L2SeaModel`
at fidelity 1 and 7 within `TOL32` — plus tests/test_apps.py's four L2-Sea
tests re-pointed, the cost model (one sleep a wave) and the device rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.l2sea as jax_l2sea
from repro_torch.apps.l2sea import (
    DRAFT_RANGE,
    FROUDE_RANGE,
    L2SeaModel,
    make_inputs,
    resistance,
)
from repro_torch.core.interface import Capabilities

torch.set_num_threads(1)

#: float32 bound against the JAX package on the same function
#: (tests/test_torch_torchmodel.py's TOL32); measured <= 4.3e-7 of the
#: largest entry on these inputs
TOL32 = dict(rtol=1e-5, atol=1e-6)

_RNG = np.random.default_rng(5)
X = make_inputs(np.stack([_RNG.uniform(*FROUDE_RANGE, 6), _RNG.uniform(*DRAFT_RANGE, 6)], 1))
X[:, 2:] = 0.1 * _RNG.standard_normal((6, 14))  # active shape parameters too
S = _RNG.standard_normal((6, 1))
V = _RNG.standard_normal((6, 16))

OPS = {
    "evaluate_batch": lambda m, c: m.evaluate_batch(X, c),
    "gradient_batch": lambda m, c: m.gradient_batch(X, S, c),
    "apply_jacobian_batch": lambda m, c: m.apply_jacobian_batch(X, V, c),
    "apply_hessian_batch": lambda m, c: m.apply_hessian_batch(X, S, V, c),
    "__call__": lambda m, c: m([list(X[0])], c)[0],
    "gradient": lambda m, c: m.gradient(0, 0, [list(X[0])], list(S[0]), c),
    "apply_jacobian": lambda m, c: m.apply_jacobian(0, 0, [list(X[0])], list(V[0]), c),
    "apply_hessian": lambda m, c: m.apply_hessian(0, 0, 0, [list(X[0])], list(S[0]),
                                                  list(V[0]), c),
}


@pytest.fixture(scope="module")
def l2sea():
    return L2SeaModel(device="cpu")


@pytest.mark.parametrize("fidelity", [1, 7])
def test_resistance_matches_jax(fidelity):
    got = torch.stack([resistance(torch.as_tensor(x, dtype=torch.float32), fidelity)
                       for x in X]).numpy()
    want = np.stack([np.asarray(jax_l2sea.resistance(jnp.asarray(x, jnp.float32), fidelity))
                     for x in X])
    assert got.shape == want.shape == (6, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL32)


@pytest.mark.parametrize("fidelity", [1, 7])
@pytest.mark.parametrize("op", sorted(OPS))
def test_every_operation_matches_jax(l2sea, op, fidelity):
    c = {"fidelity": fidelity}
    got = np.asarray(OPS[op](l2sea, c), float)
    want = np.asarray(OPS[op](jax_l2sea.L2SeaModel(), c), float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL32)


def test_capabilities_and_default_fidelity(l2sea):
    assert l2sea.capabilities() == Capabilities(**{op: True for op in Capabilities.OPS},
                                                **{f"{op}_batch": True
                                                   for op in Capabilities.OPS})
    assert l2sea.capabilities().to_json() == jax_l2sea.L2SeaModel().capabilities().to_json()
    np.testing.assert_array_equal(l2sea.evaluate_batch(X), l2sea.evaluate_batch(X, {"fidelity": 7}))


def test_one_sleep_per_wave(monkeypatch):
    import repro_torch.apps.l2sea as l2sea_mod

    sleeps = []
    monkeypatch.setattr(l2sea_mod.time, "sleep", sleeps.append)
    m = L2SeaModel(eval_cost_s=0.25, device="cpu")
    m.evaluate_batch(X)
    m.gradient_batch(X, S)
    m.apply_jacobian_batch(X, V)
    m([list(X[0])])
    assert sleeps == [0.25] * 4
    assert L2SeaModel(device="cpu").eval_cost_s == 0.0


def test_default_device_is_the_gpu_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L2SeaModel()


# -- re-pointed: tests/test_apps.py --------------------------------------------


def test_l2sea_interface(l2sea):
    assert l2sea.get_input_sizes() == [16]
    assert l2sea.get_output_sizes() == [1]
    out = l2sea([list(make_inputs(np.array([[0.3, -6.0]]))[0])])
    assert out[0][0] > 0


def test_l2sea_resistance_grows_with_froude(l2sea):
    rts = [
        l2sea([list(make_inputs(np.array([[f, -6.16]]))[0])])[0][0]
        for f in np.linspace(*FROUDE_RANGE, 6)
    ]
    assert rts[-1] > 2 * rts[0]  # steep growth with speed


def test_l2sea_deeper_draft_more_resistance(l2sea):
    shallow = l2sea([list(make_inputs(np.array([[0.33, -5.6]]))[0])])[0][0]
    deep = l2sea([list(make_inputs(np.array([[0.33, -6.7]]))[0])])[0][0]
    assert deep > shallow


def test_l2sea_fidelity_bias(l2sea):
    x = list(make_inputs(np.array([[0.33, -6.16]]))[0])
    coarse = l2sea([x], {"fidelity": 7})[0][0]
    fine = l2sea([x], {"fidelity": 1})[0][0]
    assert coarse > fine  # coarser grid over-predicts
