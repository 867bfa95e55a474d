"""PyTorch port: `TorchModel`, the AD-derived model wrapper, against the JAX
package's `JAXModel` on the same function written twice — all eight
operations, per point and batched, the fused value-and-gradient wave and
its two-wave fallback, config keys — plus the abstract
`sens_fn_traceable` probe, the device rule and `as_backend`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fabric as jax_fabric
from repro.core.interface import JAXModel
from repro_torch.core.fabric import EvaluationFabric, SPMDBackend, as_backend
from repro_torch.core.interface import (
    Capabilities,
    TorchModel,
    as_torch_callable,
    sens_fn_traceable,
)

torch.set_num_threads(1)


def f_jax(th, scale=1.0):
    return scale * jnp.array([th[0] ** 2 * th[1], jnp.sin(th[1]) * th[0],
                              jnp.exp(0.3 * th[0])])


def f_torch(th, scale=1.0):
    return scale * torch.stack([th[0] ** 2 * th[1], torch.sin(th[1]) * th[0],
                                torch.exp(0.3 * th[0])])


_RNG = np.random.default_rng(0)
X = _RNG.normal(size=(5, 2))
S = _RNG.normal(size=(5, 3))
V = _RNG.normal(size=(5, 2))
DATA = np.array([1.0, 2.0, 3.0])
#: float32 bound against JAXModel: the same function and the same AD rules,
#: rounded by two libraries (measured: <= 1.8e-7 absolute on these inputs,
#: outputs of order 1)
TOL32 = dict(rtol=1e-5, atol=1e-6)

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


def _pair(**kw):
    return TorchModel(f_torch, 2, 3, device="cpu", **kw), JAXModel(f_jax, 2, 3, **kw)


@pytest.mark.parametrize("op", sorted(OPS))
def test_every_operation_matches_jaxmodel(op):
    tm, jm = _pair()
    got, want = np.asarray(OPS[op](tm, None)), np.asarray(OPS[op](jm, None))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL32)
    # the batched operations run at the wave's own width, unpadded
    if op.endswith("_batch"):
        assert len(got) == len(X)


def test_capabilities_and_raw_fn():
    tm = TorchModel(f_torch, 2, 3, name="quad", device="cpu")
    assert tm.capabilities().to_json() == JAXModel(f_jax, 2, 3).capabilities().to_json()
    assert all(tm.capabilities().batched(op) for op in Capabilities.OPS)
    assert tm.raw_fn is f_torch and tm.name == "quad"
    assert tm.get_input_sizes() == [2] and tm.get_output_sizes() == [3]


def test_config_keys_and_defaults_select_the_function():
    tm, jm = _pair(config_keys=("scale",), defaults={"scale": 2.0})
    for c in (None, {"scale": -0.5}):
        for op in ("evaluate_batch", "apply_hessian_batch", "gradient"):
            np.testing.assert_allclose(OPS[op](tm, c), OPS[op](jm, c), **TOL32)
    np.testing.assert_allclose(tm.evaluate_batch(X, {"scale": -0.5}),
                               -0.25 * tm.evaluate_batch(X), rtol=1e-6)


def test_fused_value_and_gradient_matches_jaxmodel():
    tm, jm = _pair()
    data_t = torch.as_tensor(DATA, dtype=torch.float32)
    ys, gs = tm.value_and_gradient_batch(X, lambda y: data_t - y)
    ys_j, gs_j = jm.value_and_gradient_batch(X, lambda y: jnp.asarray(DATA) - y)
    np.testing.assert_allclose(ys, ys_j, **TOL32)
    np.testing.assert_allclose(gs, gs_j, **TOL32)
    np.testing.assert_allclose(gs, tm.gradient_batch(X, DATA - ys), **TOL32)


def test_numpy_sens_fn_takes_the_two_wave_fallback(monkeypatch):
    tm, jm = _pair()
    calls = []
    for name in ("evaluate_batch", "gradient_batch"):
        orig = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n), _o(*a, **k))[1])

    def np_sens(y):  # host-side: converts the row to numpy
        return DATA - np.asarray(y)

    assert not sens_fn_traceable(np_sens, 3)
    ys, gs = tm.value_and_gradient_batch(X, np_sens)
    assert calls == ["evaluate_batch", "gradient_batch"]
    ys_j, gs_j = jm.value_and_gradient_batch(X, np_sens)
    np.testing.assert_allclose(ys, ys_j, **TOL32)
    np.testing.assert_allclose(gs, gs_j, **TOL32)
    calls.clear()
    tm.value_and_gradient_batch(X, lambda y: torch.as_tensor(DATA, dtype=y.dtype) - y)
    assert calls == []  # the traceable one: one fused program


def test_sens_fn_traceable_probe():
    data_t = torch.as_tensor(DATA, dtype=torch.float32)
    assert sens_fn_traceable(lambda y: data_t - y, 3)
    assert sens_fn_traceable(lambda y: torch.as_tensor(DATA, dtype=y.dtype) - y, 3,
                             torch.float64)
    assert not sens_fn_traceable(lambda y: DATA - np.asarray(y), 3)
    assert not sens_fn_traceable(lambda y: y * float(y[0]), 3)  # .item() under vmap
    assert not sens_fn_traceable(lambda y: y[:2], 3)  # wrong size
    assert not sens_fn_traceable(lambda y: [0.0] * 3, 3)  # not a tensor


def test_default_device_is_the_gpu_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchModel(f_torch, 2, 3)
    assert TorchModel(f_torch, 2, 3, device="cpu").device == torch.device("cpu")


def test_as_backend_serves_a_torchmodel_and_refuses_a_jaxmodel():
    tm, jm = _pair()
    backend = as_backend(tm)
    # SPMDBackend(ModelPool(tm)), as the JAX package serves a JAXModel
    assert isinstance(backend, SPMDBackend) and backend.pool.model is tm
    with pytest.raises(TypeError, match="TorchModel"):
        as_backend(jm)


def test_fabric_waves_through_torchmodel_match_the_jax_package():
    tm, jm = _pair()
    backend, jbackend = as_backend(tm), jax_fabric.as_backend(jm)
    assert isinstance(backend, SPMDBackend) and isinstance(jbackend, jax_fabric.SPMDBackend)
    with EvaluationFabric(backend, cache_size=0) as fab, \
            jax_fabric.EvaluationFabric(jbackend, cache_size=0) as jfab:
        for name, args in (("evaluate_batch", (X,)), ("gradient_batch", (X, S)),
                           ("apply_jacobian_batch", (X, V)),
                           ("apply_hessian_batch", (X, S, V))):
            np.testing.assert_allclose(getattr(fab, name)(*args),
                                       getattr(jfab, name)(*args), **TOL32)
        ys, gs = fab.value_and_gradient_batch(X, lambda y: torch.as_tensor(DATA, dtype=y.dtype) - y)
        np.testing.assert_allclose(gs, jfab.value_and_gradient_batch(
            X, lambda y: jnp.asarray(DATA) - y)[1], **TOL32)
        pc = fab.telemetry()["per_capability"]
    assert pc["value_and_gradient"]["waves"] == 1 and pc["apply_hessian"]["waves"] == 1


def test_as_torch_callable():
    tm = TorchModel(f_torch, 2, 3, device="cpu")
    f = as_torch_callable(tm)
    np.testing.assert_allclose(f(X[0]), tm.evaluate_batch(X[:1])[0], rtol=1e-6)
