"""PyTorch port: the capability-typed model interface, the FD fallback, the
threaded pool and the evaluation fabric — the matching cases of
tests/test_core.py, test_capabilities.py and test_batch_native.py, run on
the port, plus parity of the FD fallback with the JAX package's."""
import time
import warnings

import numpy as np
import pytest

import repro.core.interface as jax_interface
from repro_torch.core.fabric import (
    CallableBackend,
    EvaluationFabric,
    ModelBackend,
    ThreadedBackend,
    as_backend,
)
from repro_torch.core.interface import (
    Capabilities,
    Model,
    UnsupportedCapability,
    model_capabilities,
    next_pow2,
    pad_to_bucket,
)
from repro_torch.core.pool import ThreadedPool
from repro_torch.core.protocol import ModelSupport


# -- descriptor ---------------------------------------------------------------


def test_capabilities_descriptor_semantics():
    caps = Capabilities(evaluate=True, gradient=True, evaluate_batch=True)
    assert "gradient" in caps and "apply_hessian" not in caps
    assert caps.op_supported("gradient") and not caps.op_supported("apply_jacobian")
    assert Capabilities(gradient_batch=True).op_supported("gradient")
    assert caps.batched("evaluate") and not caps.batched("gradient")
    sub = Capabilities(evaluate=True)
    assert sub.issubset(caps) and not caps.issubset(sub)
    u = sub.union(Capabilities(gradient=True))
    assert u.evaluate and u.gradient
    i = caps.intersection(Capabilities(evaluate=True, apply_hessian=True))
    assert i.evaluate and not i.gradient
    with pytest.raises(ValueError):
        caps.op_supported("nonsense")


def test_capabilities_wire_roundtrip_matches_jax_package():
    caps = Capabilities(evaluate=True, gradient_batch=True, apply_hessian=True)
    doc = caps.to_json()
    assert doc["Evaluate"] and doc["GradientBatch"] and doc["ApplyHessian"]
    assert Capabilities.from_json(doc) == caps
    # the wire document is the JAX package's, key for key
    ref = jax_interface.Capabilities(evaluate=True, gradient_batch=True, apply_hessian=True)
    assert doc == ref.to_json()
    assert jax_interface.Capabilities.from_json(doc) == ref
    ms = ModelSupport.from_json({"Evaluate": True, "EvaluateBatch": True})
    assert ms.evaluate and ms.evaluate_batch and not ms.gradient_batch


class _LegacyBatchModel(Model):
    """v1-style model: capability via supports_* overrides only."""

    def get_input_sizes(self, c=None):
        return [2]

    def get_output_sizes(self, c=None):
        return [1]

    def supports_evaluate(self):
        return True

    def supports_evaluate_batch(self):
        return True

    def __call__(self, p, c=None):
        return [[float(np.sum(np.square(p[0])))]]

    def evaluate_batch(self, thetas, config=None):
        return (np.atleast_2d(thetas) ** 2).sum(1, keepdims=True)


def test_base_capabilities_derive_from_legacy_probes():
    caps = model_capabilities(_LegacyBatchModel())
    assert caps.evaluate and caps.evaluate_batch
    assert not caps.op_supported("gradient")

    class WithGrad(_LegacyBatchModel):
        def gradient(self, out_wrt, in_wrt, parameters, sens, config=None):
            return (2 * np.asarray(parameters[in_wrt]) * sens[0]).tolist()

    assert model_capabilities(WithGrad()).gradient


def test_supports_evaluate_batch_probe_is_deprecated():
    class V2(Model):
        def capabilities(self, config=None):
            return Capabilities(evaluate=True, evaluate_batch=True)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert V2().supports_evaluate_batch() is True
    assert any(issubclass(w.category, DeprecationWarning) for w in rec)


# -- FD fallback --------------------------------------------------------------


class _ToyQuadratic:
    """f(theta) = [sum((theta/scale)^2), theta_0 * theta_1 / scale^2]: the
    analytic Jacobian is known, and |theta| spans six orders of magnitude."""

    SCALE = 1e3

    def get_input_sizes(self, c=None):
        return [2]

    def get_output_sizes(self, c=None):
        return [2]

    def supports_evaluate(self):
        return True

    def evaluate_batch(self, thetas, config=None):
        t = np.atleast_2d(thetas) / self.SCALE
        return np.stack([(t**2).sum(1), t[:, 0] * t[:, 1]], 1)

    def jacobian(self, theta):
        s2 = self.SCALE**2
        return np.array([[2 * theta[0] / s2, 2 * theta[1] / s2],
                         [theta[1] / s2, theta[0] / s2]])


class _PortToy(_ToyQuadratic, Model):
    pass


class _JaxToy(_ToyQuadratic, jax_interface.Model):
    pass


def test_fd_fallback_relative_step_against_analytic_gradient():
    m = _PortToy()
    thetas = np.array([[2e6, -3e6], [1e-3, 2e-3], [3.0, -4.0]])
    senss = np.array([[1.0, 0.5], [1.0, -2.0], [0.3, 1.0]])
    grads = m._fd_gradient_batch(thetas, senss)
    exact = np.stack([s @ m.jacobian(t) for t, s in zip(thetas, senss)])
    # |theta| >> 1: the step tracks the magnitude, truncation stays relative
    np.testing.assert_allclose(grads[0], exact[0], rtol=1e-3)
    np.testing.assert_allclose(grads[2], exact[2], rtol=1e-3)
    # below the unit floor the step floors at fd_step: first-order
    # truncation ~ h / 2 theta keeps the right order of magnitude
    np.testing.assert_allclose(grads[1], exact[1], rtol=0.2)
    # JVP fallback agrees with the VJP fallback through duality
    vecs = np.array([[1.0, 2.0], [0.5, -1.0], [1.0, 1.0]])
    jv = m._fd_apply_jacobian_batch(thetas, vecs)
    np.testing.assert_allclose((jv * senss).sum(1), (grads * vecs).sum(1), rtol=0.1)
    # the same fallback code in both packages: identical numbers
    ref = _JaxToy()
    np.testing.assert_array_equal(grads, ref._fd_gradient_batch(thetas, senss))
    np.testing.assert_array_equal(jv, ref._fd_apply_jacobian_batch(thetas, vecs))
    np.testing.assert_array_equal(m.gradient_batch(thetas, senss), grads)


def test_next_pow2_and_padding():
    assert [next_pow2(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    x = np.arange(6, dtype=float).reshape(3, 2)
    padded, pad = pad_to_bucket(x, 8)
    assert padded.shape == (8, 2) and pad == 5
    np.testing.assert_array_equal(padded[3:], np.tile(x[-1:], (5, 1)))
    same, none = pad_to_bucket(x, 3)
    assert none == 0 and same is x


# -- threaded pool ------------------------------------------------------------


class _Counting(Model):
    def __init__(self, delay=0.0):
        super().__init__("forward")
        self.delay = delay
        self.calls = 0

    def get_input_sizes(self, c=None):
        return [1]

    def get_output_sizes(self, c=None):
        return [1]

    def supports_evaluate(self):
        return True

    def __call__(self, p, c=None):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return [[p[0][0] * 2]]


def test_threaded_pool_one_inflight_per_instance():
    insts = [_Counting(delay=0.05) for _ in range(4)]
    tp = ThreadedPool(insts)
    t0 = time.monotonic()
    out = tp.evaluate([[i] for i in range(8)])
    dt = time.monotonic() - t0
    tp.shutdown()
    np.testing.assert_allclose(out.ravel(), np.arange(8) * 2)
    assert dt < 0.05 * 8
    assert sum(i.calls for i in insts) == 8


# -- fabric -------------------------------------------------------------------


class _NativeDouble(Model):
    """Native batch model, evaluate only (the tsunami model's surface)."""

    def __init__(self):
        super().__init__("forward")
        self.seen_sizes: list[int] = []

    def get_input_sizes(self, c=None):
        return [2]

    def get_output_sizes(self, c=None):
        return [2]

    def capabilities(self, config=None):
        return Capabilities(evaluate=True, evaluate_batch=True)

    def evaluate_batch(self, thetas, config=None):
        thetas = np.atleast_2d(thetas)
        self.seen_sizes.append(len(thetas))
        return thetas * 3.0


def test_fabric_routes_native_batch_without_fallback():
    m = _NativeDouble()
    with EvaluationFabric(ModelBackend(m), cache_size=0) as fab:
        X = np.random.default_rng(0).standard_normal((10, 2))
        out = fab.evaluate_batch(X)
        np.testing.assert_allclose(out, X * 3.0)
        back = fab.telemetry()["backend"]
        assert back["native"] is True
        assert back["native_batches"] == 1 and back["native_points"] == 10
        assert back["fallback_points"] == 0 and back["padded"] == 0
    assert m.seen_sizes == [10]  # one whole wave, padded by the model itself


class _CountingGradModel(Model):
    """Quadratic with native batched ops and per-op dispatch counters."""

    def __init__(self):
        super().__init__("forward")
        self.calls = {"evaluate": 0, "gradient": 0}

    def get_input_sizes(self, c=None):
        return [2]

    def get_output_sizes(self, c=None):
        return [1]

    def capabilities(self, config=None):
        return Capabilities(
            evaluate=True, evaluate_batch=True, gradient=True, gradient_batch=True
        )

    def evaluate_batch(self, thetas, config=None):
        self.calls["evaluate"] += 1
        return (np.atleast_2d(thetas) ** 2).sum(1, keepdims=True)

    def gradient_batch(self, thetas, senss, config=None):
        self.calls["gradient"] += 1
        return 2 * np.atleast_2d(thetas) * np.atleast_2d(senss)


def test_fabric_cache_is_namespaced_per_capability():
    m = _CountingGradModel()
    with EvaluationFabric(ModelBackend(m), cache_size=64) as fab:
        X = np.array([[1.0, 2.0]])
        S = np.ones((1, 1))
        fab.evaluate_batch(X)
        assert m.calls["evaluate"] == 1
        # same theta, different capability: not served from evaluate's cache
        np.testing.assert_allclose(fab.gradient_batch(X, S), 2 * X)
        assert m.calls["gradient"] == 1
        fab.gradient_batch(X, S)  # identical (theta, sens): cache hit
        assert m.calls["gradient"] == 1
        fab.gradient_batch(X, 2 * S)  # different sens: a new entry
        assert m.calls["gradient"] == 2
        fab.evaluate_batch(X)  # still served from its own namespace
        assert m.calls["evaluate"] == 1
        t = fab.telemetry()
        assert t["per_capability"]["evaluate"]["waves"] == 1
        assert t["per_capability"]["gradient"]["waves"] == 2
        assert t["per_capability"]["gradient"]["cache_hits"] == 1


def test_evaluate_only_fabric_refuses_gradient_waves():
    with EvaluationFabric(ModelBackend(_NativeDouble()), cache_size=0) as fab:
        with pytest.raises(UnsupportedCapability):
            fab.gradient_batch(np.ones((2, 2)), np.ones((2, 2)))
        with pytest.raises(UnsupportedCapability):
            fab.value_and_gradient_batch(np.ones((2, 2)), lambda y: y)


class JAXModel:  # a stand-in with the JAX package's model type name
    pass


def test_as_backend_ports_and_refusals():
    from repro_torch.core.fabric import SPMDBackend
    from repro_torch.core.pool import ModelPool

    assert isinstance(as_backend(_NativeDouble()), ModelBackend)
    assert isinstance(as_backend(lambda X: X), CallableBackend)
    tp = ThreadedPool([_Counting()])
    try:
        assert isinstance(as_backend(tp), ThreadedBackend)
    finally:
        tp.shutdown()
    # a device pool is served by SPMDBackend, as in the JAX package
    pool = ModelPool(_NativeDouble())
    backend = as_backend(pool)
    assert isinstance(backend, SPMDBackend) and backend.pool is pool
    # UM-Bridge URLs (and lists of them) become an HTTPBackend over a port
    # server (port 0, read back)
    from _torch_parity import serving
    from repro_torch.core.fabric import HTTPBackend
    from repro_torch.core.server import serve_models

    with serving(serve_models, _NativeDouble()) as url:
        assert isinstance(as_backend(url), HTTPBackend)
        both = as_backend([url, url])
        assert isinstance(both, HTTPBackend) and both.n_instances == 2
    # a JAX model is refused, naming what to write instead
    with pytest.raises(TypeError, match="TorchModel"):
        as_backend(JAXModel())
