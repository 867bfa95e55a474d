"""PyTorch port: the UM-Bridge wire (`core/server.py`, `core/client.py`,
`HTTPBackend`). The JAX package's HTTP tests re-pointed at a port server
and a port client (`TorchModel` where they served a `JAXModel`); the wire
across packages in both directions (a port server with a JAX client, a JAX
server with a port client), every compute route and the four GET/metadata
routes, held to `TOL32` against the other package's in-process model and
bit for bit against the serving model's own; `as_backend` over URLs; and a
tsunami wave through the wire, bit for bit. Every server binds port 0."""
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.client as jax_client
import repro.core.interface as jax_interface
import repro.core.server as jax_server
from _torch_parity import serving
from repro_torch.apps.tsunami import TsunamiModel
from repro_torch.core import client as port_client
from repro_torch.core import server as port_server
from repro_torch.core.client import HTTPModel, probe_health
from repro_torch.core.fabric import EvaluationFabric, HTTPBackend, as_backend
from repro_torch.core.interface import (
    Capabilities,
    Model,
    TorchModel,
    UnsupportedCapability,
    model_capabilities,
)
from repro_torch.core.server import serve_models

torch.set_num_threads(1)

#: float32 bound of the port against the JAX package on the same function
#: (tests/test_torch_torchmodel.py's TOL32)
TOL32 = dict(rtol=1e-5, atol=1e-6)


def _quad_torch(th):
    return torch.stack([torch.sum(th**2), th[0] - th[1]])


def _quad_jax(th):
    return jnp.array([jnp.sum(th**2), th[0] - th[1]])


def _grad_model():
    return TorchModel(_quad_torch, 2, 2, device="cpu")


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


# -- re-pointed: tests/test_core.py ---------------------------------------------


def test_http_error_paths():
    with serving(serve_models, TorchModel(lambda th: th * 2, 2, 2, device="cpu")) as url:
        hm = HTTPModel(url, "forward")
        with pytest.raises(RuntimeError, match="InvalidInput|input"):
            hm([[1.0]])  # wrong size
        with pytest.raises(RuntimeError, match="ModelNotFound"):
            HTTPModel(url, "nope")


# -- re-pointed: tests/test_capabilities.py (HTTP negotiation) ------------------


@pytest.fixture(scope="module")
def grad_server():
    with serving(serve_models, _grad_model()) as url:
        yield url


@pytest.fixture(scope="module")
def eval_only_server():
    with serving(serve_models, _LegacyBatchModel()) as url:
        yield url


def test_server_advertises_full_capability_set(grad_server):
    hm = HTTPModel(grad_server)
    caps = hm.capabilities()
    assert caps == Capabilities(**{k: True for k in caps.to_json() and {
        "evaluate": 1, "gradient": 1, "apply_jacobian": 1, "apply_hessian": 1,
        "evaluate_batch": 1, "gradient_batch": 1, "apply_jacobian_batch": 1,
        "apply_hessian_batch": 1}})
    # client advertisement ⊆ server advertisement by construction
    assert model_capabilities(hm).issubset(caps)


def test_gradient_batch_one_round_trip(grad_server):
    hm = HTTPModel(grad_server)
    hm.round_trips = 0
    X = np.array([[1.0, 2.0], [3.0, 4.0], [0.5, -0.5]])
    S = np.array([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0]])
    g = hm.gradient_batch(X, S)
    np.testing.assert_allclose(g, 2 * X, rtol=1e-5)
    assert hm.round_trips == 1  # ONE /GradientBatch for the whole wave
    jv = hm.apply_jacobian_batch(X, np.ones((3, 2)))
    np.testing.assert_allclose(jv[:, 0], 2 * X.sum(1), rtol=1e-5)
    assert hm.round_trips == 2


def test_gradient_batch_per_point_fallback(grad_server):
    hm = HTTPModel(grad_server)
    hm._grad_batch_supported = False  # pretend the route predates v2
    hm.round_trips = 0
    X = np.array([[1.0, 2.0], [3.0, 4.0]])
    g = hm.gradient_batch(X, np.array([[1.0, 0.0], [1.0, 0.0]]))
    np.testing.assert_allclose(g, 2 * X, rtol=1e-5)
    assert hm.round_trips == len(X) + 1  # per-point /Gradient + /InputSizes


def test_client_negotiates_subset_against_eval_only_server(eval_only_server):
    hm = HTTPModel(eval_only_server)
    caps = hm.capabilities()
    assert caps.evaluate and caps.evaluate_batch
    assert not caps.op_supported("gradient")
    # per-point /Gradient against an evaluate-only server: typed refusal
    with pytest.raises(RuntimeError, match="UnsupportedFeature"):
        hm.gradient(0, 0, [[1.0, 2.0]], [1.0])
    # batched gradients degrade to the FD fallback riding /EvaluateBatch
    hm.round_trips = 0
    g = hm.gradient_batch(np.array([[1e3, 2e3]]), np.array([[1.0]]))
    np.testing.assert_allclose(g, [[2e3, 4e3]], rtol=1e-3)
    # one failed /GradientBatch probe + one FD evaluate wave
    assert hm.round_trips == 2


def test_apply_hessian_batch_one_round_trip(grad_server):
    """The whole HVP wave rides ONE /ApplyHessianBatch POST. Model
    [sum th^2, th0 - th1]: Hessian of output 0 is 2I, of output 1 is 0, so
    the contracted HVP is 2 * sens[0] * vec."""
    hm = HTTPModel(grad_server)
    assert hm.capabilities().apply_hessian_batch
    hm.round_trips = 0
    X = np.array([[1.0, 2.0], [3.0, -1.0], [0.5, 0.25]])
    S = np.array([[1.0, 0.0], [2.0, 5.0], [-1.0, 3.0]])
    V = np.array([[1.0, 1.0], [2.0, 0.0], [-1.0, 3.0]])
    h = hm.apply_hessian_batch(X, S, V)
    np.testing.assert_allclose(h, 2.0 * S[:, :1] * V, rtol=1e-6)
    assert hm.round_trips == 1


def test_apply_hessian_batch_degrades_to_per_point(grad_server):
    """Against a server whose route predates /ApplyHessianBatch the client
    falls back to per-point /ApplyHessian — explicitly, mirroring the
    gradient ladder (there is NO finite-difference rung for Hessians)."""
    hm = HTTPModel(grad_server)
    hm._hvp_batch_supported = False
    hm.round_trips = 0
    X = np.array([[1.0, 2.0], [3.0, -1.0]])
    S = np.array([[1.0, 0.0], [2.0, 5.0]])
    V = np.array([[1.0, 1.0], [2.0, 0.0]])
    h = hm.apply_hessian_batch(X, S, V)
    np.testing.assert_allclose(h, 2.0 * S[:, :1] * V, rtol=1e-6)
    assert hm.round_trips == len(X) + 1  # per-point route + /InputSizes


def test_apply_hessian_refused_on_evaluate_only_server(eval_only_server):
    """No apply_hessian capability advertised: the client refuses with the
    typed error BEFORE any wire traffic (no probe, no FD fallback)."""
    hm = HTTPModel(eval_only_server)
    assert not hm.capabilities().op_supported("apply_hessian")
    hm.round_trips = 0
    with pytest.raises(UnsupportedCapability, match="apply_hessian"):
        hm.apply_hessian_batch(
            np.ones((2, 2)), np.ones((2, 1)), np.ones((2, 2))
        )
    assert hm.round_trips == 0


def test_health_probe_reports_capabilities(grad_server):
    doc = probe_health(grad_server)
    caps = Capabilities.from_json(doc["capabilities"]["forward"])
    assert caps.gradient_batch and caps.evaluate_batch
    assert doc["batch"]["forward"] is True  # legacy key kept


# -- re-pointed: tests/test_batch_native.py ------------------------------------


def test_modelinfo_advertises_evaluate_batch():
    m = TorchModel(lambda th: torch.atleast_1d(torch.sum(th**2)), 2, 1, device="cpu")
    with serving(serve_models, m) as url:
        hm = HTTPModel(url, "forward")
        assert hm.supports_evaluate_batch() is True
        assert hm._batch_supported is True  # probing skipped entirely
        hm.round_trips = 0
        out = hm.evaluate_batch(np.ones((4, 2)))
        assert hm.round_trips == 1
        np.testing.assert_allclose(out.ravel(), [2.0] * 4, rtol=1e-5)


# -- re-pointed: tests/test_fabric.py (HTTP /EvaluateBatch) --------------------


def test_evaluate_batch_roundtrip(grad_server):
    hm = HTTPModel(grad_server, "forward")
    hm.round_trips = 0
    X = np.array([[1.0, 2.0], [3.0, 4.0], [0.5, -0.5]])
    out = hm.evaluate_batch(X)
    np.testing.assert_allclose(out[:, 0], (X**2).sum(1), rtol=1e-5)
    np.testing.assert_allclose(out[:, 1], X[:, 0] - X[:, 1], rtol=1e-5, atol=1e-6)
    assert hm.round_trips == 1  # ONE round-trip for the whole batch


def test_evaluate_batch_validates_sizes(grad_server):
    hm = HTTPModel(grad_server, "forward")
    with pytest.raises(RuntimeError, match="InvalidInput|inputs"):
        hm.evaluate_batch(np.ones((3, 5)))  # wrong input size


def test_fabric_http_backend_fans_out(grad_server):
    clients = [HTTPModel(grad_server), HTTPModel(grad_server)]
    for c in clients:
        c.round_trips = 0
    with EvaluationFabric(HTTPBackend(clients), cache_size=0) as fab:
        X = np.random.default_rng(0).standard_normal((10, 2))
        out = fab.evaluate_batch(X)
        np.testing.assert_allclose(out[:, 0], (X**2).sum(1), rtol=1e-5)
    total = sum(c.round_trips for c in clients)
    assert total == 2  # one batched round-trip per client, not one per point


def test_evaluate_batch_fallback_against_legacy_server(grad_server):
    hm = HTTPModel(grad_server, "forward")
    hm._batch_supported = False  # pretend the server predates /EvaluateBatch
    hm.round_trips = 0
    X = np.array([[1.0, 2.0], [3.0, 4.0]])
    out = hm.evaluate_batch(X)
    np.testing.assert_allclose(out[:, 0], (X**2).sum(1), rtol=1e-5)
    assert hm.round_trips == len(X) + 1  # per-point fallback + /InputSizes


# -- across packages, both directions ------------------------------------------

_RNG = np.random.default_rng(7)
X = _RNG.normal(size=(5, 2))
S = _RNG.normal(size=(5, 2))
V = _RNG.normal(size=(5, 2))

#: every compute route, as a client (either package's `HTTPModel`) or an
#: in-process model calls it
ROUTES = {
    "Evaluate": lambda m: m([list(X[0])], None)[0],
    "EvaluateBatch": lambda m: m.evaluate_batch(X),
    "Gradient": lambda m: m.gradient(0, 0, [list(X[0])], list(S[0])),
    "GradientBatch": lambda m: m.gradient_batch(X, S),
    "ApplyJacobian": lambda m: m.apply_jacobian(0, 0, [list(X[0])], list(V[0])),
    "ApplyJacobianBatch": lambda m: m.apply_jacobian_batch(X, V),
    "ApplyHessian": lambda m: m.apply_hessian(0, 0, 0, [list(X[0])], list(S[0]), list(V[0])),
    "ApplyHessianBatch": lambda m: m.apply_hessian_batch(X, S, V),
}


class _PortEvalOnly(Model):
    def get_input_sizes(self, c=None):
        return [2]

    def get_output_sizes(self, c=None):
        return [1]

    def supports_evaluate(self):
        return True

    def __call__(self, p, c=None):
        return [[float(np.sum(np.square(p[0])))]]


class _JaxEvalOnly(jax_interface.Model):
    get_input_sizes = _PortEvalOnly.get_input_sizes
    get_output_sizes = _PortEvalOnly.get_output_sizes
    supports_evaluate = _PortEvalOnly.supports_evaluate
    __call__ = _PortEvalOnly.__call__


#: (server package, client package): the serving model, the other
#: package's model of the same function, the server, the client module, and
#: the serving package's evaluate-only model
DIRECTIONS = {
    "port_server_jax_client": lambda: (
        _grad_model(), jax_interface.JAXModel(_quad_jax, 2, 2),
        port_server.serve_models, jax_client, _PortEvalOnly()),
    "jax_server_port_client": lambda: (
        jax_interface.JAXModel(_quad_jax, 2, 2), _grad_model(),
        jax_server.serve_models, port_client, _JaxEvalOnly()),
}


@pytest.fixture(scope="module", params=sorted(DIRECTIONS))
def cross(request):
    served, other, serve, client, eval_only = DIRECTIONS[request.param]()
    with serving(serve, served) as url, serving(serve, eval_only) as eval_url:
        yield dict(served=served, other=other, url=url, client=client, eval_url=eval_url)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_compute_route_across_packages(cross, route):
    hm = cross["client"].HTTPModel(cross["url"], "forward")
    hm.round_trips = 0
    got = np.asarray(ROUTES[route](hm), float)
    # the wire carries float64 by repr: the served model's own answer, bit
    # for bit, and the other package's within the float32 bound
    np.testing.assert_array_equal(got, np.asarray(ROUTES[route](cross["served"]), float))
    want = np.asarray(ROUTES[route](cross["other"]), float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL32)
    assert hm.round_trips == 1  # the route itself, no fallback


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10.0) as resp:
        return json.loads(resp.read())


def test_metadata_routes_across_packages(cross):
    client, url = cross["client"], cross["url"]
    hm = client.HTTPModel(url, "forward", tenant="alice")
    want_caps = model_capabilities(cross["served"]).to_json()
    assert want_caps == model_capabilities(cross["other"]).to_json()
    # /ModelInfo (negotiated once by the client) and /Health
    assert hm.capabilities().to_json() == want_caps
    doc = client.probe_health(url)
    assert doc["status"] == "ok" and doc["models"] == ["forward"]
    assert doc["capabilities"] == {"forward": want_caps}
    assert doc["batch"] == {"forward": True}
    assert doc["stats"]["errors"] == 0 and doc["stats"]["requests"] >= 1
    # /Info, and the sizes
    assert client.supported_models(url) == ["forward"]
    info = _get(url, "/Info")
    assert info["protocolVersion"] == port_server.PROTOCOL_VERSION == jax_server.PROTOCOL_VERSION
    assert hm.get_input_sizes() == [2] and hm.get_output_sizes() == [2]
    # /Tenants: the X-UQ-Tenant header accounted a request and its points
    hm.evaluate_batch(X)
    tenants = _get(url, "/Tenants")["tenants"]
    assert tenants["alice"]["points"] >= len(X)
    assert tenants["alice"]["requests"] >= 2


def test_unsupported_feature_across_packages(cross):
    hm = cross["client"].HTTPModel(cross["eval_url"], "forward")
    assert not hm.capabilities().op_supported("gradient")
    with pytest.raises(RuntimeError, match="UnsupportedFeature"):
        hm.gradient(0, 0, [[1.0, 2.0]], [1.0])
    with pytest.raises(RuntimeError, match="UnsupportedFeature"):
        hm.apply_jacobian(0, 0, [[1.0, 2.0]], [1.0, 0.0])
    # an unadvertised route is refused, not an error of the model
    assert cross["client"].probe_health(cross["eval_url"])["stats"]["errors"] == 0


# -- as_backend over URLs -------------------------------------------------------


def test_as_backend_builds_an_http_backend_from_urls(grad_server):
    backend = as_backend(grad_server)
    assert isinstance(backend, HTTPBackend) and backend.n_instances == 1
    both = as_backend([grad_server, HTTPModel(grad_server)])
    assert isinstance(both, HTTPBackend) and both.n_instances == 2
    assert both.capabilities().op_supported("apply_hessian")
    want = _grad_model().evaluate_batch(X)
    for b in (backend, both):
        with EvaluationFabric(b, cache_size=0) as fab:
            np.testing.assert_array_equal(fab.evaluate_batch(X), want)
            np.testing.assert_array_equal(fab.gradient_batch(X, S),
                                          _grad_model().gradient_batch(X, S))
    assert both.stats()["round_trips"] >= 4  # two waves, split over two servers


def test_tsunami_wave_through_the_wire_is_bit_for_bit():
    """A 3-lane coarse wave served by a port server equals the in-process
    wave bit for bit: JSON carries float64 by repr, and the model casts to
    float32 on both paths."""
    thetas = np.array([[80.0, 2.0], [95.5, 1.25], [120.25, 3.0]])
    model = TsunamiModel(device="cpu")
    with serving(serve_models, model) as url:
        got = HTTPModel(url).evaluate_batch(thetas, {"level": 0})
        assert probe_health(url)["stats"]["errors"] == 0
    want = TsunamiModel(device="cpu").evaluate_batch(thetas, {"level": 0})
    assert got.shape == (3, 4) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert model.waves == {0: 1, 1: 0} and model.stats == {0: 3, 1: 0}
