"""UM-Bridge HTTP client (stdlib urllib — paper §2.4.1); port of
`repro.core.client`, and wire-compatible with it: either package's client
talks to either package's server.

    model = HTTPModel("http://localhost:4242", "forward")
    print(model([[0.0, 10.0]]))

`HTTPModel` negotiates the operation surface ONCE from `/ModelInfo` (the
server's `Capabilities` descriptor) and never probes endpoints after that:
`evaluate_batch` ships N points in one `/EvaluateBatch` round-trip,
`gradient_batch`/`apply_jacobian_batch` ship whole derivative waves through
`/GradientBatch`/`/ApplyJacobianBatch`, and each degrades per capability —
batched route -> per-point route -> (for derivatives) the base-class
finite-difference fallback riding `/EvaluateBatch` — against servers that
predate an extension. `round_trips` counts HTTP requests so benchmarks can
report the saving. `register_servers` probes a cluster of server URLs via
GET `/Health` and returns one fabric backend per live server, ready for
`FabricRouter` load balancing.
"""
from __future__ import annotations

import json
import urllib.request

import numpy as np

from repro_torch.core.interface import Capabilities, Model
from repro_torch.core.protocol import config_key, error_body, split_blocks


def _post(url: str, path: str, body: dict, timeout: float = 60.0,
          tenant: str | None = None) -> dict:
    headers = {"Content-Type": "application/json"}
    if tenant is not None:
        # multi-tenant service tier: the server accounts the request (and
        # its point count) to this tenant and serves the totals on /Tenants
        headers["X-UQ-Tenant"] = str(tenant)
    req = urllib.request.Request(
        url.rstrip("/") + path,
        data=json.dumps(body).encode(),
        headers=headers,
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            out = json.loads(e.read() or b"")
        except (json.JSONDecodeError, ValueError):
            out = {}
        if "error" not in out:
            # servers outside this repo answer unknown routes with plain 404
            # pages; normalize so callers can branch on the error type
            kind = "NotFound" if e.code == 404 else "HTTPError"
            out = error_body(kind, f"HTTP {e.code} on {path}")
    if "error" in out:
        raise RuntimeError(f"{out['error'].get('type')}: {out['error'].get('message')}")
    return out


def supported_models(url: str) -> list[str]:
    with urllib.request.urlopen(url.rstrip("/") + "/Info", timeout=10.0) as resp:
        return json.loads(resp.read())["models"]


def probe_health(url: str, timeout: float = 5.0) -> dict | None:
    """GET `/Health` (falling back to `/Info` for servers that predate the
    probe); returns the health document, or None when the server is down."""
    for path in ("/Health", "/Info"):
        try:
            with urllib.request.urlopen(url.rstrip("/") + path, timeout=timeout) as resp:
                doc = json.loads(resp.read())
            doc.setdefault("status", "ok")
            return doc
        except (urllib.error.HTTPError,):
            continue  # route missing: try the older probe
        except (OSError, ValueError):
            return None
    return None


def register_servers(
    urls,
    name: str = "forward",
    *,
    timeout: float = 600.0,
    probe_timeout_s: float = 5.0,
    require_all: bool = False,
    return_dead: bool = False,
    allow_empty: bool = False,
    tenant: str | None = None,
):
    """Probe each server's `/Health` and enroll the live ones as independent
    fabric backends — ONE `HTTPBackend` per server, so a `FabricRouter` (or
    `EvaluationFabric(register_servers(urls))`) load-balances across the
    cluster with per-server latency tracking, capability-aware routing and
    failover, instead of the static contiguous split a single multi-client
    `HTTPBackend` does.

    Dead servers are skipped (raise with `require_all=True`). They used to
    be dropped PERMANENTLY — the caller never learned which URLs failed the
    probe, so a server that was merely booting slowly could never be
    enrolled later. `return_dead=True` returns `(backends, dead_urls)` so a
    re-probe loop (`core.fleet.FleetManager.watch_servers`) can retry the
    dead list and enroll late arrivals via `fabric.add_backend`.

    Registering zero live servers raises unless `allow_empty=True` (an
    elastic fleet may legitimately start empty and scale up).

    `probe_timeout_s` bounds the `/Health` probe (the old hard-coded 5 s
    default): slow-cold-start backends — a server still building its
    kernels on its first wave — need a longer probe window or they are misclassified
    dead at enrollment. `tenant` stamps every request the enrolled clients
    issue with the `X-UQ-Tenant` header."""
    from repro_torch.core.fabric import HTTPBackend

    backends, dead = [], []
    for url in urls:
        doc = probe_health(url, timeout=probe_timeout_s)
        if (
            doc is None
            or doc.get("status") != "ok"
            # a live server that does not host the requested model would
            # fail every routed wave — count it as dead at registration
            or name not in doc.get("models", [name])
        ):
            dead.append(url)
            continue
        backends.append(
            HTTPBackend([HTTPModel(url, name, timeout=timeout, tenant=tenant)])
        )
    if dead and require_all:
        raise RuntimeError(f"unhealthy servers: {dead}")
    if not backends and not allow_empty:
        raise RuntimeError(f"no healthy servers among {list(urls)}")
    if return_dead:
        return backends, dead
    return backends


class HTTPModel(Model):
    def __init__(self, url: str, name: str = "forward", timeout: float = 600.0,
                 tenant: str | None = None):
        super().__init__(name)
        self.url = url
        self.timeout = timeout
        # tenant identity on the wire: every request carries X-UQ-Tenant so
        # shared servers account traffic per tenant (GET /Tenants)
        self.tenant = tenant
        self.round_trips = 0  # HTTP requests issued (telemetry)
        self._sizes_cache: dict = {}  # config_key -> input sizes (static per config)
        info = self._rpc("/ModelInfo", {"name": name}, timeout=10.0)
        self._caps = Capabilities.from_json(info.get("support", {}))
        # servers that advertise EvaluateBatch skip the endpoint probe; the
        # rest are probed on first use (protocol-1.0 servers lack the route)
        self._batch_supported: bool | None = True if self._caps.evaluate_batch else None
        # derivative-wave routes: pre-capability servers may still serve
        # /GradientBatch (the route predates the advertisement), so probe
        # lazily unless the capability set settles it
        self._grad_batch_supported: bool | None = (
            True if self._caps.gradient_batch else None
        )
        self._jvp_batch_supported: bool | None = (
            True if self._caps.apply_jacobian_batch else None
        )
        self._hvp_batch_supported: bool | None = (
            True if self._caps.apply_hessian_batch else None
        )

    def _rpc(self, path: str, body: dict, timeout: float | None = None) -> dict:
        self.round_trips += 1
        return _post(self.url, path, body, timeout or self.timeout,
                     tenant=self.tenant)

    def get_input_sizes(self, config=None):
        # cached per config: sizes are static, and the per-point fallback
        # loops (base-class gradient/jacobian delegation) call this per wave
        return self._input_sizes_cached(config)

    def get_output_sizes(self, config=None):
        return self._rpc("/OutputSizes", {"name": self.name, "config": config or {}})["outputSizes"]

    # -- capability surface --------------------------------------------------
    def capabilities(self, config=None) -> Capabilities:
        """The server's advertised surface (fetched once from `/ModelInfo`).
        What the remote advertises is what dispatch layers negotiate on —
        a client-side FD fallback never widens the advertisement."""
        return self._caps

    def supports_evaluate(self):
        return self._caps.evaluate

    def supports_gradient(self):
        return self._caps.gradient

    def supports_apply_jacobian(self):
        return self._caps.apply_jacobian

    def supports_apply_hessian(self):
        return self._caps.apply_hessian

    def supports_evaluate_batch(self):
        """True when the remote serves /EvaluateBatch from a native batched
        program — the whole wave then costs ONE round-trip AND one SPMD
        dispatch on the server, so dispatch layers treat this client as a
        native batch model. (Deprecated probe; read
        `capabilities().evaluate_batch`.)"""
        return self._caps.evaluate_batch

    # -- operations ----------------------------------------------------------
    def __call__(self, parameters, config=None):
        body = {"name": self.name, "input": [list(map(float, p)) for p in parameters], "config": config or {}}
        return self._rpc("/Evaluate", body)["output"]

    def evaluate_batch(self, thetas, config=None) -> np.ndarray:
        """[N, n] -> [N, m] in ONE `/EvaluateBatch` round-trip (vs N for the
        per-point path); transparently falls back against protocol-1.0
        servers that do not know the endpoint."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        if self._batch_supported is not False:
            body = {
                "name": self.name,
                "inputs": [list(map(float, t)) for t in thetas],
                "config": config or {},
            }
            try:
                out = self._rpc("/EvaluateBatch", body)
                self._batch_supported = True
                return np.asarray(out["outputs"], float)
            except RuntimeError as e:
                if not any(k in str(e) for k in ("NotFound", "UnsupportedFeature")):
                    raise
                self._batch_supported = False
        # per-point fallback: un-flatten each theta into the model's input
        # blocks (mirrors the server-side /EvaluateBatch splitting)
        sizes = self._input_sizes_cached(config)
        rows = []
        for t in thetas:
            out = self(split_blocks(t, sizes), config)
            rows.append(np.concatenate([np.asarray(blk, float) for blk in out]))
        return np.asarray(rows)

    def _input_sizes_cached(self, config) -> list[int]:
        ck = config_key(config)
        if ck not in self._sizes_cache:
            self._sizes_cache[ck] = self._rpc(
                "/InputSizes", {"name": self.name, "config": config or {}}
            )["inputSizes"]
        return self._sizes_cache[ck]

    def gradient(self, out_wrt, in_wrt, parameters, sens, config=None):
        body = {
            "name": self.name, "outWrt": out_wrt, "inWrt": in_wrt,
            "input": [list(map(float, p)) for p in parameters],
            "sens": list(map(float, sens)), "config": config or {},
        }
        return self._rpc("/Gradient", body)["output"]

    def gradient_batch(self, thetas, senss, config=None) -> np.ndarray:
        """[N, n] x [N, m] -> [N, n] in ONE `/GradientBatch` round-trip,
        degrading per the negotiated capability set: batched route ->
        per-point `/Gradient` loop -> finite-difference fallback over
        `/EvaluateBatch` when the server has no gradient at all."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        senss = np.atleast_2d(np.asarray(senss, float))
        if self._grad_batch_supported is not False:
            body = {
                "name": self.name,
                "inputs": [list(map(float, t)) for t in thetas],
                "senss": [list(map(float, s)) for s in senss],
                "config": config or {},
            }
            try:
                out = self._rpc("/GradientBatch", body)
                self._grad_batch_supported = True
                return np.asarray(out["outputs"], float)
            except RuntimeError as e:
                if not any(k in str(e) for k in ("NotFound", "UnsupportedFeature")):
                    raise
                self._grad_batch_supported = False
        if not self._caps.op_supported("gradient"):
            return self._fd_gradient_batch(thetas, senss, config)
        # per-point /Gradient loop == the base class's gradient delegation
        return Model.gradient_batch(self, thetas, senss, config)

    def apply_jacobian(self, out_wrt, in_wrt, parameters, vec, config=None):
        body = {
            "name": self.name, "outWrt": out_wrt, "inWrt": in_wrt,
            "input": [list(map(float, p)) for p in parameters],
            "vec": list(map(float, vec)), "config": config or {},
        }
        return self._rpc("/ApplyJacobian", body)["output"]

    def apply_jacobian_batch(self, thetas, vecs, config=None) -> np.ndarray:
        """[N, n] x [N, n] -> [N, m]: one `/ApplyJacobianBatch` round-trip,
        with the same capability-negotiated degradation as `gradient_batch`."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        vecs = np.atleast_2d(np.asarray(vecs, float))
        if self._jvp_batch_supported is not False:
            body = {
                "name": self.name,
                "inputs": [list(map(float, t)) for t in thetas],
                "vecs": [list(map(float, v)) for v in vecs],
                "config": config or {},
            }
            try:
                out = self._rpc("/ApplyJacobianBatch", body)
                self._jvp_batch_supported = True
                return np.asarray(out["outputs"], float)
            except RuntimeError as e:
                if not any(k in str(e) for k in ("NotFound", "UnsupportedFeature")):
                    raise
                self._jvp_batch_supported = False
        if not self._caps.op_supported("apply_jacobian"):
            return self._fd_apply_jacobian_batch(thetas, vecs, config)
        # per-point /ApplyJacobian loop == the base class's delegation
        return Model.apply_jacobian_batch(self, thetas, vecs, config)

    def apply_hessian(self, out_wrt, in_wrt1, in_wrt2, parameters, sens, vec, config=None):
        body = {
            "name": self.name, "outWrt": out_wrt, "inWrt1": in_wrt1, "inWrt2": in_wrt2,
            "input": [list(map(float, p)) for p in parameters],
            "sens": list(map(float, sens)), "vec": list(map(float, vec)),
            "config": config or {},
        }
        return self._rpc("/ApplyHessian", body)["output"]

    def apply_hessian_batch(self, thetas, senss, vecs, config=None) -> np.ndarray:
        """[N, n] x [N, m] x [N, n] -> [N, n]: one `/ApplyHessianBatch`
        round-trip, degrading per the negotiated capability set like
        `gradient_batch`: batched route -> per-point `/ApplyHessian` loop.
        There is NO finite-difference rung below that (second differences
        of a float32 solver are noise) — a server with no Hessian at all
        raises `UnsupportedCapability` explicitly instead of silently
        looping N per-point round-trips that will each fail."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        senss = np.atleast_2d(np.asarray(senss, float))
        vecs = np.atleast_2d(np.asarray(vecs, float))
        if not self._caps.op_supported("apply_hessian"):
            from repro_torch.core.interface import UnsupportedCapability

            raise UnsupportedCapability(
                f"server {self.url!r} advertises no apply_hessian capability"
            )
        if self._hvp_batch_supported is not False:
            body = {
                "name": self.name,
                "inputs": [list(map(float, t)) for t in thetas],
                "senss": [list(map(float, s)) for s in senss],
                "vecs": [list(map(float, v)) for v in vecs],
                "config": config or {},
            }
            try:
                out = self._rpc("/ApplyHessianBatch", body)
                self._hvp_batch_supported = True
                return np.asarray(out["outputs"], float)
            except RuntimeError as e:
                if not any(k in str(e) for k in ("NotFound", "UnsupportedFeature")):
                    raise
                self._hvp_batch_supported = False
        # per-point /ApplyHessian loop == the base class's delegation
        return Model.apply_hessian_batch(self, thetas, senss, vecs, config)
