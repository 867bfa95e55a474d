"""UM-Bridge HTTP model server (stdlib http.server — paper §2.4.2).

`serve_models([model], port)` mirrors umbridge.serve_models; the threaded
variant is used by tests and by `ThreadedPool`-over-HTTP setups to emulate
the paper's k8s pods on one host. Beyond protocol 1.0 it serves the batched
extensions used by the EvaluationFabric backends — `/EvaluateBatch`,
`/GradientBatch`, `/ApplyJacobianBatch` and `/ApplyHessianBatch` (N points /
VJPs / JVPs / HVPs per round-trip) — and a GET `/Health` liveness probe used by
`repro_torch.core.client.register_servers` when enrolling a cluster of servers
behind a `FabricRouter`. `/ModelInfo` advertises each model's full
`Capabilities` descriptor, so clients negotiate the operation surface once
instead of probing endpoints; requests for an unadvertised capability answer
`UnsupportedFeature` (HTTP 400).

Port of `repro.core.server`, route for route: a client of either package
talks to a server of either. The server is device-agnostic: the model it
serves picks its device (a port model runs on the GPU unless it was built
with `device="cpu"`), and a model exception, a CUDA fault included, answers
HTTP 400 `ModelError` and counts in `stats["errors"]` (`/Health`).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.analysis.races import named_lock
from repro_torch.core.interface import Model, model_capabilities
from repro_torch.core.protocol import (
    PROTOCOL_VERSION,
    error_body,
    validate_batched_pair_request,
    validate_evaluate_batch_request,
    validate_evaluate_request,
)


def _make_handler(models: dict[str, Model]):
    # ThreadingHTTPServer runs one handler thread per connection; the
    # request counters below are the server's shared state and follow the
    # same lock discipline the fabric telemetry does
    stats = {"requests": 0, "errors": 0}
    # per-tenant accounting keyed on the X-UQ-Tenant request header (the
    # service tier's identity on the wire): requests and model-evaluation
    # points, served back on GET /Tenants
    tenant_stats: dict[str, dict] = {}
    stats_lock = named_lock("server.stats")

    def _tenant_note(tenant: str | None, points: int):
        if tenant is None:
            return
        with stats_lock:
            bucket = tenant_stats.setdefault(
                tenant, {"requests": 0, "points": 0}
            )
            bucket["requests"] += 1
            bucket["points"] += int(points)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # silence
            pass

        def _send(self, obj, code: int = 200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            if self.path.rstrip("/") in ("", "/Info".rstrip("/"), "/Info"):
                self._send({"protocolVersion": PROTOCOL_VERSION, "models": list(models)})
            elif self.path.rstrip("/") == "/Health":
                # liveness probe for multi-server registration: routers ping
                # this before enrolling a server in the backend cluster
                with stats_lock:
                    snap = dict(stats)
                caps = {name: model_capabilities(m) for name, m in models.items()}
                self._send(
                    {
                        "status": "ok",
                        "protocolVersion": PROTOCOL_VERSION,
                        "models": list(models),
                        # legacy key (pre-capability clients read it)
                        "batch": {n: c.evaluate_batch for n, c in caps.items()},
                        "capabilities": {n: c.to_json() for n, c in caps.items()},
                        "stats": snap,
                    }
                )
            elif self.path.rstrip("/") == "/Tenants":
                # per-tenant request/point accounting for the service tier —
                # who is hitting this server, and how hard
                with stats_lock:
                    snap = {k: dict(v) for k, v in tenant_stats.items()}
                self._send({"tenants": snap})
            else:
                self._send(error_body("NotFound", self.path), 404)

        def do_POST(self):  # noqa: N802
            with stats_lock:
                stats["requests"] += 1
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                return self._send(error_body("BadRequest", str(e)), 400)
            name = body.get("name")
            model = models.get(name)
            if model is None:
                return self._send(error_body("ModelNotFound", str(name)), 400)
            # tenant accounting: one request, plus however many points the
            # batched routes carry (per-point routes count one)
            inputs = body.get("inputs")
            _tenant_note(
                self.headers.get("X-UQ-Tenant"),
                len(inputs) if isinstance(inputs, list)
                else (1 if "input" in body else 0),
            )
            config = body.get("config") or {}
            caps = model_capabilities(model, config)
            try:
                if self.path == "/InputSizes":
                    return self._send({"inputSizes": model.get_input_sizes(config)})
                if self.path == "/OutputSizes":
                    return self._send({"outputSizes": model.get_output_sizes(config)})
                if self.path == "/ModelInfo":
                    return self._send({"support": caps.to_json()})
                if self.path == "/Evaluate":
                    if not caps.evaluate:
                        return self._send(error_body("UnsupportedFeature", "Evaluate"), 400)
                    err = validate_evaluate_request(body, model.get_input_sizes(config))
                    if err:
                        return self._send(error_body("InvalidInput", err), 400)
                    out = model(body["input"], config)
                    return self._send({"output": [list(map(float, v)) for v in out]})
                if self.path == "/EvaluateBatch":
                    if not caps.evaluate:
                        return self._send(error_body("UnsupportedFeature", "Evaluate"), 400)
                    sizes = model.get_input_sizes(config)
                    err = validate_evaluate_batch_request(body, sizes)
                    if err:
                        return self._send(error_body("InvalidInput", err), 400)
                    inputs = body["inputs"]
                    # `Model.evaluate_batch` handles both the native batched
                    # program and the per-point fallback (multi-block safe)
                    outs = np.atleast_2d(
                        model.evaluate_batch(np.asarray(inputs, float), config)
                    )
                    return self._send(
                        {"outputs": [list(map(float, row)) for row in outs]}
                    )
                if self.path == "/Gradient":
                    if not caps.op_supported("gradient"):
                        return self._send(error_body("UnsupportedFeature", "Gradient"), 400)
                    out = model.gradient(
                        body["outWrt"], body["inWrt"], body["input"], body["sens"], config
                    )
                    return self._send({"output": list(map(float, out))})
                if self.path == "/GradientBatch":
                    # batched VJP wave; a model advertising only the
                    # per-point form still serves it (base-class loop) —
                    # the CLIENT saves the round-trips either way
                    if not caps.op_supported("gradient"):
                        return self._send(error_body("UnsupportedFeature", "Gradient"), 400)
                    err = validate_batched_pair_request(
                        body, model.get_input_sizes(config), "senss",
                        sum(model.get_output_sizes(config)),
                    )
                    if err:
                        return self._send(error_body("InvalidInput", err), 400)
                    outs = np.atleast_2d(model.gradient_batch(
                        np.asarray(body["inputs"], float),
                        np.asarray(body["senss"], float), config,
                    ))
                    return self._send(
                        {"outputs": [list(map(float, row)) for row in outs]}
                    )
                if self.path == "/ApplyJacobian":
                    if not caps.op_supported("apply_jacobian"):
                        return self._send(
                            error_body("UnsupportedFeature", "ApplyJacobian"), 400
                        )
                    out = model.apply_jacobian(
                        body["outWrt"], body["inWrt"], body["input"], body["vec"], config
                    )
                    return self._send({"output": list(map(float, out))})
                if self.path == "/ApplyJacobianBatch":
                    if not caps.op_supported("apply_jacobian"):
                        return self._send(
                            error_body("UnsupportedFeature", "ApplyJacobian"), 400
                        )
                    err = validate_batched_pair_request(
                        body, model.get_input_sizes(config), "vecs",
                        sum(model.get_input_sizes(config)),
                    )
                    if err:
                        return self._send(error_body("InvalidInput", err), 400)
                    outs = np.atleast_2d(model.apply_jacobian_batch(
                        np.asarray(body["inputs"], float),
                        np.asarray(body["vecs"], float), config,
                    ))
                    return self._send(
                        {"outputs": [list(map(float, row)) for row in outs]}
                    )
                if self.path == "/ApplyHessian":
                    if not caps.op_supported("apply_hessian"):
                        return self._send(
                            error_body("UnsupportedFeature", "ApplyHessian"), 400
                        )
                    out = model.apply_hessian(
                        body["outWrt"], body["inWrt1"], body["inWrt2"],
                        body["input"], body["sens"], body["vec"], config,
                    )
                    return self._send({"output": list(map(float, out))})
                if self.path == "/ApplyHessianBatch":
                    # batched HVP wave (senss AND vecs ride one request);
                    # like /GradientBatch, a model advertising only the
                    # per-point form still serves it via the base-class loop
                    if not caps.op_supported("apply_hessian"):
                        return self._send(
                            error_body("UnsupportedFeature", "ApplyHessian"), 400
                        )
                    in_sizes = model.get_input_sizes(config)
                    err = validate_batched_pair_request(
                        body, in_sizes, "senss",
                        sum(model.get_output_sizes(config)),
                    ) or validate_batched_pair_request(
                        body, in_sizes, "vecs", sum(in_sizes),
                    )
                    if err:
                        return self._send(error_body("InvalidInput", err), 400)
                    outs = np.atleast_2d(model.apply_hessian_batch(
                        np.asarray(body["inputs"], float),
                        np.asarray(body["senss"], float),
                        np.asarray(body["vecs"], float), config,
                    ))
                    return self._send(
                        {"outputs": [list(map(float, row)) for row in outs]}
                    )
                return self._send(error_body("NotFound", self.path), 404)
            except Exception as e:  # noqa: BLE001
                with stats_lock:
                    stats["errors"] += 1
                return self._send(error_body("ModelError", repr(e)), 400)

    return Handler


def serve_models(models: list[Model], port: int = 4242, background: bool = False):
    """Blocking by default (like umbridge.serve_models); background=True
    returns (server, thread) for tests."""
    by_name = {m.name: m for m in models}
    server = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(by_name))
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server, t
    server.serve_forever()
    return server, None
