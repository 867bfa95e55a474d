"""EvaluationFabric — ONE dispatch layer between UQ drivers and model pools.

The paper's architecture (§3) puts a load balancer between prototype-grade UQ
code and a cluster of model instances so that the UQ side stays oblivious to
where and how evaluations run. This repo historically had three uncoordinated
evaluation paths (SPMD `ModelPool`, HAProxy-style `ThreadedPool`, per-point
`BatchingExecutor`) that every driver wired up by hand. The fabric unifies
them behind one async-capable API:

    fabric = EvaluationFabric(backend)      # pool / model / url(s) / callable
    fut  = fabric.submit(theta, config)     # per-point, batched transparently
    ys   = fabric.evaluate_batch(thetas, config)  # vectorized fast path
    gs   = fabric.gradient_batch(thetas, senss, config)   # batched VJP wave
    ys, gs = fabric.value_and_gradient_batch(thetas, sens_fn, config)

with

  * pluggable backends — SPMD `ModelPool`, `ThreadedPool`, `HTTPModel`
    fan-out over several servers (one `/EvaluateBatch` round-trip each),
    any UM-Bridge `Model`, or a plain batched callable;
  * CAPABILITY-TYPED dispatch — every backend advertises a `Capabilities`
    descriptor (evaluate / gradient / apply_jacobian / apply_hessian, each
    with a batched variant); derivative waves route only to backends that
    advertise the capability, and asking an evaluate-only fabric for a
    gradient raises `UnsupportedCapability` up front instead of failing
    mid-wave;
  * heterogeneous clusters — a LIST of backends becomes a `FabricRouter`:
    latency-aware weighted dispatch (EWMA service time, join-shortest-queue
    tie-break) with per-backend failure backoff and retry-on-another-backend,
    so mixed threaded/HTTP resources serve one fabric — and a stolen
    gradient shard only lands on another gradient-capable backend;
  * adaptive batching — per-point submits are packed into waves; the linger
    window and max wave size self-tune from observed wave latency;
  * an LRU result cache NAMESPACED PER CAPABILITY — keys carry the operation
    plus its extra operand (sens/vec), so a gradient at theta never serves
    an evaluate at theta (and vice versa); dedupes the repeated coarse-level
    evaluations MLDA/DA subchains generate and coalesces identical in-flight
    requests into one backend call;
  * a TRAINING TAP (`record_observer`) — every completed backend dispatch
    streams its freshly computed (theta, output) rows to registered
    observers exactly once (cache hits and coalesced waiters are never
    replayed), so online surrogates (`uq.surrogate.SurrogateStore`) train
    from traffic the sampler already paid for, with zero extra evaluations;
  * per-backend telemetry — waves, points, padding waste, busy fraction,
    cache hits, and a per-capability wave/point split — so benchmarks can
    report the paper's efficiency numbers and gradient-sampler economics.

Every UQ driver (`run_chains`, `mlda`, `cub_qmc_sobol`, sparse grids, and the
gradient-based `ensemble_mala`/`ensemble_hmc`) accepts a fabric wherever it
accepted a bare callable.
"""
from __future__ import annotations

import inspect
import threading
import time
import warnings
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Callable, Sequence

import numpy as np

from repro_torch.analysis.races import named_condition, named_lock
from repro_torch.core.interface import (
    Capabilities,
    Model,
    TorchModel,
    UnsupportedCapability,
    model_capabilities,
    next_pow2,
    pad_to_bucket,
)
from repro_torch.core.pool import ModelPool, ThreadedPool
from repro_torch.core.protocol import config_key, split_blocks

#: capability families a fabric wave can carry; "value_and_gradient" is the
#: fused forward+VJP wave (an in-process optimization of the gradient
#: family — it needs no wire capability of its own); "apply_hessian" is the
#: batched HVP wave, whose second operand is the (senss, vecs) PAIR
WAVE_OPS = (
    "evaluate", "gradient", "apply_jacobian", "value_and_gradient",
    "apply_hessian",
)

#: per-tenant accounting bucket layout (`stats["per_tenant"]`): integer
#: counters plus backend-seconds. `shared_hits_taken` counts cache rows a
#: tenant read that ANOTHER tenant paid for (opt-in shared namespace only);
#: `shared_hits_given` is the payer's mirror of the same event.
_TENANT_COUNTERS = (
    "waves", "points", "cache_hits", "cache_misses", "coalesced",
    "shared_hits_taken", "shared_hits_given",
)


class Overloaded(RuntimeError):
    """Admission control rejected the request: the tenant's queue or
    inflight quota (or the service-wide queue cap) is full. Explicit
    backpressure — callers back off or shed work instead of piling latency
    onto every other tenant."""

    def __init__(self, tenant: str, reason: str):
        super().__init__(f"tenant {tenant!r} overloaded: {reason}")
        self.tenant = tenant
        self.reason = reason


class BudgetExhausted(RuntimeError):
    """A campaign's evaluation budget is spent. Samplers catch this, land a
    final checkpoint at the current step boundary, and return their partial
    result with ``terminated="budget"`` — a budget stop is a clean stop,
    never a corrupted one."""

    def __init__(self, campaign_id: str, budget: int, requested: int, charged: int):
        super().__init__(
            f"campaign {campaign_id!r} budget exhausted: "
            f"{charged}/{budget} points charged, {requested} more requested"
        )
        self.campaign_id = campaign_id
        self.budget = budget
        self.requested = requested
        self.charged = charged


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class FabricBackend:
    """A batched evaluation target: [N, n] -> [N, m] under one config, plus
    optional derivative waves, advertised through `capabilities()`."""

    name = "backend"
    n_instances = 1
    #: True when the backend can serve a fused value+gradient wave in ONE
    #: dispatch (in-process AD models); the fabric otherwise splits fused
    #: requests into an evaluate wave and a gradient wave
    fused_value_grad = False

    def capabilities(self) -> Capabilities:
        # every backend is a batched evaluation target by construction
        return Capabilities(evaluate=True, evaluate_batch=True)

    def evaluate(self, thetas: np.ndarray, config: dict | None) -> np.ndarray:
        raise NotImplementedError

    def dispatch(self, op: str, thetas: np.ndarray, extra, config: dict | None):
        """Run one wave of capability `op`. `extra` is the second operand:
        None (evaluate), senss [N, m] (gradient), vecs [N, n]
        (apply_jacobian), a per-row sens_fn callable (value_and_gradient,
        returning the (ys, grads) pair), or the (senss [N, m], vecs [N, n])
        tuple (apply_hessian)."""
        if op == "evaluate":
            return self.evaluate(thetas, config)
        raise UnsupportedCapability(
            f"{self.name!r} backend advertises no {op!r} capability"
        )

    def stats(self) -> dict:
        return {}

    def close(self):
        pass


class CallableBackend(FabricBackend):
    """Wraps a plain batched callable f([N, n]) -> [N, m] (config-aware if it
    takes a second positional argument). Evaluate-only by construction."""

    name = "callable"

    def __init__(self, fn: Callable, n_instances: int = 1):
        self.fn = fn
        self.n_instances = n_instances
        try:
            params = list(inspect.signature(fn).parameters.values())
            positional = [
                p for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            ]
            # pass config only when the callable asks for it: a second
            # REQUIRED positional, one literally named 'config', or *args —
            # defaulted params like `scale=1.0` must not silently receive it
            required = [p for p in positional if p.default is p.empty]
            self._takes_config = (
                len(required) >= 2
                or any(p.name == "config" for p in positional[1:])
                or any(p.kind == p.VAR_POSITIONAL for p in params)
            )
        except (TypeError, ValueError):
            self._takes_config = False
        self._calls = 0

    def evaluate(self, thetas, config):
        self._calls += 1
        out = self.fn(thetas, config) if self._takes_config else self.fn(thetas)
        return np.atleast_2d(np.asarray(out))

    def stats(self):
        return {"kind": self.name, "calls": self._calls}


class ThreadedBackend(FabricBackend):
    """The host-side HAProxy path: per-point dispatch to N worker threads.
    Evaluate-only — single-tenant instances hold one *evaluation* in flight;
    derivative waves belong on AD-capable backends."""

    name = "threaded"

    def __init__(self, pool: ThreadedPool):
        self.pool = pool
        self.n_instances = len(pool.instances)

    def evaluate(self, thetas, config):
        return self.pool.evaluate(thetas, config)

    def stats(self):
        s = {k: v for k, v in self.pool.stats.items() if k != "busy_s"}
        busy = self.pool.stats.get("busy_s", [])
        s["busy_s"] = round(float(np.sum(busy)), 4)
        s["kind"] = self.name
        return s

    def close(self):
        self.pool.shutdown()


class ModelBackend(FabricBackend):
    """Any UM-Bridge `Model`. Models whose `Capabilities` advertise
    `evaluate_batch` get whole waves as ONE native dispatch (vmapped program
    / single `/EvaluateBatch` round-trip), with power-of-2 shape bucketing
    when the model jits over the batch axis (`batch_bucket`) so its trace
    cache stays bounded. Everything else goes through the per-point
    `evaluate_batch` fallback inherited from `Model` — telemetry
    distinguishes the two, so benchmarks can prove no wave shattered into
    per-point calls. Derivative waves (`gradient`, `apply_jacobian`, fused
    `value_and_gradient`) dispatch to the model's batched derivative surface
    when its capability set advertises the family."""

    name = "model"

    def __init__(self, model: Model):
        self.model = model
        self.caps = model_capabilities(model)
        self.native = self.caps.evaluate_batch
        # several fabrics (or a fabric's collector plus direct batch calls)
        # can dispatch onto one backend concurrently; the counters are shared
        self._lock = named_lock("model_backend.stats")
        self._stats = {
            "native_batches": 0,
            "native_points": 0,
            "fallback_points": 0,
            "padded": 0,
        }
        self._op_stats: dict[str, int] = {}

    def capabilities(self) -> Capabilities:
        return self.caps

    @property
    def fused_value_grad(self) -> bool:
        # any in-process Model can run the host-side sens_fn callback; fused
        # still requires the gradient family so the VJP half is real
        return self.caps.op_supported("gradient") and hasattr(
            self.model, "value_and_gradient_batch"
        )

    def evaluate(self, thetas, config):
        thetas = np.atleast_2d(np.asarray(thetas, float))
        N = len(thetas)
        if self.native:
            pad = 0
            if getattr(self.model, "batch_bucket", False):
                thetas, pad = pad_to_bucket(thetas, next_pow2(N))
            out = np.atleast_2d(np.asarray(self.model.evaluate_batch(thetas, config)))
            with self._lock:
                self._stats["native_batches"] += 1
                self._stats["native_points"] += N
                self._stats["padded"] += pad
            return out[:N]
        if hasattr(self.model, "evaluate_batch"):
            with self._lock:
                self._stats["fallback_points"] += N
            return np.atleast_2d(np.asarray(self.model.evaluate_batch(thetas, config)))
        # duck-typed models outside the Model hierarchy: un-flatten each
        # theta into input blocks and re-flatten all output blocks.
        # DEPRECATED dispatch pathway (one release of back-compat): shattering
        # a wave into bare per-point `__call__`s defeats the wave economics —
        # implement `evaluate_batch` (the base class provides the loop).
        warnings.warn(
            "dispatching a wave through bare Model.__call__ per-point calls "
            "is deprecated; give the model an evaluate_batch / Capabilities "
            "surface instead",
            DeprecationWarning,
            stacklevel=2,
        )
        with self._lock:
            self._stats["fallback_points"] += N
        sizes = self.model.get_input_sizes(config)
        rows = []
        # repro-lint: allow wave — deprecated per-point back-compat path for
        # duck-typed models outside the Model hierarchy (warned above)
        for t in thetas:
            out = self.model(split_blocks(t, sizes), config)
            rows.append(np.concatenate([np.asarray(blk, float).ravel() for blk in out]))
        return np.asarray(rows)

    def dispatch(self, op, thetas, extra, config):
        if op == "evaluate":
            return self.evaluate(thetas, config)
        if not _backend_op_ok(self, op):
            raise UnsupportedCapability(
                f"model {getattr(self.model, 'name', '?')!r} advertises no {op!r}"
            )
        with self._lock:
            self._op_stats[op] = self._op_stats.get(op, 0) + 1
        if op == "gradient":
            return np.atleast_2d(np.asarray(
                self.model.gradient_batch(thetas, extra, config), float
            ))
        if op == "apply_jacobian":
            return np.atleast_2d(np.asarray(
                self.model.apply_jacobian_batch(thetas, extra, config), float
            ))
        if op == "value_and_gradient":
            ys, gs = self.model.value_and_gradient_batch(thetas, extra, config)
            return np.atleast_2d(np.asarray(ys, float)), np.atleast_2d(np.asarray(gs, float))
        if op == "apply_hessian":
            senss, vecs = extra
            return np.atleast_2d(np.asarray(
                self.model.apply_hessian_batch(thetas, senss, vecs, config), float
            ))
        raise UnsupportedCapability(op)

    def stats(self):
        with self._lock:
            snap = dict(self._stats)
            op_snap = dict(self._op_stats)
        s = {"kind": self.name, "model": getattr(self.model, "name", "?"),
             "native": self.native, **snap}
        if op_snap:
            s["derivative_waves"] = op_snap
        rt = getattr(self.model, "round_trips", None)
        if rt is not None:
            s["round_trips"] = rt
        return s


class SPMDBackend(ModelBackend):
    """The device path: one `ModelPool` wave per fabric wave, `n_instances`
    the pool's (`ctx.n_data` on a mesh). Derivative waves go straight to
    the pooled model's batched derivative programs (for a `TorchModel`, its
    vmapped VJP/JVP/HVP: one program a wave), as `ModelBackend` dispatches
    them — NOTE they are not yet mesh-sharded like evaluate waves and skip
    the pool's instance-multiple padding, so on a multi-rank ctx mesh every
    rank runs the whole gradient wave on its own device (per-capability
    sharding is a ROADMAP item), as in the JAX package."""

    name = "spmd"

    def __init__(self, pool: ModelPool):
        super().__init__(pool.model)
        self.pool = pool
        self.n_instances = pool.n_instances

    def evaluate(self, thetas, config):
        return self.pool.evaluate(thetas, config)

    def stats(self):
        s = {**self.pool.stats, "kind": self.name}
        with self._lock:
            if self._op_stats:
                s["derivative_waves"] = dict(self._op_stats)
        return s


class HTTPBackend(FabricBackend):
    """Fan a wave out over several UM-Bridge servers: the batch is split into
    contiguous chunks, one `/EvaluateBatch` (or `/GradientBatch` /
    `/ApplyJacobianBatch`) round-trip per server (the paper's k8s replicas,
    minus one round-trip per *point*). The advertised capability set is the
    INTERSECTION over the clients' — a wave must be servable by every server
    it may shard onto."""

    name = "http"

    def __init__(self, clients: Sequence):
        from repro_torch.core.client import HTTPModel

        self.clients = [
            c if isinstance(c, Model) else HTTPModel(str(c)) for c in clients
        ]
        self.n_instances = len(self.clients)
        caps = model_capabilities(self.clients[0])
        for c in self.clients[1:]:
            caps = caps.intersection(model_capabilities(c))
        self._caps = caps
        self._ex = ThreadPoolExecutor(max_workers=self.n_instances)

    def capabilities(self) -> Capabilities:
        return self._caps

    def _fan_out(self, thetas, call):
        thetas = np.atleast_2d(np.asarray(thetas, float))
        k = min(self.n_instances, len(thetas))
        chunks = np.array_split(np.arange(len(thetas)), k)
        futs = [self._ex.submit(call, self.clients[i], idx) for i, idx in enumerate(chunks)]
        return np.concatenate([np.atleast_2d(f.result()) for f in futs], axis=0)

    def evaluate(self, thetas, config):
        thetas = np.atleast_2d(np.asarray(thetas, float))
        return self._fan_out(
            thetas, lambda c, idx: c.evaluate_batch(thetas[idx], config)
        )

    def dispatch(self, op, thetas, extra, config):
        if op == "evaluate":
            return self.evaluate(thetas, config)
        if not _backend_op_ok(self, op):
            raise UnsupportedCapability(f"http backend: servers advertise no {op!r}")
        thetas = np.atleast_2d(np.asarray(thetas, float))
        if op == "apply_hessian":
            senss = np.atleast_2d(np.asarray(extra[0], float))
            vecs = np.atleast_2d(np.asarray(extra[1], float))
            return self._fan_out(
                thetas,
                lambda c, idx: c.apply_hessian_batch(
                    thetas[idx], senss[idx], vecs[idx], config
                ),
            )
        extra = np.atleast_2d(np.asarray(extra, float))
        if op == "gradient":
            return self._fan_out(
                thetas, lambda c, idx: c.gradient_batch(thetas[idx], extra[idx], config)
            )
        if op == "apply_jacobian":
            return self._fan_out(
                thetas,
                lambda c, idx: c.apply_jacobian_batch(thetas[idx], extra[idx], config),
            )
        raise UnsupportedCapability(op)

    def stats(self):
        return {
            "kind": self.name,
            "round_trips": int(
                sum(getattr(c, "round_trips", 0) for c in self.clients)
            ),
        }

    def close(self):
        self._ex.shutdown(wait=False)


def _backend_op_ok(backend: FabricBackend, op: str) -> bool:
    """Can `backend` serve a wave of capability family `op`?"""
    if op not in WAVE_OPS:
        raise ValueError(f"unknown wave capability {op!r}; one of {WAVE_OPS}")
    if op == "evaluate":
        return True  # every fabric backend is an evaluation target
    if op == "value_and_gradient":
        return bool(getattr(backend, "fused_value_grad", False))
    return backend.capabilities().op_supported(op)


class FabricRouter(FabricBackend):
    """Latency-aware load balancer over N heterogeneous backends.

    The paper's §3 load balancer fronts a *cluster of model instances*; Loi,
    Wille & Reinarz show that on uneven resources the balancing must be
    dynamic — a static split wastes the fast instances waiting on the slow
    ones. The router implements that for whole fabric waves:

      * **weighted routing** — each backend carries an EWMA of its observed
        per-point service time PER CAPABILITY; a wave of N points is split
        proportionally to the estimated throughput for that wave's op, so a
        backend that is 4x slower receives ~1/4 the points and every shard
        finishes together;
      * **join-shortest-queue tie-break** — leftover points (and whole waves
        smaller than the backend count) go to the backend with the lowest
        projected queue-time `(inflight + assigned) / throughput`;
      * **capability-aware planning** — a wave of capability `op` only plans
        over (and only STEALS onto) backends whose `Capabilities` advertise
        that family; a gradient wave never lands on an evaluate-only backend,
        and a cluster with no gradient-capable member refuses the wave with
        `UnsupportedCapability` instead of failing inside it;
      * **failure backoff + steal** — a backend that raises mid-wave is put
        on exponential backoff and its shard is re-dispatched to another
        ELIGIBLE backend (a "steal"); the wave completes as long as one
        capable backend lives;
      * **config bindings** — `bind(config, [i, j])` restricts waves carrying
        that config to a backend subset (MLDA binds `{"level": l}` to the
        sub-cluster sized for level l);
      * **dynamic lifecycle** — `add_backend` enrolls a new backend mid-run
        (router weight/EWMA/backoff state is extended under the router
        lock; the newcomer starts with the optimistic unknown-EWMA probe),
        `drain_backend` stops planning new waves onto a member while its
        in-flight shards complete, `remove_backend` drains and retires it,
        and `reinstate_backend` returns a drained/retired member to service
        with its failure state cleared — the `core.fleet.FleetManager`
        drives these from telemetry to grow/shrink the fleet under load and
        re-enroll backends that died and came back (health probation);
      * **speculative re-dispatch** — with `spec_factor` set, a shard still
        running past `spec_factor x` its EWMA-predicted wall time is
        DUPLICATED onto the fastest idle eligible backend and the first
        result wins (`ThreadedPool`'s per-request straggler respawn, lifted
        across backends). Duplication happens strictly below the fabric
        cache/tap layer: the wave still returns exactly one row per theta
        and training observers fire exactly once per computed row, so the
        `tap_exactly_once` invariant holds under speculation;
      * **telemetry** — per-backend share / points / failures / EWMA, steal
        count, per-capability wave counts (`op_waves`), and the wave
        imbalance factor (actual wave wall time over the ideal
        perfectly-balanced wall time; 1.0 = no straggling, round-robin over
        a 4x-slower backend gives ~2.5).

    `policy="round_robin"` disables the latency weighting (even split in
    cursor order) — kept as the explicit baseline benchmarks compare against.

    Service-time estimates are kept PER (backend, capability): a gradient
    point costs ~3x an evaluate point, so one blended EWMA (the original
    design) let gradient waves poison the evaluate split and mis-arm the
    speculation deadline under mixed traffic. Weighted dispatch, steal
    planning and `_spec_deadline_s` all consult the op-specific estimate;
    an op with no samples yet on a backend falls back to that backend's
    blended estimate (still maintained, and what old checkpoints seed).
    """

    name = "router"

    #: cap on the failure-backoff exponent: the backoff ceiling
    #: (`backoff_max_s`) is reached long before this, and an unbounded
    #: `2 ** streak` overflows float once a dead backend has failed a few
    #: hundred steals in a row — which used to fail the SHARD instead of
    #: stealing it
    BACKOFF_EXP_CAP = 16

    def __init__(
        self,
        backends: Sequence,
        *,
        policy: str = "latency",
        backoff_s: float = 0.25,
        backoff_max_s: float = 30.0,
        spec_factor: float | None = None,
        spec_min_s: float = 0.05,
    ):
        self.backends = [as_backend(b) for b in backends]
        if not self.backends:
            raise ValueError("FabricRouter needs at least one backend")
        if policy not in ("latency", "round_robin"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.policy = policy
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        #: speculative re-dispatch: a shard running past
        #: `spec_factor * ewma * n_points` (never less than `spec_min_s`)
        #: is duplicated onto the fastest idle eligible backend,
        #: first-result-wins; None disables speculation
        self.spec_factor = None if spec_factor is None else float(spec_factor)
        self.spec_min_s = float(spec_min_s)
        self.n_instances = sum(b.n_instances for b in self.backends)
        B = len(self.backends)
        self._lock = named_lock("router")
        self._ex = ThreadPoolExecutor(max_workers=max(8, 4 * B))
        #: blended per-POINT service time (every op folded in) — the
        #: fallback estimate for ops a backend has not served yet, and the
        #: back-compat value old checkpoints carry
        self._ewma_s: list[float | None] = [None] * B
        #: per-(backend, capability) per-point service time: the estimate
        #: weighted dispatch / steals / speculation actually consult, so
        #: ~3x-costlier gradient waves stop skewing the evaluate split
        self._ewma_op_s: list[dict[str, float]] = [{} for _ in range(B)]
        self._inflight = [0] * B
        self._fail_streak = [0] * B
        self._backoff_until = [0.0] * B
        #: per-backend lifecycle: "live" -> planned onto; "draining" ->
        #: in-flight shards finish, no new planning; "retired" -> out of
        #: service (indices stay stable so bindings/telemetry never shift)
        self._admin: list[str] = ["live"] * B
        self._bindings: dict[tuple, tuple[int, ...]] = {}
        self._rr = 0  # round-robin cursor
        self.router_stats = self._fresh_stats()

    def _in_service(self) -> list[int]:  # caller holds the lock
        return [i for i, a in enumerate(self._admin) if a == "live"]

    def capabilities(self) -> Capabilities:
        """UNION over the in-service cluster — an op is advertised when at
        least one live member can serve it (planning restricts each wave to
        that subset). Falls back to the full member list when everything is
        drained, so negotiation stays possible while a fleet resizes."""
        with self._lock:
            idx = self._in_service() or list(range(len(self.backends)))
            members = [self.backends[i] for i in idx]
        caps = members[0].capabilities()
        for b in members[1:]:
            caps = caps.union(b.capabilities())
        return caps

    @property
    def fused_value_grad(self) -> bool:
        return any(getattr(b, "fused_value_grad", False) for b in self.backends)

    def _fresh_stats(self) -> dict:
        B = len(self.backends)
        return {
            "waves": 0,
            "points": [0] * B,
            "waves_per_backend": [0] * B,
            "failures": [0] * B,
            "steals": 0,
            # speculative re-dispatch economics: duplicates launched, and
            # how many beat their primary to the finish line
            "spec_dispatches": 0,
            "spec_wins": 0,
            "op_waves": {},
            "last_imbalance": None,
            "imbalance_ewma": None,
        }

    # -- dynamic backend lifecycle -------------------------------------------
    def add_backend(self, obj) -> int:
        """Enroll a new backend mid-run and return its (stable) index.

        All router state — EWMA, inflight, failure/backoff, admin, traffic
        counters — is extended under the router lock, so waves planned
        concurrently see either the old fleet or the complete new one. The
        newcomer starts with an unknown EWMA, which `_throughput` treats
        optimistically (fastest known service time) so it is probed by the
        very next wave rather than starved."""
        backend = as_backend(obj)
        with self._lock:
            self.backends.append(backend)
            self._ewma_s.append(None)
            self._ewma_op_s.append({})
            self._inflight.append(0)
            self._fail_streak.append(0)
            self._backoff_until.append(0.0)
            self._admin.append("live")
            self.router_stats["points"].append(0)
            self.router_stats["waves_per_backend"].append(0)
            self.router_stats["failures"].append(0)
            self.n_instances = sum(b.n_instances for b in self.backends)
            return len(self.backends) - 1

    def _check_idx(self, i: int) -> int:
        i = int(i)
        if not 0 <= i < len(self.backends):
            raise IndexError(f"no backend {i} (fleet size {len(self.backends)})")
        return i

    def drain_backend(self, i: int) -> None:
        """Stop planning (and stealing) new waves onto backend `i`; shards
        already in flight complete normally. Reversible via
        `reinstate_backend`."""
        i = self._check_idx(i)
        with self._lock:
            if self._admin[i] == "live":
                self._admin[i] = "draining"

    def remove_backend(
        self, i: int, *, close: bool = False, timeout_s: float = 5.0
    ) -> None:
        """Retire backend `i`: drain it, wait (up to `timeout_s`) for its
        in-flight shards, and mark it out of service. Indices never shift —
        bindings and telemetry stay valid — and a retired member can rejoin
        later through `reinstate_backend` (health probation). `close=True`
        additionally shuts the backend object down (irreversible for pools)."""
        i = self._check_idx(i)
        with self._lock:
            self._admin[i] = "draining"
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight[i] == 0:
                    break
            time.sleep(0.005)
        with self._lock:
            self._admin[i] = "retired"
            self.n_instances = sum(
                b.n_instances for j, b in enumerate(self.backends)
                if self._admin[j] == "live"
            ) or self.backends[0].n_instances
        if close:
            self.backends[i].close()

    def reinstate_backend(self, i: int) -> None:
        """Return a drained/retired backend to service with a clean slate:
        failure streak and backoff cleared, EWMA reset to unknown (it will
        be re-probed optimistically — a machine that came back may not
        perform like it used to)."""
        i = self._check_idx(i)
        with self._lock:
            self._admin[i] = "live"
            self._fail_streak[i] = 0
            self._backoff_until[i] = 0.0
            self._ewma_s[i] = None
            self._ewma_op_s[i] = {}
            self.n_instances = sum(
                b.n_instances for j, b in enumerate(self.backends)
                if self._admin[j] == "live"
            )

    def admin_states(self) -> list[str]:
        """Per-backend lifecycle states (index-aligned with `backends`)."""
        with self._lock:
            return list(self._admin)

    def load(self) -> dict:
        """Live load snapshot for scaling policies (`core.fleet`): per-
        backend in-flight points, EWMA service times, failure streaks and
        admin states, all index-aligned and read under one lock hold."""
        with self._lock:
            return {
                "inflight": list(self._inflight),
                "ewma_point_s": list(self._ewma_s),
                "ewma_op_point_s": [dict(d) for d in self._ewma_op_s],
                "fail_streak": list(self._fail_streak),
                "backoff_remaining_s": [
                    max(0.0, t - time.monotonic()) for t in self._backoff_until
                ],
                "admin": list(self._admin),
            }

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-able learned state (EWMA + lifecycle) for campaign
        checkpoints — traffic counters are not part of it (a resumed
        campaign starts fresh telemetry)."""
        with self._lock:
            return {
                "ewma_point_s": list(self._ewma_s),
                "ewma_op_point_s": [dict(d) for d in self._ewma_op_s],
                "admin": list(self._admin),
            }

    def load_state(self, doc: dict) -> None:
        """Re-apply a `state_dict` snapshot. Applied positionally over the
        common index prefix: a resumed campaign may run on a different
        fleet size, in which case extra snapshot entries are dropped and
        extra live backends keep their unknown (optimistic) EWMA. Old
        (pre-per-capability) checkpoints carry only the blended
        `ewma_point_s` — they load as the blended seed, and the per-op
        estimates re-learn from the first wave of each capability."""
        ewma = list(doc.get("ewma_point_s", []))
        ewma_op = list(doc.get("ewma_op_point_s", []))
        admin = list(doc.get("admin", []))
        with self._lock:
            for i in range(min(len(ewma), len(self._ewma_s))):
                self._ewma_s[i] = ewma[i]
            for i in range(min(len(ewma_op), len(self._ewma_op_s))):
                self._ewma_op_s[i] = {
                    str(op): float(v) for op, v in dict(ewma_op[i]).items()
                    if v is not None
                }
            for i in range(min(len(admin), len(self._admin))):
                if admin[i] in ("live", "draining", "retired"):
                    self._admin[i] = admin[i]

    # -- config bindings -----------------------------------------------------
    def bind(self, config: dict | None, backends: Sequence[int]):
        """Restrict waves carrying `config` to the given backend indices."""
        idx = tuple(sorted(set(int(i) for i in backends)))
        if not idx or any(i < 0 or i >= len(self.backends) for i in idx):
            raise ValueError(f"invalid backend subset {backends!r}")
        self._bindings[config_key(config)] = idx

    def _allowed(self, config) -> list[int]:
        idx = list(
            self._bindings.get(config_key(config), range(len(self.backends)))
        )
        live = [i for i in idx if self._admin[i] == "live"]
        if live:
            return live
        # mid-resize degenerate case: every bound member is draining/retired.
        # Prefer draining members (still healthy, just being phased out) over
        # refusing the wave; fall back to the full bound set as a last resort.
        draining = [i for i in idx if self._admin[i] == "draining"]
        return draining or idx

    def _eligible(self, config, op: str) -> list[int]:
        """Backends that may carry a wave of capability `op` under `config`
        (binding subset ∩ capability subset). Empty -> UnsupportedCapability,
        surfaced BEFORE any dispatch."""
        idx = [i for i in self._allowed(config) if _backend_op_ok(self.backends[i], op)]
        if not idx:
            raise UnsupportedCapability(
                f"router: no backend bound to this config advertises {op!r} "
                f"(cluster capabilities: {sorted(self.capabilities().names())})"
            )
        return idx

    # -- routing plan --------------------------------------------------------
    def _ewma_for(self, i: int, op: str) -> float | None:
        """Best per-point service-time estimate for a wave of `op` on
        backend `i` (caller holds the lock): the op-specific EWMA when that
        backend has served the op, else the blended cross-op EWMA, else
        None (never observed at all)."""
        e = self._ewma_op_s[i].get(op)
        return self._ewma_s[i] if e is None else e

    def _throughput(self, i: int, op: str = "evaluate") -> float:
        """Estimated points/sec for capability `op`. The EWMA records
        wall/points per shard, so it already reflects the backend's INTERNAL
        parallelism (a 2-instance pool halves its per-point wall) — no
        n_instances factor here, or multi-instance backends would be
        double-counted. Unknown backends get the fastest known estimate
        (optimistic, so new backends are probed rather than starved)."""
        e = self._ewma_for(i, op)
        if e is None:
            known = [
                x for x in (
                    self._ewma_for(j, op) for j in range(len(self.backends))
                ) if x is not None
            ]
            e = min(known) if known else 1e-3
        return 1.0 / max(e, 1e-9)

    def _plan(self, N: int, config, op: str = "evaluate") -> list[tuple[int, int]]:
        """[(backend_idx, n_points)] for a wave of N points of capability
        `op` (caller holds no lock; planning state is read under the router
        lock)."""
        eligible = self._eligible(config, op)
        with self._lock:
            now = time.monotonic()
            live = [i for i in eligible if self._backoff_until[i] <= now]
            if not live:  # every eligible backend backed off: try them anyway
                live = eligible
            if self.policy == "round_robin":
                counts = {i: 0 for i in live}
                order = sorted(live)
                for j in range(N):
                    counts[order[(self._rr + j) % len(order)]] += 1
                self._rr = (self._rr + N) % len(order)
                return [(i, c) for i, c in counts.items() if c > 0]
            thr = {i: self._throughput(i, op) for i in live}
            total = sum(thr.values())
            counts = {i: int(N * thr[i] / total) for i in live}
            # JSQ tie-break: spill the remainder (and sub-backend-count
            # waves) onto the backend with the lowest projected queue time
            for _ in range(N - sum(counts.values())):
                i = min(
                    live,
                    key=lambda j: (self._inflight[j] + counts[j] + 1) / thr[j],
                )
                counts[i] += 1
            return [(i, c) for i, c in counts.items() if c > 0]

    # -- dispatch ------------------------------------------------------------
    @staticmethod
    def _shard_extra(extra, idx_lo: int, idx_hi: int):
        """Slice the wave's second operand to a shard: arrays shard with the
        thetas; a sens_fn callable is shared by every shard; the Hessian
        wave's (senss, vecs) pair shards element-wise."""
        if extra is None or callable(extra):
            return extra
        if isinstance(extra, tuple):
            return tuple(
                np.atleast_2d(np.asarray(e, float))[idx_lo:idx_hi] for e in extra
            )
        return np.atleast_2d(np.asarray(extra, float))[idx_lo:idx_hi]

    def _run_shard(self, op: str, i: int, thetas: np.ndarray, extra, config,
                   cancel: threading.Event | None = None):
        """Evaluate one shard on backend i, failing over on error to another
        backend ELIGIBLE for `op`. Returns (rows, wall_s, final_backend), or
        None when `cancel` was set before this attempt started (the shard's
        speculative twin already won — don't burn a backend on a dead race).
        """
        tried: set[int] = set()
        n = len(thetas)
        while True:
            if cancel is not None and cancel.is_set():
                return None
            tried.add(i)
            with self._lock:
                self._inflight[i] += n
            t0 = time.monotonic()
            try:
                out = self.backends[i].dispatch(op, thetas, extra, config)
                if op == "value_and_gradient":
                    out = tuple(np.atleast_2d(np.asarray(o)) for o in out)
                    assert out[0].shape[0] == n, "fused shard shape mismatch"
                else:
                    out = np.atleast_2d(np.asarray(out))
                    if out.shape[0] != n:
                        out = out.T
                wall = time.monotonic() - t0
                with self._lock:
                    self._inflight[i] -= n
                    self._fail_streak[i] = 0
                    # success clears the backoff immediately (don't sit out
                    # the remainder of a penalty earned while flaky)
                    self._backoff_until[i] = 0.0
                    per_point = wall / n
                    e = self._ewma_s[i]
                    self._ewma_s[i] = (
                        per_point if e is None else 0.7 * e + 0.3 * per_point
                    )
                    eo = self._ewma_op_s[i].get(op)
                    self._ewma_op_s[i][op] = (
                        per_point if eo is None else 0.7 * eo + 0.3 * per_point
                    )
                    self.router_stats["points"][i] += n
                    self.router_stats["waves_per_backend"][i] += 1
                return out, wall, i
            except UnsupportedCapability:
                # planning/steal eligibility should make this unreachable;
                # if capabilities changed under us, do NOT back the backend
                # off (it is healthy) — just re-raise
                with self._lock:
                    self._inflight[i] -= n
                raise
            except Exception as err:  # noqa: BLE001 — backend failure
                with self._lock:
                    self._inflight[i] -= n
                    self._fail_streak[i] += 1
                    self.router_stats["failures"][i] += 1
                    # exponent capped: the ceiling is what bounds the delay;
                    # the cap keeps `2 ** streak` finite after a long outage
                    self._backoff_until[i] = time.monotonic() + min(
                        self.backoff_s
                        * 2.0 ** min(self._fail_streak[i] - 1, self.BACKOFF_EXP_CAP),
                        self.backoff_max_s,
                    )
                # a steal must respect the wave's capability: a gradient
                # shard never lands on an evaluate-only survivor
                alive = [j for j in self._eligible(config, op) if j not in tried]
                if not alive:
                    raise RuntimeError(
                        f"router: all {len(tried)} eligible backends failed "
                        f"for this {op} shard; last: {err!r}"
                    ) from err
                with self._lock:
                    self.router_stats["steals"] += 1
                    now = time.monotonic()
                    ok = [j for j in alive if self._backoff_until[j] <= now]
                    i = min(
                        ok or alive,
                        key=lambda j: (self._inflight[j] + n) / self._throughput(j, op),
                    )

    def _spec_deadline_s(self, i: int, n: int, op: str = "evaluate") -> float | None:
        """Wall-time allowance for a shard of `n` points of capability `op`
        on backend `i` before a speculative duplicate launches; None when
        speculation is disabled or no backend has an estimate for the op
        yet (nothing to predict from). Consulting the op-specific EWMA
        matters here: arming an evaluate-derived deadline against a ~3x
        slower gradient shard fires spurious duplicates."""
        if self.spec_factor is None:
            return None
        with self._lock:
            e = self._ewma_for(i, op)
            if e is None:
                known = [
                    x for x in (
                        self._ewma_for(j, op) for j in range(len(self.backends))
                    ) if x is not None
                ]
                e = min(known) if known else None
        if e is None:
            return None
        return max(self.spec_min_s, self.spec_factor * e * n)

    def _spec_target(self, op, config, exclude: set[int], n: int) -> int | None:
        """Pick the backend a late shard is duplicated onto: eligible for
        `op`, not already racing this shard, not backed off — preferring an
        idle member, fastest projected finish among those. None when no
        such backend exists (the primary keeps running alone)."""
        try:
            eligible = [j for j in self._eligible(config, op) if j not in exclude]
        except UnsupportedCapability:
            return None
        if not eligible:
            return None
        with self._lock:
            now = time.monotonic()
            ok = [j for j in eligible if self._backoff_until[j] <= now]
            if not ok:
                return None
            idle = [j for j in ok if self._inflight[j] == 0]
            pool = idle or ok
            return min(
                pool, key=lambda j: (self._inflight[j] + n) / self._throughput(j, op)
            )

    def _dispatch_shards(self, op, thetas, extra, config, plan, bounds):
        """Launch the planned shards and collect their results, duplicating
        any shard that outlives its EWMA-predicted deadline onto another
        backend (first result wins, at most ONE duplicate per shard).

        Collection (and the deadline watch) runs in the CALLING thread so
        speculation never occupies an executor slot — only shard attempts
        do. A losing attempt that already started still completes on its
        backend (its EWMA/telemetry updates are honest work), but its rows
        are dropped HERE, below the fabric cache/tap layer: the wave returns
        exactly one row per theta, so observers fire exactly once per
        computed row and `tap_exactly_once` holds under duplication."""
        t0 = time.monotonic()
        shards: list[dict] = []
        for j, (i, _) in enumerate(plan):
            sl = thetas[bounds[j]:bounds[j + 1]]
            ex = self._shard_extra(extra, bounds[j], bounds[j + 1])
            cancel = threading.Event()
            d = self._spec_deadline_s(i, len(sl), op)
            shards.append({
                "thetas": sl, "extra": ex, "cancel": cancel,
                "racing": {i},
                "futs": [self._ex.submit(
                    self._run_shard, op, i, sl, ex, config, cancel
                )],
                "deadline": None if d is None else t0 + d,
                "result": None, "error": None,
            })
        pending = list(shards)
        while pending:
            outstanding = [f for s in pending for f in s["futs"] if not f.done()]
            watch = [
                s["deadline"] for s in pending
                if s["deadline"] is not None and len(s["futs"]) == 1
            ]
            timeout = None
            if watch:
                timeout = max(0.0, min(watch) - time.monotonic())
            if outstanding:
                futures_wait(
                    outstanding, timeout=timeout, return_when=FIRST_COMPLETED
                )
            still: list[dict] = []
            for s in pending:
                for k, f in enumerate(s["futs"]):
                    if not f.done() or s["result"] is not None:
                        continue
                    try:
                        out = f.result()
                    except Exception as e:  # noqa: BLE001 — attempt failed
                        s["error"] = e
                        continue
                    if out is None:  # cancelled before it started
                        continue
                    s["result"] = out
                    s["cancel"].set()
                    if k > 0:
                        with self._lock:
                            self.router_stats["spec_wins"] += 1
                if s["result"] is not None:
                    continue
                if all(f.done() for f in s["futs"]):
                    # every racing attempt failed (or was cancelled after
                    # its twin failed) — the shard is genuinely lost
                    raise s["error"] or RuntimeError(
                        f"router: {op} shard lost all racing attempts"
                    )
                still.append(s)
            pending = still
            now = time.monotonic()
            for s in pending:
                if (
                    s["deadline"] is None
                    or len(s["futs"]) > 1
                    or now < s["deadline"]
                ):
                    continue
                tgt = self._spec_target(op, config, s["racing"], len(s["thetas"]))
                if tgt is None:
                    s["deadline"] = None  # nobody to race against: stop watching
                    continue
                s["racing"].add(tgt)
                with self._lock:
                    self.router_stats["spec_dispatches"] += 1
                s["futs"].append(self._ex.submit(
                    self._run_shard, op, tgt,
                    s["thetas"], s["extra"], config, s["cancel"],
                ))
        return [s["result"] for s in shards]

    def dispatch(self, op, thetas, extra, config):
        thetas = np.atleast_2d(np.asarray(thetas, float))
        N = len(thetas)
        plan = self._plan(N, config, op)
        bounds = np.cumsum([0] + [c for _, c in plan])
        shards = self._dispatch_shards(op, thetas, extra, config, plan, bounds)
        if op == "value_and_gradient":
            rows = tuple(
                np.concatenate([s[0][k] for s in shards], axis=0) for k in (0, 1)
            )
        else:
            rows = np.concatenate([s[0] for s in shards], axis=0)
        # imbalance factor: the wave's actual wall time (slowest shard) over
        # the ideal wall time had the observed per-point costs been split
        # perfectly — 1.0 means no backend sat idle waiting on a straggler
        if len(shards) > 1:
            walls = [s[1] for s in shards]
            # observed shard throughput (points/sec, internal parallelism
            # included) — the basis for the perfectly-balanced ideal
            speeds = [c / max(s[1], 1e-9) for s, (_, c) in zip(shards, plan)]
            ideal = N / max(sum(speeds), 1e-9)
            imb = max(walls) / max(ideal, 1e-9)
            with self._lock:
                self.router_stats["last_imbalance"] = round(imb, 3)
                e = self.router_stats["imbalance_ewma"]
                self.router_stats["imbalance_ewma"] = round(
                    imb if e is None else 0.7 * e + 0.3 * imb, 3
                )
        with self._lock:
            self.router_stats["waves"] += 1
            self.router_stats["op_waves"][op] = (
                self.router_stats["op_waves"].get(op, 0) + 1
            )
        return rows

    def evaluate(self, thetas, config):
        return self.dispatch("evaluate", thetas, None, config)

    # -- telemetry / lifecycle ----------------------------------------------
    def reset_stats(self):
        """Zero the traffic counters while KEEPING the learned EWMA service
        times — benchmarks call this after warm-up waves so reported shares
        and imbalance reflect the steady state, not the cold probe."""
        with self._lock:
            self.router_stats = self._fresh_stats()

    def stats(self) -> dict:
        with self._lock:
            rs = {
                k: (list(v) if isinstance(v, list)
                    else dict(v) if isinstance(v, dict) else v)
                for k, v in self.router_stats.items()
            }
            # snapshot the fleet in the SAME lock hold as the counters, so a
            # concurrent add_backend can't desynchronize the index-aligned
            # lists from the member list
            members = list(self.backends)
            admin = list(self._admin)
            ewma = list(self._ewma_s)
            ewma_op = [dict(d) for d in self._ewma_op_s]
            backed = [
                max(0.0, round(t - time.monotonic(), 3))
                for t in self._backoff_until
            ]
        total = sum(rs["points"]) or 1
        per_backend = [
            {
                "kind": b.name,
                "admin": admin[i],
                "points": rs["points"][i],
                "waves": rs["waves_per_backend"][i],
                "share": round(rs["points"][i] / total, 3),
                "failures": rs["failures"][i],
                "capabilities": sorted(b.capabilities().names()),
                "ewma_point_s": None if ewma[i] is None else round(ewma[i], 5),
                "ewma_op_point_s": {
                    op: round(v, 5) for op, v in sorted(ewma_op[i].items())
                },
                "backoff_remaining_s": backed[i],
                **b.stats(),
            }
            for i, b in enumerate(members)
        ]
        return {
            "kind": self.name,
            "policy": self.policy,
            "n_backends": len(members),
            "n_live": sum(1 for a in admin if a == "live"),
            "waves": rs["waves"],
            "steals": rs["steals"],
            "spec_dispatches": rs["spec_dispatches"],
            "spec_wins": rs["spec_wins"],
            "op_waves": rs["op_waves"],
            "last_imbalance": rs["last_imbalance"],
            "imbalance_ewma": rs["imbalance_ewma"],
            "per_backend": per_backend,
        }

    def close(self):
        self._ex.shutdown(wait=False)
        for b in self.backends:
            b.close()


#: backend sources the port does not serve -> what to do instead; matched
#: by type name, since the type itself lives only in the JAX package
_UNPORTED_BACKENDS = {
    "JAXModel": "a JAX function; write it in PyTorch and wrap it in "
                "repro_torch.core.interface.TorchModel",
}


def _refuse_unported(obj) -> None:
    for cls in type(obj).__mro__:
        why = _UNPORTED_BACKENDS.get(cls.__name__)
        if why is not None:
            raise TypeError(
                f"cannot build a fabric backend from {type(obj).__name__}: "
                f"not ported ({why})"
            )


def as_backend(obj) -> FabricBackend:
    """Coerce pools / models / urls / callables into a FabricBackend; a
    list/tuple containing backends or pools becomes a `FabricRouter` over
    them (heterogeneous multi-backend dispatch), a list of URLs and
    `HTTPModel`s one `HTTPBackend` over those servers. A JAX model raises
    `TypeError`: write it in PyTorch as a `TorchModel`."""
    from repro_torch.core.client import HTTPModel

    if isinstance(obj, FabricBackend):
        return obj
    _refuse_unported(obj)
    if isinstance(obj, ModelPool):
        return SPMDBackend(obj)
    if isinstance(obj, ThreadedPool):
        return ThreadedBackend(obj)
    if isinstance(obj, TorchModel):
        return SPMDBackend(ModelPool(obj))
    if isinstance(obj, Model):
        return ModelBackend(obj)
    if isinstance(obj, str):
        return HTTPBackend([obj])
    if isinstance(obj, (list, tuple)):
        for o in obj:
            if not isinstance(o, FabricBackend):
                _refuse_unported(o)
        # heterogeneous cluster: any element that is already a backend (or a
        # pool) makes the list a router over N independent backends
        if any(isinstance(o, (FabricBackend, ModelPool, ThreadedPool)) for o in obj):
            return FabricRouter(obj)
        if all(isinstance(o, (str, HTTPModel)) for o in obj):
            return HTTPBackend(obj)
        return ThreadedBackend(ThreadedPool(list(obj)))
    if callable(obj):
        return CallableBackend(obj)
    raise TypeError(f"cannot build a fabric backend from {type(obj).__name__}")


# ---------------------------------------------------------------------------
# The fabric
# ---------------------------------------------------------------------------


def _derived_future(src: Future) -> Future:
    """A Future resolving to an independent copy of `src`'s result, so
    coalesced callers never share (and can freely mutate) one array."""
    dst: Future = Future()

    def _copy(f: Future):
        if f.cancelled():
            dst.cancel()
        elif f.exception() is not None:
            dst.set_exception(f.exception())
        else:
            dst.set_result(np.array(f.result()))

    src.add_done_callback(_copy)
    return dst


class EvaluationFabric:
    """Unified async evaluation layer (see module docstring).

    Parameters
    ----------
    backend : anything `as_backend` accepts; a list of backends/pools builds
        a `FabricRouter` over the heterogeneous cluster.
    max_batch : initial wave-size cap for the submit path (adapts upward when
        waves saturate; default 4 x backend instances).
    linger_s : initial collector linger window (self-tunes when adaptive).
    adaptive : tune linger/max_batch from the observed wave latency.
    cache_size : LRU entries; 0 disables result caching (in-flight request
        coalescing stays on). Keys are namespaced per capability, so a
        gradient result can never serve an evaluate request.
    """

    def __init__(
        self,
        backend,
        *,
        max_batch: int | None = None,
        linger_s: float = 0.002,
        adaptive: bool = True,
        cache_size: int = 4096,
    ):
        self.backend = as_backend(backend)
        self.max_batch = int(max_batch or max(4 * self.backend.n_instances, 8))
        self._max_batch_cap = 4096
        self.linger_s = float(linger_s)
        self.adaptive = adaptive
        self.cache_size = int(cache_size)
        self._cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        # who paid for each cached row (None = anonymous / single-tenant
        # traffic): a hit served to a DIFFERENT tenant is a shared hit,
        # accounted to both sides (see _note_hit_owner)
        self._cache_owner: dict[tuple, str | None] = {}
        self._inflight: dict[tuple, Future] = {}
        # who is paying for each in-flight wave entry: a coalesce onto
        # ANOTHER tenant's in-flight evaluation is the same economics as a
        # shared cache hit (the ride starts before the row lands)
        self._inflight_owner: dict[tuple, str | None] = {}
        self._lock = named_condition("fabric")
        self._pending: list[
            tuple[np.ndarray, dict | None, Future, tuple, str | None]
        ] = []
        self._stop = False
        self._wave_latency_ewma: float | None = None
        self._labels: dict[tuple, str] = {}
        self._observers: list[Callable] = []
        self.stats = {
            "waves": 0,
            "points": 0,
            "cache_hits": 0,
            "cache_misses": 0,
            "coalesced": 0,
            "direct_batches": 0,
            # surrogate-screen economics: proposals scored by a level-(-1)
            # surrogate instead of paying a wave, and how many survived to
            # pay one (see `uq.surrogate.SurrogateScreen` / `note_screen`)
            "surrogate_screened": 0,
            "surrogate_passed": 0,
            # sampler-step economics (see `note_steps`): MCMC steps advanced
            # and the dispatches they cost. A host lockstep sampler pays one
            # dispatch per step (steps == waves); a fused `uq.fused` block
            # advances S steps per dispatch — counting waves alone would
            # undercount sampler progress S-fold, so ESS-per-wave benchmarks
            # read `steps_per_wave` instead
            "sampler_steps": 0,
            "sampler_waves": 0,
            # per-wave fill fraction accumulator: collector waves count
            # len(wave)/max_batch, explicit evaluate_batch waves are full by
            # definition (they bypass the collector cap)
            "fill_sum": 0.0,
            # per-label traffic breakdown (see `label_config`) — multilevel
            # hierarchies label their level configs so per-level telemetry
            # surfaces here without a separate accounting layer
            "per_label": {},
            # per-capability wave/point split — gradient-sampler benchmarks
            # read their wave economics here
            "per_capability": {},
            # per-tenant cost accounting (see `_tenant_bump` / `UQService`):
            # waves, points, cache hits, shared hits given/taken, and
            # backend-seconds attributed from measured dispatch walls
            "per_tenant": {},
        }
        self._thread = threading.Thread(target=self._collector, daemon=True)
        self._thread.start()

    # -- capability surface --------------------------------------------------
    def capabilities(self) -> Capabilities:
        """What the backend (cluster) advertises — UQ drivers negotiate on
        this before building gradient-based samplers."""
        return self.backend.capabilities()

    # -- labels / routing ----------------------------------------------------
    def label_config(self, config: dict | None, label: str):
        """Attribute traffic carrying `config` to `label` in the telemetry
        (`stats["per_label"][label]` = points / waves / cache hits+misses)."""
        with self._lock:
            self._labels[config_key(config)] = str(label)
            self.stats["per_label"].setdefault(
                str(label),
                {"points": 0, "waves": 0, "cache_hits": 0, "cache_misses": 0},
            )

    def _label_bump(self, config, **inc):  # caller holds the lock
        label = self._labels.get(config_key(config))
        if label is None:
            return
        bucket = self.stats["per_label"][label]
        for k, v in inc.items():
            bucket[k] += v

    def _capability_bump(self, op, **inc):  # caller holds the lock
        bucket = self.stats["per_capability"].setdefault(
            op, {"points": 0, "waves": 0, "cache_hits": 0, "cache_misses": 0}
        )
        for k, v in inc.items():
            bucket[k] += v

    def _tenant_bump(self, tenant, **inc):  # caller holds the lock
        if tenant is None:
            return
        bucket = self.stats["per_tenant"].setdefault(
            tenant, {**{k: 0 for k in _TENANT_COUNTERS}, "backend_s": 0.0}
        )
        for k, v in inc.items():
            bucket[k] = bucket.get(k, 0) + v

    def _note_hit_owner(self, key, tenant):  # caller holds the lock
        """Cross-tenant hit accounting: a cache row (or in-flight wave ride)
        served to a tenant other than the one paying for it is a SHARED hit
        — possible only in the opt-in shared namespace (private namespaces
        cannot collide)."""
        owner = (self._cache_owner[key] if key in self._cache_owner
                 else self._inflight_owner.get(key))
        if tenant == owner or (tenant is None and owner is None):
            return
        self._tenant_bump(tenant, shared_hits_taken=1)
        self._tenant_bump(owner, shared_hits_given=1)

    def note_tenant(self, tenant: str, **inc) -> None:
        """Fold service-layer per-tenant counters (sheds, budget stops,
        fused device steps, scheduler cost-seconds) into the same telemetry
        bucket the wave path feeds — `telemetry()["per_tenant"]` stays the
        ONE place per-tenant economics surface."""
        with self._lock:
            self._tenant_bump(tenant, **inc)

    def reset_stats(self) -> None:
        """Zero the telemetry counters ATOMICALLY and COMPLETELY: every
        top-level counter, the steps-per-wave inputs, and the nested
        per-label / per-capability / per-tenant buckets reset under ONE
        acquisition of the fabric lock — no wave can interleave a bump
        between a half-reset top level and stale nested buckets. Registered
        labels survive (zeroed) so per-level attribution keeps working
        after a reset; tuning state (max_batch, linger, wave-latency EWMA)
        is NOT stats and is preserved. Cascades to a routed backend's own
        `reset_stats` (which keeps its learned EWMA) outside the fabric
        lock — the router has its own."""
        with self._lock:
            for k, v in self.stats.items():
                if isinstance(v, dict):
                    continue
                self.stats[k] = 0.0 if isinstance(v, float) else 0
            self.stats["per_label"] = {
                label: {"points": 0, "waves": 0, "cache_hits": 0, "cache_misses": 0}
                for label in self.stats["per_label"]
            }
            self.stats["per_capability"] = {}
            self.stats["per_tenant"] = {}
        reset = getattr(self.backend, "reset_stats", None)
        if callable(reset):
            reset()

    def _require_router(self, what: str) -> FabricRouter:
        if not isinstance(self.backend, FabricRouter):
            raise TypeError(
                f"{what} needs a multi-backend fabric (FabricRouter); "
                f"this fabric runs a single {self.backend.name!r} backend"
            )
        return self.backend

    def bind(self, config: dict | None, backends: Sequence[int]):
        """Restrict waves carrying `config` to a backend subset (requires a
        `FabricRouter` backend — see `FabricRouter.bind`)."""
        self._require_router("bind()").bind(config, backends)

    # -- fleet lifecycle (router passthroughs) --------------------------------
    def add_backend(self, obj) -> int:
        """Enroll a new backend in the routed cluster mid-run; returns its
        stable index (see `FabricRouter.add_backend`)."""
        return self._require_router("add_backend()").add_backend(obj)

    def drain_backend(self, i: int) -> None:
        """Phase a routed backend out: no new waves, in-flight completes."""
        self._require_router("drain_backend()").drain_backend(i)

    def remove_backend(self, i: int, **kw) -> None:
        """Drain then retire a routed backend (see
        `FabricRouter.remove_backend`)."""
        self._require_router("remove_backend()").remove_backend(i, **kw)

    def reinstate_backend(self, i: int) -> None:
        """Return a drained/retired routed backend to service."""
        self._require_router("reinstate_backend()").reinstate_backend(i)

    # -- training tap --------------------------------------------------------
    def record_observer(self, fn: Callable) -> Callable:
        """Register a training tap: `fn(op, thetas, outputs, config)` fires
        once per completed backend dispatch with that wave's freshly
        computed (theta, output) rows. Cache hits, coalesced waiters and
        intra-batch duplicates are NOT replayed — an observer sees each
        model evaluation EXACTLY once, so an online surrogate
        (`uq.surrogate.SurrogateStore`) trains from fabric traffic without
        issuing a single model evaluation of its own. Observers receive
        private copies (shared across the observers of one wave): treat
        them as read-only. Returns `fn` (usable as a decorator)."""
        with self._lock:
            self._observers.append(fn)
        return fn

    def remove_observer(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    def _notify_observers(self, op, thetas, outs, config):
        """Stream one completed wave to the training taps. Runs OUTSIDE the
        fabric lock (observers may refit surrogates); an observer's
        exception must never fail the wave that fed it. Observers get
        COPIES: the original rows are already (or about to be) in callers'
        hands, and a caller mutating its result in place must not race a
        tap into training on corrupted pairs."""
        if not self._observers:
            return
        thetas = np.array(thetas)
        outs = np.array(outs)
        for fn in list(self._observers):
            try:
                fn(op, thetas, outs, config)
            except Exception as e:  # noqa: BLE001 — observer bug, not ours
                warnings.warn(
                    f"fabric observer {fn!r} raised {e!r}",
                    RuntimeWarning, stacklevel=2,
                )

    def note_screen(self, screened: int, passed: int) -> None:
        """Fold surrogate-screen traffic into the telemetry: `screened`
        proposals were scored by a level-(-1) surrogate instead of paying
        a wave, `passed` of them survived to pay one (`telemetry()` derives
        `screen_pass_rate`)."""
        with self._lock:
            self.stats["surrogate_screened"] += int(screened)
            self.stats["surrogate_passed"] += int(passed)

    def note_steps(self, steps: int, waves: int = 1) -> None:
        """Fold sampler-step traffic into the telemetry: `steps` MCMC steps
        were advanced for the cost of `waves` dispatches. Host lockstep
        samplers note (1, waves=1) per proposal wave; fused device-resident
        blocks (`uq.fused`) note (S, waves=1) per block — `telemetry()`
        derives `steps_per_wave` so fused and per-step runs stay comparable
        on the same axis."""
        with self._lock:
            self.stats["sampler_steps"] += int(steps)
            self.stats["sampler_waves"] += int(waves)

    # -- cache --------------------------------------------------------------
    def _key(self, theta: np.ndarray, config: dict | None, op: str = "evaluate",
             extra: np.ndarray | None = None, ns: str | None = None) -> tuple:
        """Cache key: the operation NAMESPACES the entry (per-capability
        isolation), and derivative entries carry their second operand —
        gradient(theta, sens) and gradient(theta, sens') are distinct.
        `ns` is the TENANT namespace: None is the shared pool (single-tenant
        traffic and campaigns that opted into cross-tenant sharing); a
        tenant name makes the key private — two tenants evaluating the same
        (theta, config, op) can never collide unless both declared the
        config shareable."""
        return (
            ns,
            op,
            theta.tobytes(),
            theta.size,
            None if extra is None else extra.tobytes(),
            config_key(config),
        )

    def _cache_get(self, key):  # caller holds the lock
        if not self.cache_size:
            return None
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
        return hit

    def _cache_put(self, key, value, tenant: str | None = None):  # caller holds the lock
        if not self.cache_size:
            return
        # defensive copy: result arrays are handed to callers, who may
        # mutate them in place — the cached value must not alias them
        self._cache[key] = np.array(value)
        self._cache_owner[key] = tenant
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            evicted, _ = self._cache.popitem(last=False)
            self._cache_owner.pop(evicted, None)

    # -- per-point API -------------------------------------------------------
    def submit(self, theta, config: dict | None = None, *,
               tenant: str | None = None, namespace: str | None = None) -> Future:
        """Single-point evaluation future; transparently batched into waves,
        deduped against the cache and identical in-flight requests.
        `tenant` attributes the traffic in `per_tenant` telemetry;
        `namespace` selects the cache namespace (None = shared pool)."""
        theta = np.asarray(theta, float).ravel()
        key = self._key(theta, config, ns=namespace)
        with self._lock:
            if self._stop:
                raise RuntimeError("fabric is shut down")
            hit = self._cache_get(key)
            if hit is not None:
                self.stats["cache_hits"] += 1
                self._label_bump(config, cache_hits=1)
                self._capability_bump("evaluate", cache_hits=1)
                self._tenant_bump(tenant, cache_hits=1)
                self._note_hit_owner(key, tenant)
                fut: Future = Future()
                fut.set_result(hit.copy())
                return fut
            inflight = self._inflight.get(key)
            if inflight is not None:
                self.stats["coalesced"] += 1
                self._tenant_bump(tenant, coalesced=1)
                self._note_hit_owner(key, tenant)
                return _derived_future(inflight)
            self.stats["cache_misses"] += 1
            self._label_bump(config, cache_misses=1)
            self._capability_bump("evaluate", cache_misses=1)
            self._tenant_bump(tenant, cache_misses=1)
            fut = Future()
            self._inflight[key] = fut
            self._inflight_owner[key] = tenant
            self._pending.append((theta, config, fut, key, tenant))
            self._lock.notify()
        return fut

    def as_callable(self, config: dict | None = None) -> Callable:
        """theta -> output row view (what prototype-grade UQ code calls);
        concurrent callers coalesce into shared waves."""

        def f(theta):
            return self.submit(theta, config).result()

        return f

    # -- batched API ---------------------------------------------------------
    def evaluate_batch(self, thetas, config: dict | None = None, *,
                       tenant: str | None = None,
                       namespace: str | None = None) -> np.ndarray:
        """[N, n] -> [N, m] in ONE backend dispatch (bypasses the collector —
        an explicit batch is already a wave), deduping repeated rows and
        cache hits first. `tenant`/`namespace` as in `submit`."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        N = len(thetas)
        keys = [self._key(t, config, ns=namespace) for t in thetas]
        rows: list[np.ndarray | None] = [None] * N
        miss_order: list[tuple] = []
        miss_rows: dict[tuple, int] = {}
        miss_thetas: list[np.ndarray] = []
        wait_futs: dict[tuple, Future] = {}
        with self._lock:
            if self._stop:
                raise RuntimeError("fabric is shut down")
            for i, key in enumerate(keys):
                hit = self._cache_get(key)
                if hit is not None:
                    self.stats["cache_hits"] += 1
                    self._label_bump(config, cache_hits=1)
                    self._capability_bump("evaluate", cache_hits=1)
                    self._tenant_bump(tenant, cache_hits=1)
                    self._note_hit_owner(key, tenant)
                    rows[i] = hit
                    continue
                if key in miss_rows:
                    self.stats["cache_hits"] += 1  # intra-batch duplicate
                    self._label_bump(config, cache_hits=1)
                    self._capability_bump("evaluate", cache_hits=1)
                    self._tenant_bump(tenant, cache_hits=1)
                    continue
                inflight = self._inflight.get(key)
                if inflight is not None:
                    self.stats["coalesced"] += 1
                    self._tenant_bump(tenant, coalesced=1)
                    self._note_hit_owner(key, tenant)
                    wait_futs[key] = inflight
                    continue
                self.stats["cache_misses"] += 1
                self._label_bump(config, cache_misses=1)
                self._capability_bump("evaluate", cache_misses=1)
                self._tenant_bump(tenant, cache_misses=1)
                miss_rows[key] = len(miss_order)
                miss_order.append(key)
                miss_thetas.append(thetas[i])
                self._inflight[key] = Future()
                self._inflight_owner[key] = tenant
        outs = None
        if miss_order:
            t0 = time.monotonic()
            try:
                outs = np.atleast_2d(
                    np.asarray(self.backend.evaluate(np.stack(miss_thetas), config))
                )
                if outs.shape[0] != len(miss_order):
                    outs = outs.T
            except Exception as e:
                with self._lock:
                    for k in miss_order:
                        fut = self._inflight.pop(k, None)
                        self._inflight_owner.pop(k, None)
                        if fut is not None and not fut.done():
                            fut.set_exception(e)
                raise
            wall = time.monotonic() - t0
            # tap snapshot BEFORE futures resolve (same discipline as the
            # collector path): no waiter mutation can reach the observers
            tap_outs = np.array(outs)
            with self._lock:
                self.stats["waves"] += 1
                self.stats["points"] += len(miss_order)
                self.stats["direct_batches"] += 1
                self.stats["fill_sum"] += 1.0
                self._label_bump(config, points=len(miss_order), waves=1)
                self._capability_bump("evaluate", points=len(miss_order), waves=1)
                self._tenant_bump(tenant, points=len(miss_order), waves=1,
                                  backend_s=wall)
                for k, out in zip(miss_order, outs):
                    self._cache_put(k, out, tenant)
                    fut = self._inflight.pop(k, None)
                    self._inflight_owner.pop(k, None)
                    if fut is not None and not fut.done():
                        fut.set_result(out)
            self._notify_observers(
                "evaluate", np.stack(miss_thetas), tap_outs, config
            )
        for i, key in enumerate(keys):
            if rows[i] is None:
                if key in miss_rows:
                    rows[i] = outs[miss_rows[key]]
                elif key in wait_futs:
                    rows[i] = np.asarray(wait_futs[key].result())
        return np.stack([np.asarray(r).ravel() for r in rows])

    evaluate = evaluate_batch
    __call__ = evaluate_batch

    # -- batched derivative API ----------------------------------------------
    def gradient_batch(self, thetas, senss, config: dict | None = None, *,
                       tenant: str | None = None,
                       namespace: str | None = None) -> np.ndarray:
        """Batched VJP wave: [N, n] x [N, m] -> [N, n] routed only to
        gradient-capable backends (raises `UnsupportedCapability` when the
        cluster has none). Cached in the per-capability namespace, keyed on
        (theta, sens, config)."""
        return self._derivative_wave("gradient", thetas, senss, config,
                                     tenant=tenant, namespace=namespace)

    def apply_jacobian_batch(self, thetas, vecs, config: dict | None = None, *,
                             tenant: str | None = None,
                             namespace: str | None = None) -> np.ndarray:
        """Batched JVP wave: [N, n] x [N, n] -> [N, m], capability-routed
        and cached like `gradient_batch`."""
        return self._derivative_wave("apply_jacobian", thetas, vecs, config,
                                     tenant=tenant, namespace=namespace)

    def apply_hessian_batch(self, thetas, senss, vecs,
                            config: dict | None = None, *,
                            tenant: str | None = None,
                            namespace: str | None = None) -> np.ndarray:
        """Batched HVP wave: [N, n] x [N, m] x [N, n] -> [N, n] with
        row k = d/de [J(thetas[k] + e vecs[k])^T senss[k]]. Routed only to
        hessian-capable backends (raises `UnsupportedCapability` when the
        cluster has none) and cached in the per-capability namespace, keyed
        on (theta, sens ++ vec, config) — the two operands concatenate into
        one key row, so hvp(theta, s, v) and hvp(theta, s', v) are distinct
        entries."""
        return self._derivative_wave(
            "apply_hessian", thetas, (senss, vecs), config,
            tenant=tenant, namespace=namespace,
        )

    def _derivative_wave(self, op: str, thetas, extras, config, *,
                         tenant: str | None = None,
                         namespace: str | None = None) -> np.ndarray:
        thetas = np.atleast_2d(np.asarray(thetas, float))
        if isinstance(extras, tuple):
            # two-operand wave (apply_hessian): both arrays shard with the
            # thetas; their concatenation is the cache-key operand row
            parts = tuple(np.atleast_2d(np.asarray(e, float)) for e in extras)
            for p in parts:
                if len(p) != len(thetas):
                    raise ValueError(
                        f"{op}_batch: {len(thetas)} thetas but {len(p)} operand rows"
                    )
            extras = parts
            key_extras = np.concatenate(parts, axis=1)
        else:
            extras = np.atleast_2d(np.asarray(extras, float))
            if len(extras) != len(thetas):
                raise ValueError(
                    f"{op}_batch: {len(thetas)} thetas but {len(extras)} operand rows"
                )
            key_extras = extras
        if not _backend_op_ok(self.backend, op):
            raise UnsupportedCapability(
                f"fabric backend advertises no {op!r} capability "
                f"(advertised: {sorted(self.capabilities().names())})"
            )
        N = len(thetas)
        keys = [self._key(t, config, op, e, ns=namespace)
                for t, e in zip(thetas, key_extras)]
        rows: list[np.ndarray | None] = [None] * N
        miss_order: list[tuple] = []
        miss_rows: dict[tuple, int] = {}
        miss_idx: list[int] = []
        with self._lock:
            if self._stop:
                raise RuntimeError("fabric is shut down")
            for i, key in enumerate(keys):
                hit = self._cache_get(key)
                if hit is not None:
                    self.stats["cache_hits"] += 1
                    self._label_bump(config, cache_hits=1)
                    self._capability_bump(op, cache_hits=1)
                    self._tenant_bump(tenant, cache_hits=1)
                    self._note_hit_owner(key, tenant)
                    rows[i] = hit
                    continue
                if key in miss_rows:
                    self.stats["cache_hits"] += 1  # intra-batch duplicate
                    self._label_bump(config, cache_hits=1)
                    self._capability_bump(op, cache_hits=1)
                    self._tenant_bump(tenant, cache_hits=1)
                    continue
                self.stats["cache_misses"] += 1
                self._label_bump(config, cache_misses=1)
                self._capability_bump(op, cache_misses=1)
                self._tenant_bump(tenant, cache_misses=1)
                miss_rows[key] = len(miss_order)
                miss_order.append(key)
                miss_idx.append(i)
        outs = None
        if miss_order:
            miss_extras = (
                tuple(p[miss_idx] for p in extras)
                if isinstance(extras, tuple) else extras[miss_idx]
            )
            t0 = time.monotonic()
            outs = np.atleast_2d(np.asarray(self.backend.dispatch(
                op, thetas[miss_idx], miss_extras, config
            ), float))
            wall = time.monotonic() - t0
            with self._lock:
                self.stats["waves"] += 1
                self.stats["points"] += len(miss_order)
                self.stats["fill_sum"] += 1.0
                self._label_bump(config, points=len(miss_order), waves=1)
                self._capability_bump(op, points=len(miss_order), waves=1)
                self._tenant_bump(tenant, points=len(miss_order), waves=1,
                                  backend_s=wall)
                for k, out in zip(miss_order, outs):
                    self._cache_put(k, out, tenant)
            self._notify_observers(op, thetas[miss_idx], outs, config)
        for i, key in enumerate(keys):
            if rows[i] is None:
                rows[i] = outs[miss_rows[key]]
        return np.stack([np.asarray(r).ravel() for r in rows])

    def value_and_gradient_batch(
        self, thetas, sens_fn: Callable, config: dict | None = None, *,
        tenant: str | None = None, namespace: str | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Fused forward + VJP wave: (ys [N, m], grads [N, n]) with
        grads[k] = sens_fn(ys[k])^T J(thetas[k]).

        ONE backend dispatch when the backend advertises the fused in-process
        path (AD models: the VJP computes the primal anyway); otherwise two
        capability-routed waves (evaluate, then gradient with host-computed
        sensitivities) — which is also the negotiation HTTP backends land on,
        since a callable cannot cross the wire. Fused results are not
        cached: samplers never revisit a proposal, and the value half is
        cache-served through the two-wave path when it matters."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        if getattr(self.backend, "fused_value_grad", False):
            t0 = time.monotonic()
            ys, grads = self.backend.dispatch(
                "value_and_gradient", thetas, sens_fn, config
            )
            wall = time.monotonic() - t0
            ys = np.atleast_2d(np.asarray(ys, float))
            grads = np.atleast_2d(np.asarray(grads, float))
            with self._lock:
                if self._stop:
                    raise RuntimeError("fabric is shut down")
                self.stats["waves"] += 1
                self.stats["points"] += len(thetas)
                self.stats["fill_sum"] += 1.0
                self._label_bump(config, points=len(thetas), waves=1)
                self._capability_bump(
                    "value_and_gradient", points=len(thetas), waves=1
                )
                self._tenant_bump(tenant, points=len(thetas), waves=1,
                                  backend_s=wall)
            # fused waves carry fresh forward values too — observers that
            # train on (theta, y) pairs filter on the op themselves
            self._notify_observers("value_and_gradient", thetas, ys, config)
            return ys, grads
        if not _backend_op_ok(self.backend, "gradient"):
            raise UnsupportedCapability(
                "fabric backend advertises no 'gradient' capability — "
                "cannot serve value_and_gradient waves "
                f"(advertised: {sorted(self.capabilities().names())})"
            )
        ys = self.evaluate_batch(thetas, config, tenant=tenant,
                                 namespace=namespace)
        senss = np.stack([np.asarray(sens_fn(y), float).ravel() for y in ys])
        return ys, self.gradient_batch(thetas, senss, config, tenant=tenant,
                                       namespace=namespace)

    # -- collector (submit path) --------------------------------------------
    def _collector(self):
        while True:
            with self._lock:
                while not self._pending and not self._stop:
                    self._lock.wait(timeout=0.05)
                if self._stop and not self._pending:
                    return
                t_first = time.monotonic()
                while (
                    len(self._pending) < self.max_batch
                    and time.monotonic() - t_first < self.linger_s
                ):
                    self._lock.wait(timeout=self.linger_s)
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch :]
            if not batch:
                continue
            # one backend call per distinct config in the wave
            groups: dict[tuple, list] = {}
            for item in batch:
                groups.setdefault(config_key(item[1]), []).append(item)
            t0 = time.monotonic()
            for items in groups.values():
                stack = np.stack([it[0] for it in items])
                t_grp = time.monotonic()
                try:
                    outs = np.atleast_2d(
                        np.asarray(self.backend.evaluate(stack, items[0][1]))
                    )
                    if outs.shape[0] != len(items):
                        outs = outs.T
                    grp_wall = time.monotonic() - t_grp
                    # tap snapshot BEFORE futures resolve: the original
                    # submitter gets the raw rows and may mutate its
                    # result in place the instant set_result runs
                    tap_outs = np.array(outs[: len(items)])
                    # per-tenant share of this group: a mixed collector wave
                    # charges each tenant its point count and a proportional
                    # slice of the measured dispatch wall
                    tenant_points: dict[str, int] = {}
                    for it in items:
                        if it[4] is not None:
                            tenant_points[it[4]] = tenant_points.get(it[4], 0) + 1
                    with self._lock:
                        self._label_bump(items[0][1], points=len(items), waves=1)
                        self._capability_bump(
                            "evaluate", points=len(items), waves=1
                        )
                        for tname, n_t in tenant_points.items():
                            self._tenant_bump(
                                tname, points=n_t, waves=1,
                                backend_s=grp_wall * n_t / len(items),
                            )
                        for (_, _, fut, key, tname), out in zip(items, outs):
                            self._cache_put(key, out, tname)
                            self._inflight.pop(key, None)
                            self._inflight_owner.pop(key, None)
                            if not fut.done():
                                fut.set_result(out)
                    self._notify_observers(
                        "evaluate", stack, tap_outs, items[0][1]
                    )
                except Exception as e:  # noqa: BLE001
                    with self._lock:
                        for _, _, fut, key, _tname in items:
                            self._inflight.pop(key, None)
                            self._inflight_owner.pop(key, None)
                            if not fut.done():
                                fut.set_exception(e)
            with self._lock:
                self.stats["waves"] += 1
                self.stats["points"] += len(batch)
                self.stats["fill_sum"] += min(1.0, len(batch) / self.max_batch)
            self._tune(len(batch), time.monotonic() - t0)

    def _tune(self, wave_size: int, wave_latency: float):
        """Self-tune linger/max_batch from observed wave latency: linger a
        small fraction of how long a wave takes (waiting costs little when
        waves are slow, a lot when they are fast), and grow the wave cap
        whenever submits saturate it."""
        if not self.adaptive:
            return
        # the collector calls this after releasing the fabric lock, but
        # linger_s/max_batch are read by every submit and evaluate_batch —
        # re-take the lock so the tuned values publish safely
        with self._lock:
            e = self._wave_latency_ewma
            self._wave_latency_ewma = wave_latency if e is None else 0.7 * e + 0.3 * wave_latency
            self.linger_s = float(np.clip(0.25 * self._wave_latency_ewma, 2e-4, 0.05))
            if wave_size >= self.max_batch and self.max_batch < self._max_batch_cap:
                self.max_batch = min(2 * self.max_batch, self._max_batch_cap)

    # -- telemetry / lifecycle ----------------------------------------------
    def telemetry(self) -> dict:
        s = dict(self.stats)
        s["per_label"] = {k: dict(v) for k, v in s["per_label"].items()}
        s["per_capability"] = {k: dict(v) for k, v in s["per_capability"].items()}
        s["per_tenant"] = {k: dict(v) for k, v in s["per_tenant"].items()}
        looked_up = s["cache_hits"] + s["cache_misses"]
        s["cache_hit_rate"] = s["cache_hits"] / looked_up if looked_up else 0.0
        scr = s["surrogate_screened"]
        # fraction of surrogate-screened proposals that survived to pay a
        # real wave; None until a screen has run (see note_screen)
        s["screen_pass_rate"] = s["surrogate_passed"] / scr if scr else None
        # sampler steps advanced per dispatch: 1.0 for host lockstep loops,
        # ~S under fused blocks; None until a sampler has noted steps
        sw = s["sampler_waves"]
        s["steps_per_wave"] = s["sampler_steps"] / sw if sw else None
        s["mean_wave_size"] = s["points"] / s["waves"] if s["waves"] else 0.0
        s["max_batch"] = self.max_batch
        # mean fill fraction (0..1]: collector waves relative to the wave
        # cap, explicit batches full by definition
        s["wave_fill"] = s.pop("fill_sum") / s["waves"] if s["waves"] else 0.0
        s["linger_s"] = round(self.linger_s, 5)
        s["capabilities"] = sorted(self.capabilities().names())
        s["backend"] = self.backend.stats()
        back = s["backend"]
        if "padded" in back and s["points"]:
            s["padding_waste"] = back["padded"] / (back["padded"] + s["points"])
        if "busy_s" in back and back.get("evaluations"):
            n_inst = max(1, self.backend.n_instances)
            s["busy_fraction_hint"] = back["busy_s"] / n_inst
        if back.get("kind") == "router":
            # fold the router's headline numbers into the flat stats so
            # benchmarks read them without digging into the backend tree
            s["router_steals"] = back["steals"]
            s["router_imbalance"] = back["imbalance_ewma"]
            s["router_op_waves"] = back["op_waves"]
            s["backend_share"] = [b["share"] for b in back["per_backend"]]
        return s

    def shutdown(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=2.0)
        self.backend.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
