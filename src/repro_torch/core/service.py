"""UQService — the multi-tenant service tier above the EvaluationFabric
(port of `repro.core.service`; numpy and the standard library only).

The paper's pitch is UQ-as-a-service: UQ experts submit campaigns against a
shared model fleet without owning the stack. The fabric made ONE
caller fast; this module makes MANY callers coexist on one fabric/router/
fleet without trampling each other:

    service = UQService(fabric, max_concurrent_waves=4)
    camp = service.open_campaign("alice", priority="high", budget=100_000)
    ys = camp.evaluate_batch(thetas, config)        # scheduled, accounted
    run_chains(..., fabric=camp)                    # drivers run unchanged

* CAMPAIGN/SESSION ABSTRACTION — `open_campaign(tenant, priority, budget)`
  returns a `Campaign` handle with the fabric's evaluator surface (submit /
  evaluate_batch / gradient_batch / apply_jacobian_batch /
  value_and_gradient_batch / as_callable / note_steps / capabilities), so
  every existing UQ driver that accepts a fabric accepts a campaign.
  Tenant identity rides each call into the fabric's wave path and telemetry.

* FAIR-SHARE + PRIORITY WAVE SCHEDULER — wave-granularity calls pass
  through a weighted deficit round-robin scheduler instead of FIFO-draining
  into the fabric: strict priority tiers (high > normal > low), DRR within
  a tier with deficits measured in ESTIMATED COST SECONDS (points x a
  per-op EWMA seeded from the router's learned service times), and an aging
  escape hatch that grants any request waiting past `aging_s` regardless of
  tier — starvation-free. Charging cost-seconds rather than waves is what
  stops a gradient-heavy tenant (~3x per-point cost) from crowding out
  evaluate-only tenants: its deficit drains 3x faster.

* PER-TENANT CACHE NAMESPACES — campaign traffic lands in a private cache
  namespace by default (two tenants evaluating the same (theta, config, op)
  NEVER share rows). A campaign opts into cross-tenant sharing per config
  (`share_configs=[...]`); shared-namespace hits are accounted to both
  sides (`shared_hits_taken` / `shared_hits_given`).

* ADMISSION CONTROL + BUDGETS — per-tenant queue and inflight-point quotas
  shed excess load with an explicit `Overloaded` (backpressure, not latency
  collapse); campaign-level eval budgets raise `BudgetExhausted`, which the
  ensemble samplers catch to land a final checkpoint and return a clean
  partial result (`terminated="budget"`).

* PER-TENANT ACCOUNTING — the fabric's `telemetry()["per_tenant"]` carries
  waves / points / cache hits / shared hits / backend-seconds; the service's
  own `telemetry()` adds scheduler economics (granted waves, sheds, aged
  grants, queue depth, p50/p99 wave latency, DRR cost charged).

Scheduling is wave-granular: `submit()` per-point futures are admission-
checked and budget-charged but ride the fabric's shared collector directly
(the collector already batches them into waves; re-queueing single points
through DRR would serialize the batching the fabric exists to do).
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np

from repro_torch.analysis.races import named_lock
from repro_torch.core.fabric import (
    BudgetExhausted,
    EvaluationFabric,
    FabricRouter,
    Overloaded,
)
from repro_torch.core.protocol import config_key

__all__ = ["UQService", "Campaign", "Overloaded", "BudgetExhausted",
           "PRIORITY_TIERS"]

#: priority classes, best first — the scheduler grants strictly by tier,
#: with weighted DRR inside a tier and aging across tiers
PRIORITY_TIERS = ("high", "normal", "low")

#: relative DRR quantum scale per tier (same-tier tenants may still differ
#: via an explicit `weight=`)
_TIER_WEIGHT = {"high": 4.0, "normal": 2.0, "low": 1.0}

#: per-op cost multiplier applied before any measured EWMA exists — a
#: gradient wave costs ~a forward plus a VJP, a fused wave both halves
_OP_COST_SCALE = {
    "evaluate": 1.0,
    "gradient": 3.0,
    "apply_jacobian": 2.0,
    "value_and_gradient": 3.0,
    # second-order: a forward tangent sweep plus the reverse sweep over it
    "apply_hessian": 4.0,
}


class _Request:
    """One wave waiting for a scheduler grant."""

    __slots__ = ("tenant", "op", "n_points", "est_cost", "grant",
                 "t_enqueue", "cancelled", "aged")

    def __init__(self, tenant: str, op: str, n_points: int, est_cost: float):
        self.tenant = tenant
        self.op = op
        self.n_points = int(n_points)
        self.est_cost = float(est_cost)
        self.grant = threading.Event()
        self.t_enqueue = time.monotonic()
        self.cancelled = False
        self.aged = False


class _TenantState:
    """Scheduler-side view of one tenant (shared by all its campaigns)."""

    def __init__(self, name: str, priority: str, weight: float):
        self.name = name
        self.priority = priority
        self.tier = PRIORITY_TIERS.index(priority)
        self.weight = float(weight)
        self.queue: deque[_Request] = deque()
        self.deficit = 0.0
        self.queued_points = 0
        self.inflight_points = 0
        self.stats = {"granted_waves": 0, "shed": 0, "aged_grants": 0,
                      "budget_stops": 0, "sched_cost_s": 0.0}
        # wave latency samples (submit -> complete, queueing included) for
        # the p99-under-overload acceptance story
        self.latencies: deque[float] = deque(maxlen=1024)


class UQService:
    """Fair-share multi-tenant scheduler over ONE `EvaluationFabric`.

    `backend` is anything `EvaluationFabric` accepts (or an existing
    fabric). Wave-granularity campaign calls block until the scheduler
    grants them one of `max_concurrent_waves` dispatch slots; grants go to
    the best non-empty priority tier, weighted-DRR within it, with requests
    older than `aging_s` granted unconditionally so low tiers cannot
    starve. `quantum_s` is the DRR quantum in cost-seconds per scheduling
    round (scaled by each tenant's weight)."""

    def __init__(
        self,
        backend,
        *,
        max_concurrent_waves: int = 2,
        quantum_s: float = 0.01,
        aging_s: float = 2.0,
        max_queued_waves: int = 256,
        max_queued_waves_per_tenant: int = 32,
        default_point_s: float = 1e-3,
    ):
        self.fabric = (backend if isinstance(backend, EvaluationFabric)
                       else EvaluationFabric(backend))
        self.max_concurrent_waves = int(max_concurrent_waves)
        self.quantum_s = float(quantum_s)
        self.aging_s = float(aging_s)
        self.max_queued_waves = int(max_queued_waves)
        self.max_queued_waves_per_tenant = int(max_queued_waves_per_tenant)
        self.default_point_s = float(default_point_s)
        self._lock = named_lock("service.scheduler")
        self._tenants: dict[str, _TenantState] = {}
        self._rr: int = 0  # round-robin cursor over tenant insertion order
        self._active_waves = 0
        self._queued_waves = 0
        # learned per-op per-point EWMA seconds (the scheduler's cost model;
        # seeded from the router's EWMA on first use)
        self._op_ewma_s: dict[str, float] = {}
        self._campaign_seq = 0
        self._closed = False

    # -- campaigns -----------------------------------------------------------
    def open_campaign(
        self,
        tenant: str,
        *,
        priority: str = "normal",
        weight: float | None = None,
        budget: int | None = None,
        max_inflight_points: int | None = None,
        share_configs: Sequence[dict | None] = (),
        campaign_id: str | None = None,
    ) -> "Campaign":
        """Open a campaign for `tenant`. `priority` picks the scheduler
        tier; `weight` overrides the tier's DRR weight for this tenant;
        `budget` caps TOTAL points this campaign may evaluate (exceeding it
        raises `BudgetExhausted`); `max_inflight_points` caps the tenant's
        queued+inflight points (`Overloaded` beyond); `share_configs` lists
        model configs whose traffic goes to the SHARED cache namespace —
        cross-tenant hits happen only between campaigns that both declared
        the config."""
        if priority not in PRIORITY_TIERS:
            raise ValueError(
                f"priority must be one of {PRIORITY_TIERS}, got {priority!r}"
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            ten = self._tenants.get(tenant)
            if ten is None:
                ten = _TenantState(
                    tenant, priority, weight or _TIER_WEIGHT[priority]
                )
                self._tenants[tenant] = ten
            else:
                # a re-opened tenant may move tiers; latest campaign wins
                ten.priority = priority
                ten.tier = PRIORITY_TIERS.index(priority)
                if weight is not None:
                    ten.weight = float(weight)
            self._campaign_seq += 1
            cid = campaign_id or f"{tenant}/c{self._campaign_seq}"
        return Campaign(
            self, ten, campaign_id=cid, budget=budget,
            max_inflight_points=max_inflight_points,
            share_configs=share_configs,
        )

    # -- cost model ----------------------------------------------------------
    def _seed_point_s(self) -> float:
        """Reuse the router's learned EWMA service times as the cost-model
        seed; single-backend fabrics start from `default_point_s` until the
        first completion teaches the real number."""
        b = self.fabric.backend
        if isinstance(b, FabricRouter):
            known = [e for e in b.load()["ewma_point_s"] if e]
            if known:
                return float(sum(known) / len(known))
        return self.default_point_s

    def _est_cost(self, op: str, n_points: int) -> float:  # caller holds the lock
        per = self._op_ewma_s.get(op)
        if per is None:
            per = self._seed_point_s() * _OP_COST_SCALE.get(op, 1.0)
        return max(n_points * per, 1e-9)

    def _learn_cost(self, op, n_points, wall):  # caller holds the lock
        per = wall / max(1, n_points)
        e = self._op_ewma_s.get(op)
        self._op_ewma_s[op] = per if e is None else 0.7 * e + 0.3 * per

    # -- scheduler core ------------------------------------------------------
    def _ring(self) -> list[_TenantState]:  # caller holds the lock
        # insertion order rotated by the RR cursor
        order = list(self._tenants.values())
        if not order:
            return order
        c = self._rr % len(order)
        return order[c:] + order[:c]

    def _grant(self, ten, aged=False):  # caller holds the lock
        req = ten.queue.popleft()
        ten.queued_points -= req.n_points
        ten.inflight_points += req.n_points
        self._queued_waves -= 1
        self._active_waves += 1
        ten.deficit -= req.est_cost
        if not ten.queue:
            # classic DRR: an emptied queue forfeits leftover credit, so an
            # idle tenant cannot hoard deficit and burst past the others
            ten.deficit = 0.0
        ten.stats["granted_waves"] += 1
        if aged:
            ten.stats["aged_grants"] += 1
            req.aged = True
        req.grant.set()

    def _schedule(self):
        """Grant queued requests into free wave slots. Caller holds the lock.

        Order of precedence per slot: (1) aging — any head request waiting
        past `aging_s` goes first, oldest first, whatever its tier
        (starvation-freedom); (2) the best non-empty priority tier, weighted
        deficit round-robin within it. When the fleet is idle and no deficit
        covers a head cost yet, rounds are fast-forwarded analytically
        instead of busy-looping."""
        while self._active_waves < self.max_concurrent_waves:
            now = time.monotonic()
            aged = [t for t in self._tenants.values()
                    if t.queue and now - t.queue[0].t_enqueue > self.aging_s]
            if aged:
                self._grant(min(aged, key=lambda t: t.queue[0].t_enqueue),
                            aged=True)
                continue
            busy = [t for t in self._tenants.values() if t.queue]
            if not busy:
                return
            tier = min(t.tier for t in busy)
            ring = [t for t in self._ring() if t.queue and t.tier == tier]
            granted = False
            for i, t in enumerate(ring):
                t.deficit += self.quantum_s * t.weight
                if t.deficit >= t.queue[0].est_cost:
                    self._grant(t)
                    # advance the cursor past the granted tenant so the
                    # next round starts with its successor
                    order = list(self._tenants.values())
                    self._rr = (order.index(t) + 1) % len(order)
                    granted = True
                    break
            if granted:
                continue
            if self._active_waves > 0:
                # deficits keep accruing on the completion-driven rounds;
                # nothing to do until a slot frees
                return
            # idle fleet, nobody qualified: fast-forward the DRR rounds so
            # the cheapest head qualifies on the next pass (equivalent to
            # running k quantum rounds, preserving the weight proportions)
            rounds = min(
                (t.queue[0].est_cost - t.deficit) / (self.quantum_s * t.weight)
                for t in ring
            )
            k = max(1, int(math.ceil(rounds)))
            for t in ring:
                t.deficit += k * self.quantum_s * t.weight

    def _enqueue(self, camp: "Campaign", op: str, n_points: int) -> tuple:
        """Admission-check, budget-charge and queue one wave; returns
        (request, tenant_state) after appending. Raises `Overloaded` /
        `BudgetExhausted` instead of queueing when quotas say no."""
        ten = camp.tenant_state
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            camp.check_open()
            camp.charge_budget(n_points)  # caller holds the lock
            if len(ten.queue) >= self.max_queued_waves_per_tenant:
                ten.stats["shed"] += 1
                raise Overloaded(
                    ten.name,
                    f"{len(ten.queue)} waves queued "
                    f"(cap {self.max_queued_waves_per_tenant})",
                )
            if (camp.max_inflight_points is not None
                    and ten.queued_points + ten.inflight_points + n_points
                    > camp.max_inflight_points):
                ten.stats["shed"] += 1
                raise Overloaded(
                    ten.name,
                    f"inflight quota {camp.max_inflight_points} points",
                )
            if self._queued_waves >= self.max_queued_waves:
                ten.stats["shed"] += 1
                raise Overloaded(
                    ten.name,
                    f"service queue full ({self.max_queued_waves} waves)",
                )
            req = _Request(ten.name, op, n_points, self._est_cost(op, n_points))
            ten.queue.append(req)
            ten.queued_points += n_points
            self._queued_waves += 1
            self._schedule()
        return req, ten

    def _run_scheduled(self, camp: "Campaign", op: str, n_points: int,
                       fn: Callable):
        """The scheduled dispatch path: admission -> grant -> dispatch ->
        charge actuals -> free the slot and reschedule."""
        try:
            req, ten = self._enqueue(camp, op, n_points)
        except Overloaded:
            self.fabric.note_tenant(camp.tenant_state.name, shed=1)
            raise
        req.grant.wait()
        if req.cancelled:
            raise RuntimeError("service closed while request was queued")
        t0 = time.monotonic()
        try:
            return fn()
        finally:
            wall = time.monotonic() - t0
            with self._lock:
                self._active_waves -= 1
                ten.inflight_points -= req.n_points
                ten.latencies.append(time.monotonic() - req.t_enqueue)
                ten.stats["sched_cost_s"] += wall
                if not req.aged:
                    # replace the estimate with the measured cost so chronic
                    # under-estimates cannot buy extra grants (the deficit
                    # debt carries into the tenant's next rounds)
                    ten.deficit -= wall - req.est_cost
                self._learn_cost(op, req.n_points, wall)
                self._schedule()

    # -- telemetry / lifecycle ----------------------------------------------
    def load(self) -> dict:
        """Queue-depth snapshot for scaling policies (`core.fleet`)."""
        with self._lock:
            return {
                "queued_waves": self._queued_waves,
                "active_waves": self._active_waves,
                "queued_points": sum(
                    t.queued_points for t in self._tenants.values()
                ),
                "per_tenant": {
                    t.name: {"queued_waves": len(t.queue),
                             "queued_points": t.queued_points,
                             "inflight_points": t.inflight_points}
                    for t in self._tenants.values()
                },
            }

    def telemetry(self) -> dict:
        """Scheduler economics per tenant + the fabric's per-tenant wave
        accounting, in one document."""
        with self._lock:
            tenants = {}
            for t in self._tenants.values():
                lat = sorted(t.latencies)
                tenants[t.name] = {
                    "priority": t.priority,
                    "weight": t.weight,
                    "queued_waves": len(t.queue),
                    "queued_points": t.queued_points,
                    "inflight_points": t.inflight_points,
                    **dict(t.stats),
                    "p50_wave_s": lat[len(lat) // 2] if lat else None,
                    "p99_wave_s": _p99(lat),
                }
            doc = {
                "tenants": tenants,
                "active_waves": self._active_waves,
                "queued_waves": self._queued_waves,
                "max_concurrent_waves": self.max_concurrent_waves,
                "op_cost_ewma_s": dict(self._op_ewma_s),
            }
        doc["fabric_per_tenant"] = self.fabric.telemetry()["per_tenant"]
        return doc

    def close(self):
        """Stop admitting work and cancel every queued request (their
        waiters raise). The fabric is NOT shut down — the service is a tier
        above it, not its owner."""
        with self._lock:
            self._closed = True
            for t in self._tenants.values():
                while t.queue:
                    req = t.queue.popleft()
                    t.queued_points -= req.n_points
                    self._queued_waves -= 1
                    req.cancelled = True
                    req.grant.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _p99(sorted_lat: list[float]) -> float | None:
    if not sorted_lat:
        return None
    return sorted_lat[min(len(sorted_lat) - 1, int(0.99 * len(sorted_lat)))]


class Campaign:
    """A tenant's session handle with the fabric's evaluator surface.

    Drop-in wherever a fabric goes: `batched_logpost(campaign, ...)`,
    `ensemble_mlda(fabric=campaign, ...)`, `cub_qmc_sobol(campaign, ...)`
    and the fused samplers' `telemetry=campaign` all work unchanged, with
    tenant identity, scheduling, budgets and cache namespacing applied
    underneath."""

    def __init__(self, service: UQService, tenant_state: _TenantState, *,
                 campaign_id: str, budget: int | None,
                 max_inflight_points: int | None,
                 share_configs: Sequence[dict | None]):
        self.service = service
        self.tenant_state = tenant_state
        self.campaign_id = campaign_id
        self.budget = None if budget is None else int(budget)
        self.max_inflight_points = max_inflight_points
        self._shared = {config_key(c) for c in share_configs}
        self.points_charged = 0
        self.closed = False

    # -- identity / bookkeeping ----------------------------------------------
    @property
    def tenant(self) -> str:
        return self.tenant_state.name

    def _ns(self, config: dict | None) -> str | None:
        """Cache namespace for `config`: the shared pool (None) only when
        this campaign declared the config shareable, else tenant-private."""
        return None if config_key(config) in self._shared else self.tenant

    def check_open(self):  # caller holds the service lock
        if self.closed:
            raise RuntimeError(f"campaign {self.campaign_id!r} is closed")

    def charge_budget(self, n_points: int):  # caller holds the service lock
        if self.budget is not None and self.points_charged + n_points > self.budget:
            self.tenant_state.stats["budget_stops"] += 1
            raise BudgetExhausted(
                self.campaign_id, self.budget, n_points, self.points_charged
            )
        self.points_charged += n_points

    @property
    def budget_remaining(self) -> int | None:
        return None if self.budget is None else self.budget - self.points_charged

    # -- evaluator surface (what UQ drivers call) -----------------------------
    def evaluate_batch(self, thetas, config: dict | None = None) -> np.ndarray:
        thetas = np.atleast_2d(np.asarray(thetas, float))
        return self.service._run_scheduled(
            self, "evaluate", len(thetas),
            lambda: self.service.fabric.evaluate_batch(
                thetas, config, tenant=self.tenant, namespace=self._ns(config)
            ),
        )

    evaluate = evaluate_batch
    __call__ = evaluate_batch

    def gradient_batch(self, thetas, senss, config: dict | None = None) -> np.ndarray:
        thetas = np.atleast_2d(np.asarray(thetas, float))
        return self.service._run_scheduled(
            self, "gradient", len(thetas),
            lambda: self.service.fabric.gradient_batch(
                thetas, senss, config,
                tenant=self.tenant, namespace=self._ns(config),
            ),
        )

    def apply_jacobian_batch(self, thetas, vecs, config: dict | None = None) -> np.ndarray:
        thetas = np.atleast_2d(np.asarray(thetas, float))
        return self.service._run_scheduled(
            self, "apply_jacobian", len(thetas),
            lambda: self.service.fabric.apply_jacobian_batch(
                thetas, vecs, config,
                tenant=self.tenant, namespace=self._ns(config),
            ),
        )

    def apply_hessian_batch(
        self, thetas, senss, vecs, config: dict | None = None
    ) -> np.ndarray:
        thetas = np.atleast_2d(np.asarray(thetas, float))
        return self.service._run_scheduled(
            self, "apply_hessian", len(thetas),
            lambda: self.service.fabric.apply_hessian_batch(
                thetas, senss, vecs, config,
                tenant=self.tenant, namespace=self._ns(config),
            ),
        )

    def value_and_gradient_batch(
        self, thetas, sens_fn: Callable, config: dict | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        thetas = np.atleast_2d(np.asarray(thetas, float))
        return self.service._run_scheduled(
            self, "value_and_gradient", len(thetas),
            lambda: self.service.fabric.value_and_gradient_batch(
                thetas, sens_fn, config,
                tenant=self.tenant, namespace=self._ns(config),
            ),
        )

    def submit(self, theta, config: dict | None = None) -> Future:
        """Per-point future: admission-checked and budget-charged, then
        handed to the fabric collector (which batches concurrent submits
        across campaigns into shared waves — see the module docstring for
        why single points skip the DRR queue)."""
        with self.service._lock:
            if self.service._closed:
                raise RuntimeError("service is closed")
            self.check_open()
            self.charge_budget(1)
        return self.service.fabric.submit(
            theta, config, tenant=self.tenant, namespace=self._ns(config)
        )

    def as_callable(self, config: dict | None = None) -> Callable:
        def f(theta):
            return self.submit(theta, config).result()

        return f

    def capabilities(self):
        return self.service.fabric.capabilities()

    # -- sampler telemetry hooks (fabric passthroughs) ------------------------
    def note_steps(self, steps: int, waves: int = 1) -> None:
        self.service.fabric.note_steps(steps, waves)

    def note_screen(self, screened: int, passed: int) -> None:
        self.service.fabric.note_screen(screened, passed)

    def note_fused_block(self, k_chains: int, steps: int) -> None:
        """Device-resident `uq.fused` blocks advance k_chains x steps model
        evaluations without a fabric wave — charge them to the campaign
        budget and surface them in per-tenant telemetry so a fused tenant's
        economics stay visible."""
        n = int(k_chains) * int(steps)
        with self.service._lock:
            self.check_open()
            self.charge_budget(n)
        self.service.fabric.note_tenant(self.tenant, fused_steps=n)

    # -- checkpoints ----------------------------------------------------------
    def checkpoint(self, directory, **kw):
        """A `CampaignCheckpoint` stamped with this campaign's id (the id
        lands in every manifest/META.json the checkpoint writes)."""
        from repro_torch.core.fleet import CampaignCheckpoint

        return CampaignCheckpoint(directory, campaign_id=self.campaign_id, **kw)

    # -- telemetry / lifecycle ------------------------------------------------
    def telemetry(self) -> dict:
        """This campaign's slice: budget state + the tenant's fabric and
        scheduler buckets."""
        doc = self.service.telemetry()
        return {
            "campaign_id": self.campaign_id,
            "tenant": self.tenant,
            "points_charged": self.points_charged,
            "budget": self.budget,
            "budget_remaining": self.budget_remaining,
            "scheduler": doc["tenants"].get(self.tenant, {}),
            "fabric": doc["fabric_per_tenant"].get(self.tenant, {}),
        }

    def close(self):
        with self.service._lock:
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
