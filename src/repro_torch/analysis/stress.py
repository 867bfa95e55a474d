"""Schedule-perturbing stress harness for the fabric stack.

Four scenarios drive the known-concurrent surfaces under an activated
`LockMonitor` (every production lock built through the `named_*`
factories is instrumented, acquisitions are jittered to shake out
interleavings), then the monitor's global view is checked:

* **tap_exactly_once** — >= 8 threads mix `EvaluationFabric.submit` and
  `evaluate_batch` over a small overlapping theta universe with an LRU
  cache smaller than the universe (so evictions force recomputation),
  while a counting observer and a `SurrogateStore` -> `OnlineGP` tap ride
  the wave stream (the GP on `device`: the GPU unless the caller names
  another, under the port's device rule). Asserts the tap's exactly-once property (per-theta
  observed rows == per-theta backend computations — no replayed cache
  hits, no dropped waves) and telemetry-counter consistency
  (cache_hits + cache_misses + coalesced == rows requested,
  points == rows computed), plus result correctness for every caller.

* **router_steal** — a `FabricRouter` over two `ThreadedPool` backends;
  one pool is shut down while caller threads hammer waves. Every wave
  must still return correct rows (the router backs the dead pool off and
  steals its shard) and at least one steal must be observed.

* **pool_shutdown** — repeated rounds of submit-hammering threads racing
  a randomly-timed `ThreadedPool.shutdown()`. Every accepted future must
  resolve (result or error — never hang), and submits after shutdown
  must raise.

* **elastic_resize** — a resize storm: >= 8 caller threads hammer waves
  through a speculating `FabricRouter` (one deliberately slow member, so
  cross-backend duplication fires) while a resizer thread concurrently
  enrolls, drains, re-instates and retires backends. Every wave must
  return correct rows (zero lost waves), the training tap must fire
  EXACTLY once per delivered row even when speculative duplicates race
  (the `tap_exactly_once` invariant under duplication), and the lifecycle
  churn + speculation must actually have happened.

The harness FAILS (report["passed"] is False) on any scenario violation,
any lock-order cycle, or any unguarded shared-field write. CLI:
``python -m repro_torch.analysis --stress [--threads N] [--seed S] [--no-perturb]
[--device D]``.
"""
from __future__ import annotations

import random
import threading
import time
from concurrent.futures import wait as futures_wait

import numpy as np

from repro_torch.analysis.races import GuardedDict, LockMonitor, monitored, watch_fields
from repro_torch.core.fabric import (
    CallableBackend,
    EvaluationFabric,
    FabricRouter,
    ThreadedBackend,
)
from repro_torch.core.interface import Model
from repro_torch.core.pool import ThreadedPool
from repro_torch.uq.surrogate import SurrogateStore

__all__ = ["run_stress"]


def _f(theta: np.ndarray) -> np.ndarray:
    """The model under stress: deterministic, cheap, 2 outputs."""
    theta = np.asarray(theta, float).ravel()
    return np.array([theta.sum(), float((theta**2).sum())])


def _universe(n: int = 24, dim: int = 3) -> np.ndarray:
    """Small overlapping theta set; rounded so byte-level cache keys from
    independently-constructed copies collide (hits/coalescing happen)."""
    rng = np.random.default_rng(12345)
    return rng.standard_normal((n, dim)).round(3)


class _CountingBackend:
    """Batched callable recording per-theta computation counts."""

    def __init__(self):
        # plain lock on purpose: harness bookkeeping must not show up in
        # the production lock-order graph
        self._count_lock = threading.Lock()
        self.computed: dict[bytes, int] = {}
        self.calls = 0

    def __call__(self, thetas):
        thetas = np.atleast_2d(np.asarray(thetas, float))
        with self._count_lock:
            self.calls += 1
            for t in thetas:
                k = t.tobytes()
                self.computed[k] = self.computed.get(k, 0) + 1
        return np.stack([_f(t) for t in thetas])

    def snapshot(self) -> dict[bytes, int]:
        with self._count_lock:
            return dict(self.computed)


class _StressModel(Model):
    """Per-point model for the ThreadedPool scenarios."""

    def __init__(self, cost_s: float = 0.0):
        super().__init__("stress")
        self.cost_s = cost_s

    def get_input_sizes(self, config=None):
        return [3]

    def get_output_sizes(self, config=None):
        return [2]

    def supports_evaluate(self):
        return True

    def __call__(self, parameters, config=None):
        if self.cost_s:
            time.sleep(self.cost_s)
        return [list(_f(parameters[0]))]


# ---------------------------------------------------------------------------
# Scenario 1: exactly-once tap + telemetry consistency
# ---------------------------------------------------------------------------


def _stress_tap_exactly_once(
    monitor: LockMonitor, n_threads: int, seed: int, rounds: int = 25, device=None
) -> dict:
    violations: list[str] = []
    backend = _CountingBackend()
    universe = _universe()
    # LRU smaller than the universe: evictions force re-computation, so the
    # exactly-once check covers the recompute path, not just first touch
    fabric = EvaluationFabric(
        CallableBackend(backend), max_batch=8, linger_s=1e-3, cache_size=16
    )
    # audit the telemetry dict + adaptively-tuned fields against held locks
    fabric.stats = GuardedDict(monitor, "fabric.stats", fabric.stats)
    store = SurrogateStore(target=lambda t, y: float(y[0]), config=None, device=device)
    fabric.record_observer(store.observe)

    observed: dict[bytes, int] = {}
    obs_lock = threading.Lock()

    @fabric.record_observer
    def _count_tap(op, thetas, outs, config):
        with obs_lock:
            for t, y in zip(thetas, outs):
                k = np.asarray(t, float).ravel().tobytes()
                observed[k] = observed.get(k, 0) + 1
                if not np.allclose(np.asarray(y).ravel(), _f(t)):
                    violations.append(f"tap saw corrupted row for theta {t}")

    requested = [0] * n_threads
    errors: list[str] = []

    def worker(k: int) -> None:
        rng = random.Random(seed * 31 + k + 1)
        try:
            for _ in range(rounds):
                if rng.random() < 0.5:
                    t = universe[rng.randrange(len(universe))]
                    out = fabric.submit(t).result(timeout=30)
                    requested[k] += 1
                    if not np.allclose(np.asarray(out).ravel(), _f(t)):
                        errors.append(f"submit returned wrong row for {t}")
                else:
                    idx = [
                        rng.randrange(len(universe))
                        for _ in range(rng.randrange(1, 6))
                    ]
                    X = universe[idx]
                    out = fabric.evaluate_batch(X)
                    requested[k] += len(idx)
                    want = np.stack([_f(t) for t in X])
                    if not np.allclose(np.asarray(out), want):
                        errors.append(f"evaluate_batch wrong rows for idx {idx}")
        except Exception as e:  # noqa: BLE001 — surface, don't hang the run
            errors.append(f"worker {k}: {e!r}")

    with watch_fields(
        monitor, EvaluationFabric, ("linger_s", "max_batch", "_wave_latency_ewma"),
        tag="fabric",
    ):
        threads = [
            threading.Thread(target=worker, args=(k,)) for k in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        # snapshot only after shutdown joins the collector: it resolves a
        # wave's futures BEFORE bumping waves/points, so an earlier read
        # could miss the final wave's telemetry
        fabric.shutdown()
        stats = dict(fabric.stats)

    violations.extend(errors)
    computed = backend.snapshot()
    n_computed = sum(computed.values())
    n_requested = sum(requested)

    if observed != computed:
        only_c = {k: v for k, v in computed.items() if observed.get(k) != v}
        only_o = {k: v for k, v in observed.items() if computed.get(k) != v}
        violations.append(
            "tap not exactly-once: "
            f"{len(only_c)} theta(s) with observed != computed "
            f"(computed side {sorted(only_c.values())}, "
            f"observed side {sorted(only_o.values())})"
        )
    classified = stats["cache_hits"] + stats["cache_misses"] + stats["coalesced"]
    if classified != n_requested:
        violations.append(
            f"telemetry drift: hits+misses+coalesced = {classified} "
            f"!= {n_requested} rows requested"
        )
    if stats["points"] != n_computed:
        violations.append(
            f"telemetry drift: points = {stats['points']} "
            f"!= {n_computed} rows computed"
        )
    tap_stats = store.stats()
    if tap_stats["points_observed"] != n_computed:
        violations.append(
            f"surrogate tap drift: ingested {tap_stats['points_observed']} "
            f"!= {n_computed} rows computed"
        )
    return {
        "passed": not violations,
        "violations": violations,
        "rows_requested": n_requested,
        "rows_computed": n_computed,
        "rows_observed": sum(observed.values()),
        "distinct_thetas": len(computed),
        "cache_hits": stats["cache_hits"],
        "cache_misses": stats["cache_misses"],
        "coalesced": stats["coalesced"],
        "waves": stats["waves"],
        "gp_window": len(store.gp),
        "gp_device": str(store.gp.device),
    }


# ---------------------------------------------------------------------------
# Scenario 2: router failover under concurrent waves
# ---------------------------------------------------------------------------


def _stress_router_steal(
    monitor: LockMonitor, n_threads: int, seed: int, rounds: int = 6
) -> dict:
    del monitor  # instrumentation arrives via the active named_* factories
    violations: list[str] = []
    pools = [
        ThreadedPool([_StressModel(0.001) for _ in range(2)]),
        ThreadedPool([_StressModel(0.001) for _ in range(2)]),
    ]
    router = FabricRouter([ThreadedBackend(p) for p in pools], backoff_s=0.05)
    fabric = EvaluationFabric(router, cache_size=0)
    universe = _universe()
    errors: list[str] = []
    first_wave_done = threading.Event()

    def worker(k: int) -> None:
        rng = random.Random(seed * 97 + k + 1)
        try:
            for r in range(rounds):
                idx = [rng.randrange(len(universe)) for _ in range(8)]
                X = universe[idx]
                out = fabric.evaluate_batch(X)
                first_wave_done.set()
                want = np.stack([_f(t) for t in X])
                if not np.allclose(np.asarray(out), want):
                    errors.append(f"worker {k} round {r}: wrong rows")
        except Exception as e:  # noqa: BLE001
            errors.append(f"worker {k}: {e!r}")

    def killer() -> None:
        # wait for live traffic, then yank a backend out from under it
        first_wave_done.wait(timeout=30)
        pools[1].shutdown()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
    kt = threading.Thread(target=killer)
    for t in threads:
        t.start()
    kt.start()
    for t in threads:
        t.join(timeout=60)
    kt.join(timeout=60)
    stats = router.stats()
    fabric.shutdown()

    violations.extend(errors)
    if stats["steals"] < 1:
        violations.append(
            "router recorded no steal — the dead backend's shard was never "
            "re-dispatched (kill may not have landed mid-traffic)"
        )
    return {
        "passed": not violations,
        "violations": violations,
        "steals": stats["steals"],
        "failures": [b["failures"] for b in stats["per_backend"]],
        "points": [b["points"] for b in stats["per_backend"]],
    }


# ---------------------------------------------------------------------------
# Scenario 3: shutdown vs submit races
# ---------------------------------------------------------------------------


def _stress_pool_shutdown(
    monitor: LockMonitor, n_threads: int, seed: int, rounds: int = 5
) -> dict:
    del monitor
    violations: list[str] = []
    theta = [1.0, 2.0, 3.0]
    want = _f(theta)
    stranded = 0
    accepted_total = 0
    refused_total = 0

    for r in range(rounds):
        rng = random.Random(seed * 131 + r)
        pool = ThreadedPool([_StressModel(0.0) for _ in range(2)])
        futs_per_thread: list[list] = [[] for _ in range(n_threads)]
        saw_refusal = [False] * n_threads

        def worker(k: int, pool=pool, futs=futs_per_thread, refused=saw_refusal):
            for _ in range(200):
                try:
                    futs[k].append(pool.submit(theta))
                except RuntimeError:
                    refused[k] = True
                    return

        threads = [
            threading.Thread(target=worker, args=(k,)) for k in range(n_threads)
        ]
        for t in threads:
            t.start()
        time.sleep(rng.uniform(0.0, 0.01))
        pool.shutdown()
        for t in threads:
            t.join(timeout=30)

        futs = [f for per in futs_per_thread for f in per]
        accepted_total += len(futs)
        refused_total += sum(saw_refusal)
        done, not_done = futures_wait(futs, timeout=10)
        if not_done:
            stranded += len(not_done)
            violations.append(
                f"round {r}: {len(not_done)} accepted future(s) never "
                "resolved — submit slipped past the shutdown drain"
            )
        for f in done:
            exc = f.exception()
            if exc is None and not np.allclose(np.asarray(f.result()), want):
                violations.append(f"round {r}: resolved future has wrong row")
                break
        try:
            pool.submit(theta)
            violations.append(f"round {r}: submit after shutdown did not raise")
        except RuntimeError:
            pass
    return {
        "passed": not violations,
        "violations": violations,
        "rounds": rounds,
        "futures_accepted": accepted_total,
        "futures_stranded": stranded,
        "threads_refused": refused_total,
    }


# ---------------------------------------------------------------------------
# Scenario 4: elastic resize storm + speculation exactly-once
# ---------------------------------------------------------------------------


def _stress_elastic_resize(
    monitor: LockMonitor, n_threads: int, seed: int, rounds: int = 6
) -> dict:
    del monitor  # instrumentation arrives via the active named_* factories
    violations: list[str] = []
    universe = _universe()

    slow_calls = [0]
    slow_lock = threading.Lock()

    def slow_backend(thetas):
        # variably slow: a steady baseline establishes the EWMA, then every
        # fourth call stalls well past spec_factor * EWMA so speculative
        # duplication actually fires against this member's own history
        with slow_lock:
            slow_calls[0] += 1
            k = slow_calls[0]
        thetas = np.atleast_2d(np.asarray(thetas, float))
        time.sleep(0.004 * len(thetas) + (0.06 if k % 4 == 3 else 0.0))
        return np.stack([_f(t) for t in thetas])

    def fast_backend(thetas):
        thetas = np.atleast_2d(np.asarray(thetas, float))
        return np.stack([_f(t) for t in thetas])

    router = FabricRouter(
        [CallableBackend(fast_backend), CallableBackend(slow_backend),
         CallableBackend(fast_backend)],
        spec_factor=1.5, spec_min_s=0.005, backoff_s=0.05,
    )
    # cache off: the tap then fires for EVERY delivered row, so delivered
    # row accounting is exact (observed == fabric points == rows requested)
    fabric = EvaluationFabric(router, cache_size=0)

    observed = [0]
    obs_lock = threading.Lock()

    @fabric.record_observer
    def _tap(op, thetas, outs, config):
        with obs_lock:
            observed[0] += len(np.atleast_2d(thetas))
            for t, y in zip(np.atleast_2d(thetas), np.atleast_2d(outs)):
                if not np.allclose(np.asarray(y).ravel(), _f(t)):
                    violations.append("tap saw corrupted row under resize")

    errors: list[str] = []
    requested = [0] * n_threads
    stop_resize = threading.Event()

    def worker(k: int) -> None:
        rng = random.Random(seed * 193 + k + 1)
        try:
            for _ in range(rounds):
                idx = [rng.randrange(len(universe)) for _ in range(8)]
                X = universe[idx]
                out = fabric.evaluate_batch(X)
                requested[k] += len(idx)
                want = np.stack([_f(t) for t in X])
                if not np.allclose(np.asarray(out), want):
                    errors.append(f"worker {k}: wrong rows under resize")
        except Exception as e:  # noqa: BLE001 — a lost wave is the violation
            errors.append(f"worker {k}: {e!r}")

    resize_counts = {"added": 0, "drained": 0, "reinstated": 0, "removed": 0}

    def resizer() -> None:
        # storm the lifecycle surface while traffic is in flight; backend 0
        # is never touched, so at least one fast member always serves
        rng = random.Random(seed * 389 + 7)
        grown: list[int] = []
        while not stop_resize.is_set():
            action = rng.randrange(4)
            if action == 0:
                grown.append(router.add_backend(CallableBackend(fast_backend)))
                resize_counts["added"] += 1
            elif action == 1:
                router.drain_backend(rng.choice([1, 2]))
                resize_counts["drained"] += 1
            elif action == 2:
                router.reinstate_backend(rng.choice([1, 2]))
                resize_counts["reinstated"] += 1
            elif grown:
                router.remove_backend(grown.pop(), timeout_s=0.2)
                resize_counts["removed"] += 1
            time.sleep(rng.uniform(0.0, 0.004))
        # leave the fleet fully live so the final waves see every member
        for i in range(len(router.backends)):
            router.reinstate_backend(i)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
    rt = threading.Thread(target=resizer)
    for t in threads:
        t.start()
    rt.start()
    for t in threads:
        t.join(timeout=60)
    stop_resize.set()
    rt.join(timeout=30)
    stats = router.stats()
    fstats = dict(fabric.stats)
    fabric.shutdown()

    violations.extend(errors)
    n_requested = sum(requested)
    # delivery-layer exactly-once: every row the fabric computed reached the
    # tap exactly once, even when speculative duplicates raced below it
    # (losing attempts are dropped under the cache/tap layer)
    if observed[0] != fstats["points"]:
        violations.append(
            f"tap not exactly-once under duplication: observed {observed[0]} "
            f"rows != {fstats['points']} computed"
        )
    accounted = fstats["cache_hits"] + fstats["cache_misses"] + fstats["coalesced"]
    if accounted != n_requested:
        violations.append(
            f"telemetry drift under resize: hits+misses+coalesced "
            f"{accounted} != {n_requested} rows requested"
        )
    if stats["spec_dispatches"] < 1:
        violations.append(
            "speculation never fired — the straggler stalls were not "
            "duplicated cross-backend"
        )
    churn = resize_counts["added"] + resize_counts["drained"]
    if churn < 2:
        violations.append(
            f"resize storm too quiet (churn={churn}) — scenario did not "
            "exercise the lifecycle under load"
        )
    return {
        "passed": not violations,
        "violations": violations,
        "rows_requested": n_requested,
        "rows_computed": fstats["points"],
        "rows_observed": observed[0],
        "fleet_size_final": stats["n_backends"],
        "spec_dispatches": stats["spec_dispatches"],
        "spec_wins": stats["spec_wins"],
        "steals": stats["steals"],
        **resize_counts,
    }


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def run_stress(
    n_threads: int = 8,
    seed: int = 0,
    perturb: bool = True,
    max_jitter_s: float = 2e-4,
    device=None,
) -> dict:
    """Run all four scenarios under one monitor; merge the lock-order
    graph across them. Returns a JSON-able report with ``passed``.
    `device` is the tap's online GP's: None is the GPU (no CPU fallback)."""
    n_threads = max(2, int(n_threads))
    monitor = LockMonitor(seed=seed, perturb=perturb, max_jitter_s=max_jitter_s)
    scenarios: dict[str, dict] = {}
    with monitored(monitor):
        scenarios["tap_exactly_once"] = _stress_tap_exactly_once(
            monitor, n_threads, seed, device=device
        )
        scenarios["router_steal"] = _stress_router_steal(monitor, n_threads, seed)
        scenarios["pool_shutdown"] = _stress_pool_shutdown(monitor, n_threads, seed)
        scenarios["elastic_resize"] = _stress_elastic_resize(monitor, n_threads, seed)
    mon_report = monitor.report()
    passed = (
        all(s["passed"] for s in scenarios.values())
        and not mon_report["lock_order_cycles"]
        and not mon_report["unguarded_writes"]
    )
    return {
        "schema": "repro-analysis-stress-v1",
        "n_threads": n_threads,
        "seed": seed,
        "perturb": perturb,
        "scenarios": scenarios,
        "monitor": mon_report,
        "passed": passed,
    }
