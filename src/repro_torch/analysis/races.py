"""Fabric race detector: instrumented locks + lock-order analysis.

The fabric stack (EvaluationFabric collector, FabricRouter steal/backoff,
ThreadedPool workers, OnlineGP tap) mutates shared state under a growing
set of locks. This module turns "we think the locking is right" into a
checkable property:

* `LockMonitor` — records, per thread, the order in which named locks are
  acquired, builds the global lock-order graph, and reports cycles
  (potential deadlocks). It also collects unguarded shared-field writes
  reported by `watch_fields` / `GuardedDict`: a field written by two or
  more threads where at least one write held no instrumented lock.

* `InstrumentedLock` / `InstrumentedCondition` — drop-in wrappers around
  `threading.Lock`/`RLock`/`Condition` that feed the monitor and
  (optionally) perturb the schedule with small seeded sleeps before each
  acquisition, so a stress run explores many more interleavings than the
  thread scheduler would surface on its own.

* `named_lock` / `named_rlock` / `named_condition` — the factories the
  production classes call instead of `threading.Lock()` directly. With no
  monitor activated they return the plain `threading` primitive (zero
  overhead); inside `monitored(monitor)` they return instrumented
  wrappers, so a stress harness instruments every lock in the stack just
  by constructing the objects under test inside the context.

The monitor never blocks the code under test: bookkeeping is thread-local
where possible and guarded by one internal plain lock otherwise.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Iterator

__all__ = [
    "LockMonitor",
    "InstrumentedLock",
    "InstrumentedCondition",
    "GuardedDict",
    "watch_fields",
    "named_lock",
    "named_rlock",
    "named_condition",
    "monitored",
    "activate",
    "deactivate",
    "active_monitor",
    "instrument_attr",
]


# ---------------------------------------------------------------------------
# Monitor
# ---------------------------------------------------------------------------


class LockMonitor:
    """Collects lock acquisition order, cycle candidates, and write audits.

    Lock-order edges: whenever a thread acquires lock B while already
    holding lock A, the edge A -> B is recorded. A cycle in the resulting
    graph is a potential deadlock — two threads CAN interleave into a
    deadly embrace even if this particular run did not. Reentrant
    re-acquisition of a lock already held by the same thread records no
    edge (that is what RLock/Condition are for, not a deadlock).

    Schedule perturbation: with ``perturb=True`` each acquisition may be
    preceded by a tiny sleep drawn from a per-thread seeded RNG, shaking
    the interleavings a stress run explores while staying deterministic
    enough to reproduce with the same seed and thread layout.
    """

    def __init__(self, seed: int = 0, perturb: bool = True, max_jitter_s: float = 2e-4):
        self.seed = int(seed)
        self.perturb = bool(perturb)
        self.max_jitter_s = float(max_jitter_s)
        # one plain (uninstrumented!) lock guards the cross-thread tables
        self._meta = threading.Lock()
        self._held = threading.local()
        self._n_threads_seen = 0
        self.acquisitions = 0
        self.acquisitions_by_lock: dict[str, int] = {}
        self.waits = 0
        self.edges: dict[tuple[str, str], int] = {}
        self.lock_names: set[str] = set()
        self._writes: dict[str, dict] = {}

    # -- per-thread state ---------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = []
            self._held.stack = st
        return st

    def _serial(self) -> int:
        """Monitor-local thread id. NOT `threading.get_ident()` — the OS
        recycles idents, so two sequential threads could collapse into one
        "writer" and mask a real multi-writer race."""
        s = getattr(self._held, "serial", None)
        if s is None:
            with self._meta:
                self._n_threads_seen += 1
                s = self._n_threads_seen
            self._held.serial = s
        return s

    def _rng(self) -> random.Random:
        rng = getattr(self._held, "rng", None)
        if rng is None:
            rng = random.Random(self.seed * 7919 + self._serial())
            self._held.rng = rng
        return rng

    def held_names(self) -> tuple[str, ...]:
        """Names of instrumented locks the calling thread currently holds."""
        return tuple(name for name, _ in self._stack())

    # -- hooks called by the instrumented locks -----------------------------
    def maybe_jitter(self) -> None:
        if not self.perturb:
            return
        rng = self._rng()
        if rng.random() < 0.25:
            time.sleep(rng.random() * self.max_jitter_s)

    def on_acquire(self, name: str) -> None:
        st = self._stack()
        for i, (held, count) in enumerate(st):
            if held == name:  # reentrant: no new edge, bump the hold count
                st[i] = (held, count + 1)
                return
        with self._meta:
            self.acquisitions += 1
            self.acquisitions_by_lock[name] = self.acquisitions_by_lock.get(name, 0) + 1
            self.lock_names.add(name)
            for held, _ in st:
                key = (held, name)
                self.edges[key] = self.edges.get(key, 0) + 1
        st.append((name, 1))

    def on_release(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == name:
                held, count = st[i]
                if count > 1:
                    st[i] = (held, count - 1)
                else:
                    del st[i]
                return
        # release of a lock this thread never acquired through the monitor
        # (e.g. a condition handed between threads) — nothing to unwind

    def on_wait(self) -> None:
        with self._meta:
            self.waits += 1

    # -- write auditing -----------------------------------------------------
    def note_write(self, tag: str) -> None:
        """Record a write to the shared field `tag` by the calling thread."""
        holding = bool(self._stack())
        tid = self._serial()
        with self._meta:
            rec = self._writes.setdefault(
                tag, {"threads": set(), "unlocked": 0, "total": 0}
            )
            rec["total"] += 1
            rec["threads"].add(tid)
            if not holding:
                rec["unlocked"] += 1

    def unguarded_writes(self) -> list[dict]:
        """Fields written by >= 2 threads with at least one lock-free write."""
        out = []
        with self._meta:
            for tag, rec in sorted(self._writes.items()):
                if rec["unlocked"] > 0 and len(rec["threads"]) > 1:
                    out.append(
                        {
                            "field": tag,
                            "writer_threads": len(rec["threads"]),
                            "unlocked_writes": rec["unlocked"],
                            "total_writes": rec["total"],
                        }
                    )
        return out

    # -- lock-order analysis ------------------------------------------------
    def lock_order_cycles(self) -> list[list[str]]:
        """Cycles in the lock-order graph (each a potential deadlock).

        Returns one entry per strongly connected component with more than
        one lock, plus one per self-edge; each entry lists the locks in
        the component, sorted for stable output.
        """
        with self._meta:
            edges = dict(self.edges)
        adj: dict[str, set[str]] = {}
        for (a, b), _ in edges.items():
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        # Tarjan SCC, iterative (graphs here are tiny, but be safe)
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        sccs: list[list[str]] = []
        counter = [0]

        def strongconnect(root: str) -> None:
            work = [(root, iter(sorted(adj[root])))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    sccs.append(comp)

        for node in sorted(adj):
            if node not in index:
                strongconnect(node)
        cycles = [sorted(c) for c in sccs if len(c) > 1]
        cycles += [[a] for (a, b) in edges if a == b]
        return sorted(cycles)

    def report(self) -> dict:
        with self._meta:
            edges = [[a, b, n] for (a, b), n in sorted(self.edges.items())]
            acq, waits = self.acquisitions, self.waits
            names = sorted(self.lock_names)
            by_lock = dict(sorted(self.acquisitions_by_lock.items()))
        return {
            "locks": names,
            "acquisitions": acq,
            "acquisitions_by_lock": by_lock,
            "condition_waits": waits,
            "lock_order_edges": edges,
            "lock_order_cycles": self.lock_order_cycles(),
            "unguarded_writes": self.unguarded_writes(),
        }


# ---------------------------------------------------------------------------
# Instrumented primitives
# ---------------------------------------------------------------------------


class InstrumentedLock:
    """Wraps a `threading.Lock`/`RLock`, feeding a `LockMonitor`."""

    def __init__(self, inner, name: str, monitor: LockMonitor):
        self._inner = inner
        self.name = name
        self._monitor = monitor

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._monitor.maybe_jitter()
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._monitor.on_acquire(self.name)
        return got

    def release(self) -> None:
        self._monitor.on_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedCondition(InstrumentedLock):
    """Wraps a `threading.Condition`; `wait()` is a release + re-acquire."""

    def wait(self, timeout: float | None = None) -> bool:
        self._monitor.on_wait()
        self._monitor.on_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            self._monitor.on_acquire(self.name)

    def wait_for(self, predicate, timeout: float | None = None):
        self._monitor.on_wait()
        self._monitor.on_release(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._monitor.on_acquire(self.name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def locked(self) -> bool:  # Condition has no locked(); report via stack
        return self.name in self._monitor.held_names()


# ---------------------------------------------------------------------------
# Write auditing helpers
# ---------------------------------------------------------------------------


class GuardedDict(dict):
    """A dict whose item-writes are reported to a monitor under one tag.

    Swap it in for a telemetry dict (`obj.stats = GuardedDict(mon, "x.stats",
    obj.stats)`) and every ``stats[k] = v`` / ``stats[k] += v`` write is
    audited against the calling thread's held-lock state.
    """

    def __init__(self, monitor: LockMonitor, tag: str, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._monitor = monitor
        self._tag = tag

    def __setitem__(self, key, value) -> None:
        self._monitor.note_write(self._tag)
        super().__setitem__(key, value)

    def setdefault(self, key, default=None):
        if key not in self:
            self._monitor.note_write(self._tag)
        return super().setdefault(key, default)

    def update(self, *args, **kwargs) -> None:
        self._monitor.note_write(self._tag)
        super().update(*args, **kwargs)


class watch_fields:
    """Context manager: audit attribute writes on a class.

    Patches ``cls.__setattr__`` so that writes to any of `fields` on ANY
    instance are reported to the monitor (tagged ``ClassName.field``),
    then restores the original on exit.
    """

    def __init__(self, monitor: LockMonitor, cls: type, fields, tag: str | None = None):
        self._monitor = monitor
        self._cls = cls
        self._fields = frozenset(fields)
        self._tag = tag or cls.__name__
        self._orig = None

    def __enter__(self):
        monitor, fields, tag = self._monitor, self._fields, self._tag
        self._orig = orig = self._cls.__setattr__

        def audited(obj, name, value):
            if name in fields:
                monitor.note_write(f"{tag}.{name}")
            orig(obj, name, value)

        self._cls.__setattr__ = audited
        return self

    def __exit__(self, *exc) -> None:
        self._cls.__setattr__ = self._orig


# ---------------------------------------------------------------------------
# Lock factories (the adoption surface for production code)
# ---------------------------------------------------------------------------

_active: LockMonitor | None = None
_active_guard = threading.Lock()


def activate(monitor: LockMonitor) -> None:
    """Make `named_lock`/`named_rlock`/`named_condition` hand out
    instrumented locks until `deactivate()`; nested activation is an
    error (one monitor owns the factory at a time)."""
    global _active
    with _active_guard:
        if _active is not None:
            raise RuntimeError("a LockMonitor is already active")
        _active = monitor


def deactivate() -> None:
    global _active
    with _active_guard:
        _active = None


def active_monitor() -> LockMonitor | None:
    return _active


class monitored:
    """``with monitored(mon): fabric = EvaluationFabric(...)`` — every lock
    the constructors create through the named factories is instrumented."""

    def __init__(self, monitor: LockMonitor):
        self.monitor = monitor

    def __enter__(self) -> LockMonitor:
        activate(self.monitor)
        return self.monitor

    def __exit__(self, *exc) -> None:
        deactivate()


def named_lock(name: str):
    """`threading.Lock()`, or an instrumented one inside `monitored(...)`."""
    mon = _active
    if mon is None:
        return threading.Lock()
    return InstrumentedLock(threading.Lock(), name, mon)


def named_rlock(name: str):
    """`threading.RLock()`, or an instrumented one inside `monitored(...)`."""
    mon = _active
    if mon is None:
        return threading.RLock()
    return InstrumentedLock(threading.RLock(), name, mon)


def named_condition(name: str):
    """`threading.Condition()`, or an instrumented one inside `monitored(...)`."""
    mon = _active
    if mon is None:
        return threading.Condition()
    return InstrumentedCondition(threading.Condition(), name, mon)


def instrument_attr(obj, attr: str, name: str, monitor: LockMonitor):
    """Retrofit-instrument an existing lock attribute on a live object.

    Only safe while the lock is not held. Conditions (anything with a
    `wait` method) get the condition wrapper; plain/RLocks the lock one.
    """
    cur = getattr(obj, attr)
    if isinstance(cur, InstrumentedLock):
        return cur
    cls = InstrumentedCondition if hasattr(cur, "wait") else InstrumentedLock
    wrapped = cls(cur, name, monitor)
    setattr(obj, attr, wrapped)
    return wrapped


def iter_lock_names(monitor: LockMonitor) -> Iterator[str]:
    yield from sorted(monitor.lock_names)
