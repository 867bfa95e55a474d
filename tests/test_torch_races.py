"""PyTorch port: the race detector (`repro_torch.analysis.races`), with
the JAX package's race tests (`tests/test_races.py`) re-pointed at the
port, one case each: lock-order cycle detection, unguarded-write auditing,
the instrumented condition, the port's `ThreadedPool` shutdown/submit race,
and the port's stress harness (`repro_torch.analysis.stress`) with the
tap's online GP on the CPU."""
import threading
import time
from concurrent.futures import wait as futures_wait

import numpy as np
import pytest

from repro_torch.analysis.races import (
    GuardedDict,
    InstrumentedCondition,
    InstrumentedLock,
    LockMonitor,
    monitored,
    named_condition,
    named_lock,
    named_rlock,
    watch_fields,
)
from repro_torch.core.interface import Model
from repro_torch.core.pool import ThreadedPool


# -- factories ----------------------------------------------------------------


def test_factories_return_plain_primitives_without_monitor():
    assert isinstance(named_lock("a"), type(threading.Lock()))
    assert isinstance(named_rlock("b"), type(threading.RLock()))
    assert isinstance(named_condition("c"), threading.Condition)


def test_factories_return_instrumented_inside_monitored():
    mon = LockMonitor(perturb=False)
    with monitored(mon):
        lk = named_lock("a")
        cv = named_condition("c")
    assert isinstance(lk, InstrumentedLock)
    assert isinstance(cv, InstrumentedCondition)
    with lk:
        pass
    assert mon.acquisitions == 1
    with pytest.raises(RuntimeError, match="already active"):
        with monitored(mon):
            with monitored(LockMonitor()):
                pass


# -- lock-order graph ---------------------------------------------------------


def test_lock_order_cycle_detected_on_opposite_nesting():
    mon = LockMonitor(perturb=False)
    a = InstrumentedLock(threading.Lock(), "A", mon)
    b = InstrumentedLock(threading.Lock(), "B", mon)
    # sequentially (so nothing deadlocks) acquire A->B then B->A: the
    # GRAPH has the cycle even though this run interleaved safely
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert mon.lock_order_cycles() == [["A", "B"]]


def test_consistent_nesting_has_no_cycle():
    mon = LockMonitor(perturb=False)
    a = InstrumentedLock(threading.Lock(), "A", mon)
    b = InstrumentedLock(threading.Lock(), "B", mon)
    for _ in range(3):
        with a:
            with b:
                pass
    assert mon.lock_order_cycles() == []
    assert mon.edges[("A", "B")] == 3


def test_reentrant_rlock_records_no_self_edge():
    mon = LockMonitor(perturb=False)
    r = InstrumentedLock(threading.RLock(), "R", mon)
    with r:
        with r:
            pass
    assert mon.lock_order_cycles() == []
    assert mon.acquisitions == 1  # the reentrant acquire is a hold-count bump


# -- write auditing -----------------------------------------------------------


class _Racy:
    def __init__(self, lock):
        self._lock = lock
        self.counter = 0

    def bump_guarded(self):
        with self._lock:
            self.counter += 1

    def bump_racy(self):
        self.counter += 1


def test_watch_fields_flags_multi_thread_unlocked_writes():
    mon = LockMonitor(perturb=False)
    obj = _Racy(InstrumentedLock(threading.Lock(), "racy", mon))
    with watch_fields(mon, _Racy, ("counter",), tag="racy"):
        ts = [threading.Thread(target=obj.bump_racy) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    bad = mon.unguarded_writes()
    assert len(bad) == 1 and bad[0]["field"] == "racy.counter"
    assert bad[0]["writer_threads"] == 2


def test_watch_fields_silent_on_guarded_writes():
    mon = LockMonitor(perturb=False)
    obj = _Racy(InstrumentedLock(threading.Lock(), "racy", mon))
    with watch_fields(mon, _Racy, ("counter",), tag="racy"):
        ts = [threading.Thread(target=obj.bump_guarded) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert mon.unguarded_writes() == []
    # single-threaded unlocked writes are fine too (no sharing)
    obj2 = _Racy(InstrumentedLock(threading.Lock(), "racy2", mon))
    with watch_fields(mon, _Racy, ("counter",), tag="single"):
        obj2.bump_racy()
    assert mon.unguarded_writes() == []


def test_guarded_dict_audits_item_writes():
    mon = LockMonitor(perturb=False)
    lk = InstrumentedLock(threading.Lock(), "stats", mon)
    d = GuardedDict(mon, "t.stats", {"n": 0})

    def unlocked():
        d["n"] += 1

    def locked():
        with lk:
            d["n"] += 1

    ts = [threading.Thread(target=unlocked), threading.Thread(target=locked)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    bad = mon.unguarded_writes()
    assert [b["field"] for b in bad] == ["t.stats"]
    assert bad[0]["unlocked_writes"] == 1


# -- instrumented condition ---------------------------------------------------


def test_instrumented_condition_wait_notify_round_trip():
    mon = LockMonitor(perturb=False)
    cv = InstrumentedCondition(threading.Condition(), "cv", mon)
    ready = []

    def consumer():
        with cv:
            while not ready:
                cv.wait(timeout=5)
            ready.append("consumed")

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.02)
    with cv:
        ready.append("produced")
        cv.notify_all()
    t.join(timeout=5)
    assert ready == ["produced", "consumed"]
    assert mon.waits >= 1
    # wait() released and re-acquired without corrupting the held stack
    assert mon.held_names() == ()
    assert mon.lock_order_cycles() == []


# -- ThreadedPool shutdown/submit race regression -----------------------------


class _InstantModel(Model):
    def __init__(self):
        super().__init__("instant")

    def get_input_sizes(self, c=None):
        return [2]

    def get_output_sizes(self, c=None):
        return [1]

    def supports_evaluate(self):
        return True

    def __call__(self, p, c=None):
        return [[float(np.sum(p[0]))]]


def test_pool_submit_vs_shutdown_never_strands_futures():
    """The check-then-put race: a submit racing shutdown
    must either be refused (RuntimeError) or produce a future that
    RESOLVES — never a future stranded behind the drain."""
    for trial in range(10):
        pool = ThreadedPool([_InstantModel() for _ in range(2)])
        futs = []
        refused = threading.Event()
        started = threading.Event()

        def hammer():
            started.set()
            for _ in range(500):
                try:
                    futs.append(pool.submit([1.0, 2.0]))
                except RuntimeError:
                    refused.set()
                    return

        t = threading.Thread(target=hammer)
        t.start()
        started.wait(timeout=5)
        time.sleep(0.0005 * trial)
        pool.shutdown()
        t.join(timeout=10)
        done, not_done = futures_wait(futs, timeout=10)
        assert not not_done, (
            f"trial {trial}: {len(not_done)} future(s) stranded by shutdown"
        )
        for f in done:
            if f.exception() is None:
                assert f.result()[0] == pytest.approx(3.0)
        with pytest.raises(RuntimeError, match="shut down"):
            pool.submit([1.0, 2.0])


def test_pool_worker_retry_respects_shutdown_drain():
    """A failing request re-queued by the retry path must not slip behind
    the drain either: after shutdown every future is resolved."""

    class _Flaky(_InstantModel):
        def __call__(self, p, c=None):
            raise RuntimeError("instance down")

    pool = ThreadedPool([_Flaky() for _ in range(2)], max_retries=50)
    futs = [pool.submit([1.0, 2.0]) for _ in range(8)]
    time.sleep(0.02)
    pool.shutdown()
    done, not_done = futures_wait(futs, timeout=10)
    assert not not_done
    assert all(f.exception() is not None for f in done)


# -- stress harness smoke -----------------------------------------------------


@pytest.mark.slow
def test_stress_harness_clean_at_8_threads():
    from repro_torch.analysis.stress import run_stress

    report = run_stress(n_threads=8, seed=0, perturb=True, device="cpu")
    assert report["passed"], report
    assert report["monitor"]["lock_order_cycles"] == []
    assert report["monitor"]["unguarded_writes"] == []
    tap = report["scenarios"]["tap_exactly_once"]
    assert tap["rows_observed"] == tap["rows_computed"]
    assert tap["gp_device"] == "cpu"


def test_monitor_counts_acquisitions_by_lock():
    """The port's monitor also counts acquisitions per lock (a check that a
    given lock was taken at all, e.g. the CUDA capture lock); reentrant
    acquires are hold-count bumps there too."""
    mon = LockMonitor(perturb=False)
    a = InstrumentedLock(threading.Lock(), "A", mon)
    r = InstrumentedLock(threading.RLock(), "R", mon)
    for _ in range(3):
        with a:
            with r:
                with r:
                    pass
    assert mon.acquisitions_by_lock == {"A": 3, "R": 3}
    assert mon.report()["acquisitions_by_lock"] == {"A": 3, "R": 3}
