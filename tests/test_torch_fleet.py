"""PyTorch port: the elastic fleet (`core/fleet.py`: `FaultInjector`,
`FleetManager`; `core/client.py::register_servers`), with
tests/test_fleet.py's fleet, registration and router-lifecycle tests
re-pointed at the port: the `FaultInjector` chaos schedule, `FleetManager`
enroll/retire/probation/scale policies under live traffic, cross-backend
speculation with the tap-exactly-once invariant under duplication, capped
failure backoff with recovery (its checkpoint tests are in
test_torch_checkpoint.py). Plus: the same seed gives the same
`FaultInjector` schedule in both packages. Every server binds port 0."""
import threading
import time

import numpy as np
import pytest

from repro_torch.core import (
    CallableBackend,
    CampaignCheckpoint,
    EvaluationFabric,
    FabricRouter,
    FaultInjector,
    FleetManager,
)
from repro_torch.core.client import register_servers
from repro_torch.core.interface import Model
from repro_torch.distributed.fault import StepFailure


def _quad(thetas):
    thetas = np.atleast_2d(np.asarray(thetas, float))
    return np.stack([np.array([t.sum(), float((t**2).sum())]) for t in thetas])


@pytest.fixture()
def flaky_backend():
    """FlakyBackend factory: a seeded `FaultInjector` over the quadratic
    test model — the chaos fixture the fleet tests (and the elastic_fleet
    benchmark) share."""

    def make(**kw):
        return FaultInjector(CallableBackend(_quad), **kw)

    return make


# -- FaultInjector schedule ----------------------------------------------------


def test_fault_injector_schedule_is_deterministic(flaky_backend):
    inj = flaky_backend(fail_waves=(1,), kill_after=4)
    X = np.ones((2, 3))
    assert np.allclose(inj.evaluate(X, None), _quad(X))  # dispatch 0
    with pytest.raises(StepFailure):  # dispatch 1: scheduled one-shot flake
        inj.evaluate(X, None)
    inj.evaluate(X, None)  # 2
    inj.evaluate(X, None)  # 3
    assert inj.probe() and inj.alive
    with pytest.raises(StepFailure):  # dispatch 4: the kill — and it stays dead
        inj.evaluate(X, None)
    assert not inj.probe()
    with pytest.raises(StepFailure):
        inj.evaluate(X, None)
    inj.revive()
    assert inj.alive
    assert np.allclose(inj.evaluate(X, None), _quad(X))
    s = inj.stats()
    assert s["kind"] == "fault_injector" and s["dispatches"] == 7


def test_fault_injector_seeded_flakes_replay(flaky_backend):
    def failure_pattern():
        inj = flaky_backend(seed=3, p_fail=0.4)
        pat = []
        for _ in range(20):
            try:
                inj.evaluate(np.ones((1, 2)), None)
                pat.append(0)
            except StepFailure:
                pat.append(1)
        return pat

    a, b = failure_pattern(), failure_pattern()
    assert a == b and 0 < sum(a) < 20


# -- FleetManager policies -----------------------------------------------------


def test_fleet_drains_killed_member_and_reinstates_on_revival(flaky_backend):
    """Enroll/retire under load: a member dies mid-traffic -> next tick
    drains it (health probe, not streak patience); it revives -> next tick
    re-instates it; every wave stays correct throughout."""
    inj = flaky_backend()
    router = FabricRouter(
        [CallableBackend(_quad), inj, CallableBackend(_quad)],
        backoff_s=0.02, backoff_max_s=0.1,
    )
    fabric = EvaluationFabric(router, cache_size=0)
    mgr = FleetManager(fabric, retire_streak=3)
    rng = np.random.default_rng(0)
    errors = []

    def hammer(n):
        for _ in range(n):
            X = rng.standard_normal((6, 3))
            if not np.allclose(fabric.evaluate_batch(X), _quad(X)):
                errors.append("wrong rows")

    try:
        hammer(5)
        inj.kill()
        t = threading.Thread(target=hammer, args=(10,))
        t.start()
        # the kill surfaces as a failed dispatch + dead probe; the policy
        # must not need retire_streak failures (backoff starves the streak)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if 1 in mgr.tick()["drained"]:
                break
            time.sleep(0.02)
        t.join()
        assert router.admin_states()[1] == "draining"
        assert not errors  # steals kept every wave correct during the kill
        hammer(3)
        inj.revive()
        rep = mgr.tick()
        assert 1 in rep["reinstated"]
        assert router.admin_states()[1] == "live"
        assert [e["event"] for e in mgr.events] == ["drain", "reinstate"]
        hammer(3)
        assert not errors
    finally:
        fabric.shutdown()


def test_fleet_scales_up_under_queueing():
    def slow(thetas):
        time.sleep(0.1)
        return _quad(thetas)

    router = FabricRouter([CallableBackend(slow)])
    fabric = EvaluationFabric(router, cache_size=0)
    spawned = []

    def spawn():
        b = CallableBackend(_quad)
        spawned.append(b)
        return b

    mgr = FleetManager(fabric, spawn=spawn, scale_up_inflight=2.0,
                       max_backends=2)
    try:
        rng = np.random.default_rng(1)
        futs = [fabric.submit(rng.standard_normal(3)) for _ in range(24)]
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not spawned:
            mgr.tick()
            time.sleep(0.01)
        for f in futs:
            f.result()
        assert len(spawned) == 1  # max_backends=2 caps the growth
        assert router.stats()["n_backends"] == 2
        assert any(e["event"] == "spawn" for e in mgr.events)
    finally:
        fabric.shutdown()


def test_fleet_background_loop_runs_policies(flaky_backend):
    inj = flaky_backend()
    router = FabricRouter([CallableBackend(_quad), inj], backoff_s=0.02)
    fabric = EvaluationFabric(router, cache_size=0)
    mgr = FleetManager(fabric)
    try:
        mgr.start(interval_s=0.02)
        inj.kill()
        X = np.ones((4, 3))
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            fabric.evaluate_batch(X + np.random.default_rng(2).normal(size=(4, 3)))
            if router.admin_states()[1] == "draining":
                break
            time.sleep(0.02)
        assert router.admin_states()[1] == "draining"
    finally:
        mgr.stop()
        fabric.shutdown()


def test_fleet_manager_rejects_unrouted_fabric():
    fabric = EvaluationFabric(CallableBackend(_quad))
    try:
        with pytest.raises(TypeError, match="FabricRouter"):
            FleetManager(fabric)
    finally:
        fabric.shutdown()


# -- register_servers dead-list semantics -------------------------------------


class _Minimal(Model):
    def get_input_sizes(self, config=None):
        return [1]

    def get_output_sizes(self, config=None):
        return [1]

    def supports_evaluate(self):
        return True

    def __call__(self, parameters, config=None):
        return [[parameters[0][0] * 2]]


def _server_not_listening(*models):
    """A port server bound to a free port (port 0, read back) that does not
    listen yet: its URL refuses connections, as a server that is down,
    until `_start` makes it answer."""
    from http.server import ThreadingHTTPServer

    from repro_torch.core.server import _make_handler

    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler({m.name: m for m in models}),
                                 bind_and_activate=False)
    server.server_bind()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _start(server):
    server.server_activate()
    threading.Thread(target=server.serve_forever, daemon=True).start()


def test_register_servers_returns_dead_list_and_supports_reprobe():
    from repro_torch.core.server import serve_models

    server, _ = serve_models([_Minimal("forward")], 0, background=True)
    down, dead_url = _server_not_listening(_Minimal("forward"))
    try:
        live_url = f"http://127.0.0.1:{server.server_address[1]}"
        backends, dead = register_servers(
            [live_url, dead_url], return_dead=True
        )
        assert len(backends) == 1 and dead == [dead_url]
        # all-dead: allow_empty opts into an empty elastic fleet...
        empty, dead2 = register_servers(
            [dead_url], return_dead=True, allow_empty=True
        )
        assert empty == [] and dead2 == [dead_url]
        # ...while the default (and require_all) still refuse
        with pytest.raises(RuntimeError):
            register_servers([dead_url])
        with pytest.raises(RuntimeError):
            register_servers([live_url, dead_url], require_all=True)
        # the dead list is re-probe-able: enroll the late arrival by hand
        router = FabricRouter(backends)
        fabric = EvaluationFabric(router)
        try:
            out = fabric.evaluate_batch(np.array([[21.0]]))
            assert np.allclose(out, [[42.0]])
        finally:
            fabric.shutdown()
    finally:
        server.shutdown()
        server.server_close()
        down.server_close()


def test_fleet_manager_enrolls_watched_server_when_it_comes_up():
    server, url = _server_not_listening(_Minimal("forward"))
    router = FabricRouter([CallableBackend(lambda th: _quad(th)[:, :1])])
    fabric = EvaluationFabric(router)
    mgr = FleetManager(fabric, watch_urls=[url], http_timeout=5.0)
    try:
        assert mgr.tick()["enrolled"] == []  # still down: stays on the list
        _start(server)
        rep = mgr.tick()
        assert rep["enrolled"] == [url]
        assert router.stats()["n_backends"] == 2
        assert mgr.tick()["enrolled"] == []  # idempotent
    finally:
        server.shutdown()
        server.server_close()
        fabric.shutdown()


# -- speculation + tap exactly-once -------------------------------------------


def test_speculation_duplicates_straggler_tap_fires_exactly_once():
    """A backend that intermittently stalls far past its EWMA gets its late
    shards duplicated onto a fast member; first result wins, waves stay
    correct, and the training tap still fires exactly once per computed row
    (losing duplicates are dropped BELOW the tap)."""
    calls = [0]
    lock = threading.Lock()

    def straggler(thetas):
        # same baseline as its peer (the EWMA planner keeps feeding it rows),
        # but every third call stalls far past spec_factor * EWMA
        with lock:
            calls[0] += 1
            k = calls[0]
        thetas = np.atleast_2d(np.asarray(thetas, float))
        time.sleep(0.002 * len(thetas) + (0.08 if k % 3 == 0 else 0.0))
        return _quad(thetas)

    def steady(thetas):
        thetas = np.atleast_2d(np.asarray(thetas, float))
        time.sleep(0.002 * len(thetas))
        return _quad(thetas)

    router = FabricRouter(
        [CallableBackend(straggler), CallableBackend(steady)],
        spec_factor=1.5, spec_min_s=0.005,
    )
    fabric = EvaluationFabric(router, cache_size=0)
    observed = [0]

    @fabric.record_observer
    def tap(op, thetas, outs, config):
        with lock:
            observed[0] += len(np.atleast_2d(thetas))

    try:
        rng = np.random.default_rng(0)
        for _ in range(25):
            X = rng.standard_normal((8, 3))
            assert np.allclose(fabric.evaluate_batch(X), _quad(X))
        s = router.stats()
        assert s["spec_dispatches"] >= 1
        assert observed[0] == fabric.stats["points"]
    finally:
        fabric.shutdown()


def test_router_lifecycle_drains_and_removes_under_traffic():
    router = FabricRouter([CallableBackend(_quad), CallableBackend(_quad)])
    fabric = EvaluationFabric(router, cache_size=0)
    try:
        X = np.random.default_rng(3).standard_normal((8, 3))
        assert np.allclose(fabric.evaluate_batch(X), _quad(X))
        j = router.add_backend(CallableBackend(_quad))
        assert router.admin_states()[j] == "live"
        assert np.allclose(fabric.evaluate_batch(X + 1), _quad(X + 1))
        router.drain_backend(1)
        assert np.allclose(fabric.evaluate_batch(X + 2), _quad(X + 2))
        router.remove_backend(j, timeout_s=2.0)
        assert router.admin_states()[j] == "retired"
        # indices stay stable: backend 1 re-instates under its old index
        router.reinstate_backend(1)
        assert router.admin_states() == ["live", "live", "retired"]
        assert np.allclose(fabric.evaluate_batch(X + 3), _quad(X + 3))
        st = router.stats()
        assert st["n_backends"] == 3 and st["n_live"] == 2
    finally:
        fabric.shutdown()


# -- backoff cap + recovery ----------------------------------------------------


def test_failure_backoff_is_capped_and_clears_on_recovery(flaky_backend):
    inj = flaky_backend()
    router = FabricRouter(
        [inj, CallableBackend(_quad)], backoff_s=0.01, backoff_max_s=0.05
    )
    fabric = EvaluationFabric(router, cache_size=0)
    try:
        inj.kill()
        X = np.ones((4, 3))
        for k in range(6):
            fabric.evaluate_batch(X * (k + 1))  # steals keep waves alive
        # a huge streak used to overflow `backoff_s * 2**streak` (float);
        # the exponent cap keeps the next failure's backoff finite + capped
        with router._lock:
            router._fail_streak[0] = 10_000
        router._backoff_until[0] = 0.0  # let the next wave retry it
        fabric.evaluate_batch(X * 10)
        load = router.load()
        assert load["fail_streak"][0] > 10_000 - 1
        assert 0.0 < load["backoff_remaining_s"][0] <= 0.05 + 1e-6
        # recovery: one successful dispatch clears streak AND backoff
        inj.revive()
        router._backoff_until[0] = 0.0
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            fabric.evaluate_batch(np.random.default_rng(4).normal(size=(4, 3)))
            load = router.load()
            if load["fail_streak"][0] == 0:
                break
        assert load["fail_streak"][0] == 0
        assert load["backoff_remaining_s"][0] == 0.0
    finally:
        fabric.shutdown()


# -- parity with the JAX package ------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(seed=3, p_fail=0.4),
    dict(seed=11, p_fail=0.2, fail_waves=(2, 5), delay_s=(0.0, 1e-4)),
    dict(seed=0, p_fail=0.3, kill_after=15),
], ids=["flakes", "flakes_waves_jitter", "flakes_then_kill"])
def test_fault_schedule_matches_the_jax_package(kw):
    """`FaultInjector` draws from `np.random.default_rng(seed)` in both
    packages: the same seed gives the same schedule of failures and the
    same delays, dispatch for dispatch."""
    import repro.core.fabric as jax_fabric
    import repro.core.fleet as jax_fleet
    from repro.distributed.fault import StepFailure as JaxStepFailure

    def schedule(inj, failure):
        pattern = []
        for _ in range(24):
            try:
                inj.evaluate(np.ones((1, 2)), None)
                pattern.append(0)
            except failure:
                pattern.append(1)
        return pattern, inj.stats()["dispatches"], inj.rng.uniform()

    port = schedule(FaultInjector(CallableBackend(_quad), **kw), StepFailure)
    ref = schedule(jax_fleet.FaultInjector(jax_fabric.CallableBackend(_quad), **kw),
                   JaxStepFailure)
    assert port == ref
    assert 0 < sum(port[0]) < 24
