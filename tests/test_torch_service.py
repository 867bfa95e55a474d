"""PyTorch port: the multi-tenant service tier (`core/service.py`), with
tests/test_service.py re-pointed at the port (the same scenarios and
margins): campaign handles, fair-share wave scheduling, per-tenant cache
namespaces, admission control, budgets, and the per-tenant accounting that
flows through fabric / server / fleet. Plus one parity test: the same
two-tenant MLDA scenario under each package's `UQService` gives the same
samples and the same per-tenant accounting. Every server binds port 0.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from repro_torch.core import client as client_mod
from repro_torch.core.client import HTTPModel
from repro_torch.core.fabric import (
    BudgetExhausted,
    CallableBackend,
    EvaluationFabric,
    FabricRouter,
    Overloaded,
    ThreadedBackend,
)
from repro_torch.core.fleet import CampaignCheckpoint, FleetManager
from repro_torch.core.interface import Model
from repro_torch.core.pool import ThreadedPool
from repro_torch.core.server import serve_models
from repro_torch.core.service import UQService
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.uq.mcmc import batched_logpost, ensemble_random_walk_metropolis
from repro_torch.uq.mlda import ensemble_mlda


def _quad(thetas, config=None):
    shift = -0.5 if (config or {}).get("level") == 0 else 1.0
    return ((np.atleast_2d(np.asarray(thetas, float)) - shift) ** 2).sum(
        1, keepdims=True
    )


def _loglik(y):
    return -0.5 * float(y[0])


def _svc(cost_s: float = 0.0, cache_size: int = 1024, **kw) -> UQService:
    def model(thetas, config):
        if cost_s:
            time.sleep(cost_s)
        return _quad(thetas, config)

    kw.setdefault("max_concurrent_waves", 2)
    return UQService(
        EvaluationFabric(CallableBackend(model), cache_size=cache_size), **kw
    )


def _wait(pred, timeout: float = 5.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.005)
    return False


# -- satellite: reset_stats is atomic and complete ----------------------------


def test_reset_stats_zeroes_every_key_and_cascades_to_router():
    router = FabricRouter([CallableBackend(_quad), CallableBackend(_quad)])
    fab = EvaluationFabric(router, cache_size=256)
    try:
        fab.label_config({"level": 1}, "fine")
        X = np.arange(8.0).reshape(4, 2)
        fab.evaluate_batch(X, {"level": 1}, tenant="alice")
        fab.evaluate_batch(X, {"level": 1}, tenant="alice")  # cache hits
        keys_before = set(fab.stats.keys())
        assert fab.stats["points"] > 0 and fab.stats["cache_hits"] > 0
        assert fab.telemetry()["per_tenant"]["alice"]["points"] == 4
        ewma_before = router.load()["ewma_point_s"]
        assert any(e is not None for e in ewma_before)

        fab.reset_stats()

        # same key set, every scalar counter zero, every nested bucket reset
        assert set(fab.stats.keys()) == keys_before
        for k, v in fab.stats.items():
            if not isinstance(v, dict):
                assert v == 0, f"stats[{k!r}] survived reset: {v}"
        assert fab.stats["per_capability"] == {}
        assert fab.stats["per_tenant"] == {}
        # registered labels survive, zeroed (attribution keeps working)
        assert fab.stats["per_label"] == {
            "fine": {"points": 0, "waves": 0, "cache_hits": 0, "cache_misses": 0}
        }
        # cascade: the router's traffic counters reset, learned EWMA kept
        after = router.load()["ewma_point_s"]
        assert after == ewma_before
        rstats = router.stats()
        assert rstats["waves"] == 0
        assert all(pb["points"] == 0 for pb in rstats["per_backend"])
        # telemetry derivations stay well-defined on the zeroed state
        t = fab.telemetry()
        assert t["cache_hit_rate"] == 0.0 and t["per_tenant"] == {}
    finally:
        fab.shutdown()


# -- satellite: probe timeout plumbed through registration --------------------


def test_register_servers_probe_timeout_propagates(monkeypatch):
    seen = []

    def fake_probe(url, timeout=5.0):
        seen.append((url, timeout))
        return None

    monkeypatch.setattr(client_mod, "probe_health", fake_probe)
    backends, dead = client_mod.register_servers(
        ["http://127.0.0.1:1"], probe_timeout_s=0.25,
        return_dead=True, allow_empty=True,
    )
    assert backends == [] and dead == ["http://127.0.0.1:1"]
    assert seen == [("http://127.0.0.1:1", 0.25)]


# -- cache namespaces ---------------------------------------------------------


def test_private_namespaces_never_collide():
    calls = [0]

    def model(thetas, config):
        calls[0] += 1
        return _quad(thetas, config)

    svc = UQService(EvaluationFabric(CallableBackend(model), cache_size=256))
    X = np.arange(8.0).reshape(4, 2)
    try:
        with svc.open_campaign("a") as a, svc.open_campaign("b") as b:
            ya = a.evaluate_batch(X)
            yb = b.evaluate_batch(X)  # same thetas, DIFFERENT namespace
        assert calls[0] == 2, "tenant b must pay its own wave"
        np.testing.assert_allclose(ya, yb)
        pt = svc.fabric.telemetry()["per_tenant"]
        assert pt["b"]["cache_hits"] == 0
        assert pt["b"]["shared_hits_taken"] == 0
        # a SECOND campaign of the SAME tenant reuses the tenant namespace
        with svc.open_campaign("a") as a2:
            a2.evaluate_batch(X)
        assert calls[0] == 2
        assert svc.fabric.telemetry()["per_tenant"]["a"]["cache_hits"] == 4
    finally:
        svc.close()
        svc.fabric.shutdown()


def test_opt_in_sharing_hits_exactly_on_declared_config():
    calls = [0]

    def model(thetas, config):
        calls[0] += 1
        return _quad(thetas, config)

    svc = UQService(EvaluationFabric(CallableBackend(model), cache_size=256))
    X = np.arange(8.0).reshape(4, 2)
    fine = {"level": 1}
    try:
        a = svc.open_campaign("a", share_configs=[fine])
        b = svc.open_campaign("b", share_configs=[fine])
        c = svc.open_campaign("c")  # did NOT declare
        a.evaluate_batch(X, fine)
        b.evaluate_batch(X, fine)  # rides a's shared rows
        assert calls[0] == 1
        pt = svc.fabric.telemetry()["per_tenant"]
        assert pt["b"]["shared_hits_taken"] == 4
        assert pt["a"]["shared_hits_given"] == 4
        # the declaration is per-CONFIG: an undeclared config stays private
        b.evaluate_batch(X, {"level": 0})
        a.evaluate_batch(X, {"level": 0})
        assert calls[0] == 3
        # one-sided declaration shares nothing: c pays its own wave
        c.evaluate_batch(X, fine)
        assert calls[0] == 4
        assert svc.fabric.telemetry()["per_tenant"]["c"]["shared_hits_taken"] == 0
    finally:
        svc.close()
        svc.fabric.shutdown()


# -- scheduler: priority, fairness, aging -------------------------------------


def test_priority_tier_granted_before_earlier_low_request():
    svc = _svc(cost_s=0.15, max_concurrent_waves=1, aging_s=30.0)
    order = []
    X = np.ones((2, 2))

    def run(camp, tag):
        camp.evaluate_batch(X)
        order.append(tag)

    try:
        bl = svc.open_campaign("blocker")
        lo = svc.open_campaign("lo", priority="low")
        hi = svc.open_campaign("hi", priority="high")
        threads = [threading.Thread(target=run, args=(bl, "blocker"), daemon=True)]
        threads[0].start()
        assert _wait(lambda: svc.load()["active_waves"] == 1)
        threads.append(threading.Thread(target=run, args=(lo, "lo"), daemon=True))
        threads[1].start()
        assert _wait(lambda: svc.load()["queued_waves"] == 1)
        threads.append(threading.Thread(target=run, args=(hi, "hi"), daemon=True))
        threads[2].start()
        assert _wait(lambda: svc.load()["queued_waves"] == 2)
        for t in threads:
            t.join(timeout=10)
        # the low request was enqueued FIRST, but the freed slot goes to the
        # high tier — strict precedence, not FIFO
        assert order == ["blocker", "hi", "lo"]
    finally:
        svc.close()
        svc.fabric.shutdown()


def test_weighted_fair_share_under_saturation():
    # quantum small vs wave cost so a grant needs several DRR rounds —
    # that is the regime where the 3x weight shows up in the grant ratio
    svc = _svc(cost_s=0.008, max_concurrent_waves=1, aging_s=30.0,
               quantum_s=0.001)
    heavy = svc.open_campaign("heavy", weight=3.0)
    light = svc.open_campaign("light", weight=1.0)
    stop = threading.Event()

    def worker(camp, seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                camp.evaluate_batch(rng.standard_normal((4, 2)))
            except RuntimeError:
                return  # service closed under us at teardown

    threads = [
        threading.Thread(target=worker, args=(c, s), daemon=True)
        for c, s in ((heavy, 1), (heavy, 2), (light, 3), (light, 4))
    ]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        tel = svc.telemetry()["tenants"]
        h, l = tel["heavy"]["granted_waves"], tel["light"]["granted_waves"]
        # 3x DRR weight must buy a clearly larger share (exact 3x only in
        # the fluid limit; 1.4x keeps the assert robust on loaded runners)
        assert h > 1.4 * l, f"weight-3 tenant got {h} waves vs {l}"
    finally:
        stop.set()
        svc.close()
        svc.fabric.shutdown()


def test_aging_rescues_low_tier_from_persistent_high_load():
    svc = _svc(cost_s=0.01, max_concurrent_waves=1, aging_s=0.08)
    hi = svc.open_campaign("hi", priority="high")
    lo = svc.open_campaign("lo", priority="low")
    stop = threading.Event()

    def flood(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                hi.evaluate_batch(rng.standard_normal((4, 2)))
            except (Overloaded, RuntimeError):
                time.sleep(0.005)

    threads = [threading.Thread(target=flood, args=(s,), daemon=True)
               for s in (1, 2, 3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)  # let the high tier own every slot
        t0 = time.monotonic()
        lo.evaluate_batch(np.ones((4, 2)))
        dt = time.monotonic() - t0
        assert dt < 2.0, f"low tier starved for {dt:.1f}s despite aging"
        assert svc.telemetry()["tenants"]["lo"]["aged_grants"] >= 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        svc.close()
        svc.fabric.shutdown()


# -- admission control --------------------------------------------------------


def test_overloaded_on_per_tenant_queue_cap():
    svc = _svc(cost_s=0.2, max_concurrent_waves=1,
               max_queued_waves_per_tenant=1, aging_s=30.0)
    a = svc.open_campaign("a")
    X = np.ones((2, 2))
    threads = []
    try:
        threads.append(threading.Thread(
            target=lambda: a.evaluate_batch(X), daemon=True))
        threads[0].start()
        assert _wait(lambda: svc.load()["active_waves"] == 1)
        threads.append(threading.Thread(
            target=lambda: a.evaluate_batch(2 * X), daemon=True))
        threads[1].start()
        assert _wait(lambda: svc.load()["queued_waves"] == 1)
        with pytest.raises(Overloaded) as exc:
            a.evaluate_batch(3 * X)
        assert exc.value.tenant == "a"
        assert svc.telemetry()["tenants"]["a"]["shed"] == 1
        # the shed is visible in the fabric's per-tenant economics too
        assert svc.fabric.telemetry()["per_tenant"]["a"]["shed"] == 1
    finally:
        for t in threads:
            t.join(timeout=10)
        svc.close()
        svc.fabric.shutdown()


def test_overloaded_on_inflight_point_quota():
    svc = _svc()
    try:
        camp = svc.open_campaign("q", max_inflight_points=4)
        with pytest.raises(Overloaded):
            camp.evaluate_batch(np.ones((8, 2)))
        # within quota still flows
        out = camp.evaluate_batch(np.ones((2, 2)))
        np.testing.assert_allclose(np.asarray(out).ravel(), _quad(np.ones((2, 2))).ravel())
    finally:
        svc.close()
        svc.fabric.shutdown()


# -- budgets ------------------------------------------------------------------


def test_budget_terminates_rwm_cleanly_mid_run():
    svc = _svc()
    K, budget_steps, n_steps = 8, 6, 20
    try:
        camp = svc.open_campaign("b", budget=K * budget_steps)
        lp = batched_logpost(camp, _loglik)
        x0s = np.random.default_rng(1).standard_normal((K, 2))
        res = ensemble_random_walk_metropolis(
            lp, x0s, n_steps, 0.5 * np.eye(2), np.random.default_rng(2)
        )
        assert res.terminated == "budget"
        assert 0 < res.samples.shape[1] < n_steps
        assert np.isfinite(res.samples).all() and np.isfinite(res.logposts).all()
        assert camp.points_charged <= camp.budget
        assert camp.budget_remaining >= 0
        assert svc.telemetry()["tenants"]["b"]["budget_stops"] >= 1
    finally:
        svc.close()
        svc.fabric.shutdown()


def test_budget_mlda_lands_final_checkpoint_with_campaign_id(tmp_path):
    svc = _svc()
    K, n_samples = 4, 40
    kw = dict(
        loglik=_loglik, level_configs=[{"level": 0}, {"level": 1}],
    )
    x0s = np.random.default_rng(7).standard_normal((K, 2)) * 0.3 + 1.0
    try:
        camp = svc.open_campaign("m", budget=400, campaign_id="m/tsunami-1")
        res = ensemble_mlda(
            None, x0s, n_samples, [2], 0.5 * np.eye(2),
            np.random.default_rng(5), fabric=camp,
            checkpoint=camp.checkpoint(tmp_path), **kw,
        )
        assert res.terminated == "budget"
        n_done = res.samples.shape[1]
        assert 0 < n_done < n_samples

        # the budget boundary landed an attributable, resumable checkpoint
        doc = CheckpointManager(tmp_path).meta()
        assert doc["campaign_id"] == "m/tsunami-1"
        saved_meta = doc["manifest"]["meta"]
        assert saved_meta["campaign_id"] == "m/tsunami-1"
        assert saved_meta["terminated"] == "budget"
        assert saved_meta["i_next"] == n_done

        # a re-opened campaign (fresh budget) resumes exactly at the
        # boundary and finishes the run; the prefix is bit-identical
        camp2 = svc.open_campaign("m", campaign_id="m/tsunami-2")
        res2 = ensemble_mlda(
            None, x0s, n_samples, [2], 0.5 * np.eye(2),
            np.random.default_rng(99), fabric=camp2,
            checkpoint=camp2.checkpoint(tmp_path), **kw,
        )
        assert res2.terminated is None
        assert res2.samples.shape[1] == n_samples
        np.testing.assert_array_equal(res2.samples[:, :n_done], res.samples)
    finally:
        svc.close()
        svc.fabric.shutdown()


# -- accounting invariant under a concurrent storm ----------------------------


def test_multi_campaign_storm_accounting_invariant():
    """8 threads, 4 tenants, overlapping thetas: for every tenant each
    requested point lands in EXACTLY one of {cache_hits, cache_misses,
    coalesced} — nothing double-counted, nothing lost."""

    def mk(cost_s):
        class _M(Model):
            def __init__(self):
                super().__init__("forward")

            def get_input_sizes(self, c=None):
                return [2]

            def get_output_sizes(self, c=None):
                return [1]

            def supports_evaluate(self):
                return True

            def __call__(self, p, c=None):
                time.sleep(cost_s)
                return [[float(_quad(np.asarray(p[0]))[0, 0])]]

        return _M()

    svc = UQService(
        EvaluationFabric(
            ThreadedBackend(ThreadedPool([mk(0.001), mk(0.001)])),
            cache_size=4096,
        ),
        max_concurrent_waves=4,
    )
    pool = np.random.default_rng(0).standard_normal((16, 2))
    requested = {t: 0 for t in ("s0", "s1", "p0", "p1")}
    req_lock = threading.Lock()
    camps = {
        "s0": svc.open_campaign("s0", share_configs=[None]),
        "s1": svc.open_campaign("s1", share_configs=[None]),
        "p0": svc.open_campaign("p0"),
        "p1": svc.open_campaign("p1", priority="low"),
    }

    def storm(tenant, seed):
        rng = np.random.default_rng(seed)
        for _ in range(15):
            thetas = pool[rng.integers(0, len(pool), size=8)]
            camps[tenant].evaluate_batch(thetas)
            with req_lock:
                requested[tenant] += len(thetas)

    threads = [
        threading.Thread(target=storm, args=(t, 10 * i + j), daemon=True)
        for i, t in enumerate(requested)
        for j in range(2)
    ]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        pt = svc.fabric.telemetry()["per_tenant"]
        for tenant, n_req in requested.items():
            got = (pt[tenant]["cache_hits"] + pt[tenant]["cache_misses"]
                   + pt[tenant]["coalesced"])
            assert got == n_req, (
                f"{tenant}: {got} accounted vs {n_req} requested — "
                f"bucket split {pt[tenant]}"
            )
        # private tenants trace the same theta pool yet never cross-hit
        assert pt["p0"]["shared_hits_taken"] == 0
        assert pt["p1"]["shared_hits_taken"] == 0
    finally:
        svc.close()
        svc.fabric.shutdown()


# -- tenant identity on the wire ----------------------------------------------


class _WireModel(Model):
    def __init__(self):
        super().__init__("forward")

    def get_input_sizes(self, c=None):
        return [2]

    def get_output_sizes(self, c=None):
        return [1]

    def supports_evaluate(self):
        return True

    def __call__(self, p, c=None):
        return [[float(np.sum(np.asarray(p[0], float) ** 2))]]


def test_tenant_header_reaches_server_tenants_endpoint():
    server, _ = serve_models([_WireModel()], 0, background=True)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        # registration-level tenancy: every request the enrolled backend
        # issues carries X-UQ-Tenant
        backends = client_mod.register_servers(
            [url], tenant="alice", probe_timeout_s=2.0
        )
        fab = EvaluationFabric(backends[0], cache_size=0)
        try:
            # distinct rows — identical thetas would coalesce to one point
            fab.evaluate_batch(np.arange(6.0).reshape(3, 2))
        finally:
            fab.shutdown()
        # plus a second tenant straight through HTTPModel
        HTTPModel(url, "forward", tenant="bob").evaluate_batch(
            np.arange(4.0).reshape(2, 2)
        )
        with urllib.request.urlopen(url + "/Tenants", timeout=5.0) as resp:
            doc = json.loads(resp.read())
        assert doc["tenants"]["alice"]["points"] >= 3
        assert doc["tenants"]["alice"]["requests"] >= 1
        assert doc["tenants"]["bob"]["points"] >= 2
    finally:
        server.shutdown()
        server.server_close()


# -- fleet scaling sees the service backlog -----------------------------------


def test_fleet_scales_up_on_service_queue_backlog():
    router = FabricRouter([CallableBackend(_quad)])
    fab = EvaluationFabric(router)

    class _Backlogged:
        """UQService.load() shape with a deep scheduler queue."""

        def load(self):
            return {"queued_waves": 12, "active_waves": 0,
                    "queued_points": 48, "per_tenant": {}}

    try:
        mgr = FleetManager(
            fab, spawn=lambda: CallableBackend(_quad),
            service=_Backlogged(), scale_up_queued_waves=4.0,
            scale_up_inflight=1e9,  # the router alone would never trigger
        )
        report = mgr.tick()
        assert report["spawned"] == 1
        spawn_events = [e for e in mgr.events if e["event"] == "spawn"]
        assert spawn_events and spawn_events[0]["queued_waves_per_live"] == 12.0
        assert len(router.backends) == 2
    finally:
        fab.shutdown()


# -- drop-in equivalence ------------------------------------------------------


def test_campaign_is_dropin_equivalent_to_fabric():
    x0s = np.random.default_rng(3).standard_normal((6, 2))

    def run(evaluator):
        lp = batched_logpost(evaluator, _loglik)
        return ensemble_random_walk_metropolis(
            lp, x0s, 30, 0.5 * np.eye(2), np.random.default_rng(9)
        )

    fab = EvaluationFabric(CallableBackend(_quad), cache_size=256)
    try:
        ref = run(fab)
    finally:
        fab.shutdown()
    svc = _svc()
    try:
        res = run(svc.open_campaign("t"))
    finally:
        svc.close()
        svc.fabric.shutdown()
    np.testing.assert_array_equal(res.samples, ref.samples)
    np.testing.assert_array_equal(res.logposts, ref.logposts)
    assert res.terminated is None


def test_closed_service_and_campaign_reject_new_work():
    svc = _svc()
    camp = svc.open_campaign("t")
    camp.close()
    with pytest.raises(RuntimeError, match="closed"):
        camp.evaluate_batch(np.ones((2, 2)))
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.open_campaign("u")
    svc.fabric.shutdown()


# -- parity with the JAX package ------------------------------------------------


def _two_tenant_mlda(UQService_, EvaluationFabric_, CallableBackend_, ensemble_mlda_):
    """Two tenants (high and low priority, weights 2 : 1), each running a
    two-level MLDA campaign with its own seed in its own thread, over one
    service on one fabric of the numpy model `_quad`."""
    svc = UQService_(EvaluationFabric_(CallableBackend_(_quad), cache_size=1024),
                     max_concurrent_waves=2)
    out, errors = {}, []

    def run(tenant, priority, weight, seed):
        try:
            camp = svc.open_campaign(tenant, priority=priority, weight=weight)
            x0s = np.random.default_rng(seed).standard_normal((4, 2)) * 0.3 + 1.0
            res = ensemble_mlda_(
                None, x0s, 12, [2], 0.5 * np.eye(2), np.random.default_rng(seed + 1),
                fabric=camp, loglik=_loglik, level_configs=[{"level": 0}, {"level": 1}],
            )
            out[tenant] = (res, camp.points_charged)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=a, daemon=True)
               for a in (("hi", "high", 2.0, 11), ("lo", "low", 1.0, 23))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        tel = svc.telemetry()
    finally:
        svc.close()
        svc.fabric.shutdown()
    return out, tel


def test_two_tenant_mlda_matches_the_jax_service():
    import repro.core.fabric as jax_fabric
    import repro.core.service as jax_service
    import repro.uq.mlda as jax_mlda

    port, port_tel = _two_tenant_mlda(UQService, EvaluationFabric, CallableBackend,
                                      ensemble_mlda)
    ref, ref_tel = _two_tenant_mlda(jax_service.UQService, jax_fabric.EvaluationFabric,
                                    jax_fabric.CallableBackend, jax_mlda.ensemble_mlda)
    for tenant in ("hi", "lo"):
        (res, charged), (want, want_charged) = port[tenant], ref[tenant]
        np.testing.assert_array_equal(res.samples, want.samples)
        assert res.evals_per_level == want.evals_per_level
        assert res.n_waves == want.n_waves
        assert charged == want_charged > 0
        sched, want_sched = port_tel["tenants"][tenant], ref_tel["tenants"][tenant]
        assert sched["granted_waves"] == want_sched["granted_waves"] > 0
        assert (sched["priority"], sched["weight"]) == (want_sched["priority"],
                                                        want_sched["weight"])
        fab, want_fab = (t["fabric_per_tenant"][tenant] for t in (port_tel, ref_tel))
        for key in ("waves", "points", "cache_hits", "cache_misses", "coalesced",
                    "shared_hits_taken"):
            assert fab[key] == want_fab[key], (tenant, key, fab, want_fab)


# -- device-resident fused blocks under a campaign ------------------------------


def test_fused_blocks_charge_the_campaign_budget():
    """The fused runners (`uq.fused`) call the campaign's `note_fused_block`
    after every block: K x S evaluations charged to the budget and surfaced
    as the tenant's `fused_steps`; a budget smaller than the run stops it
    with `BudgetExhausted` at a block boundary."""
    import torch

    from repro_torch.uq.fused import fused_ensemble_rwm, gaussian_target

    lp = gaussian_target(np.array([1.0, -0.5]), np.eye(2))
    x0s = np.random.default_rng(4).standard_normal((6, 2))
    svc = _svc()
    try:
        camp = svc.open_campaign("fused", budget=6 * 40)
        res = fused_ensemble_rwm(lp, x0s, 20, 0.5 * np.eye(2),
                                 torch.Generator().manual_seed(1), fused_steps=5,
                                 telemetry=camp)
        assert res.samples.shape == (6, 20, 2)
        assert camp.points_charged == 6 * 20
        assert svc.fabric.telemetry()["per_tenant"]["fused"]["fused_steps"] == 6 * 20
        with pytest.raises(BudgetExhausted):
            fused_ensemble_rwm(lp, x0s, 40, 0.5 * np.eye(2),
                               torch.Generator().manual_seed(1), fused_steps=5,
                               telemetry=camp)
        assert camp.points_charged <= camp.budget
        assert svc.telemetry()["tenants"]["fused"]["budget_stops"] == 1
    finally:
        svc.close()
        svc.fabric.shutdown()
