"""Elastic fault-tolerant fleet management over a `FabricRouter` (port of
`repro.core.fleet`; numpy and the standard library, plus torch for the
fused samplers' generator state in `CampaignCheckpoint`).

The router (`core.fabric.FabricRouter`) already survives a dead backend via
backoff + steals; this module closes the loop so the fleet *changes shape*
under the campaign instead of merely surviving:

  * `FleetManager` — a policy loop over the telemetry the router already
    keeps (per-backend in-flight depth, EWMA service time, failure streaks):
    it re-probes dead/unknown server URLs and enrolls late arrivals
    (`register_servers(return_dead=True)` hands it the dead list), spawns
    new backends when the fleet saturates, drains members whose failure
    streak or health probe marks them dead, and re-instates drained members
    whose health probe passes again (probation re-entry).
  * `FaultInjector` — a seeded chaos wrapper around any backend
    (`distributed.fault.FlakyStep` lifted to the fabric layer): kills,
    delays and hangs on a deterministic schedule drawn from
    `np.random.default_rng(seed)`, so the same seed gives the same fault
    schedule in both packages.
  * `CampaignCheckpoint` — crash-consistent campaign state on top of
    `distributed.checkpoint.CheckpointManager`: one atomic snapshot holds
    the sampler arrays (chain positions, sample prefix, adapters), the rng
    state, the router's learned EWMA/lifecycle state and the
    online-surrogate training window. `ensemble_mlda`/`ensemble_mala` and
    the fused runners (`uq.fused`) accept it via `checkpoint=` and resume a
    killed campaign exactly (restored rng stream → the same trajectory the
    uninterrupted run would have produced). The manifest is the JAX
    package's, so a host campaign checkpointed by one package resumes in
    the other.

Everything here drives the router through its public lifecycle surface
(`add_backend` / `drain_backend` / `reinstate_backend` / `load`), all of
which mutate state under the router lock — the manager thread never touches
router internals directly.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.analysis.races import named_lock
from repro_torch.core.client import probe_health
from repro_torch.core.fabric import (
    EvaluationFabric,
    FabricBackend,
    FabricRouter,
    HTTPBackend,
    ThreadedBackend,
    as_backend,
)
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import StepFailure


# ---------------------------------------------------------------------------
# Fault injection (chaos harness)
# ---------------------------------------------------------------------------


class FaultInjector(FabricBackend):
    """Seeded chaos wrapper around any fabric backend.

    Faults fire per DISPATCH on a deterministic schedule, so a test (or the
    chaos benchmark) replays the exact same failure sequence every run:

      * `p_fail` — each dispatch raises `StepFailure` with this probability
        (seeded rng), emulating flaky pods;
      * `fail_waves` — explicit dispatch indices that raise once each
        (`FlakyStep.fail_steps` at the fabric layer);
      * `delay_s` — extra latency per dispatch: a float for a fixed
        straggler, or a `(lo, hi)` pair for seeded uniform jitter whose
        tail draws stall past the router's EWMA deadline (what speculative
        re-dispatch duplicates away from);
      * `kill_after` — dispatch index at which the backend DIES: every
        dispatch from then on raises until `revive()` — the preempted-node
        case the FleetManager's probation loop re-enrolls.

    `probe()` reports liveness (False while killed), so a `FleetManager`
    treats an injector exactly like a real backend with a health endpoint.
    """

    name = "fault_injector"

    def __init__(
        self,
        backend,
        *,
        seed: int = 0,
        p_fail: float = 0.0,
        fail_waves: Sequence[int] = (),
        delay_s: float = 0.0,
        kill_after: int | None = None,
    ):
        self.inner = as_backend(backend)
        self.n_instances = self.inner.n_instances
        self.rng = np.random.default_rng(seed)
        self.p_fail = float(p_fail)
        self.fail_waves = set(int(w) for w in fail_waves)
        self.delay_s = (
            (float(delay_s[0]), float(delay_s[1]))
            if isinstance(delay_s, (tuple, list))
            else float(delay_s)
        )
        self.kill_after = None if kill_after is None else int(kill_after)
        self._n = 0  # dispatches seen
        self._dead = False
        self._fired: set[int] = set()
        self._lock = named_lock("fault_injector")

    # -- chaos schedule ------------------------------------------------------
    def _maybe_fault(self):
        with self._lock:
            n = self._n
            self._n += 1
            if self.kill_after is not None and n >= self.kill_after:
                self._dead = True
            if self._dead:
                raise StepFailure(f"{self.inner.name}: killed at dispatch {n}")
            if n in self.fail_waves and n not in self._fired:
                self._fired.add(n)
                raise StepFailure(f"{self.inner.name}: injected failure {n}")
            # draw only when flaking is on, so a pure kill/delay schedule
            # stays deterministic regardless of traffic volume
            if self.p_fail and float(self.rng.uniform()) < self.p_fail:
                raise StepFailure(f"{self.inner.name}: seeded flake at {n}")
            delay = self.delay_s
            if isinstance(delay, tuple):
                delay = float(self.rng.uniform(*delay))
        if delay:
            time.sleep(delay)

    def kill(self):
        """Kill the backend NOW (every future dispatch raises)."""
        with self._lock:
            self._dead = True

    def revive(self):
        """Bring a killed backend back (the node rebooted); the kill
        schedule is cleared so it stays up."""
        with self._lock:
            self._dead = False
            self.kill_after = None

    def probe(self) -> bool:
        with self._lock:
            return not self._dead

    @property
    def alive(self) -> bool:
        return self.probe()

    # -- backend surface -----------------------------------------------------
    def capabilities(self):
        return self.inner.capabilities()

    @property
    def fused_value_grad(self) -> bool:
        return getattr(self.inner, "fused_value_grad", False)

    def evaluate(self, thetas, config):
        self._maybe_fault()
        return self.inner.evaluate(thetas, config)

    def dispatch(self, op, thetas, extra, config):
        self._maybe_fault()
        return self.inner.dispatch(op, thetas, extra, config)

    def stats(self):
        s = dict(self.inner.stats())
        with self._lock:
            s.update(kind=self.name, wrapped=self.inner.name,
                     dispatches=self._n, dead=self._dead)
        return s

    def close(self):
        self.inner.close()


# ---------------------------------------------------------------------------
# Fleet manager (elastic lifecycle policy)
# ---------------------------------------------------------------------------


def _probe_backend(backend, probe_timeout_s: float = 5.0) -> bool:
    """Health-probe a router member for probation re-entry: injectors and
    pools report liveness directly; HTTP backends get a `/Health` GET per
    server (bounded by `probe_timeout_s`); anything else is assumed healthy
    (in-process backends do not die independently of the driver)."""
    if hasattr(backend, "probe"):
        try:
            return bool(backend.probe())
        except Exception:  # noqa: BLE001 — a raising probe IS a dead probe
            return False
    if isinstance(backend, ThreadedBackend):
        return bool(getattr(backend.pool, "alive", True))
    if isinstance(backend, HTTPBackend):
        for c in backend.clients:
            doc = probe_health(getattr(c, "url", ""), timeout=probe_timeout_s)
            if doc is None or doc.get("status") != "ok":
                return False
        return True
    return True


class FleetManager:
    """Telemetry-driven elastic lifecycle policy over a `FabricRouter`.

    One `tick()` (call it directly in tests, or `start()` a background
    thread) runs four policies against `router.load()`:

      1. **enroll** — re-probe `watch_urls` that are not yet enrolled
         (servers that failed their registration probe, or arrived after
         startup) and `add_backend` each one whose `/Health` now answers;
      2. **probation** — re-probe drained/retired members; a passing probe
         re-instates them with failure state cleared (a node that died and
         came back rejoins instead of being skipped forever);
      3. **retire** — a live member whose failure streak reaches
         `retire_streak` is drained (kept enrolled: probation can bring it
         back, and its indices/bindings stay valid);
      4. **scale** — when mean in-flight depth per live backend exceeds
         `scale_up_inflight` — or, with a `UQService` attached (`service=`),
         when the service's queued waves per live backend exceed
         `scale_up_queued_waves` — and the fleet is below `max_backends`,
         call `spawn()` for a fresh backend (e.g. a new `ThreadedPool`) and
         enroll it. The service signal sees demand the router cannot: waves
         held back by the fair-share scheduler have no in-flight footprint
         yet, so a multi-tenant backlog scales the fleet BEFORE it turns
         into dispatch-side queueing.

    Every action lands in the tick's report (and `self.events`), so tests
    and the chaos benchmark assert on exact lifecycle sequences.
    """

    def __init__(
        self,
        fabric,
        *,
        spawn: Callable[[], object] | None = None,
        watch_urls: Sequence[str] = (),
        model_name: str = "forward",
        scale_up_inflight: float = 8.0,
        service=None,
        scale_up_queued_waves: float = 4.0,
        max_backends: int = 8,
        retire_streak: int = 3,
        http_timeout: float = 600.0,
        probe_timeout_s: float = 5.0,
    ):
        router = fabric.backend if isinstance(fabric, EvaluationFabric) else fabric
        if not isinstance(router, FabricRouter):
            raise TypeError(
                "FleetManager needs a FabricRouter (or a fabric routed over "
                f"one); got {type(fabric).__name__}"
            )
        self.router = router
        self.spawn = spawn
        self.watch_urls = list(watch_urls)
        self.model_name = model_name
        self.scale_up_inflight = float(scale_up_inflight)
        self.service = service
        self.scale_up_queued_waves = float(scale_up_queued_waves)
        self.max_backends = int(max_backends)
        self.retire_streak = int(retire_streak)
        self.http_timeout = float(http_timeout)
        self.probe_timeout_s = float(probe_timeout_s)
        self._enrolled_urls: set[str] = set()
        self.events: list[dict] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._events_lock = named_lock("fleet.events")

    # -- policy tick ---------------------------------------------------------
    def _note(self, kind: str, **info):
        with self._events_lock:
            self.events.append({"event": kind, "t": time.monotonic(), **info})

    def tick(self) -> dict:
        """Run every policy once; returns what happened (all lists may be
        empty on a quiet fleet)."""
        report = {"enrolled": [], "reinstated": [], "drained": [], "spawned": 0}
        # 1. enroll newly healthy watched servers
        for url in self.watch_urls:
            if url in self._enrolled_urls:
                continue
            doc = probe_health(url, timeout=self.probe_timeout_s)
            if (
                doc is None or doc.get("status") != "ok"
                or self.model_name not in doc.get("models", [self.model_name])
            ):
                continue
            from repro_torch.core.client import HTTPModel

            idx = self.router.add_backend(
                HTTPBackend([HTTPModel(url, self.model_name,
                                       timeout=self.http_timeout)])
            )
            self._enrolled_urls.add(url)
            report["enrolled"].append(url)
            self._note("enroll", url=url, backend=idx)
        load = self.router.load()
        # 2. probation: drained/retired members whose probe passes rejoin
        for i, admin in enumerate(load["admin"]):
            if admin == "live" or load["inflight"][i] > 0:
                continue
            if _probe_backend(self.router.backends[i], self.probe_timeout_s):
                self.router.reinstate_backend(i)
                report["reinstated"].append(i)
                self._note("reinstate", backend=i)
        load = self.router.load()
        # 3. retire hopeless members (drain, not remove: probation may
        # bring them back, and indices/bindings stay stable either way).
        # Every live member is health-probed, not just streaky ones — the
        # router's EWMA/backoff can starve a dead member of traffic
        # entirely, so a corpse with a zero streak would otherwise stay
        # enrolled forever
        for i, streak in enumerate(load["fail_streak"]):
            if load["admin"][i] != "live":
                continue
            if streak >= self.retire_streak or not _probe_backend(
                self.router.backends[i], self.probe_timeout_s
            ):
                self.router.drain_backend(i)
                report["drained"].append(i)
                self._note("drain", backend=i, fail_streak=streak)
        load = self.router.load()
        # 4. scale up under sustained queueing — router in-flight depth, or
        # (service-aware) the multi-tenant scheduler's queued-wave backlog
        live = [i for i, a in enumerate(load["admin"]) if a == "live"]
        if self.spawn is not None and live and len(live) < self.max_backends:
            depth = sum(load["inflight"][i] for i in live) / len(live)
            queued = 0.0
            if self.service is not None:
                queued = self.service.load()["queued_waves"] / len(live)
            if depth > self.scale_up_inflight:
                idx = self.router.add_backend(self.spawn())
                report["spawned"] = 1
                self._note("spawn", backend=idx, mean_inflight=round(depth, 2))
            elif queued > self.scale_up_queued_waves:
                idx = self.router.add_backend(self.spawn())
                report["spawned"] = 1
                self._note("spawn", backend=idx,
                           queued_waves_per_live=round(queued, 2))
        return report

    # -- background loop -----------------------------------------------------
    def start(self, interval_s: float = 1.0):
        """Run `tick()` every `interval_s` on a daemon thread until
        `stop()`. Idempotent while running."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — policy must outlive probes
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ---------------------------------------------------------------------------
# Campaign checkpointing
# ---------------------------------------------------------------------------


class CampaignCheckpoint:
    """Crash-consistent campaign state for the ensemble samplers.

    Built on `CheckpointManager` (atomic tmp-dir + rename publish, torn-dir
    detection), so a driver killed mid-save costs at most one checkpoint
    interval. The numeric payload (chain positions, sample prefix, adapted
    proposals, surrogate window) lands as npy leaves; everything JSON-able
    — the rng bit-generator state, counters, the key/shape/dtype manifest
    that lets `resume()` rebuild the tree without knowing it a priori, and
    the router's learned EWMA/lifecycle state — rides in META.json.

    Attach the infrastructure once and the samplers stay oblivious:

        ckpt = CampaignCheckpoint(dir, router=fabric, surrogate=screen)
        ensemble_mlda(..., checkpoint=ckpt, checkpoint_every=50)

    On resume, `ensemble_mlda` restores its own arrays while the checkpoint
    re-applies the router EWMA (`FabricRouter.load_state`) and the surrogate
    window (`OnlineGP.restore`) — the resumed campaign is statistically
    indistinguishable from the uninterrupted one (identical, in fact: the
    rng stream continues exactly where the snapshot left it).
    """

    def __init__(self, directory: str, *, keep_last: int = 3,
                 router=None, surrogate=None, campaign_id: str | None = None):
        self.manager = CheckpointManager(directory, keep_last=keep_last)
        self._router = router
        self._surrogate = surrogate
        # multi-tenant provenance: the owning campaign's id rides in every
        # manifest (and META.json top level), so a checkpoint directory is
        # attributable to the campaign that wrote it
        self.campaign_id = campaign_id

    def attach(self, *, router=None, surrogate=None):
        """Late-bind the infra whose state rides along (chainable)."""
        if router is not None:
            self._router = router
        if surrogate is not None:
            self._surrogate = surrogate
        return self

    # -- rng key manifest ----------------------------------------------------
    # The host samplers snapshot `rng.bit_generator.state` (JSON-able, rides
    # in META.json); the device-resident fused samplers (`uq.fused`) carry a
    # `torch.Generator` instead. Its state (`get_state()`: seed and Philox
    # offset on the card, the Mersenne Twister state on the CPU) is an
    # ordinary uint8 array, so it lands as an npy leaf like any other
    # sampler array — these two helpers are the boundary where a generator
    # becomes checkpoint payload and back, keeping resume bit-exact (same
    # state -> same stream). The writer records the generator's device type
    # in the manifest's meta, so resume restores onto the device that wrote
    # it.

    @staticmethod
    def pack_key(gen: torch.Generator) -> np.ndarray:
        """Generator -> its state as a uint8 array for the npy payload."""
        return gen.get_state().numpy().copy()

    @staticmethod
    def unpack_key(data: np.ndarray, device) -> torch.Generator:
        """uint8 state array (as restored) -> a generator on `device` (the
        device type the writer recorded) with that state."""
        gen = torch.Generator(device=device)
        gen.set_state(torch.as_tensor(np.asarray(data, np.uint8)))
        return gen

    def _router_obj(self) -> FabricRouter | None:
        r = self._router
        if isinstance(r, EvaluationFabric):
            r = r.backend
        return r if isinstance(r, FabricRouter) else None

    def _gp_obj(self):
        s = self._surrogate
        if s is None:
            return None
        return getattr(s, "gp", s)  # SurrogateScreen/Store -> OnlineGP

    # -- save ----------------------------------------------------------------
    def save(self, step: int, arrays: dict, meta: dict,
             blocking: bool = True) -> None:
        """Snapshot `arrays` (str -> ndarray) + `meta` (JSON-able) plus the
        attached router/surrogate state, atomically, as step `step`."""
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        meta = dict(meta)
        if self.campaign_id is not None:
            meta["campaign_id"] = self.campaign_id
        router = self._router_obj()
        if router is not None:
            meta["router"] = router.state_dict()
        gp = self._gp_obj()
        if gp is not None and hasattr(gp, "snapshot"):
            snap = gp.snapshot()
            if snap.get("X") is not None:
                arrays["surrogate_X"] = np.asarray(snap["X"])
                arrays["surrogate_y"] = np.asarray(snap["y"])
            meta["surrogate"] = {
                k: snap[k] for k in ("n_seen", "since_refit", "err_ewma", "frozen")
            }
        manifest = {
            "meta": meta,
            "keys": {
                k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                for k, v in arrays.items()
            },
        }
        self.manager.save(int(step), arrays, blocking=blocking,
                          manifest=manifest, campaign_id=self.campaign_id)

    def wait(self):
        self.manager.wait()

    # -- resume --------------------------------------------------------------
    def resume(self, step: int | None = None):
        """(arrays, meta, step) from the newest complete snapshot — or None
        when the directory holds none (fresh campaign). Re-applies the
        attached router/surrogate state as a side effect."""
        try:
            doc = self.manager.meta(step)
        except FileNotFoundError:
            return None
        manifest = doc.get("manifest", {})
        keys = manifest.get("keys", {})
        if not keys:
            return None
        state_like = {
            k: np.zeros(tuple(v["shape"]), dtype=v["dtype"])
            for k, v in keys.items()
        }
        state, got = self.manager.restore(state_like, step=int(doc["step"]),
                                          host=True)
        arrays = {k: np.asarray(v) for k, v in state.items()}
        meta = dict(manifest.get("meta", {}))
        router = self._router_obj()
        if router is not None and "router" in meta:
            router.load_state(meta["router"])
        gp = self._gp_obj()
        if gp is not None and "surrogate" in meta and hasattr(gp, "restore"):
            gp.restore({
                "X": arrays.pop("surrogate_X", None),
                "y": arrays.pop("surrogate_y", None),
                **meta["surrogate"],
            })
        return arrays, meta, got
