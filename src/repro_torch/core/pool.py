"""Parallel model-instance pools — the paper's §3 kubernetes/HAProxy analogue.

Two pools, matching the two deployment modes in the paper:

* `ModelPool` — the device path. A wave of evaluation points is ONE call of
  the model's own batched program (`model.evaluate_batch`: a `TorchModel`'s
  vmapped program, an `LMUQModel`'s one forward over the wave's sequences);
  on a device mesh (`ctx=`), one such call a rank on its rows of the wave,
  the rows gathered to every rank. The UQ driver is completely oblivious
  to the devices — the paper's separation-of-concerns invariant.

* `ThreadedPool` — the host-side path with literal HAProxy semantics: a queue
  and N worker threads, each representing one model server with AT MOST ONE
  request in flight (paper §3.1.1). Works with any `Model`, including HTTP
  clients, and implements deadline-based speculative re-dispatch (straggler
  mitigation — the k8s-restart analogue) plus failure retry.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.analysis.races import named_lock
from repro_torch.core.interface import Model, pad_to_bucket


# ---------------------------------------------------------------------------
# Device pool
# ---------------------------------------------------------------------------


class ModelPool:
    """Batched evaluation of a model on its device: one wave, one call of
    the model's batched program, in the model's dtype.

    Without `ctx`, n_instances = `torch.cuda.device_count()` when the model
    lives on a CUDA device (its `device`), else 1, and a wave runs at its
    own width: the JAX package pads a wave to a power of two to bound its
    jit cache, and eager PyTorch keeps no such cache, so `stats["padded"]`
    stays 0 and `stats["bucket_shapes"]` counts the distinct wave widths.

    With `ctx` (a `distributed.sharding.ShardingCtx` over a `DeviceMesh`,
    the pool replicated on every rank), n_instances = `ctx.n_data`: a wave
    of N points is padded to a multiple of n_instances by repeating its
    last point (the JAX package rounds its bucket up to an instance
    multiple), each rank evaluates its contiguous rows with the model's one
    batched program, and the rows are gathered to every rank
    (`ShardingCtx.gather_rows`) before the padding is dropped;
    `stats["padded"]` counts it. With `n_data == 1` nothing is padded or
    gathered. A model that takes a `ctx` of its own (`LMUQModel(ctx=)`)
    splits its waves itself and gets every wave whole.
    """

    def __init__(self, model: Model, ctx=None, config: dict | None = None):
        self.model = model
        self.ctx = ctx
        self.config = config
        if ctx is not None:
            self.n_instances = ctx.n_data
        else:
            device = torch.device(getattr(model, "device", "cpu"))
            self.n_instances = torch.cuda.device_count() if device.type == "cuda" else 1
        # the model shards its own waves over its mesh
        self._split = ctx is not None and ctx.n_data > 1 and getattr(model, "ctx", None) is None
        # waves arrive from fabric collector threads and direct batch calls
        self._lock = named_lock("model_pool.stats")
        self.stats = {"batches": 0, "evaluations": 0, "padded": 0, "bucket_shapes": 0}
        self._bucket_shapes: set[int] = set()

    def evaluate(self, thetas: np.ndarray, config: dict | None = None) -> np.ndarray:
        """[N, n] -> [N, m]: one call of the model's batched program (on a
        mesh, one a rank, on its rows of the padded wave)."""
        config = self.config if config is None else config
        thetas = np.atleast_2d(np.asarray(thetas, float))
        N, pad = len(thetas), 0
        if self._split:
            wave, pad = pad_to_bucket(thetas, N + (-N) % self.n_instances)
            out = self._rows_out(self.model.evaluate_batch(wave[self.ctx.rows(len(wave))],
                                                           config))
            out = self.ctx.gather_rows(out)[:N]
        else:
            out = self._rows_out(self.model.evaluate_batch(thetas, config))
        with self._lock:
            self._bucket_shapes.add(N + pad)
            self.stats["bucket_shapes"] = len(self._bucket_shapes)
            self.stats["batches"] += 1
            self.stats["evaluations"] += N
            self.stats["padded"] += pad
        return out

    @staticmethod
    def _rows_out(out) -> np.ndarray:
        out = np.asarray(out)
        return out[:, None] if out.ndim == 1 else out

    __call__ = evaluate


# ---------------------------------------------------------------------------
# Threaded pool (HAProxy semantics)
# ---------------------------------------------------------------------------


@dataclass
class _Request:
    theta: list
    config: dict | None
    future: Future
    deadline: float | None = None
    attempts: int = 0
    # speculative re-dispatch puts the SAME request on two workers; the
    # attempts budget check must be atomic across them
    lock: threading.Lock = field(default_factory=lambda: named_lock("pool.request"))

    def consume_attempt(self, budget: int) -> bool:
        """Count one failed attempt; True while retries remain."""
        with self.lock:
            self.attempts += 1
            return self.attempts <= budget


class ThreadedPool:
    """N single-tenant model instances behind a queue.

    - one in-flight request per instance (paper §3.1.1)
    - `deadline_s`: if an evaluation exceeds the deadline, it is speculatively
      re-dispatched to another instance; first completion wins (straggler
      mitigation)
    - `max_retries`: instance failures (exceptions) are retried on another
      instance (the k8s restart analogue)
    """

    def __init__(
        self,
        instances: Sequence[Model] | Model,
        n_instances: int | None = None,
        deadline_s: float | None = None,
        max_retries: int = 2,
    ):
        if isinstance(instances, Model):
            assert n_instances, "pass n_instances when sharing one Model object"
            instances = [instances] * n_instances
        self.instances = list(instances)
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # _submit_lock makes "check stop, then enqueue" atomic against the
        # shutdown drain; _stats_lock covers the counters the N worker
        # threads and the respawn timers all bump
        self._submit_lock = named_lock("pool.submit")
        self._stats_lock = named_lock("pool.stats")
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(len(self.instances))
        ]
        self.stats = {"evaluations": 0, "retries": 0, "respawns": 0, "busy_s": [0.0] * len(self.instances)}
        for t in self._threads:
            t.start()

    # -- worker loop --------------------------------------------------------
    def _worker(self, idx: int):
        model = self.instances[idx]
        while not self._stop.is_set():
            try:
                req: _Request = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if req.future.done():  # speculative duplicate already finished
                self._q.task_done()
                continue
            t0 = time.monotonic()
            try:
                out = model([req.theta], req.config)
                if not req.future.done():
                    req.future.set_result(np.asarray(out[0]))
                with self._stats_lock:
                    self.stats["evaluations"] += 1
            except Exception as e:  # noqa: BLE001 — instance failure
                if req.consume_attempt(self.max_retries) and self._enqueue(req):
                    with self._stats_lock:
                        self.stats["retries"] += 1
                else:
                    # no retry budget left — or the pool started draining, in
                    # which case a re-queued request could land after the
                    # shutdown drain and strand its caller (_enqueue refuses
                    # atomically, so the request can only fail here, visibly)
                    if not req.future.done():
                        req.future.set_exception(e)
            finally:
                with self._stats_lock:
                    self.stats["busy_s"][idx] += time.monotonic() - t0
                self._q.task_done()

    # -- API ----------------------------------------------------------------
    def _enqueue(self, req: _Request) -> bool:
        """Atomically enqueue unless the pool is draining.

        `shutdown()` sets the stop flag under the same lock, so once it
        holds the lock no request can slip into the queue behind the
        drain — the check-then-put window that used to strand futures
        (submit/retry/respawn racing shutdown) is closed for every
        producer path, which all funnel through here.
        """
        with self._submit_lock:
            if self._stop.is_set():
                return False
            self._q.put(req)
            return True

    def submit(self, theta, config: dict | None = None) -> Future:
        fut: Future = Future()
        req = _Request(list(np.asarray(theta, float).ravel()), config, fut)
        if not self._enqueue(req):
            # fail fast instead of queueing work no worker will ever take —
            # a dead pool behind a FabricRouter must RAISE so the router can
            # back it off and steal the shard onto a live backend
            raise RuntimeError("ThreadedPool is shut down")
        if self.deadline_s is not None:
            def respawn():
                if not fut.done() and self._enqueue(req):
                    # re-queue the SAME request object: the duplicate shares
                    # the attempts counter, so speculation does not silently
                    # double the retry budget
                    with self._stats_lock:
                        self.stats["respawns"] += 1
            timer = threading.Timer(self.deadline_s, respawn)
            timer.daemon = True
            timer.start()
            # don't leak a live timer thread per request until the deadline:
            # cancel as soon as the future resolves
            fut.add_done_callback(lambda _f: timer.cancel())
        return fut

    def evaluate(self, thetas, config: dict | None = None, timeout_s: float | None = None) -> np.ndarray:
        """Submit every point in one pass, then collect under ONE shared
        deadline (`timeout_s`, measured from submission of the whole wave).
        Collecting with `wait` instead of in-order `result()` calls means a
        poisoned first future cannot hide progress (or faults) on later
        ones; partial failures surface every failing theta index at once."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        futs = [self.submit(t, config) for t in thetas]
        _, not_done = futures_wait(futs, timeout=timeout_s)
        for f in not_done:
            # cancel stragglers still in the queue so abandoned work does
            # not occupy workers ahead of the next wave (running ones are
            # skipped by the worker loop once the future is done)
            f.cancel()
        failures: list[tuple[int, Exception]] = []
        rows: list[np.ndarray | None] = [None] * len(futs)
        for i, f in enumerate(futs):
            if f in not_done:
                failures.append((i, TimeoutError(
                    f"evaluation exceeded the shared {timeout_s}s deadline"
                )))
                continue
            exc = f.exception()
            if exc is not None:
                failures.append((i, exc))
            else:
                rows[i] = f.result()
        if failures:
            idx = [i for i, _ in failures]
            raise RuntimeError(
                f"ThreadedPool.evaluate: {len(failures)}/{len(futs)} points failed "
                f"(theta indices {idx}); first: {failures[0][1]!r}"
            ) from failures[0][1]
        return np.stack(rows)

    __call__ = evaluate

    @property
    def alive(self) -> bool:
        """True while the pool accepts work — the liveness probe fleet
        managers use before (re)enrolling a threaded backend."""
        return not self._stop.is_set()

    def shutdown(self):
        with self._submit_lock:
            # taking the submit lock before raising the flag means every
            # in-flight _enqueue has either finished its put (the drain
            # below will see it) or will observe the flag and refuse
            self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        # drain the queue: requests stranded behind the stop flag would hang
        # their callers forever (mid-flight kill during router failover) —
        # fail them so waves in progress surface the death immediately
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError("ThreadedPool shut down"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
