"""Surrogate-accelerated delayed acceptance: the level-(-1) screen.

The paper's MLDA application (§4.3) spends most of its wall-clock on
coarse-level subchain evaluations — exactly where a cheap surrogate screen
buys the most. This module provides the two pieces that turn the
`uq.gp.OnlineGP` emulator into a screen IN FRONT of the coarse model:

* `SurrogateStore` — a fabric training tap: it subscribes to an
  `EvaluationFabric`'s completed-wave traffic (`fabric.record_observer`)
  and streams each freshly computed (theta, output) row — mapped through a
  scalar `target(theta, y)` such as the log-likelihood — into the GP's
  sliding window. The surrogate therefore trains entirely from evaluations
  the sampler already paid for: ZERO extra model evaluations, each wave
  observed exactly once (cache hits are never replayed).

* `SurrogateScreen` — the first stage of three-stage delayed acceptance in
  `ensemble_mlda(surrogate=...)`: one lockstep `predict_batch` per step
  (zero fabric waves) scores every chain's proposal, only survivors pay
  the real coarse wave, and the stage-2 correction divides the coarse
  Metropolis ratio by the SAME screen ratio — so each step targets the
  coarse posterior EXACTLY for ANY screen (Christen & Fox 2005), including
  an arbitrarily wrong GP. The screen changes how many coarse evaluations
  are spent, never what an individual step accepts; for the chain-level
  guarantee, `freeze()` the screen after warm-up (an unfrozen screen is
  adaptive MCMC — see `SurrogateScreen`).

The GP fits and predicts on the card unless its `device=` (an `OnlineGP`
keyword, passed through `SurrogateStore` and `from_fabric`) says "cpu".
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.analysis.races import named_lock
from repro_torch.core.protocol import config_key
from repro_torch.uq.gp import OnlineGP

#: pass as `config=` to ingest waves under EVERY config (the default is to
#: ingest exactly the one config given — a fine-level wave must never train
#: a coarse-level surrogate)
ANY_CONFIG = object()


class SurrogateStore:
    """Fabric training tap -> sliding-window GP training set.

    `fabric.record_observer(store.observe)` wires it up; thereafter every
    completed wave whose op carries fresh forward values ("evaluate", or
    the value half of a fused "value_and_gradient" wave) and whose config
    matches `config` streams into the `OnlineGP` as
    (theta, target(theta, output)) pairs. Non-matching waves are ignored,
    matching waves are ingested exactly once, and the store never issues a
    model evaluation of its own.
    """

    def __init__(
        self,
        target: Callable[[np.ndarray, np.ndarray], float],
        config: dict | None = None,
        *,
        gp: OnlineGP | None = None,
        ops: Sequence[str] = ("evaluate", "value_and_gradient"),
        **gp_kwargs,
    ):
        self.target = target
        self.gp = gp if gp is not None else OnlineGP(**gp_kwargs)
        self.ops = tuple(ops)
        self._any = config is ANY_CONFIG
        self._cfg_key = None if self._any else config_key(config)
        self.n_waves = 0
        self.n_points = 0
        self._lock = named_lock("surrogate_store")

    def observe(self, op: str, thetas, outputs, config) -> None:
        """`record_observer` callback: one call per completed wave."""
        if op not in self.ops:
            return
        if not self._any and config_key(config) != self._cfg_key:
            return
        thetas = np.atleast_2d(np.asarray(thetas, float))
        outputs = np.atleast_2d(np.asarray(outputs, float))
        ts = np.asarray(
            [float(self.target(t, y)) for t, y in zip(thetas, outputs)]
        )
        with self._lock:
            self.n_waves += 1
            self.n_points += len(ts)
        self.gp.add(thetas, ts)

    def stats(self) -> dict:
        with self._lock:
            return {"waves_observed": self.n_waves, "points_observed": self.n_points}


class SurrogateScreen:
    """Level-(-1) GP screen for three-stage delayed acceptance.

    With g(theta) = gp_mean(theta) + logprior(theta), stage 1 promotes a
    proposal y from x with probability min{1, e^(g(y)-g(x))} at ZERO model
    cost; stage 2 (run by the sampler on survivors only) accepts with
    min{1, e^((lp(y)-lp(x)) - (g(y)-g(x)))} — the DA correction that makes
    the compound kernel exact for any g. Where the screen is skipped the
    log-ratio is 0, so the step degrades to plain lockstep Metropolis.

    Policy knobs (the staleness policy itself lives on the `OnlineGP`):

      * ``min_train`` (via the GP): the screen reports ``active = False``
        and skips every chain until the window holds enough traffic;
      * ``sd_skip``: the variance gate — a chain whose current state OR
        proposal has predictive sd above the gate skips the screen for
        that step, so the GP is never trusted where it is uncertain. The
        skip decision is symmetric in (x, y), preserving detailed balance;
      * ``freeze()``: stop ingesting/refitting. Each step's DA correction
        is exact regardless, but an UNFROZEN screen keeps adapting to the
        chain's own history — adaptive MCMC, whose chain-level guarantees
        need the adaptation to diminish (the sliding window saturating).
        Freezing after warm-up makes the kernel time-homogeneous and
        restores the standard ergodicity argument; do it before any run
        whose samples you keep.

    When `fabric` is given (e.g. via `from_fabric`), screen traffic is
    mirrored into the fabric telemetry (`surrogate_screened`,
    `screen_pass_rate`).
    """

    def __init__(
        self,
        source: SurrogateStore | OnlineGP,
        *,
        logprior: Callable[[np.ndarray], float] | None = None,
        sd_skip: float | None = None,
        fabric=None,
    ):
        if isinstance(source, SurrogateStore):
            self.store: SurrogateStore | None = source
            self.gp = source.gp
        elif isinstance(source, OnlineGP):
            self.store = None
            self.gp = source
        else:
            raise TypeError(
                "SurrogateScreen needs a SurrogateStore or an OnlineGP; "
                f"got {type(source).__name__}"
            )
        self.logprior = logprior
        self.sd_skip = None if sd_skip is None else float(sd_skip)
        self._fabric = fabric
        self.n_screened = 0
        self.n_passed = 0
        self.n_skipped = 0

    @classmethod
    def from_fabric(
        cls,
        fabric,
        target: Callable[[np.ndarray, np.ndarray], float],
        config: dict | None = None,
        *,
        logprior: Callable | None = None,
        sd_skip: float | None = None,
        gp: OnlineGP | None = None,
        **gp_kwargs,
    ) -> "SurrogateScreen":
        """Build the store, subscribe it to the fabric's training tap, and
        return the screen — one call wires the whole level-(-1) path:

            screen = SurrogateScreen.from_fabric(
                fabric, target=lambda th, y: loglik(y),
                config={"level": 0}, logprior=logprior,
                window=256, min_train=32)
            warm = ensemble_mlda(..., fabric=fabric, surrogate=screen)
            screen.freeze()  # stop adapting before the samples you keep
            res = ensemble_mlda(..., fabric=fabric, surrogate=screen)
        """
        store = SurrogateStore(target, config=config, gp=gp, **gp_kwargs)
        fabric.record_observer(store.observe)
        return cls(store, logprior=logprior, sd_skip=sd_skip, fabric=fabric)

    @property
    def active(self) -> bool:
        """Whether the GP has enough traffic to screen at all."""
        return self.gp.ready

    def freeze(self) -> None:
        self.gp.freeze()

    def delta(self, xs: np.ndarray, props: np.ndarray):
        """Screen log-ratio g(prop) - g(x) per chain plus the skip mask:
        ([K, d], [K, d]) -> (dg [K], skipped [K] bool), with dg = 0 where
        skipped (inactive screen, or variance gate). ONE lockstep
        `predict_batch` over both endpoints — zero fabric waves."""
        xs = np.atleast_2d(np.asarray(xs, float))
        props = np.atleast_2d(np.asarray(props, float))
        K = len(props)
        if not self.active:
            self.n_skipped += K
            return np.zeros(K), np.ones(K, bool)
        # the variance back-substitution is only paid when a gate consumes it
        gated = self.sd_skip is not None
        pred = self.gp.predict_batch(
            np.concatenate([xs, props], axis=0), return_var=gated
        )
        mu = pred[0] if gated else pred
        dg = np.asarray(mu[K:] - mu[:K], float)
        skipped = np.zeros(K, bool)
        if gated:
            sd = np.sqrt(pred[1])
            skipped = (sd[:K] > self.sd_skip) | (sd[K:] > self.sd_skip)
        if self.logprior is not None:
            pr_x = np.asarray([float(self.logprior(t)) for t in xs])
            pr_p = np.asarray([float(self.logprior(t)) for t in props])
            # a chain whose CURRENT state sits outside the support cannot
            # be screened: dg would be +inf and the stage-2 correction
            # would pin the chain there forever. Skip it — the step
            # degrades to plain Metropolis and the chain escapes; out-of-
            # support states are transient (never re-entered), so the skip
            # cannot affect stationarity.
            bad_x = ~np.isfinite(pr_x)
            skipped = skipped | bad_x
            with np.errstate(invalid="ignore"):
                dpr = pr_p - pr_x
            dg = dg + np.where(bad_x, 0.0, dpr)
        dg = np.where(skipped, 0.0, dg)
        self.n_skipped += int(skipped.sum())
        return dg, skipped

    def note(self, screened: int, passed: int) -> None:
        """Sampler-side telemetry callback: of `screened` actively screened
        proposals this step, `passed` survived stage 1. Mirrored into the
        fabric stats when fabric-attached."""
        self.n_screened += int(screened)
        self.n_passed += int(passed)
        if self._fabric is not None and screened:
            self._fabric.note_screen(screened, passed)

    def stats(self) -> dict:
        scr = self.n_screened
        out = {
            "screened": scr,
            "passed": self.n_passed,
            "pass_rate": (self.n_passed / scr) if scr else None,
            "skipped": self.n_skipped,
            "gp": self.gp.stats(),
        }
        if self.store is not None:
            out["store"] = self.store.stats()
        return out
