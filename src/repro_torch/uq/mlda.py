"""Multilevel Delayed Acceptance MCMC (paper §4.3; Lykkegaard et al. 2023).

MLDA recursively applies Delayed Acceptance over a model hierarchy: the
proposal for level l is the endpoint of a subchain of length `subsampling[l-1]`
run on level l-1 (down to level 0, sampled with random-walk Metropolis). The
acceptance at level l uses the two-level DA ratio

    alpha = min{1, [pi_l(x') pi_{l-1}(x)] / [pi_l(x) pi_{l-1}(x')]}.

`logposts[l]` maps theta -> log posterior density at level l (coarsest = 0).

Two dispatch disciplines:

* `mlda` — one chain, one model round-trip per subchain step (optionally
  through an `EvaluationFabric` for caching/wave-coalescing);
* `ensemble_mlda` — K chains in LOCKSTEP: every coarse-subchain step and
  every fine acceptance test across all K chains is ONE `evaluate_batch`
  wave (reusing `uq.mcmc.batched_logpost`), so the sampling cost is ~tens
  of waves instead of thousands of round-trips. With
  `coarse_sampler="mala"` the coarse subchains become gradient-informed
  (lockstep preconditioned MALA over fused value-and-gradient waves)
  while the DA correction above them stays exact.

`ensemble_mlda` additionally accepts `surrogate=` — a
`uq.surrogate.SurrogateScreen` inserted as a level-(-1) GP screen below
level 0 (THREE-stage delayed acceptance): every level-0 proposal is first
scored by one lockstep `predict_batch` (zero fabric waves), only stage-1
survivors pay the coarse wave, and the stage-2 correction divides the
coarse Metropolis ratio by the same screen ratio, so each step targets the
coarse posterior exactly for ANY screen — a wrong GP can only waste
evaluations, never bias an individual accept/reject. For the CHAIN-level
guarantee, freeze the screen after warm-up (`screen.freeze()`): a screen
that keeps training from the run's own traffic is adaptive MCMC, exact per
step but only asymptotically safe insofar as the adaptation diminishes
(the sliding window saturating); a frozen screen is a fixed Markov kernel
with the standard ergodicity guarantees.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.uq.mcmc import (
    ChainResult,
    PooledCovarianceAdapter,
    batched_logpost,
    _fused_key,
    batched_value_grad_logpost,
)


@dataclass
class MLDAResult:
    samples: np.ndarray  # [n, d] finest-level samples
    accept_rates: list  # per level
    evals_per_level: list


@dataclass
class EnsembleMLDAResult:
    """K lockstep MLDA chains: every subchain step and every acceptance test
    is ONE `evaluate_batch` wave across all K chains."""

    samples: np.ndarray  # [K, n, d] finest-level samples
    accept_rates: list  # per level, aggregated over chains
    evals_per_level: list  # logpost evaluations per level (all chains)
    n_waves: int  # batched model dispatches for the whole ensemble
    #: final level-0 proposal covariance when Haario adaptation was on
    proposal_cov: np.ndarray | None = None
    #: surrogate-screen telemetry when three-stage DA was on (screened /
    #: passed / pass_rate / skipped + GP fit counters — see
    #: `uq.surrogate.SurrogateScreen.stats`)
    surrogate: dict | None = None
    #: "budget" when a service-tier campaign budget ran out mid-run (the
    #: returned samples are the truncated-but-valid prefix), else None
    terminated: str | None = None

    @property
    def samples_flat(self) -> np.ndarray:
        """[K * n, d] pooled finest-level samples."""
        return self.samples.reshape(-1, self.samples.shape[-1])

    def chains(self) -> list[MLDAResult]:
        """Per-chain view, interchangeable with `mlda` output (accept rates
        and eval counts are ensemble aggregates)."""
        return [
            MLDAResult(self.samples[k], list(self.accept_rates),
                       list(self.evals_per_level))
            for k in range(len(self.samples))
        ]


def fabric_logposts(
    fabric,
    loglik: Callable[[np.ndarray], float],
    level_configs: Sequence[dict | None],
    logprior: Callable[[np.ndarray], float] | None = None,
) -> list[Callable]:
    """Per-level log-posteriors routed through an `EvaluationFabric`.

    `level_configs[l]` is the UM-Bridge config selecting level l (coarsest
    first, e.g. `{"level": 0}`); `loglik(model_output) -> float` turns the
    forward-model output into a log likelihood; `logprior(theta)` (optional)
    short-circuits out-of-support proposals BEFORE any model evaluation.

    Because MLDA subchains re-evaluate the coarse model at repeated states
    (the subchain start, rejected proposals), routing through the fabric's
    result cache removes those duplicate evaluations entirely.
    """

    def make(config):
        def logpost(theta):
            lp = 0.0
            if logprior is not None:
                lp = float(logprior(theta))
                if not np.isfinite(lp):
                    return -np.inf
            # submit (not evaluate_batch): single points ride the collector,
            # so concurrent chains pack into shared dispatch waves
            out = fabric.submit(np.asarray(theta, float), config).result()
            return lp + float(loglik(out))

        return logpost

    return [make(c) for c in level_configs]


class _LevelSampler:
    """Recursive DA sampler for one level."""

    def __init__(self, logposts, subsampling, prop_cov, rng):
        self.logposts = logposts
        self.subsampling = subsampling
        self.rng = rng
        self.L = len(logposts)
        d = len(np.atleast_2d(prop_cov))
        self.chol = np.linalg.cholesky(np.atleast_2d(prop_cov))
        self.d = self.chol.shape[0]
        self.acc = [0] * self.L
        self.tot = [0] * self.L
        self.evals = [0] * self.L

    def _lp(self, level, x):
        self.evals[level] += 1
        return float(self.logposts[level](x))

    def propose(self, level: int, x: np.ndarray, lp_x: float):
        """Returns (x_new, lp_new, accepted) after one step at `level`."""
        if level == 0:
            prop = x + self.chol @ self.rng.standard_normal(self.d)
            lp_prop = self._lp(0, prop)
            self.tot[0] += 1
            if np.log(self.rng.uniform()) < lp_prop - lp_x:
                self.acc[0] += 1
                return prop, lp_prop, True
            return x, lp_x, False
        # run a subchain at level-1 started from x
        sub = self.subsampling[level - 1]
        y = x.copy()
        lp_y_coarse = self._lp(level - 1, y)
        lp_start_coarse = lp_y_coarse
        # track acceptances rather than comparing states: a subchain that
        # wanders and returns to (numerically) x is a REAL proposal with its
        # own coarse ratio — `np.allclose(y, x)` false-positived on it and
        # skipped the fine acceptance test entirely
        moved = False
        for _ in range(sub):
            y, lp_y_coarse, accepted = self.propose(level - 1, y, lp_y_coarse)
            moved = moved or accepted
        if not moved:
            # no subchain proposal was accepted; proposal == current state
            return x, lp_x, False
        lp_prop = self._lp(level, y)
        self.tot[level] += 1
        # DA ratio: fine ratio corrected by inverse coarse ratio
        log_alpha = (lp_prop - lp_x) - (lp_y_coarse - lp_start_coarse)
        if np.log(self.rng.uniform()) < log_alpha:
            self.acc[level] += 1
            return y, lp_prop, True
        return x, lp_x, False


def mlda(
    logposts: Sequence[Callable] | None,
    x0: np.ndarray,
    n_samples: int,
    subsampling: Sequence[int],
    prop_cov: np.ndarray,
    rng: np.random.Generator,
    *,
    fabric=None,
    level_configs: Sequence[dict | None] | None = None,
    loglik: Callable | None = None,
    logprior: Callable | None = None,
) -> MLDAResult:
    """Draw n_samples at the finest level with MLDA.

    logposts: [coarsest ... finest]; subsampling[l] = subchain length used to
    generate proposals for level l+1 (paper: (25, 2) for 3 levels).

    Instead of bare logpost callables, the level stack can be given as an
    `EvaluationFabric` plus `level_configs`/`loglik` (and optional
    `logprior`) — evaluations then flow through the fabric's batching layer
    and result cache (see `fabric_logposts`)."""
    if fabric is not None:
        assert loglik is not None and level_configs is not None, (
            "fabric= requires loglik= and level_configs="
        )
        logposts = fabric_logposts(fabric, loglik, level_configs, logprior)
    assert len(subsampling) == len(logposts) - 1
    sampler = _LevelSampler(list(logposts), list(subsampling), prop_cov, rng)
    x = np.asarray(x0, float).copy()
    top = len(logposts) - 1
    lp = sampler._lp(top, x)
    out = np.empty((n_samples, len(x)))
    for i in range(n_samples):
        x, lp, _ = sampler.propose(top, x, lp)
        out[i] = x
    rates = [
        (sampler.acc[l] / sampler.tot[l]) if sampler.tot[l] else 0.0
        for l in range(len(logposts))
    ]
    return MLDAResult(out, rates, list(sampler.evals))


def batched_level_logposts(
    fabric,
    loglik: Callable[[np.ndarray], float],
    level_configs: Sequence[dict | None],
    logprior: Callable[[np.ndarray], float] | None = None,
) -> list[Callable]:
    """Per-level BATCHED log-posteriors ([M, d] -> [M]) for `ensemble_mlda`,
    routed through an `EvaluationFabric` (reuses `uq.mcmc.batched_logpost`:
    prior-masked points never reach the model, waves hit the fabric cache/
    router). Coarsest level first, as in `fabric_logposts`."""
    return [batched_logpost(fabric, loglik, logprior, c) for c in level_configs]


class _EnsembleLevelSampler:
    """Recursive DA sampler advancing K chains in LOCKSTEP: one step at any
    level costs one [<=K, d] model wave, never K round-trips.

    Optional Haario-style adaptation of the level-0 proposal covariance,
    POOLED across the whole lockstep chain block (`adapt_start` level-0
    steps of warm-up, then the proposal Cholesky refreshes from
    `sd * pooled_cov + eps I` — one einsum per level-0 step, see
    `uq.mcmc.PooledCovarianceAdapter`). Only the coarsest level's random
    walk adapts: all finer proposals are subchain endpoints, so the whole
    MLDA stack inherits the adapted scale."""

    def __init__(self, logpost_batches, subsampling, prop_cov, rng, K,
                 adaptive: bool = False, adapt_start: int = 50,
                 adapt_interval: int = 1, sd: float | None = None,
                 surrogate=None, fused_level0=None, fused_key=None,
                 coarse_vg=None, mala_step: float = 0.5):
        self.logposts = list(logpost_batches)
        self.subsampling = list(subsampling)
        self.rng = rng
        self.K = K
        self.surrogate = surrogate
        self.L = len(self.logposts)
        self.chol = np.linalg.cholesky(np.atleast_2d(prop_cov))
        self.d = self.chol.shape[0]
        self.acc = np.zeros(self.L)
        self.tot = np.zeros(self.L)
        self.evals = [0] * self.L
        self.waves = 0
        # gradient-informed (MALA) coarse subchains: `coarse_vg` is the
        # batched value-and-gradient view of logposts[0] ([M, d] ->
        # (lps, glps)); `prop_cov` doubles as the MALA preconditioner C
        self.coarse_vg = coarse_vg
        self.mala_step = float(mala_step)
        if coarse_vg is not None:
            C = self.chol @ self.chol.T
            self._mala_C = C
            self._mala_Cinv = np.linalg.inv(C)
        # device-resident level-0 subchains (`uq.fused`): the whole coarse
        # subchain between two level-1 acceptance tests becomes ONE device
        # dispatch (one CUDA-graph replay on the card) against this
        # tensor-program logpost, drawing from the `fused_key` generator
        self.fused_level0 = fused_level0
        self._fused_key = fused_key
        self._fused_run = None
        self.adapter = PooledCovarianceAdapter(self.d, sd=sd) if adaptive else None
        self.adapt_start = int(adapt_start)
        self.adapt_interval = max(1, int(adapt_interval))
        self._level0_steps = 0

    def _lp(self, level: int, xs: np.ndarray) -> np.ndarray:
        """[M, d] -> [M] in ONE wave."""
        self.evals[level] += len(xs)
        self.waves += 1
        return np.asarray(self.logposts[level](xs), float).ravel()

    def _vg0(self, xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """[M, d] -> (lps [M], glps [M, d]) at level 0 in ONE fused wave."""
        self.evals[0] += len(xs)
        self.waves += 1
        lps, gs = self.coarse_vg(xs)
        return np.asarray(lps, float).ravel(), np.atleast_2d(np.asarray(gs, float))

    def _mala_step0(self, xs, lps, gs):
        """One lockstep preconditioned-MALA step at level 0 for all chains:
        x' = x + (eps^2/2) C grad(x) + eps chol(C) xi, accepted with the
        EXACT MH ratio (both proposal densities), so the coarse subchain
        still targets logposts[0] exactly and the DA correction above it
        needs no change. One fused value-and-gradient wave per step — the
        same wave count the blind RWM subchain pays, but each wave also
        buys the drift. Returns (xs, lps, gs, accepted[K])."""
        K = len(xs)
        eps = self.mala_step
        C, Cinv = self._mala_C, self._mala_Cinv

        def logq(diff_minus_drift):
            # log N(x'; x + drift, eps^2 C) up to the cancelling norm const
            return -0.5 / eps**2 * np.einsum(
                "ki,ij,kj->k", diff_minus_drift, Cinv, diff_minus_drift
            )

        drift = 0.5 * eps**2 * gs @ C.T
        props = xs + drift + eps * self.rng.standard_normal((K, self.d)) @ self.chol.T
        lp_props, g_props = self._vg0(props)
        drift_back = 0.5 * eps**2 * g_props @ C.T
        with np.errstate(invalid="ignore"):
            log_alpha = (lp_props - lps) + (
                logq(xs - props - drift_back) - logq(props - xs - drift)
            )
        log_alpha = np.where(np.isnan(log_alpha), -np.inf, log_alpha)
        accept = np.log(self.rng.uniform(size=K)) < log_alpha
        self.tot[0] += K
        self.acc[0] += accept.sum()
        xs = np.where(accept[:, None], props, xs)
        lps = np.where(accept, lp_props, lps)
        gs = np.where(accept[:, None], g_props, gs)
        return xs, lps, gs, accept

    def step(self, level: int, xs: np.ndarray, lps: np.ndarray):
        """One lockstep step at `level` for all K chains.
        Returns (xs, lps, accepted[K] bool)."""
        K = len(xs)
        if level == 0:
            props = xs + self.rng.standard_normal((K, self.d)) @ self.chol.T
            scr = self.surrogate
            if scr is not None:
                # three-stage DA stage 1: the GP screen (zero fabric
                # waves). Stage 1 promotes with prob min{1, e^dg}; stage 2
                # divides the coarse Metropolis ratio by the SAME screen
                # ratio, so the compound kernel targets the coarse
                # posterior exactly for ANY screen (Christen & Fox 2005).
                # Where the screen is inactive or variance-gated, dg = 0
                # and the step reduces to plain lockstep Metropolis.
                dg, skipped = scr.delta(xs, props)
                pass1 = np.log(self.rng.uniform(size=K)) < dg
                active = ~skipped
                scr.note(int(active.sum()), int((pass1 & active).sum()))
                lp_props = np.full(K, -np.inf)
                if pass1.any():
                    # only stage-1 survivors pay the coarse wave
                    lp_props[pass1] = self._lp(0, props[pass1])
                self.tot[0] += K
                with np.errstate(invalid="ignore"):
                    log_alpha = (lp_props - lps) - dg
                log_alpha = np.where(np.isnan(log_alpha), -np.inf, log_alpha)
                accept = pass1 & (np.log(self.rng.uniform(size=K)) < log_alpha)
            else:
                lp_props = self._lp(0, props)
                self.tot[0] += K
                accept = np.log(self.rng.uniform(size=K)) < lp_props - lps
            self.acc[0] += accept.sum()
            xs = np.where(accept[:, None], props, xs)
            lps = np.where(accept, lp_props, lps)
            if self.adapter is not None:
                self.adapter.update(xs)
                self._level0_steps += 1
                past = self._level0_steps - self.adapt_start
                if past >= 0 and past % self.adapt_interval == 0:
                    self.chol = self.adapter.chol()
            return xs, lps, accept
        # K coarse subchains advanced in lockstep, started from xs
        sub = self.subsampling[level - 1]
        if level == 1 and self.fused_level0 is not None:
            # device-resident subchain: `sub` coarse RWM steps for all K
            # chains in ONE dispatch — the DA ratio below uses lp_start/lp_ys
            # from the SAME coarse tensor-program logpost, so the correction
            # is exact; only the fine test pays a fabric wave
            if self._fused_run is None:
                from repro_torch.uq.fused import make_fused_rwm_subchain

                self._fused_run = make_fused_rwm_subchain(
                    self.fused_level0, sub, self.chol
                )
            ys, lp_ys_coarse, lp_start_coarse, sub_acc, self._fused_key = (
                self._fused_run(xs, self._fused_key)
            )
            moved = sub_acc > 0
            self.evals[0] += K * (sub + 1)
            self.waves += 2  # start-lps wave + the fused block
            self.acc[0] += sub_acc.sum()
            self.tot[0] += K * sub
            note = getattr(self.logposts[0], "note_steps", None)
            if note is not None:
                note(sub, waves=1)
        elif level == 1 and self.coarse_vg is not None:
            # gradient-informed coarse subchain: `sub` lockstep MALA steps,
            # each ONE fused value-and-gradient wave. All coarse log-
            # posterior values entering the DA ratio (lp_start, lp_ys) come
            # from the same `coarse_vg`, so the correction stays exact.
            ys = xs.copy()
            lp_ys_coarse, g_ys = self._vg0(ys)
            lp_start_coarse = lp_ys_coarse.copy()
            moved = np.zeros(K, bool)
            for _ in range(sub):
                ys, lp_ys_coarse, g_ys, acc = self._mala_step0(
                    ys, lp_ys_coarse, g_ys
                )
                moved |= acc
        else:
            ys = xs.copy()
            lp_ys_coarse = self._lp(level - 1, ys)  # cache-served when fabric-backed
            lp_start_coarse = lp_ys_coarse.copy()
            moved = np.zeros(K, bool)  # any subchain proposal accepted, per chain
            for _ in range(sub):
                ys, lp_ys_coarse, acc = self.step(level - 1, ys, lp_ys_coarse)
                moved |= acc
        accept = np.zeros(K, bool)
        if moved.any():
            # fine acceptance test for ALL moved chains in ONE wave; chains
            # whose subchain never accepted keep their state without paying
            # a fine evaluation
            lp_props = np.full(K, -np.inf)
            lp_props[moved] = self._lp(level, ys[moved])
            self.tot[level] += int(moved.sum())
            log_alpha = np.full(K, -np.inf)
            log_alpha[moved] = (lp_props[moved] - lps[moved]) - (
                lp_ys_coarse[moved] - lp_start_coarse[moved]
            )
            accept = moved & (np.log(self.rng.uniform(size=K)) < log_alpha)
            self.acc[level] += accept.sum()
            xs = np.where(accept[:, None], ys, xs)
            lps = np.where(accept, lp_props, lps)
        return xs, lps, accept


def ensemble_mlda(
    logpost_batches: Sequence[Callable] | None,
    x0s: np.ndarray,
    n_samples: int,
    subsampling: Sequence[int],
    prop_cov: np.ndarray,
    rng: np.random.Generator,
    *,
    fabric=None,
    level_configs: Sequence[dict | None] | None = None,
    loglik: Callable | None = None,
    logprior: Callable | None = None,
    adaptive: bool = False,
    adapt_start: int = 50,
    adapt_interval: int = 1,
    adapt_sd: float | None = None,
    surrogate=None,
    checkpoint=None,
    checkpoint_every: int = 0,
    fused_level0=None,
    fused_key=None,
    coarse_sampler: str = "rwm",
    coarse_value_grad: Callable | None = None,
    grad_loglik: Callable | None = None,
    grad_logprior: Callable | None = None,
    mala_step: float = 0.5,
) -> EnsembleMLDAResult:
    """K MLDA chains advanced in LOCKSTEP (paper §4.3 at fabric scale).

    Where `mlda` + `run_chains` issues one model round-trip per subchain
    step per chain, the ensemble turns each coarse-subchain step and each
    fine-level acceptance test across all K chains into ONE
    `evaluate_batch` wave — the paper's 1400-coarse/800-fine budget runs as
    ~tens of waves instead of thousands of round-trips. Per-chain kernels
    are the standard MLDA recursion (independent randomness per chain), so
    each chain's law matches `mlda`.

    `logpost_batches[l]`: [M, d] -> [M] at level l (coarsest first) — or
    pass `fabric=` with `level_configs=`/`loglik=` (and optional
    `logprior=`) to build them via `batched_level_logposts`.
    `x0s`: [K, d] initial states (one per chain).

    `adaptive=True` adapts the level-0 random-walk proposal covariance
    Haario-style, pooled across the lockstep chain block (the [K, d] state
    block makes the pooled empirical covariance one einsum per level-0
    step); `adapt_start` counts level-0 steps before the first refresh. The
    final adapted covariance is reported as `proposal_cov`.

    `surrogate=` (a `uq.surrogate.SurrogateScreen`, typically built with
    `SurrogateScreen.from_fabric` so it trains online from this very run's
    coarse traffic) inserts a level-(-1) GP screen below level 0 — THREE-
    stage delayed acceptance: each level-0 proposal is scored by one
    lockstep `predict_batch` (zero fabric waves), only stage-1 survivors
    pay the coarse wave, and the stage-2 correction keeps every step exact
    for ANY screen. Call `screen.freeze()` once warm-up traffic has
    trained it (see the module docstring: an unfrozen screen is adaptive
    MCMC). Screen telemetry lands in `result.surrogate` (and in
    `fabric.telemetry()["screen_pass_rate"]` when fabric-attached).

    `checkpoint=` (a `core.fleet.CampaignCheckpoint`, or anything with its
    `resume()`/`save(step, arrays, meta)` surface) makes the campaign
    crash-consistent: every `checkpoint_every` finest-level steps the full
    sampler state — chain positions, sample prefix, adapted proposal, rng
    bit-generator state, acceptance counters (plus whatever the checkpoint
    object itself captures: router EWMA, surrogate window) — is snapshotted
    atomically. A killed driver re-invoked with the same `checkpoint=`
    resumes from the newest complete snapshot and, because the rng stream
    is restored exactly, reproduces the uninterrupted run sample for
    sample.

    `fused_level0=` (a ``[K, d] -> [K]`` coarse log-posterior tensor
    program, e.g. `uq.fused.gaussian_likelihood_target` over the coarse
    solver's `apps.tsunami.solve_batch`) runs each level-0 subchain as ONE
    device-resident dispatch (on the card one CUDA-graph replay of
    `subsampling[0]` steps) instead of `subsampling[0]` host waves — the
    `uq.fused` generator (seeded on the card from `rng`, or passed as
    `fused_key=`) rides checkpoints as the `fused_key` leaf so resume stays
    bit-exact. Incompatible with `adaptive=` (the host adaptation path runs
    inside the level-0 loop this replaces) and `surrogate=` (the GP screen
    taps host-side coarse traffic that no longer exists).

    `coarse_sampler="mala"` makes the coarse subchains GRADIENT-INFORMED:
    each level-0 subchain step is one lockstep preconditioned-MALA step
    (drift from the coarse posterior gradient; `prop_cov` doubles as the
    preconditioner C, `mala_step` is eps) costing ONE fused
    value-and-gradient wave — the same wave count the blind random walk
    pays. The MALA kernel uses the exact MH ratio with both proposal
    densities, so the subchain targets the coarse posterior exactly and
    the DA correction above it is unchanged — DA stays exact; only the
    QUALITY of the fine-level proposals improves. Pass the batched
    value-and-gradient coarse logpost as `coarse_value_grad=` ([M, d] ->
    (lps, glps); see `uq.mcmc.batched_value_grad_logpost` — it MUST
    evaluate the same posterior as `logpost_batches[0]`), or with
    `fabric=` pass `grad_loglik=` (and optionally `grad_logprior=`) and it
    is built automatically. Requires at least two levels and a
    gradient-capable coarse backend; incompatible with `adaptive=`,
    `surrogate=` and `fused_level0=` (all act inside the blind level-0
    path this replaces)."""
    if fused_level0 is not None and (adaptive or surrogate is not None):
        raise ValueError(
            "fused_level0= is incompatible with adaptive= and surrogate=: "
            "both act inside the host level-0 loop that fused subchains "
            "replace (run them on the host path, or freeze/disable them)"
        )
    if coarse_sampler not in ("rwm", "mala"):
        raise ValueError(f"coarse_sampler must be 'rwm' or 'mala', got {coarse_sampler!r}")
    if coarse_sampler == "mala":
        if adaptive or surrogate is not None or fused_level0 is not None:
            raise ValueError(
                "coarse_sampler='mala' is incompatible with adaptive=, "
                "surrogate= and fused_level0=: all three act inside the "
                "blind level-0 random-walk path that MALA subchains replace"
            )
        if coarse_value_grad is None:
            if fabric is None or grad_loglik is None:
                raise ValueError(
                    "coarse_sampler='mala' needs coarse_value_grad= (a "
                    "batched [M, d] -> (lps, glps) view of the coarse "
                    "posterior), or fabric= plus grad_loglik= to build one"
                )
            coarse_value_grad = batched_value_grad_logpost(
                fabric, loglik, grad_loglik, logprior, grad_logprior,
                (level_configs or [None])[0],
            )
    else:
        coarse_value_grad = None
    if fabric is not None:
        assert loglik is not None and level_configs is not None, (
            "fabric= requires loglik= and level_configs="
        )
        logpost_batches = batched_level_logposts(
            fabric, loglik, level_configs, logprior
        )
    assert len(subsampling) == len(logpost_batches) - 1
    if coarse_value_grad is not None and len(logpost_batches) < 2:
        raise ValueError(
            "coarse_sampler='mala' needs at least two levels: the MALA "
            "kernel drives the coarse SUBCHAINS below a DA acceptance test "
            "(for single-level gradient-based sampling use uq.mcmc.ensemble_mala)"
        )
    if fused_level0 is not None:
        fused_key = _fused_key(fused_key, rng)
    xs = np.atleast_2d(np.asarray(x0s, float)).copy()
    K, d = xs.shape
    sampler = _EnsembleLevelSampler(
        logpost_batches, subsampling, prop_cov, rng, K,
        adaptive=adaptive, adapt_start=adapt_start,
        adapt_interval=adapt_interval, sd=adapt_sd, surrogate=surrogate,
        fused_level0=fused_level0, fused_key=fused_key,
        coarse_vg=coarse_value_grad, mala_step=mala_step,
    )
    top = len(logpost_batches) - 1
    out = np.empty((K, n_samples, d))

    def _snap(i_next: int) -> tuple[dict, dict]:
        arrays = {
            "xs": xs, "lps": lps, "samples": out[:, :i_next].copy(),
            "chol": sampler.chol, "acc": sampler.acc, "tot": sampler.tot,
        }
        meta = {
            "i_next": int(i_next),
            "evals": [int(v) for v in sampler.evals],
            "waves": int(sampler.waves),
            "level0_steps": int(sampler._level0_steps),
            "rng_state": rng.bit_generator.state,
        }
        if sampler._fused_key is not None:
            # the fused subchains' generator rides as its state, with its
            # device type — restoring it replays the identical proposals
            from repro_torch.core.fleet import CampaignCheckpoint

            arrays["fused_key"] = CampaignCheckpoint.pack_key(sampler._fused_key)
            meta["fused_key_device"] = sampler._fused_key.device.type
        if sampler.adapter is not None:
            arrays["adapter_mean"] = sampler.adapter.mean
            arrays["adapter_scatter"] = sampler.adapter._scatter
            meta["adapter_n"] = int(sampler.adapter.n)
        return arrays, meta

    start = 0
    resumed = checkpoint.resume() if checkpoint is not None else None
    if resumed is not None:
        arrays, meta, _step = resumed
        start = int(meta["i_next"])
        xs = np.array(arrays["xs"])
        lps = np.array(arrays["lps"]).ravel()
        out[:, :start] = arrays["samples"]
        sampler.chol = np.array(arrays["chol"])
        sampler.acc = np.array(arrays["acc"])
        sampler.tot = np.array(arrays["tot"])
        sampler.evals = [int(v) for v in meta["evals"]]
        sampler.waves = int(meta["waves"])
        sampler._level0_steps = int(meta["level0_steps"])
        if sampler.adapter is not None and "adapter_mean" in arrays:
            sampler.adapter.mean = np.array(arrays["adapter_mean"])
            sampler.adapter._scatter = np.array(arrays["adapter_scatter"])
            sampler.adapter.n = int(meta["adapter_n"])
        if "fused_key" in arrays:
            from repro_torch.core.fleet import CampaignCheckpoint

            sampler._fused_key = CampaignCheckpoint.unpack_key(
                arrays["fused_key"], meta["fused_key_device"])
        # exact-stream resume: the generator continues precisely where the
        # snapshot left it, so the resumed trajectory matches the
        # uninterrupted one sample for sample
        rng.bit_generator.state = meta["rng_state"]
    else:
        lps = sampler._lp(top, xs)
    from repro_torch.core.fabric import BudgetExhausted

    terminated = None
    n_done = n_samples
    for i in range(start, n_samples):
        try:
            xs, lps, _ = sampler.step(top, xs, lps)
        except BudgetExhausted:
            # campaign budget ran out: the completed finest-level steps are
            # a valid chain prefix; land a final checkpoint at this
            # boundary so re-opening the campaign resumes exactly here
            terminated = "budget"
            n_done = i
            if checkpoint is not None:
                arrays, meta = _snap(i)
                meta["terminated"] = "budget"
                checkpoint.save(i, arrays, meta)
            break
        out[:, i] = xs
        if (
            checkpoint is not None and checkpoint_every
            and (i + 1) % checkpoint_every == 0
        ):
            arrays, meta = _snap(i + 1)
            checkpoint.save(i + 1, arrays, meta)
    rates = [
        float(sampler.acc[l] / sampler.tot[l]) if sampler.tot[l] else 0.0
        for l in range(len(logpost_batches))
    ]
    return EnsembleMLDAResult(
        out[:, :n_done], rates, list(sampler.evals), sampler.waves,
        proposal_cov=None if sampler.adapter is None
        else sampler.adapter.proposal_cov(),
        surrogate=None if surrogate is None else surrogate.stats(),
        terminated=terminated,
    )


def delayed_acceptance(
    logpost_coarse: Callable,
    logpost_fine: Callable,
    x0: np.ndarray,
    n_samples: int,
    subchain: int,
    prop_cov: np.ndarray,
    rng: np.random.Generator,
) -> MLDAResult:
    """Two-level DA (Christen & Fox 2005) == MLDA with one subchain level."""
    return mlda([logpost_coarse, logpost_fine], x0, n_samples, [subchain], prop_cov, rng)
