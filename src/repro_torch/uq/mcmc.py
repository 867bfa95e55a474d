"""MCMC: random-walk Metropolis, adaptive Metropolis (Haario), pCN — plus
lockstep ENSEMBLE variants of RWM / pCN and GRADIENT-BASED lockstep
samplers (MALA / HMC) riding the capability-typed model surface.

Host-side implementations (the paper's UQ drivers run on a laptop /
workstation and treat the model as remote), with ESS / R-hat diagnostics.
Chains are embarrassingly parallel two ways:

* `run_chains` — K chains as K threads (the paper's 100-independent-samplers
  pattern); each proposal is ONE model call, so waves only form if a fabric
  collector catches concurrent submits mid-flight.
* `ensemble_random_walk_metropolis` / `ensemble_pcn` — K chains advanced in
  LOCKSTEP: every step proposes for all chains at once and costs exactly ONE
  `evaluate_batch` wave of K points, which native batch models (vmapped JAX
  apps, `/EvaluateBatch` servers) evaluate as one SPMD program. Same
  per-chain Markov kernel, perfectly filled waves by construction. The
  optional `adaptive=` flag pools a Haario-style empirical proposal
  covariance across the whole [K, d] state block (one einsum per step).
* `ensemble_mala` / `ensemble_hmc` — the gradient analogue: every step (or
  leapfrog substep) across all K chains is ONE fused value-and-gradient
  wave through `batched_value_grad_logpost` — AD-capable backends compute
  the primal and sens^T J in a single dispatch, so drift-informed proposals
  cost the same wave count RWM pays for blind ones.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class ChainResult:
    samples: np.ndarray  # [n, d]
    logposts: np.ndarray  # [n]
    accept_rate: float
    n_model_evals: int


@dataclass
class EnsembleResult:
    """K lockstep chains: samples [K, n_steps, d], one wave per step."""

    samples: np.ndarray  # [K, n, d]
    logposts: np.ndarray  # [K, n]
    accept_rates: np.ndarray  # [K]
    # proposal points submitted to the logpost (K per wave); prior-masked
    # points never reach the model — `batched_logpost(...).points_evaluated`
    # counts the ones that did
    n_model_evals: int
    n_waves: int  # batched model dispatches (steps + 1)
    #: fused value-and-gradient waves issued (gradient-based samplers only)
    n_grad_waves: int = 0
    #: final (possibly adapted) proposal covariance / step size
    proposal_cov: np.ndarray | None = None
    final_step_size: float | None = None
    #: None for a full run; "budget" when a campaign budget ran out mid-run
    #: and the sampler stopped cleanly at a step boundary (arrays hold the
    #: completed prefix, a final checkpoint was saved when one is attached)
    terminated: str | None = None

    @property
    def accept_rate(self) -> float:
        return float(np.mean(self.accept_rates))

    def chains(self) -> list[ChainResult]:
        """Per-chain view, interchangeable with `run_chains` output."""
        return [
            ChainResult(
                self.samples[k],
                self.logposts[k],
                float(self.accept_rates[k]),
                self.n_waves,
            )
            for k in range(len(self.samples))
        ]


class PooledCovarianceAdapter:
    """Haario-style adaptive proposal covariance POOLED across K lockstep
    chains: every step contributes its whole [K, d] state block as one batch
    — the running mean/scatter update is a single einsum, so adaptation
    costs nothing next to a model wave. The per-step weight of any single
    state shrinks as 1/n_total, so diminishing adaptation holds exactly as
    in single-chain Haario, but the empirical covariance sees K points per
    step instead of one (K-fold faster warm-up)."""

    def __init__(self, d: int, sd: float | None = None, eps: float = 1e-10):
        self.d = int(d)
        self.sd = float(sd) if sd is not None else 2.4**2 / d
        self.eps = float(eps)
        self.n = 0
        self.mean = np.zeros(d)
        self._scatter = np.zeros((d, d))

    def update(self, xs: np.ndarray):
        """Fold one [K, d] block of post-step states into the running
        moments (Chan-style batched Welford; one einsum for the scatter)."""
        xs = np.atleast_2d(np.asarray(xs, float))
        m = len(xs)
        mu_b = xs.mean(axis=0)
        dev = xs - mu_b
        s_b = np.einsum("ki,kj->ij", dev, dev)
        delta = mu_b - self.mean
        tot = self.n + m
        self._scatter += s_b + np.outer(delta, delta) * (self.n * m / tot)
        self.mean += delta * (m / tot)
        self.n = tot

    def cov(self) -> np.ndarray:
        if self.n < 2:
            return np.eye(self.d)
        return self._scatter / (self.n - 1)

    def proposal_cov(self) -> np.ndarray:
        """sd * empirical covariance + eps I (Haario's regularized scale)."""
        return self.sd * self.cov() + self.eps * np.eye(self.d)

    def chol(self) -> np.ndarray:
        return np.linalg.cholesky(self.proposal_cov())


def batched_logpost(
    evaluator,
    loglik: Callable[[np.ndarray], float],
    logprior: Callable[[np.ndarray], float] | None = None,
    config: dict | None = None,
) -> Callable[[np.ndarray], np.ndarray]:
    """[K, d] -> [K] log-posterior for the ensemble samplers, from anything
    with an `evaluate_batch(thetas, config)` (EvaluationFabric, native batch
    Model, HTTPModel) or a plain batched callable. Out-of-prior chains are
    masked BEFORE the wave, so no model evaluation is wasted on them."""

    def logpost(thetas: np.ndarray) -> np.ndarray:
        thetas = np.atleast_2d(np.asarray(thetas, float))
        K = len(thetas)
        out = np.full(K, -np.inf)
        prior = np.zeros(K)
        if logprior is not None:
            prior = np.asarray([float(logprior(t)) for t in thetas])
        ok = np.isfinite(prior)
        if ok.any():
            if hasattr(evaluator, "evaluate_batch"):
                ys = evaluator.evaluate_batch(thetas[ok], config)
            else:
                ys = evaluator(thetas[ok])
            ys = np.atleast_2d(np.asarray(ys, float))
            out[ok] = prior[ok] + np.asarray([float(loglik(y)) for y in ys])
        logpost.points_evaluated += int(ok.sum())
        logpost.waves += 1
        return out

    # model points actually evaluated (prior-masked proposals never reach
    # the model) — benchmarks report honest evals/sec from these
    def reset():
        """Zero the wave/point counters (benchmarks call this after warm-up
        so jit compilation never counts toward measured throughput)."""
        logpost.points_evaluated = 0
        logpost.waves = 0

    logpost.reset = reset
    logpost.reset()
    logpost.note_steps = _steps_hook(evaluator)
    return logpost


def _steps_hook(evaluator):
    """Forward sampler-step accounting to the evaluator's telemetry when it
    keeps one (`EvaluationFabric.note_steps`); no-op otherwise. The host
    samplers note 1 step per proposal wave, the fused runners S per block —
    `telemetry()['steps_per_wave']` then stays comparable across both."""
    ev_note = getattr(evaluator, "note_steps", None)

    def note_steps(steps: int = 1, waves: int = 1):
        if ev_note is not None:
            ev_note(steps, waves=waves)

    return note_steps


def batched_value_grad_logpost(
    evaluator,
    loglik: Callable[[np.ndarray], float],
    grad_loglik: Callable,
    logprior: Callable[[np.ndarray], float] | None = None,
    grad_logprior: Callable[[np.ndarray], np.ndarray] | None = None,
    config: dict | None = None,
) -> Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """[K, d] -> (logpost [K], grad_logpost [K, d]) for the gradient-based
    ensemble samplers, from anything with a `value_and_gradient_batch`
    (EvaluationFabric, capability-typed Model).

    `grad_loglik(y [m]) -> [m]` is the data-side sensitivity (dloglik/dy at
    one output row); when it is jax-traceable AND the backend is AD-native,
    the whole (value, grad) pair costs ONE fused wave per call — otherwise
    the fabric negotiates down to an evaluate wave plus a gradient wave.
    Out-of-prior chains are masked BEFORE the wave (their logpost is -inf
    and their gradient zero), so no model evaluation is wasted; the chain
    rule adds `grad_logprior` (when given) on the parameter side."""
    if not hasattr(evaluator, "value_and_gradient_batch"):
        raise TypeError(
            "batched_value_grad_logpost needs an evaluator with "
            "value_and_gradient_batch (an EvaluationFabric or a Model); "
            f"got {type(evaluator).__name__}"
        )

    def value_grad(thetas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        thetas = np.atleast_2d(np.asarray(thetas, float))
        K, d = thetas.shape
        lps = np.full(K, -np.inf)
        glps = np.zeros((K, d))
        prior = np.zeros(K)
        if logprior is not None:
            prior = np.asarray([float(logprior(t)) for t in thetas])
        ok = np.isfinite(prior)
        if ok.any():
            ys, gys = evaluator.value_and_gradient_batch(
                thetas[ok], grad_loglik, config
            )
            ys = np.atleast_2d(np.asarray(ys, float))
            lps[ok] = prior[ok] + np.asarray([float(loglik(y)) for y in ys])
            grads = np.atleast_2d(np.asarray(gys, float))
            if grad_logprior is not None:
                grads = grads + np.stack([
                    np.asarray(grad_logprior(t), float).ravel()
                    for t in thetas[ok]
                ])
            glps[ok] = grads
        value_grad.points_evaluated += int(ok.sum())
        value_grad.waves += 1
        return lps, glps

    def reset():
        value_grad.points_evaluated = 0
        value_grad.waves = 0

    value_grad.reset = reset
    value_grad.reset()
    value_grad.note_steps = _steps_hook(evaluator)
    return value_grad


def _fused_key(fused_key, rng: np.random.Generator):
    """Generator of the fused path's stream: explicit `fused_key` wins
    (reproducible key-manifest workflows, and the device the block runs
    on); otherwise one on the card seeded from the host rng, so
    `rng`-seeded callers stay deterministic."""
    if fused_key is not None:
        return fused_key
    import torch

    from repro_torch.core.device import resolve_device

    gen = torch.Generator(device=resolve_device(None))
    return gen.manual_seed(int(rng.integers(0, 2**31 - 1)))


def ensemble_random_walk_metropolis(
    logpost_batch: Callable[[np.ndarray], np.ndarray],
    x0s: np.ndarray,
    n_steps: int,
    prop_cov: np.ndarray,
    rng: np.random.Generator,
    *,
    adaptive: bool = False,
    adapt_start: int = 25,
    adapt_interval: int = 1,
    sd: float | None = None,
    fused_steps: int | None = None,
    fused_key=None,
    ctx=None,
    telemetry=None,
    checkpoint=None,
    checkpoint_every: int = 0,
) -> EnsembleResult:
    """K lockstep RWM chains: ONE [K, d] -> [K] model wave per step.

    Each chain runs the standard Metropolis kernel (same proposal covariance,
    independent randomness per chain) — only the model evaluations are fused,
    so the per-chain law matches `random_walk_metropolis`.

    `adaptive=True` turns on Haario-style proposal adaptation with the
    empirical covariance POOLED across the whole lockstep [K, d] state block
    (one einsum per step, K observations per update): after `adapt_start`
    steps the proposal Cholesky refreshes every `adapt_interval` steps from
    `sd * pooled_cov + eps I` (sd defaults to Haario's 2.4^2/d). The pooled
    estimate warms up K-fold faster than single-chain adaptation.

    `fused_steps=S` switches to the device-resident block sampler
    (`uq.fused`): `logpost_batch` must then be a ``[K, d] -> [K]`` tensor
    program (see `uq.fused.gaussian_likelihood_target`), proposals are
    drawn from a `torch.Generator` seeded from `rng` on the card (or
    `fused_key`, whose device the block runs on), and S steps run per
    dispatch, one CUDA-graph replay on the card — the host loop here stays
    the reference path and the only one for non-tensor backends.
    Incompatible with `adaptive=` (per-block covariance refits would change
    the kernel mid-block)."""
    if fused_steps is not None:
        if adaptive:
            raise ValueError(
                "fused_steps= and adaptive= are incompatible: Haario "
                "adaptation refits the proposal on the host every step"
            )
        from repro_torch.uq import fused as _fused

        return _fused.fused_ensemble_rwm(
            logpost_batch, x0s, n_steps, prop_cov,
            _fused_key(fused_key, rng), fused_steps=fused_steps, ctx=ctx,
            telemetry=telemetry, checkpoint=checkpoint,
            checkpoint_every=checkpoint_every,
        )
    from repro_torch.core.fabric import BudgetExhausted

    xs = np.atleast_2d(np.asarray(x0s, float)).copy()
    K, d = xs.shape
    L = np.linalg.cholesky(np.atleast_2d(prop_cov))
    adapter = PooledCovarianceAdapter(d, sd=sd) if adaptive else None
    note = getattr(logpost_batch, "note_steps", None)
    lps = np.asarray(logpost_batch(xs), float).ravel()
    samples = np.empty((K, n_steps, d))
    lps_out = np.empty((K, n_steps))
    acc = np.zeros(K)
    terminated = None
    n_done = n_steps
    for i in range(n_steps):
        props = xs + rng.standard_normal((K, d)) @ L.T
        try:
            lp_props = np.asarray(logpost_batch(props), float).ravel()
        except BudgetExhausted:
            # campaign budget ran out: stop at the step boundary — every
            # completed step's samples are valid, nothing is corrupted
            terminated = "budget"
            n_done = i
            break
        accept = np.log(rng.uniform(size=K)) < lp_props - lps
        xs = np.where(accept[:, None], props, xs)
        lps = np.where(accept, lp_props, lps)
        acc += accept
        samples[:, i] = xs
        lps_out[:, i] = lps
        if note is not None:
            note(1, waves=1)
        if adapter is not None:
            adapter.update(xs)
            if i >= adapt_start and (i - adapt_start) % adapt_interval == 0:
                L = adapter.chol()
    return EnsembleResult(
        samples[:, :n_done], lps_out[:, :n_done], acc / max(n_done, 1),
        K * (n_done + 1), n_done + 1,
        proposal_cov=None if adapter is None else adapter.proposal_cov(),
        terminated=terminated,
    )


def ensemble_pcn(
    loglik_batch: Callable[[np.ndarray], np.ndarray],
    prior_sample: Callable[[np.random.Generator, int], np.ndarray],
    x0s: np.ndarray,
    n_steps: int,
    beta: float,
    rng: np.random.Generator,
    *,
    fused_steps: int | None = None,
    fused_key=None,
    prior_chol: np.ndarray | None = None,
    ctx=None,
    telemetry=None,
) -> EnsembleResult:
    """K lockstep pCN chains (Gaussian priors; dimension-robust); ONE model
    wave per step. `prior_sample(rng, K)` draws [K, d] prior samples.

    `fused_steps=S` runs the device-resident block sampler instead:
    `loglik_batch` must be a tensor program, the (centered) Gaussian prior
    is given by its Cholesky factor `prior_chol` (default I) and sampled
    on-device, and `prior_sample` is unused."""
    if fused_steps is not None:
        from repro_torch.uq import fused as _fused

        return _fused.fused_ensemble_pcn(
            loglik_batch, x0s, n_steps, beta, _fused_key(fused_key, rng),
            prior_chol=prior_chol, fused_steps=fused_steps, ctx=ctx,
            telemetry=telemetry,
        )
    xs = np.atleast_2d(np.asarray(x0s, float)).copy()
    K, _ = xs.shape
    note = getattr(loglik_batch, "note_steps", None)
    lls = np.asarray(loglik_batch(xs), float).ravel()
    samples = np.empty((K, n_steps, xs.shape[1]))
    lls_out = np.empty((K, n_steps))
    acc = np.zeros(K)
    root = np.sqrt(1.0 - beta**2)
    for i in range(n_steps):
        props = root * xs + beta * np.atleast_2d(prior_sample(rng, K))
        ll_props = np.asarray(loglik_batch(props), float).ravel()
        accept = np.log(rng.uniform(size=K)) < ll_props - lls
        xs = np.where(accept[:, None], props, xs)
        lls = np.where(accept, ll_props, lls)
        acc += accept
        samples[:, i] = xs
        lls_out[:, i] = lls
        if note is not None:
            note(1, waves=1)
    return EnsembleResult(samples, lls_out, acc / n_steps, K * (n_steps + 1), n_steps + 1)


def ensemble_mala(
    value_grad_logpost: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]],
    x0s: np.ndarray,
    n_steps: int,
    step_size: float,
    rng: np.random.Generator,
    *,
    precond: np.ndarray | None = None,
    adapt_steps: int = 0,
    target_accept: float = 0.574,
    checkpoint=None,
    checkpoint_every: int = 0,
    fused_steps: int | None = None,
    fused_key=None,
    ctx=None,
    telemetry=None,
) -> EnsembleResult:
    """K lockstep MALA chains: ONE fused value-and-gradient wave per step.

    Preconditioned Metropolis-adjusted Langevin: with C = `precond` (defaults
    to I; pass the prior/posterior scale — MALA without preconditioning is
    hopeless on badly scaled parameters) and eps = `step_size`,

        x' = x + (eps^2/2) C grad(x) + eps chol(C) xi,

    accepted with the exact MH ratio including both proposal densities. The
    current state's (logpost, grad) pair is carried between steps, so the
    whole ensemble costs exactly one wave per step — the same wave count
    ensemble RWM pays, but each wave also buys the drift (AD backends fuse
    the primal and the VJP into one dispatch).

    `adapt_steps > 0` runs Robbins-Monro step-size adaptation toward
    `target_accept` (MALA's optimal 0.574) over the first `adapt_steps`
    steps, pooled across chains; the adapted eps is reported in
    `final_step_size`.

    `checkpoint=` / `checkpoint_every=` snapshot the full sampler state
    (positions, carried gradients, adapted eps, rng stream, sample prefix)
    every `checkpoint_every` steps through a `core.fleet.CampaignCheckpoint`
    — a killed run re-invoked with the same checkpoint resumes exactly
    (same rng stream → identical trajectory).

    `fused_steps=S` switches to the device-resident block sampler:
    `value_grad_logpost` must then be a ``[K, d] -> [K]`` LOG-POSTERIOR
    tensor program that torch autograd differentiates (not a
    value-and-grad pair) — the drift gradients are taken on-device with
    one backward pass per step — and checkpoints land at block boundaries
    with the generator state instead of every step."""
    if fused_steps is not None:
        from repro_torch.uq import fused as _fused

        return _fused.fused_ensemble_mala(
            value_grad_logpost, x0s, n_steps, step_size,
            _fused_key(fused_key, rng), precond=precond,
            adapt_steps=adapt_steps, target_accept=target_accept,
            fused_steps=fused_steps, ctx=ctx, telemetry=telemetry,
            checkpoint=checkpoint, checkpoint_every=checkpoint_every,
        )
    xs = np.atleast_2d(np.asarray(x0s, float)).copy()
    K, d = xs.shape
    C = np.eye(d) if precond is None else np.atleast_2d(np.asarray(precond, float))
    L = np.linalg.cholesky(C)
    Cinv = np.linalg.inv(C)
    eps = float(step_size)
    note = getattr(value_grad_logpost, "note_steps", None)
    samples = np.empty((K, n_steps, d))
    lps_out = np.empty((K, n_steps))
    acc = np.zeros(K)
    start = 0
    resumed = checkpoint.resume() if checkpoint is not None else None
    if resumed is not None:
        arrays, meta, _step = resumed
        start = int(meta["i_next"])
        xs = np.array(arrays["xs"])
        lps = np.array(arrays["lps"]).ravel()
        gs = np.atleast_2d(np.array(arrays["gs"]))
        acc = np.array(arrays["acc"]).ravel()
        samples[:, :start] = arrays["samples"]
        lps_out[:, :start] = arrays["lps_out"]
        eps = float(meta["eps"])
        rng.bit_generator.state = meta["rng_state"]
    else:
        lps, gs = value_grad_logpost(xs)
        lps = np.asarray(lps, float).ravel()
        gs = np.atleast_2d(np.asarray(gs, float))

    def _logq(diff_minus_drift: np.ndarray, e: float) -> np.ndarray:
        # log N(x' ; x + drift, e^2 C) up to the (cancelling) normalization
        return -0.5 / e**2 * np.einsum(
            "ki,ij,kj->k", diff_minus_drift, Cinv, diff_minus_drift
        )

    from repro_torch.core.fabric import BudgetExhausted

    terminated = None
    n_done = n_steps
    for i in range(start, n_steps):
        drift = 0.5 * eps**2 * gs @ C.T
        props = xs + drift + eps * rng.standard_normal((K, d)) @ L.T
        try:
            lp_props, g_props = value_grad_logpost(props)
        except BudgetExhausted:
            # budget stop at a step boundary: the prefix is a valid chain;
            # land a final checkpoint so the campaign resumes (under a new
            # budget) exactly where the old one ran dry
            terminated = "budget"
            n_done = i
            if checkpoint is not None:
                checkpoint.save(
                    i,
                    {
                        "xs": xs, "lps": lps, "gs": gs, "acc": acc,
                        "samples": samples[:, :i].copy(),
                        "lps_out": lps_out[:, :i].copy(),
                    },
                    {
                        "i_next": i, "eps": float(eps),
                        "rng_state": rng.bit_generator.state,
                        "terminated": "budget",
                    },
                )
            break
        lp_props = np.asarray(lp_props, float).ravel()
        g_props = np.atleast_2d(np.asarray(g_props, float))
        drift_rev = 0.5 * eps**2 * g_props @ C.T
        log_q_fwd = _logq(props - xs - drift, eps)
        log_q_rev = _logq(xs - props - drift_rev, eps)
        with np.errstate(invalid="ignore"):
            log_alpha = (lp_props - lps) + (log_q_rev - log_q_fwd)
        log_alpha = np.where(np.isnan(log_alpha), -np.inf, log_alpha)
        accept = np.log(rng.uniform(size=K)) < log_alpha
        xs = np.where(accept[:, None], props, xs)
        lps = np.where(accept, lp_props, lps)
        gs = np.where(accept[:, None], g_props, gs)
        acc += accept
        samples[:, i] = xs
        lps_out[:, i] = lps
        if note is not None:
            note(1, waves=1)
        if i < adapt_steps:
            # Robbins-Monro on log eps, pooled acceptance across the block
            eps *= float(np.exp((i + 1) ** -0.6 * (accept.mean() - target_accept)))
        if (
            checkpoint is not None and checkpoint_every
            and (i + 1) % checkpoint_every == 0
        ):
            checkpoint.save(
                i + 1,
                {
                    "xs": xs, "lps": lps, "gs": gs, "acc": acc,
                    "samples": samples[:, :i + 1].copy(),
                    "lps_out": lps_out[:, :i + 1].copy(),
                },
                {
                    "i_next": i + 1, "eps": float(eps),
                    "rng_state": rng.bit_generator.state,
                },
            )
    return EnsembleResult(
        samples[:, :n_done], lps_out[:, :n_done], acc / max(n_done, 1),
        K * (n_done + 1), n_done + 1,
        n_grad_waves=n_done + 1, final_step_size=eps, terminated=terminated,
    )


def ensemble_hmc(
    value_grad_logpost: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]],
    x0s: np.ndarray,
    n_steps: int,
    step_size: float,
    n_leapfrog: int,
    rng: np.random.Generator,
    *,
    precond: np.ndarray | None = None,
    adapt_steps: int = 0,
    target_accept: float = 0.8,
) -> EnsembleResult:
    """K lockstep preconditioned HMC chains: `n_leapfrog` fused
    value-and-gradient waves per step (every leapfrog substep advances ALL
    chains at once).

    With C = `precond`, momenta are drawn p ~ N(0, C^-1) and the kinetic
    energy is p^T C p / 2 — equivalent to mass matrix M = C^-1, the standard
    preconditioning that makes unit `step_size` roughly correct when C
    matches the posterior scale. Chains accept/reject independently on the
    exact Hamiltonian error; a chain whose trajectory leaves the prior
    support (logpost -inf) diverges to H = inf and rejects."""
    xs = np.atleast_2d(np.asarray(x0s, float)).copy()
    K, d = xs.shape
    C = np.eye(d) if precond is None else np.atleast_2d(np.asarray(precond, float))
    L = np.linalg.cholesky(C)
    # p ~ N(0, C^-1): p = L^-T xi  (so p^T C p = |xi|^2)
    Linv_T = np.linalg.inv(L).T
    eps = float(step_size)
    note = getattr(value_grad_logpost, "note_steps", None)
    lps, gs = value_grad_logpost(xs)
    lps = np.asarray(lps, float).ravel()
    gs = np.atleast_2d(np.asarray(gs, float))
    samples = np.empty((K, n_steps, d))
    lps_out = np.empty((K, n_steps))
    acc = np.zeros(K)
    n_waves = 1
    for i in range(n_steps):
        p0 = rng.standard_normal((K, d)) @ Linv_T.T
        h0 = -lps + 0.5 * np.einsum("ki,ij,kj->k", p0, C, p0)
        q, p = xs.copy(), p0.copy()
        lp_q, g_q = lps, gs
        for _ in range(n_leapfrog):
            p = p + 0.5 * eps * g_q
            q = q + eps * p @ C.T
            lp_q, g_q = value_grad_logpost(q)
            lp_q = np.asarray(lp_q, float).ravel()
            g_q = np.atleast_2d(np.asarray(g_q, float))
            p = p + 0.5 * eps * g_q
            n_waves += 1
        with np.errstate(invalid="ignore"):
            h1 = -lp_q + 0.5 * np.einsum("ki,ij,kj->k", p, C, p)
            log_alpha = h0 - h1
        log_alpha = np.where(np.isnan(log_alpha), -np.inf, log_alpha)
        accept = np.log(rng.uniform(size=K)) < log_alpha
        xs = np.where(accept[:, None], q, xs)
        lps = np.where(accept, lp_q, lps)
        gs = np.where(accept[:, None], g_q, gs)
        acc += accept
        samples[:, i] = xs
        lps_out[:, i] = lps
        if note is not None:
            note(1, waves=n_leapfrog)
        if i < adapt_steps:
            eps *= float(np.exp((i + 1) ** -0.6 * (accept.mean() - target_accept)))
    return EnsembleResult(
        samples, lps_out, acc / n_steps, K * n_waves, n_waves,
        n_grad_waves=n_waves, final_step_size=eps,
    )


def random_walk_metropolis(
    logpost: Callable[[np.ndarray], float],
    x0: np.ndarray,
    n_steps: int,
    prop_cov: np.ndarray,
    rng: np.random.Generator,
    adaptive: bool = False,
    adapt_start: int = 100,
) -> ChainResult:
    x = np.asarray(x0, float).copy()
    d = len(x)
    L = np.linalg.cholesky(np.atleast_2d(prop_cov))
    lp = float(logpost(x))
    samples = np.empty((n_steps, d))
    lps = np.empty(n_steps)
    acc = 0
    n_evals = 1
    mean = x.copy()
    cov = np.atleast_2d(prop_cov).copy()
    sd = 2.4**2 / d
    for i in range(n_steps):
        prop = x + L @ rng.standard_normal(d)
        lp_prop = float(logpost(prop))
        n_evals += 1
        if np.log(rng.uniform()) < lp_prop - lp:
            x, lp = prop, lp_prop
            acc += 1
        samples[i] = x
        lps[i] = lp
        if adaptive:  # Haario adaptive metropolis
            w = 1.0 / (i + 2)
            dx = x - mean
            mean += w * dx
            cov = (1 - w) * cov + w * np.outer(dx, dx)
            if i >= adapt_start:
                L = np.linalg.cholesky(sd * cov + 1e-10 * np.eye(d))
    return ChainResult(samples, lps, acc / n_steps, n_evals)


def pcn(
    loglik: Callable[[np.ndarray], float],
    prior_sample: Callable[[np.random.Generator], np.ndarray],
    x0: np.ndarray,
    n_steps: int,
    beta: float,
    rng: np.random.Generator,
) -> ChainResult:
    """Preconditioned Crank-Nicolson (for Gaussian priors; dimension-robust)."""
    x = np.asarray(x0, float).copy()
    ll = float(loglik(x))
    samples = np.empty((n_steps, len(x)))
    lls = np.empty(n_steps)
    acc = 0
    for i in range(n_steps):
        xi = prior_sample(rng)
        prop = np.sqrt(1 - beta**2) * x + beta * xi
        ll_prop = float(loglik(prop))
        if np.log(rng.uniform()) < ll_prop - ll:
            x, ll = prop, ll_prop
            acc += 1
        samples[i] = x
        lls[i] = ll
    return ChainResult(samples, lls, acc / n_steps, n_steps + 1)


def run_chains(
    make_chain: Callable,
    n_chains: int,
    parallel: bool = True,
    fabric=None,
):
    """n independent chains (paper §4.3: 100 parallel MLDA samplers).

    When `fabric` (an `EvaluationFabric`) is given, `make_chain` is called as
    `make_chain(i, fabric)` so every chain routes its model evaluations
    through the shared dispatch layer — concurrent chains then coalesce into
    batched waves and share the result cache, which is the whole point of
    running them in threads."""
    if fabric is not None:
        import inspect

        if len(inspect.signature(make_chain).parameters) < 2:
            raise TypeError("with fabric=, make_chain must accept (chain_id, fabric)")
        chain = lambda i: make_chain(i, fabric)
    else:
        chain = make_chain
    if parallel and n_chains > 1:
        with ThreadPoolExecutor(max_workers=n_chains) as ex:
            return list(ex.map(chain, range(n_chains)))
    return [chain(i) for i in range(n_chains)]


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------


def effective_sample_size(x: np.ndarray) -> float:
    """ESS via initial positive sequence of autocorrelations."""
    x = np.asarray(x, float).ravel()
    n = len(x)
    if n < 4:
        return float(n)
    xc = x - x.mean()
    acf = np.correlate(xc, xc, "full")[n - 1 :] / (np.arange(n, 0, -1) * x.var() + 1e-300)
    s = 0.0
    for k in range(1, n // 2):
        pair = acf[2 * k - 1] + acf[2 * k] if 2 * k < n else acf[2 * k - 1]
        if pair < 0:
            break
        s += pair
    return n / (1 + 2 * s)


def gelman_rubin(chains: np.ndarray) -> float:
    """R-hat over [n_chains, n_samples]."""
    m, n = chains.shape
    means = chains.mean(axis=1)
    B = n * means.var(ddof=1)
    W = chains.var(axis=1, ddof=1).mean()
    var_hat = (n - 1) / n * W + B / n
    return float(np.sqrt(var_hat / (W + 1e-300)))
