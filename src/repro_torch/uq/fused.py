"""Device-resident fused sampler blocks (port of `repro.uq.fused`).

The host lockstep samplers in `uq.mcmc` made waves WIDE: one `[K, d]`
model wave per MCMC step instead of K single-point calls. But the hot loop
still pays one dispatch — and one full device round trip — per step, so on
a fast posterior the sampler is latency-bound at the driver/solver boundary.
This module makes waves DEEP as well: S sampler steps run as ONE unit of
device work with

* on-device proposal generation — a `torch.Generator` (Philox on the card)
  drawn from in step order, never reseeded,
* log-posterior evaluation through any ``[K, d] -> [K]`` tensor program
  (see the target builders; on the tsunami, `apps.tsunami.solve_batch`,
  one launch of the SWE solve kernel a step, and for MALA's drift one more
  of its adjoint),
* Metropolis accept/reject, and Robbins-Monro step-size adaptation for
  MALA, all on the device with no host sync inside the block,

so only every S-th state crosses the host boundary. On the card the block
is ONE CUDA graph: the S-step body is warmed up once on a side stream,
captured on that stream (thread-local capture mode, so the fabric's
collector thread may run evaluate waves of the same model meanwhile) with
the generator registered in the graph, and replayed once per block,
followed by one device→host copy of the block's samples and log-densities.
Captured graphs and their static buffers are memoised (LRU 32) on the step
configuration, S, K and the device, so a repeated call copies its new start
state into the graph's inputs instead of capturing again. On the CPU the
same body runs eagerly. The block runs on its generator's device.

The per-step reference path (``per_step=True``) is the SAME body with
S = 1, replayed once per step with a host pull in between. Its replays
draw from the Philox stream at the same offsets as the S-step graph, so the
S = 1 bit-exactness invariant (CONTRIBUTING) holds on the card as on the
CPU, and the fused-vs-per-step comparison is an apples-to-apples
dispatch-cost measurement.

Checkpointing reconciles with `core.fleet.CampaignCheckpoint` at block
boundaries: the carry tensors land as npy leaves and the generator state
rides as the `rng_key` leaf (`CampaignCheckpoint.pack_key`), with the
generator's device type in the meta, so a killed campaign resumed with the
same block size replays the identical stream — bit-exact, not just
statistically indistinguishable.

On a device mesh (`ctx=`, a `distributed.sharding.ShardingCtx`, the driver
replicated on every rank) the chains are padded to `max(next_pow2(K),
ctx.n_data)` (rounded up to an `n_data` multiple), the last start repeated,
as the JAX package's `_pad_chains` pads them; a padding lane always rejects
and is dropped from the result. Each rank keeps its contiguous rows of the
carry and captures its own block as one CUDA graph. Every Philox array is
drawn at its GLOBAL shape [Kp, ...] and the rank keeps its rows, so a
sharded run equals a one-rank run with the same Kp bit for bit wherever
the target's rows are independent of the wave's width (the tsunami's
lanes; a row-wise Gaussian). The block's samples are gathered to every
rank at its one host pull (`ShardingCtx.gather_rows`; no collective enters
a captured body), and rank 0 writes the checkpoints, the carry gathered,
so a run resumes on any mesh whose padding gives the same Kp. Fused MALA's
step-size adaptation pools the acceptance over every chain each step: on a
mesh of more than one batch rank, with `adapt_steps > 0`, each step gathers
the ranks' counts on the host, so that block runs eagerly instead of as a
graph. Without a mesh no chain is padded.

The host numpy loops in `uq.mcmc` remain the reference implementation and
the only path for non-tensor backends (HTTP models, subprocess fleets); the
`ensemble_*` entry points there expose this module as ``fused_steps=S``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.races import named_lock
from repro_torch.core.device import CAPTURE_LOCK
from repro_torch.core.interface import next_pow2, pad_to_bucket
from repro_torch.kernels import launches
from repro_torch.uq.mcmc import EnsembleResult

#: memo of step closures and of the blocks (captured graphs with their
#: static buffers) built from them: the public runners are called
#: repeatedly in campaigns and benchmarks, and a fresh closure per call
#: would capture the whole S-step graph again every time. Keyed on the
#: sampler config (logpost_fn IDENTITY included — a new target is a new
#: program); LRU-bounded so sweeping many configs cannot leak graphs.
_BLOCK_MEMO: OrderedDict = OrderedDict()
_BLOCK_MEMO_MAX = 32
_memo_lock = named_lock("fused._BLOCK_MEMO")


def _memo(key, build):
    with _memo_lock:
        got = _BLOCK_MEMO.get(key)
        if got is not None:
            _BLOCK_MEMO.move_to_end(key)
            return got
    got = build()  # outside the lock: a build may capture a graph
    with _memo_lock:
        got = _BLOCK_MEMO.setdefault(key, got)
        _BLOCK_MEMO.move_to_end(key)
        while len(_BLOCK_MEMO) > _BLOCK_MEMO_MAX:
            _BLOCK_MEMO.popitem(last=False)
    return got


def _f() -> torch.dtype:
    """Carry dtype: torch's default dtype (float32 unless the caller set
    float64), the counterpart of `jnp.result_type(float)`."""
    return torch.get_default_dtype()


def _per_device(*arrays) -> Callable:
    """`on(device)` -> the arrays as tensors of the current carry dtype on
    `device`, copied there once per device. The first call on a device is
    eager (a block runs its body eagerly before it captures it), so a
    captured body finds them in place and copies nothing from the host."""
    dt = _f()
    cache: dict = {}

    def on(device: torch.device) -> tuple:
        got = cache.get(device)
        if got is None:
            got = cache[device] = tuple(
                torch.as_tensor(np.asarray(a, float), dtype=dt, device=device)
                for a in arrays
            )
        return got

    return on


# ---------------------------------------------------------------------------
# Target builders (tensor programs, no host sync)
# ---------------------------------------------------------------------------


def gaussian_target(mean, cov=None) -> Callable:
    """``[K, d] -> [K]`` log-density of N(mean, cov) (cov=None: I). The
    analytic target used by the exactness tests and the dispatch-cost
    benchmark — evaluation is a handful of FLOPs, so steps/s measures the
    sampler loop itself."""
    on = _per_device(mean) if cov is None else _per_device(
        mean, np.linalg.inv(np.atleast_2d(cov)))

    def logpost(xs: torch.Tensor) -> torch.Tensor:
        consts = on(xs.device)
        r = xs - consts[0]
        if cov is None:
            return -0.5 * torch.sum(r * r, dim=-1)
        return -0.5 * torch.einsum("ki,ij,kj->k", r, consts[1], r)

    return logpost


def gaussian_likelihood_target(
    forward_fn: Callable, data, noise_sd, prior_bounds=None
) -> Callable:
    """Log-posterior from a batch forward model: Gaussian likelihood on the
    observables plus an optional uniform box prior (out-of-box rows get
    -inf BEFORE the accept step, mirroring the host `batched_logpost` prior
    mask). `forward_fn` must be a lockstep ``[K, d] -> [K, m]`` tensor
    program (e.g. `apps.tsunami.solve_batch` under `functools.partial`) —
    per-row independence is also what lets the MALA block take per-chain
    gradients with one backward pass (block-diagonal Jacobian)."""
    dt = _f()
    if prior_bounds is None:
        on = _per_device(data, noise_sd)
    else:
        on = _per_device(data, noise_sd, [b[0] for b in prior_bounds],
                         [b[1] for b in prior_bounds])

    def logpost(xs: torch.Tensor) -> torch.Tensor:
        consts = on(xs.device)
        ys = forward_fn(xs).to(dt)
        ll = -0.5 * torch.sum(((ys - consts[0]) / consts[1]) ** 2, dim=-1)
        if prior_bounds is None:
            return ll
        inbox = torch.all((xs >= consts[2]) & (xs <= consts[3]), dim=-1)
        return torch.where(inbox, ll, -torch.inf)

    return logpost


def _value_and_grad_rows(logpost_fn: Callable) -> Callable:
    """(lps [K], dlps/dx [K, d]) in one backward pass: the log-posterior
    rows depend only on their own chain's row (lockstep batch =>
    block-diagonal Jacobian), so the gradient of their sum IS the per-row
    gradient. The tsunami's `solve_batch` is differentiated through the SWE
    solve's autograd rule (`kernels.swe.SweSolve`: on the card one launch
    of the solve and one of its adjoint a step, both held in a block's
    graph). A target that autograd cannot differentiate raises."""

    def value_grad(xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            xs = xs.detach().requires_grad_(True)
            lps = logpost_fn(xs)
            if not lps.requires_grad:
                raise NotImplementedError(
                    "fused MALA needs a log-posterior that torch autograd "
                    "differentiates; this one gives no gradient in its "
                    "parameters (it computes outside autograd, or from tensors "
                    "that do not depend on them)"
                )
            (grads,) = torch.autograd.grad(lps.sum(), xs)
        return lps.detach(), grads

    return value_grad


# ---------------------------------------------------------------------------
# Step bodies: (carry, generator) -> (carry, (xs, lps)), no host sync
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Lanes:
    """The chains of a run: `Kp` lanes, the first `K` real and the rest
    padding, and this rank's contiguous rows `lo:hi` of them. Random
    arrays are drawn for all `Kp` lanes and cut to the rank's rows, so a
    rank's stream position is the same whatever the mesh."""

    K: int
    Kp: int
    lo: int
    hi: int

    @classmethod
    def whole(cls, K: int) -> "_Lanes":
        return cls(K, K, 0, K)

    def mine(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a [Kp, ...] array."""
        return x if (self.lo, self.hi) == (0, self.Kp) else x[self.lo:self.hi]

    def active(self, device) -> torch.Tensor | None:
        """Which of the rank's rows are real chains (None: all of them),
        made eagerly, so that a captured body finds it on the device."""
        if self.K == self.Kp:
            return None
        return torch.arange(self.lo, self.hi, device=device) < self.K


def _normal(gen: torch.Generator, like: torch.Tensor, lanes: _Lanes) -> torch.Tensor:
    """Standard normals for all Kp lanes of `like`'s [K, ...] rows."""
    return torch.randn((lanes.Kp, *like.shape[1:]), generator=gen, dtype=like.dtype,
                       device=like.device)


def _log_uniform(gen: torch.Generator, like: torch.Tensor, lanes: _Lanes) -> torch.Tensor:
    return torch.log(torch.rand((lanes.Kp, *like.shape[1:]), generator=gen,
                                dtype=like.dtype, device=like.device))


def _accept(log_alpha: torch.Tensor, gen: torch.Generator, lanes: _Lanes,
            active: torch.Tensor | None) -> torch.Tensor:
    """Metropolis test: a NaN ratio rejects (-inf), a padding lane always."""
    log_alpha = torch.where(torch.isnan(log_alpha), -torch.inf, log_alpha)
    accept = lanes.mine(_log_uniform(gen, log_alpha, lanes)) < log_alpha
    return accept if active is None else accept & active


def _rwm_step(logpost_fn, L, device, lanes: _Lanes):
    (Lt,) = _per_device(np.asarray(L, float).T)(device)
    active = lanes.active(device)

    def step(carry, gen):
        xs, lps = carry["xs"], carry["lps"]
        props = xs + lanes.mine(_normal(gen, xs, lanes) @ Lt)
        lp_props = logpost_fn(props)
        accept = _accept(lp_props - lps, gen, lanes, active)
        xs = torch.where(accept[:, None], props, xs)
        lps = torch.where(accept, lp_props, lps)
        out = {"xs": xs, "lps": lps, "acc": carry["acc"] + accept.to(lps.dtype)}
        return out, (xs, lps)

    return step


def _pcn_step(loglik_fn, prior_chol, beta, device, lanes: _Lanes):
    (L0t,) = _per_device(np.asarray(prior_chol, float).T)(device)
    beta = float(beta)
    root = float(np.sqrt(1.0 - beta**2))
    active = lanes.active(device)

    def step(carry, gen):
        xs, lls = carry["xs"], carry["lps"]
        props = root * xs + beta * lanes.mine(_normal(gen, xs, lanes) @ L0t)
        ll_props = loglik_fn(props)
        accept = _accept(ll_props - lls, gen, lanes, active)
        xs = torch.where(accept[:, None], props, xs)
        lls = torch.where(accept, ll_props, lls)
        out = {"xs": xs, "lps": lls, "acc": carry["acc"] + accept.to(lls.dtype)}
        return out, (xs, lls)

    return step


def _mala_step(logpost_fn, C, L, Cinv, adapt_steps, target_accept, device, lanes: _Lanes,
               ctx=None):
    """`ctx`: the mesh whose batch ranks hold the other chains, whose
    acceptances the step-size adaptation pools (a host gather a step)."""
    value_grad = _value_and_grad_rows(logpost_fn)
    Ct, Lt, Cinv = _per_device(np.asarray(C, float).T, np.asarray(L, float).T,
                               Cinv)(device)
    active = lanes.active(device)

    def _logq(diff_minus_drift, eps):
        return -0.5 / eps**2 * torch.einsum(
            "ki,ij,kj->k", diff_minus_drift, Cinv, diff_minus_drift
        )

    def step(carry, gen):
        xs, lps, gs, eps, i = (carry[k] for k in ("xs", "lps", "gs", "eps", "i"))
        drift = 0.5 * eps**2 * gs @ Ct
        props = xs + drift + lanes.mine(eps * _normal(gen, xs, lanes) @ Lt)
        lp_props, g_props = value_grad(props)
        drift_rev = 0.5 * eps**2 * g_props @ Ct
        log_q_fwd = _logq(props - xs - drift, eps)
        log_q_rev = _logq(xs - props - drift_rev, eps)
        accept = _accept((lp_props - lps) + (log_q_rev - log_q_fwd), gen, lanes, active)
        xs = torch.where(accept[:, None], props, xs)
        lps = torch.where(accept, lp_props, lps)
        gs = torch.where(accept[:, None], g_props, gs)
        # Robbins-Monro on eps, acceptance pooled over the K real chains
        # (padding lanes always reject and would bias the rate down)
        accepted = accept.to(lps.dtype).sum()
        if ctx is not None:
            counts = ctx.gather_rows(accepted.reshape(1).cpu().numpy())
            accepted = torch.as_tensor(counts.sum(), dtype=lps.dtype, device=lps.device)
        pooled = accepted / lanes.K
        eps = torch.where(
            i < adapt_steps,
            eps * torch.exp((i + 1.0) ** -0.6 * (pooled - target_accept)),
            eps,
        )
        out = {"xs": xs, "lps": lps, "gs": gs,
               "acc": carry["acc"] + accept.to(lps.dtype), "eps": eps, "i": i + 1}
        return out, (xs, lps)

    return step


# ---------------------------------------------------------------------------
# Block: S steps, one CUDA graph on the card
# ---------------------------------------------------------------------------


class _Block:
    """S steps of `step` from a carry of tensors, as one unit of work.

    `load(carry, gen)` sets the start state and the generator to draw from;
    `run()` advances S steps and returns the block's samples and
    log-densities as one host array [S, K, d + 1] (`run(pull=False)`
    returns nothing); `carry()` is the current state (tensors), `key()` the
    generator holding the current stream position, and `finish()` hands
    that position back to the generator `load` was given.

    On the card the body is warmed up once on a side stream, then captured
    as ONE CUDA graph on that stream with the block's own generator
    registered in it; `load` copies the start state into the graph's static
    inputs and the caller's generator state into the graph's generator, and
    each `run` is one replay plus one device→host copy. The graph writes
    its final state back into its inputs, so replays chain. On the CPU, and
    with `capture=False` (a step that gathers across ranks: no collective
    enters a captured body), the body runs eagerly on the caller's
    generator."""

    def __init__(self, step, carry: dict, S: int, capture: bool = True):
        self.step, self.S = step, S
        self.device = carry["xs"].device
        self.lock = threading.Lock()  # one run at a time on the static buffers
        self.graph = None
        if self.device.type == "cuda" and capture:
            self._capture(carry)

    def _body(self, carry: dict, gen) -> tuple[dict, torch.Tensor]:
        outs = []
        for _ in range(self.S):
            carry, (xs, lps) = self.step(carry, gen)
            outs.append(torch.cat([xs, lps[:, None]], dim=1))
        return carry, torch.stack(outs)

    def _capture(self, carry: dict) -> None:
        self.gen = torch.Generator(device=self.device)
        self.static = {k: v.clone() for k, v in carry.items()}

        def body():
            out_carry, out = self._body(dict(self.static), self.gen)
            for k, v in out_carry.items():
                self.static[k].copy_(v)
            return out

        graph = torch.cuda.CUDAGraph()
        # a generator other than the default one is tied into the capture
        # only when registered: its Philox seed and offset are then read
        # from the device at each replay, and each replay advances the
        # offset by what the graph draws
        graph.register_generator_state(self.gen)
        # one capture at a time in the process (`CAPTURE_LOCK`)
        with CAPTURE_LOCK:
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                body()  # warm-up: lazy state (cuBLAS, autograd, the kernels' libraries)
            torch.cuda.current_stream(self.device).wait_stream(side)
            with launches.capturing() as held:
                # captured on the block's own stream, and only this thread's
                # unsafe calls (a malloc, a synchronous copy) break the
                # capture: the fabric runs waves of the same model from
                # other threads
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    self.out = body()
        self.graph, self.held = graph, held

    def load(self, carry: dict, gen: torch.Generator) -> None:
        if gen.device.type != self.device.type:
            raise ValueError(f"the generator is on {gen.device}, the chains on {self.device}")
        self.caller = gen
        if self.graph is None:
            self.state, self.out = dict(carry), None
            return
        for k, v in carry.items():
            self.static[k].copy_(v)
        self.gen.set_state(gen.get_state())

    def run(self, pull: bool = True) -> np.ndarray | None:
        if self.graph is None:
            self.state, out = self._body(self.state, self.caller)
        else:
            self.graph.replay()
            launches.replayed(self.held)
            out = self.out
        return out.cpu().numpy() if pull else None  # the block's one host pull

    def carry(self) -> dict:
        return self.state if self.graph is None else self.static

    def key(self) -> torch.Generator:
        return self.caller if self.graph is None else self.gen

    def finish(self) -> dict:
        """Hand the stream position back to the caller's generator; -> the
        final carry (copies, the static buffers stay the block's)."""
        if self.graph is None:
            return self.state
        self.caller.set_state(self.gen.get_state())
        return {k: v.clone() for k, v in self.static.items()}


def _run_fused(
    step_fn,
    carry: dict,
    key: torch.Generator,
    *,
    lanes: _Lanes,
    n_steps: int,
    fused_steps: int,
    per_step: bool = False,
    ctx=None,
    telemetry=None,
    checkpoint=None,
    checkpoint_every: int = 0,
    scalar_keys: tuple = (),
    capture: bool = True,
):
    """Drive `n_steps` of `step_fn` in blocks of `fused_steps` (`capture`:
    as `_Block`'s).

    Returns (samples [Kp, n, d], lps_out [Kp, n] as host numpy, final carry
    of this rank's rows, n_blocks); `key` ends where the stream ends.
    ``per_step=True`` runs the SAME body with S=1 once per step with a host
    round trip in between — the per-step reference both the benchmark and
    the S=1 bit-exactness test compare against. Checkpoints land at block
    boundaries (effective interval: `checkpoint_every` rounded down to a
    block multiple) with the generator state, so resume replays the
    identical stream; on a mesh rank 0 writes them, every chain's rows
    gathered."""
    S = 1 if per_step else int(fused_steps)
    if S < 1:
        raise ValueError(f"fused_steps must be >= 1, got {S}")
    if n_steps % S:
        raise ValueError(f"n_steps={n_steps} not a multiple of fused_steps={S}")
    n_blocks = n_steps // S
    K, d = carry["xs"].shape
    Kp = lanes.Kp
    device = carry["xs"].device

    def gathered(rows: np.ndarray) -> np.ndarray:
        return rows if ctx is None else ctx.gather_rows(rows)

    samples = np.empty((Kp, n_steps, d))
    lps_out = np.empty((Kp, n_steps))
    start_block = 0
    gen = key
    resumed = checkpoint.resume() if checkpoint is not None else None
    if resumed is not None:
        from repro_torch.core.fleet import CampaignCheckpoint

        arrays, meta, _step = resumed
        done = int(meta["steps_done"])
        start_block = done // S
        if meta["key_device"] != device.type:
            raise ValueError(f"the checkpoint's generator was on {meta['key_device']}, "
                             f"this run's chains are on {device}")
        if len(arrays["samples"]) != Kp:
            raise ValueError(f"the checkpoint holds {len(arrays['samples'])} chains, this "
                             f"run pads to {Kp}")
        gen = CampaignCheckpoint.unpack_key(arrays["rng_key"], device)
        carry = {k: torch.as_tensor(arrays[k][lanes.lo:lanes.hi] if v.ndim else arrays[k])
                 .to(device=device, dtype=v.dtype) for k, v in carry.items()}
        samples[:, :done] = arrays["samples"]
        lps_out[:, :done] = arrays["lps_out"]

    # memoized on the (already memoized) step closure: a repeat call with
    # the same sampler config reuses the captured S-step graph
    block = _memo(("block", step_fn, S, K, device), lambda: _Block(step_fn, carry, S, capture))
    every_blocks = max(1, checkpoint_every // S) if checkpoint_every else 0
    writes = ctx is None or not dist.is_initialized() or dist.get_rank() == 0
    with block.lock:
        block.load(carry, gen)
        for b in range(start_block, n_blocks):
            out = gathered(np.moveaxis(block.run(), 0, 1))  # [Kp, S, d + 1]
            lo = b * S
            samples[:, lo:lo + S] = out[:, :, :d]
            lps_out[:, lo:lo + S] = out[:, :, d]
            if telemetry is not None:
                telemetry.note_steps(S, waves=1)
                # service-tier campaigns meter device-resident work through
                # this optional hook (budget charge + per-tenant fused-step
                # telemetry; it does NOT re-count steps — note_steps did)
                nb = getattr(telemetry, "note_fused_block", None)
                if nb is not None:
                    nb(len(samples), S)
            if checkpoint is not None and every_blocks and (b + 1) % every_blocks == 0:
                from repro_torch.core.fleet import CampaignCheckpoint

                done = (b + 1) * S
                now = block.carry()
                # every rank takes part in the gathers; rank 0 writes
                arrays = {k: gathered(v.cpu().numpy()) if v.ndim else v.cpu().numpy()
                          for k, v in now.items()}
                if writes:
                    arrays["rng_key"] = CampaignCheckpoint.pack_key(block.key())
                    arrays["samples"] = samples[:, :done].copy()
                    arrays["lps_out"] = lps_out[:, :done].copy()
                    checkpoint.save(done, arrays, {
                        "steps_done": done, "fused_steps": S,
                        "key_device": device.type,
                        **{k: float(now[k]) for k in scalar_keys},
                    })
        carry = block.finish()
    if gen is not key:
        key.set_state(gen.get_state())
    return samples, lps_out, carry, n_blocks


def _init_carry(x0s, key: torch.Generator, ctx) -> tuple[torch.Tensor, _Lanes]:
    """(this rank's start states on the generator's device, in the carry
    dtype; the run's lanes). On a mesh the K starts are padded to
    `max(next_pow2(K), n_data)`, rounded up to an `n_data` multiple, the
    last start repeated (the JAX package's `_pad_chains`), and split over
    the batch axes."""
    x0s = np.atleast_2d(np.asarray(x0s, float))
    K = len(x0s)
    lanes = _Lanes.whole(K)
    if ctx is not None:
        Kp = max(next_pow2(K), ctx.n_data)
        x0s, _ = pad_to_bucket(x0s, Kp + (-Kp) % ctx.n_data)
        rows = ctx.rows(len(x0s))
        lanes = _Lanes(K, len(x0s), rows.start, rows.stop)
        x0s = x0s[rows]
    return torch.as_tensor(x0s, dtype=_f(), device=key.device), lanes


def _result(samples, lps_out, carry, n_blocks, lanes: _Lanes, ctx, n_steps: int, **kw):
    """The runners' EnsembleResult: the K real chains of the gathered run."""
    acc = carry["acc"].cpu().numpy()
    if ctx is not None:
        acc = ctx.gather_rows(acc)
    K = lanes.K
    return EnsembleResult(samples[:K], lps_out[:K], acc[:K] / n_steps, K * (n_steps + 1),
                          n_blocks + 1, **kw)


# ---------------------------------------------------------------------------
# Fused runners (EnsembleResult-compatible)
# ---------------------------------------------------------------------------


def fused_ensemble_rwm(
    logpost_fn: Callable,
    x0s: np.ndarray,
    n_steps: int,
    prop_cov: np.ndarray,
    key: torch.Generator,
    *,
    fused_steps: int,
    per_step: bool = False,
    ctx=None,
    telemetry=None,
    checkpoint=None,
    checkpoint_every: int = 0,
) -> EnsembleResult:
    """K lockstep RWM chains, S steps per device dispatch, on `key`'s
    device; `key` advances by what the run draws, as a numpy Generator
    does. `ctx`: split the chains over a mesh's batch axes."""
    xs, lanes = _init_carry(x0s, key, ctx)
    L = np.linalg.cholesky(np.atleast_2d(prop_cov))
    step = _memo(("rwm", logpost_fn, L.tobytes(), lanes, xs.device, xs.dtype),
                 lambda: _rwm_step(logpost_fn, L, xs.device, lanes))
    carry = {"xs": xs, "lps": logpost_fn(xs), "acc": torch.zeros_like(xs[:, 0])}
    samples, lps_out, carry, n_blocks = _run_fused(
        step, carry, key, lanes=lanes, n_steps=n_steps, fused_steps=fused_steps,
        per_step=per_step, ctx=ctx, telemetry=telemetry,
        checkpoint=checkpoint, checkpoint_every=checkpoint_every,
    )
    return _result(samples, lps_out, carry, n_blocks, lanes, ctx, n_steps)


def fused_ensemble_pcn(
    loglik_fn: Callable,
    x0s: np.ndarray,
    n_steps: int,
    beta: float,
    key: torch.Generator,
    *,
    prior_chol: np.ndarray | None = None,
    fused_steps: int,
    per_step: bool = False,
    ctx=None,
    telemetry=None,
    checkpoint=None,
    checkpoint_every: int = 0,
) -> EnsembleResult:
    """K lockstep pCN chains (centered Gaussian prior with Cholesky factor
    `prior_chol`, default I), S steps per device dispatch."""
    xs, lanes = _init_carry(x0s, key, ctx)
    d = xs.shape[1]
    L0 = np.eye(d) if prior_chol is None else np.atleast_2d(prior_chol)
    step = _memo(("pcn", loglik_fn, L0.tobytes(), float(beta), lanes, xs.device, xs.dtype),
                 lambda: _pcn_step(loglik_fn, L0, beta, xs.device, lanes))
    carry = {"xs": xs, "lps": loglik_fn(xs), "acc": torch.zeros_like(xs[:, 0])}
    samples, lps_out, carry, n_blocks = _run_fused(
        step, carry, key, lanes=lanes, n_steps=n_steps, fused_steps=fused_steps,
        per_step=per_step, ctx=ctx, telemetry=telemetry,
        checkpoint=checkpoint, checkpoint_every=checkpoint_every,
    )
    return _result(samples, lps_out, carry, n_blocks, lanes, ctx, n_steps)


def fused_ensemble_mala(
    logpost_fn: Callable,
    x0s: np.ndarray,
    n_steps: int,
    step_size: float,
    key: torch.Generator,
    *,
    precond: np.ndarray | None = None,
    adapt_steps: int = 0,
    target_accept: float = 0.574,
    fused_steps: int,
    per_step: bool = False,
    ctx=None,
    telemetry=None,
    checkpoint=None,
    checkpoint_every: int = 0,
) -> EnsembleResult:
    """K lockstep MALA chains, S steps per device dispatch: drift gradients
    come from ONE backward pass of the log-posterior per step (block-
    diagonal Jacobian, see `_value_and_grad_rows`; the target must be one
    autograd differentiates), and Robbins-Monro step-size adaptation runs
    inside the block on the acceptance rate pooled over the K chains (on a
    mesh of several batch ranks a host gather a step, the block eager: see
    the module docstring)."""
    xs, lanes = _init_carry(x0s, key, ctx)
    pool_ctx = ctx if ctx is not None and ctx.n_data > 1 and adapt_steps > 0 else None
    d = xs.shape[1]
    C = np.eye(d) if precond is None else np.atleast_2d(np.asarray(precond, float))
    L = np.linalg.cholesky(C)
    Cinv = np.linalg.inv(C)
    step = _memo(
        ("mala", logpost_fn, C.tobytes(), int(adapt_steps),
         float(target_accept), lanes, pool_ctx, xs.device, xs.dtype),
        lambda: _mala_step(logpost_fn, C, L, Cinv, int(adapt_steps),
                           float(target_accept), xs.device, lanes, pool_ctx))
    lps0, gs0 = _value_and_grad_rows(logpost_fn)(xs)
    carry = {
        "xs": xs, "lps": lps0, "gs": gs0, "acc": torch.zeros_like(xs[:, 0]),
        "eps": torch.tensor(float(step_size), dtype=xs.dtype, device=xs.device),
        "i": torch.tensor(0, dtype=torch.int32, device=xs.device),
    }
    samples, lps_out, carry, n_blocks = _run_fused(
        step, carry, key, lanes=lanes, n_steps=n_steps, fused_steps=fused_steps,
        per_step=per_step, ctx=ctx, telemetry=telemetry,
        checkpoint=checkpoint, checkpoint_every=checkpoint_every,
        scalar_keys=("eps",), capture=pool_ctx is None,
    )
    return _result(samples, lps_out, carry, n_blocks, lanes, ctx, n_steps,
                   n_grad_waves=n_blocks + 1, final_step_size=float(carry["eps"]))


def make_fused_rwm_subchain(
    logpost_fn: Callable, n_sub: int, prop_chol: np.ndarray
) -> Callable:
    """Fused RWM subchain for MLDA coarse levels.

    Returns ``run(xs, key) -> (ys, lp_ys, lp_start, acc_counts, key)``:
    all K chains advance `n_sub` coarse steps in ONE device dispatch (one
    graph replay on the card, plus one wave for the start log-densities)
    and come back with exactly the quantities the delayed-acceptance ratio
    needs, in one host pull. No sample collection, no host traffic inside
    the subchain, and BOTH lp_start and lp_ys come from the same
    `logpost_fn`, so the DA correction stays exact. The block is built (on
    the card: captured) once per (K, device) here, not per subchain call;
    `key` advances and is returned."""
    blocks: dict = {}

    def run(xs, key: torch.Generator):
        xs, lanes = _init_carry(xs, key, None)
        lps = logpost_fn(xs)
        carry = {"xs": xs, "lps": lps, "acc": torch.zeros_like(lps)}
        where = (len(xs), xs.device)
        block = blocks.get(where)
        if block is None:
            step = _rwm_step(logpost_fn, prop_chol, xs.device, lanes)
            block = blocks[where] = _Block(step, carry, int(n_sub))
        with block.lock:
            block.load(carry, key)
            block.run(pull=False)  # no samples: the final carry is the result
            out = block.finish()
        packed = torch.stack([*out["xs"].T, out["lps"], lps, out["acc"]], 1)
        packed = packed.cpu().numpy().astype(float)  # the one host pull
        d = xs.shape[1]
        return (packed[:, :d], packed[:, d], packed[:, d + 1],
                packed[:, d + 2], key)

    return run
