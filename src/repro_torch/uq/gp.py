"""Gaussian-process emulation: the paper's offline coarsest-level GP (§4.3)
plus an ONLINE sliding-window variant that the surrogate-accelerated DA
screen trains from evaluation-fabric traffic.

`GP` — exact GP with constant mean, Matérn-5/2 ARD covariance, (near-)
noise-free Gaussian likelihood; hyperparameters by Type-II maximum
likelihood (Adam on the log-marginal-likelihood via torch autograd —
matching the paper's setup of 'constant mean, Matérn-5/2 ARD, noise-free
likelihood, Type-II MLE').

`OnlineGP` — the same model refit incrementally on a sliding window of
streamed (theta, y) pairs: refits re-factorize the window from scratch
(Cholesky-DOWNDATE-FREE — at screen-sized windows a fresh O(n^3)
factorization is cheaper and unconditionally stable, where rank-1 downdates
lose positive-definiteness to round-off), and the expensive Type-II MLE
hyperparameter search re-runs only on a predictive-error STALENESS trigger.
`uq.surrogate.SurrogateStore` is the fabric tap that feeds it.

Devices: the Adam loop and every Matérn matrix run in float32 on the GP's
device (`device=None` is the GPU; pass `device="cpu"` for the CPU). The
float64 factorization of the training set and the solves against it stay
numpy on the host, so a prediction moves one [Q, n] block off the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis.races import named_rlock
from repro_torch.core.device import resolve_device

#: predictive-variance floor relative to the kernel amplitude — the Schur
#: complement amp - v^T v is computed by subtraction, so near-degenerate
#: training sets return small NEGATIVE variances through round-off, and a
#: screen that takes log/sqrt/1-over of the variance NaNs on them
_VAR_REL_FLOOR = 1e-9


def _matern52(X1, X2, lengthscales, amp):
    d = (X1[:, None, :] - X2[None, :, :]) / lengthscales
    r2 = torch.sum(d * d, dim=-1)
    r = torch.sqrt(r2 + 1e-12)
    s5r = math.sqrt(5.0) * r
    return amp * (1.0 + s5r + 5.0 * r2 / 3.0) * torch.exp(-s5r)


def _nlml(log_params, X, y):
    n, d = X.shape
    ls = torch.exp(log_params[:d])
    amp = torch.exp(log_params[d])
    noise = torch.exp(log_params[d + 1])
    mean = log_params[d + 2]
    # jitter scales with amp: keeps K PD in fp32 even when a lengthscale
    # grows unbounded (irrelevant input dim -> K tends to rank-1)
    K = _matern52(X, X, ls, amp) + (noise + 1e-5 * amp + 1e-8) * torch.eye(
        n, dtype=X.dtype, device=X.device
    )
    # a K that is not positive definite makes L all NaN, as JAX's Cholesky
    # does, so value and gradient are NaN and `GP.fit` stops on its guard;
    # `cholesky_ex` reports the failure in `info` without raising or syncing
    L, info = torch.linalg.cholesky_ex(K)
    L = L * torch.where(info == 0, 1.0, torch.nan)
    r = y - mean
    alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
    return (
        0.5 * r @ alpha
        + torch.sum(torch.log(torch.diagonal(L)))
        + 0.5 * n * math.log(2 * math.pi)
    )


def _nlml_grad(log_params, X, y):
    p = log_params.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(_nlml(p, X, y), p)
    return g


def _chol64(K: np.ndarray) -> np.ndarray:
    """float64 Cholesky with escalating jitter: online sliding windows can
    be near-duplicate-degenerate, and a failed factorization must not kill
    the sampler the GP screens for."""
    scale = float(np.mean(np.diag(K))) or 1.0
    jit = 0.0
    for _ in range(4):
        try:
            return np.linalg.cholesky(K + jit * np.eye(len(K)))
        except np.linalg.LinAlgError:
            jit = max(jit * 100.0, 1e-8 * scale)
    raise np.linalg.LinAlgError("kernel matrix not PD even with jitter")


@dataclass
class GP:
    X: np.ndarray
    y: np.ndarray
    log_params: np.ndarray  # [d lengthscales, amp, noise, mean]
    _chol: np.ndarray
    _alpha: np.ndarray
    device: torch.device
    #: Adam steps `fit` took: n_iters, or fewer where the non-finite guard
    #: stopped it (each step ends in one host sync, the guard's)
    fit_steps: int = 0

    @classmethod
    def fit(
        cls,
        X: np.ndarray,
        y: np.ndarray,
        n_iters: int = 400,
        lr: float = 0.05,
        noise_floor: float = 1e-6,
        seed: int = 0,
        device=None,
    ) -> "GP":
        device = resolve_device(device)
        X = np.atleast_2d(np.asarray(X, np.float32))
        yn = np.asarray(y, np.float32).ravel()
        y_mu, y_sd = float(yn.mean()), float(yn.std() + 1e-12)
        Xt = torch.as_tensor(X, device=device)
        ys = torch.as_tensor((yn - y_mu) / y_sd, device=device)
        span = torch.as_tensor(np.ptp(X, axis=0) + 1e-6, device=device)

        def const(*vals):
            return torch.tensor(vals, dtype=torch.float32, device=device)

        p0 = torch.cat([torch.log(span / 3.0), const(0.0, np.log(noise_floor), 0.0)])
        # Adam with box constraints + non-finite-step guard
        lo = torch.cat([torch.log(span) - 6.0, const(-6.0, np.log(1e-8), -3.0)])
        hi = torch.cat([torch.log(span) + 4.0, const(4.0, np.log(1e-2), 3.0)])
        p = p0
        m = torch.zeros_like(p)
        v = torch.zeros_like(p)
        steps = 0
        for i in range(n_iters):
            g = _nlml_grad(p, Xt, ys)
            if not bool(torch.isfinite(g).all()):
                break  # keep the last finite iterate
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1 - 0.9 ** (i + 1))
            vh = v / (1 - 0.999 ** (i + 1))
            p = torch.clamp(p - lr * mh / (torch.sqrt(vh) + 1e-8), lo, hi)
            steps += 1
        gp = cls.from_params(X, yn, p.cpu().numpy(), device=device)
        gp.fit_steps = steps
        return gp

    @classmethod
    def from_params(cls, X: np.ndarray, y: np.ndarray, log_params, device=None) -> "GP":
        """Factorize a training set under FIXED hyperparameters — the
        online sliding-window refit path: no Adam loop, ONE Cholesky (and
        no rank-1 downdates when the window slides — re-factorizing is
        unconditionally stable and cheaper at screen-sized windows)."""
        device = resolve_device(device)
        X = np.atleast_2d(np.asarray(X, np.float32))
        yn = np.asarray(y, np.float32).ravel()
        y_mu, y_sd = float(yn.mean()), float(yn.std() + 1e-12)
        ys = (yn - y_mu) / y_sd
        d = X.shape[1]
        p = np.asarray(log_params, float)
        ls, amp, noise = np.exp(p[:d]), float(np.exp(p[d])), float(np.exp(p[d + 1]))
        Xt = torch.as_tensor(X, device=device)
        ls_t = torch.as_tensor(ls, dtype=torch.float32, device=device)
        K = _matern52(Xt, Xt, ls_t, amp).cpu().numpy().astype(np.float64) + (
            noise + 1e-5 * amp + 1e-8
        ) * np.eye(len(X))
        L = _chol64(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, np.asarray(ys - p[d + 2], np.float64)))
        gp = cls(X, yn, p, L, alpha, device)
        gp._ymu, gp._ysd = y_mu, y_sd
        gp._Xt, gp._ls_t = Xt, ls_t  # the training set stays on the device
        return gp

    def predict(self, Xq: np.ndarray, return_var: bool = False):
        """Posterior mean (and variance) at Xq [Q, d] — one batched
        linear-algebra call for the whole query block, zero model waves.

        The predictive variance is clamped at a strictly positive floor
        (relative to the kernel amplitude): round-off in the Schur
        complement can return slightly negative values on near-degenerate
        training sets, and anything downstream that takes log/sqrt/1-over
        of the variance must stay finite."""
        Xq = np.atleast_2d(np.asarray(Xq, np.float32))
        d = self.X.shape[1]
        amp = np.exp(self.log_params[d])
        mean_c = self.log_params[d + 2]
        Ks = _matern52(
            torch.as_tensor(Xq, device=self.device), self._Xt, self._ls_t, float(amp)
        ).cpu().numpy()
        mu = mean_c + Ks @ self._alpha
        mu = self._ymu + self._ysd * mu
        if not return_var:
            return mu
        v = np.linalg.solve(self._chol, Ks.T)
        var = amp - np.sum(v * v, axis=0)
        var = np.maximum(var, _VAR_REL_FLOOR * float(amp) + 1e-300)
        return mu, var * self._ysd**2


class OnlineGP:
    """Batch-native GP trained ONLINE from streamed (theta, y) pairs — the
    level-(-1) surrogate behind `ensemble_mlda(surrogate=...)`.

    Three disciplines keep it cheap enough to sit inside a sampler loop:

      * **sliding window** — the newest `window` observations form the
        training set; `add()` only appends and marks the fit dirty.
      * **incremental, downdate-free refits** — the Cholesky factorization
        refreshes lazily at the next `predict_batch`, and at most once per
        `refit_every` absorbed points, by re-factorizing the window under
        the CURRENT hyperparameters (`GP.from_params`): a training burst
        costs one O(n^3) factorization, not one per wave, and no rank-1
        downdate ever risks losing positive-definiteness.
      * **staleness-triggered hyperparameter refits** — each incoming batch
        is first SCORED against the current fit; when the EWMA of the
        standardized predictive error |y - mu|/sd exceeds `stale_z`, the
        next refit re-runs the full Type-II MLE search (`GP.fit`) instead
        of reusing hyperparameters (a drifting target, or a window that
        outgrew its lengthscales, trips it).

    `predict_batch` serves the whole [Q, d] query block as ONE batched
    linear-algebra call with a strictly positive variance guarantee (see
    `GP.predict`), and `freeze()` stops ingestion/refitting for strict
    time-homogeneity once a DA screen must provably stop adapting.
    Thread-safe: the fabric training tap feeds `add` from collector
    threads while the sampler calls `predict_batch`. Fits and predictions
    run on `device` (default: the GPU; raises if there is none).
    """

    def __init__(
        self,
        window: int = 256,
        min_train: int = 16,
        refit_every: int = 32,
        hyper_iters: int = 150,
        stale_z: float = 3.0,
        ewma_alpha: float = 0.2,
        seed: int = 0,
        device=None,
    ):
        self.window = int(window)
        self.min_train = max(2, int(min_train))
        self.refit_every = max(1, int(refit_every))
        self.hyper_iters = int(hyper_iters)
        self.stale_z = float(stale_z)
        self.ewma_alpha = float(ewma_alpha)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.frozen = False
        self._X: np.ndarray | None = None  # [n, d] sliding window
        self._y: np.ndarray | None = None
        self._gp: GP | None = None
        self._since_refit = 0  # points absorbed since the last factorization
        self._hyper_stale = True  # first fit IS the hyperparameter search
        self.err_ewma: float | None = None
        self.n_seen = 0
        self.n_hyper_fits = 0
        self.n_chol_refits = 0
        self._lock = named_rlock("online_gp")

    def __len__(self) -> int:
        return 0 if self._y is None else len(self._y)

    @property
    def ready(self) -> bool:
        """Whether `predict_batch` can serve (window >= min_train)."""
        with self._lock:
            return self._gp is not None or len(self) >= self.min_train

    def freeze(self) -> None:
        """Stop ingesting and (after at most one pending lazy refit)
        refitting — the fit becomes time-homogeneous, so a DA screen built
        on it is a fixed Markov kernel from here on."""
        with self._lock:
            self.frozen = True

    def add(self, X: np.ndarray, y: np.ndarray) -> None:
        """Absorb a streamed (theta [N, d], y [N]) block into the window.
        Non-finite targets are dropped (a diverged solve must not poison
        the emulator). No factorization happens here — refits are lazy and
        batched (see class docstring)."""
        X = np.atleast_2d(np.asarray(X, float))
        y = np.asarray(y, float).ravel()
        keep = np.isfinite(y) & np.all(np.isfinite(X), axis=1)
        if not keep.any():
            return
        X, y = X[keep], y[keep]
        with self._lock:
            gp = None if self.frozen else self._gp
        z = None
        if gp is not None:
            # staleness probe: score the incoming batch BEFORE absorbing —
            # against a snapshot, OUTSIDE the lock, so the kernel solves
            # never stall a concurrent predict_batch or another tap thread
            mu, var = gp.predict(X, return_var=True)
            z = float(np.mean(np.abs(y - mu) / np.sqrt(var)))
        with self._lock:
            if self.frozen:
                # re-checked under the lock: a wave in flight when
                # freeze() lands must not be absorbed after it
                return
            if z is not None:
                a = self.ewma_alpha
                self.err_ewma = (
                    z if self.err_ewma is None else (1 - a) * self.err_ewma + a * z
                )
                if self.err_ewma > self.stale_z:
                    self._hyper_stale = True
            if self._X is None:
                self._X, self._y = X.copy(), y.copy()
            else:
                self._X = np.concatenate([self._X, X])[-self.window:]
                self._y = np.concatenate([self._y, y])[-self.window:]
            self.n_seen += len(y)
            self._since_refit += len(y)

    def _current_fit(self) -> GP:
        """The up-to-date fit, refitting lazily first. The expensive part
        (Cholesky / Type-II MLE) runs OUTSIDE the lock so the fabric
        collector thread can keep streaming `add()` traffic meanwhile;
        concurrent predictors may duplicate a refit (last writer wins),
        which costs work but never correctness — in practice one sampler
        thread predicts."""
        with self._lock:
            if len(self) < self.min_train:
                raise RuntimeError(
                    f"OnlineGP not ready: window holds {len(self)} < "
                    f"min_train={self.min_train} points"
                )
            fresh = self._gp is not None and self._since_refit < self.refit_every
            if fresh and not self._hyper_stale:
                return self._gp
            X, y = self._X.copy(), self._y.copy()
            hyper = self._hyper_stale or self._gp is None
            params = None if hyper else self._gp.log_params
            absorbed = self._since_refit
        gp = (
            GP.fit(X, y, n_iters=self.hyper_iters, seed=self.seed, device=self.device)
            if params is None
            else GP.from_params(X, y, params, device=self.device)
        )
        with self._lock:
            self._gp = gp
            if params is None:
                self.n_hyper_fits += 1
                self._hyper_stale = False
                self.err_ewma = None  # fresh hyperparameters reset the probe
            else:
                self.n_chol_refits += 1
            # points streamed in DURING the fit stay pending for the next one
            self._since_refit = max(0, self._since_refit - absorbed)
        return gp

    def predict_batch(self, Xq: np.ndarray, return_var: bool = False):
        """[Q, d] -> mu [Q] (and var [Q], strictly positive) in ONE batched
        linear-algebra call — zero model waves. Lazily refits first."""
        return self._current_fit().predict(Xq, return_var=return_var)

    def stats(self) -> dict:
        with self._lock:
            return {
                "n": len(self),
                "window": self.window,
                "n_seen": self.n_seen,
                "hyper_fits": self.n_hyper_fits,
                "chol_refits": self.n_chol_refits,
                "err_ewma": None if self.err_ewma is None else round(self.err_ewma, 3),
                "ready": self._gp is not None or len(self) >= self.min_train,
                "frozen": self.frozen,
            }

    # -- campaign checkpointing ---------------------------------------------
    def snapshot(self) -> dict:
        """Consistent copy of the learnable state — the training window plus
        the staleness/counter bookkeeping — for `CampaignCheckpoint`. Arrays
        come out as arrays (checkpoint leaves); scalars are JSON-able. The
        fit itself is NOT captured: `restore` marks it dirty and the first
        `predict_batch` after resume re-factorizes the restored window."""
        with self._lock:
            return {
                "X": None if self._X is None else self._X.copy(),
                "y": None if self._y is None else self._y.copy(),
                "n_seen": self.n_seen,
                "since_refit": self._since_refit,
                "err_ewma": self.err_ewma,
                "frozen": self.frozen,
            }

    def restore(self, snap: dict) -> None:
        """Re-apply a `snapshot()` — the window is restored verbatim and the
        factorization is rebuilt lazily (hyperparameter search included, so
        a resumed screen trains from exactly the data it had)."""
        with self._lock:
            X, y = snap.get("X"), snap.get("y")
            self._X = None if X is None else np.atleast_2d(np.asarray(X, float)).copy()
            self._y = None if y is None else np.asarray(y, float).ravel().copy()
            self.n_seen = int(snap.get("n_seen", 0))
            self._since_refit = int(snap.get("since_refit", 0))
            e = snap.get("err_ewma")
            self.err_ewma = None if e is None else float(e)
            self.frozen = bool(snap.get("frozen", False))
            self._gp = None
            self._hyper_stale = True
