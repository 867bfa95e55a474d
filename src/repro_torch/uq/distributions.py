"""1-D parameter distributions used by the paper's applications:
Triangular (L2-Sea Froude), 4-parameter Beta (L2-Sea draft), Gaussian
(composite defect), Uniform, truncated Gaussian. Each provides pdf/logpdf,
sampling, and the inverse CDF (for QMC transforms)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import special


class Distribution:
    def pdf(self, x):
        raise NotImplementedError

    def logpdf(self, x):
        with np.errstate(divide="ignore"):
            return np.log(self.pdf(x))

    def sample(self, rng: np.random.Generator, n: int):
        return self.ppf(rng.uniform(size=n))

    def ppf(self, u):
        raise NotImplementedError

    def support(self) -> tuple[float, float]:
        raise NotImplementedError

    def mean(self) -> float:
        lo, hi = self.support()
        xs = np.linspace(lo, hi, 20001)
        return float(np.trapezoid(xs * self.pdf(xs), xs))


@dataclass(frozen=True)
class Uniform(Distribution):
    a: float
    b: float

    def pdf(self, x):
        x = np.asarray(x, float)
        return np.where((x >= self.a) & (x <= self.b), 1.0 / (self.b - self.a), 0.0)

    def ppf(self, u):
        return self.a + (self.b - self.a) * np.asarray(u, float)

    def support(self):
        return (self.a, self.b)


@dataclass(frozen=True)
class Normal(Distribution):
    mu: float = 0.0
    sigma: float = 1.0

    def pdf(self, x):
        z = (np.asarray(x, float) - self.mu) / self.sigma
        return np.exp(-0.5 * z * z) / (self.sigma * np.sqrt(2 * np.pi))

    def ppf(self, u):
        return self.mu + self.sigma * special.ndtri(np.asarray(u, float))

    def support(self):
        return (self.mu - 8 * self.sigma, self.mu + 8 * self.sigma)

    def mean(self):
        return self.mu


@dataclass(frozen=True)
class TruncatedNormal(Distribution):
    """Gaussian cut off at [lo, hi] (paper §4.2: 'cut off at the domain
    boundary')."""

    mu: float
    sigma: float
    lo: float
    hi: float

    def _cdf(self, x):
        return special.ndtr((np.asarray(x, float) - self.mu) / self.sigma)

    def pdf(self, x):
        x = np.asarray(x, float)
        z = (x - self.mu) / self.sigma
        base = np.exp(-0.5 * z * z) / (self.sigma * np.sqrt(2 * np.pi))
        norm = self._cdf(self.hi) - self._cdf(self.lo)
        return np.where((x >= self.lo) & (x <= self.hi), base / norm, 0.0)

    def ppf(self, u):
        lo_c, hi_c = self._cdf(self.lo), self._cdf(self.hi)
        return self.mu + self.sigma * special.ndtri(lo_c + (hi_c - lo_c) * np.asarray(u, float))

    def support(self):
        return (self.lo, self.hi)


@dataclass(frozen=True)
class Beta(Distribution):
    """4-parameter Beta on [a, b] with shape (alpha, beta) — the paper's
    draft distribution uses the density
      rho(x) ~ (x-a)^alpha (b-x)^beta  (footnote 2: shapes offset by +1
      relative to the standard Beta(alpha+1, beta+1))."""

    alpha: float
    beta: float
    a: float
    b: float

    @property
    def _sa(self):
        return self.alpha + 1

    @property
    def _sb(self):
        return self.beta + 1

    def pdf(self, x):
        x = np.asarray(x, float)
        t = (x - self.a) / (self.b - self.a)
        inside = (t >= 0) & (t <= 1)
        t = np.clip(t, 1e-300, 1 - 1e-16)
        lg = (
            special.gammaln(self._sa + self._sb)
            - special.gammaln(self._sa)
            - special.gammaln(self._sb)
        )
        val = np.exp(lg + (self._sa - 1) * np.log(t) + (self._sb - 1) * np.log1p(-t))
        return np.where(inside, val / (self.b - self.a), 0.0)

    def ppf(self, u):
        t = special.betaincinv(self._sa, self._sb, np.asarray(u, float))
        return self.a + (self.b - self.a) * t

    def support(self):
        return (self.a, self.b)


@dataclass(frozen=True)
class Triangular(Distribution):
    """Symmetric triangular on [a, b] (paper §4.1: F ~ Triang(Fa, Fb))."""

    a: float
    b: float

    @property
    def c(self):
        return 0.5 * (self.a + self.b)

    def pdf(self, x):
        x = np.asarray(x, float)
        a, b, c = self.a, self.b, self.c
        up = 2 * (x - a) / ((b - a) * (c - a))
        down = 2 * (b - x) / ((b - a) * (b - c))
        return np.where(x < a, 0.0, np.where(x <= c, up, np.where(x <= b, down, 0.0)))

    def ppf(self, u):
        u = np.asarray(u, float)
        a, b, c = self.a, self.b, self.c
        fc = (c - a) / (b - a)
        left = a + np.sqrt(u * (b - a) * (c - a))
        right = b - np.sqrt((1 - u) * (b - a) * (b - c))
        return np.where(u < fc, left, right)

    def support(self):
        return (self.a, self.b)


@dataclass(frozen=True)
class MultivariateNormal:
    """Diagonal-covariance Gaussian over R^d (paper §4.2 defect prior)."""

    mean: tuple
    var: tuple

    @property
    def dim(self):
        return len(self.mean)

    def logpdf(self, x):
        x = np.atleast_2d(np.asarray(x, float))
        mu = np.asarray(self.mean)
        v = np.asarray(self.var)
        out = -0.5 * np.sum((x - mu) ** 2 / v + np.log(2 * np.pi * v), axis=-1)
        return out[0] if out.shape == (1,) else out

    def sample(self, rng: np.random.Generator, n: int):
        mu = np.asarray(self.mean)
        sd = np.sqrt(np.asarray(self.var))
        return mu + sd * rng.standard_normal((n, self.dim))


def product_ppf(dists, u: np.ndarray) -> np.ndarray:
    """Map uniform [N, d] points through per-dim inverse CDFs."""
    u = np.atleast_2d(u)
    return np.stack([d.ppf(u[:, i]) for i, d in enumerate(dists)], axis=1)
