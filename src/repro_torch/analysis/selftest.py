"""Per-rule fixture snippets proving each rule fires (and does not).

Used two ways:

* ``python -m repro_torch.analysis --selftest`` (tier-1 and
  `chip_smoke.py`'s `analysis_gate` run it): every rule must flag its
  "bad" fixture and stay silent on its "good" fixture — an injected
  violation of each rule class demonstrably fails.
* `tests/test_torch_analysis.py` parametrizes over the same fixtures and
  adds harder false-positive lookalikes.

The fixtures of the four rules the JAX package shares are its own, under
`src/repro_torch/` paths; the capability fixtures add `TorchModel`, the
port's every-op base, and the exactness fixtures torch's global-stream
draws and their `generator=` lookalikes. The `torch` rule's bad fixture holds one violation
of each sub-check, reached through each resolution route: (a) a statement
inside the capture, (b) a function and a method called from it, (c) a
body handed to a runner that calls it inside the capture.

Fixture file names matter: scope-limited rules (wave, exactness) only
fire on matching module paths, so fixtures are written under those
relative names inside a temp tree.
"""
from __future__ import annotations

import tempfile
from pathlib import Path

from repro_torch.analysis.lint import run_lint

FIXTURES: dict[str, dict] = {
    "capability": {
        "bad": {
            "src/repro_torch/apps/fixture_models.py": '''
class Model:
    def evaluate_batch(self, thetas, config=None):
        return [self(t, config) for t in thetas]
    def gradient_batch(self, thetas, senss, config=None):
        return thetas


class OverAdvertised(Model):
    """Advertises gradient_batch; only the base-class FD loop exists."""
    def capabilities(self, config=None):
        return Capabilities(evaluate=True, gradient_batch=True)
    def __call__(self, parameters, config=None):
        return parameters


class UnderAdvertised(Model):
    """Native gradient_batch, not advertised."""
    def capabilities(self, config=None):
        return Capabilities(evaluate=True)
    def __call__(self, parameters, config=None):
        return parameters
    def gradient_batch(self, thetas, senss, config=None):
        return senss


class TorchModel(Model):
    def __call__(self, parameters, config=None):
        return parameters
    def apply_hessian_batch(self, thetas, senss, vecs, config=None):
        return vecs


class QuietHessian(TorchModel):
    """Overrides its native HVP wave and does not advertise it."""
    def capabilities(self, config=None):
        return Capabilities(evaluate=True)
    def apply_hessian_batch(self, thetas, senss, vecs, config=None):
        return vecs
''',
        },
        "good": {
            "src/repro_torch/apps/fixture_models.py": '''
class Model:
    def evaluate_batch(self, thetas, config=None):
        return [self(t, config) for t in thetas]


class Conformant(Model):
    def capabilities(self, config=None):
        return Capabilities(evaluate=True, evaluate_batch=True, gradient=True)
    def __call__(self, parameters, config=None):
        return parameters
    def evaluate_batch(self, thetas, config=None):
        return thetas
    def gradient(self, out_wrt, in_wrt, parameters, sens, config=None):
        return sens


class Negotiated(Model):
    """Dynamic capabilities (HTTP negotiation) — statically unverifiable."""
    def capabilities(self, config=None):
        return self._caps


class TorchModel(Model):
    """Every op natively, by autograd."""
    def __call__(self, parameters, config=None):
        return parameters
    def evaluate_batch(self, thetas, config=None):
        return thetas
    def gradient(self, out_wrt, in_wrt, parameters, sens, config=None):
        return sens
    def gradient_batch(self, thetas, senss, config=None):
        return senss
    def apply_jacobian(self, out_wrt, in_wrt1, in_wrt2, parameters, vec, config=None):
        return vec
    def apply_jacobian_batch(self, thetas, vecs, config=None):
        return vecs
    def apply_hessian(self, out_wrt, in_wrt1, in_wrt2, parameters, sens, vec, config=None):
        return vec
    def apply_hessian_batch(self, thetas, senss, vecs, config=None):
        return vecs


class Autograd(TorchModel):
    """Advertises every op; conforms by inheritance."""
    def capabilities(self, config=None):
        return Capabilities(evaluate=True, evaluate_batch=True, gradient_batch=True,
                            apply_jacobian_batch=True, apply_hessian_batch=True)
''',
        },
        "expect_min": 3,
    },
    "wave": {
        "bad": {
            "src/repro_torch/uq/mcmc.py": '''
def shattered_wave(model, thetas):
    outs = [model(t) for t in thetas]
    for t in thetas:
        outs.append(model.evaluate(t))
    return outs
''',
        },
        "good": {
            # host-side per-point loops (priors) are fine even in scope...
            "src/repro_torch/uq/mcmc.py": '''
def prior_scan(logprior, thetas, fabric):
    pr = [float(logprior(t)) for t in thetas]
    ys = fabric.evaluate_batch(thetas)
    return pr, ys
''',
            # ...and the base-class fallback module is outside the scope
            "src/repro_torch/core/interface.py": '''
class Model:
    def evaluate_batch(self, thetas, config=None):
        return [self.model(t, config) for t in thetas]
''',
        },
        "expect_min": 2,
    },
    "exactness": {
        "bad": {
            "src/repro_torch/uq/helper.py": '''
import numpy as np


def jitter(thetas):
    return thetas + np.random.normal(size=len(thetas))


def fresh_rng():
    return np.random.default_rng()
''',
            "src/repro_torch/uq/draws.py": '''
import torch


def jitter(x):
    return x + torch.randn(x.shape)


def reseed():
    torch.manual_seed(0)


def fill(buf):
    buf.uniform_()
''',
        },
        "good": {
            "src/repro_torch/uq/helper.py": '''
import random

import numpy as np


def jitter(thetas, rng):
    return thetas + rng.normal(size=len(thetas))


def make_rng(seed):
    return np.random.default_rng(seed)


def perturbation_source(seed):
    return random.Random(seed)
''',
            "src/repro_torch/uq/draws.py": '''
import torch


def jitter(x, gen):
    return x + torch.randn(x.shape, generator=gen)


def make_gen(seed):
    return torch.Generator().manual_seed(seed)


def fill(buf, gen):
    buf.uniform_(generator=gen)
''',
        },
        "expect_min": 5,
    },
    "torch": {
        "bad": {
            "src/repro_torch/apps/fixture_graphs.py": '''
import time

import numpy as np
import torch


def _replay(body, n):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(n):
        graph.replay()


def _norm(x):
    if x.abs().max() > 1.0:
        x = x / 2
    return float(x.sum())


class Stepper:
    def __init__(self, x):
        self.x = x

    def _advance(self, y):
        shift = torch.as_tensor(np.ones(3), device=y.device)
        self.x.copy_(y + shift)

    def capture(self):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = self.x + 1
            total = y.sum().item()
            torch.cuda.synchronize()
            self._advance(y)
            _norm(y)
        return graph, total

    def sweep(self, n):
        def body():
            self.x.mul_(np.random.normal())
            stamp = time.perf_counter()
            self.x.add_(self.x.cpu().cuda() * stamp)

        _replay(body, n)


def capture_per_chunk(chunks):
    graphs = []
    for c in chunks:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            c.mul_(2)
        graphs.append(g)
    return graphs


def _fd_gradient(f, theta):
    theta = torch.as_tensor(theta).float()
    return f(theta)
''',
        },
        "good": {
            "src/repro_torch/apps/fixture_graphs.py": '''
import numpy as np
import torch


def _warm(body):
    body()


def _replay(body, n):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(n):
        graph.replay()


class Chunked:
    def __init__(self, x):
        self.x = x
        self.graph = None

    def steps(self, n):
        for _ in range(n):
            if self.x.ndim == 2 and self.x.shape[0] > 1:
                self.x.mul_(0.5)
        self.x.add_(self.x.to(self.x.dtype))

    def run(self, n):
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.steps(n)
            self.graph = graph
        while True:
            self.graph.replay()
            if not bool(self.x.sum() > 0):
                return self.x.cpu().numpy()

    def sweep(self, n, kept=None):
        def body():
            if kept is not None:
                kept.copy_(self.x.to(self.x.device))
            self.x.add_(1.0)

        def report():
            return self.x.sum().item()

        _replay(body, n)
        _warm(report)
        return report()


def _fd_gradient(f, theta):
    theta = torch.as_tensor(theta)
    dtype = theta.dtype if theta.dtype == torch.float64 else torch.float32
    return f(theta.to(dtype))


def summarize(totals):
    return totals.sum().item()
''',
        },
        "expect_min": 10,
    },
    "locks": {
        "bad": {
            "src/repro_torch/core/fixture_locks.py": '''
import threading


class Telemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self.stats = {"waves": 0}

    def bump_guarded(self):
        with self._lock:
            self.stats["waves"] += 1

    def bump_racy(self):
        self.stats["waves"] += 1
''',
        },
        "good": {
            "src/repro_torch/core/fixture_locks.py": '''
import threading


class Telemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self.stats = {"waves": 0}

    def bump(self):
        with self._lock:
            self._bump()

    def _bump(self):  # caller holds the lock
        self.stats["waves"] += 1


class SingleThreaded:
    """Owns no lock — out of this rule's scope by design."""

    def __init__(self):
        self.stats = {"calls": 0}

    def bump(self):
        self.stats["calls"] += 1
''',
        },
        "expect_min": 1,
    },
}


def _materialize(tree: dict[str, str], root: Path) -> None:
    for rel, src in tree.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)


def run_selftest() -> dict:
    """Inject one violation per rule class; verify detection AND silence.

    Returns ``{"passed": bool, "rules": {rule: {...}}}``.
    """
    report: dict = {"schema": "repro-analysis-selftest-v1", "rules": {}, "passed": True}
    for rule, spec in FIXTURES.items():
        entry: dict = {}
        with tempfile.TemporaryDirectory(prefix=f"repro-lint-{rule}-") as td:
            root = Path(td)
            _materialize(spec["bad"], root)
            bad = [f for f in run_lint([root], rules=[rule], root=root) if f.rule == rule]
            entry["bad_findings"] = len(bad)
            entry["detects"] = len(bad) >= spec["expect_min"]
        with tempfile.TemporaryDirectory(prefix=f"repro-lint-{rule}-") as td:
            root = Path(td)
            _materialize(spec["good"], root)
            good = [f for f in run_lint([root], rules=[rule], root=root) if f.rule == rule]
            entry["false_positives"] = [str(f) for f in good]
            entry["clean_on_good"] = not good
        entry["passed"] = entry["detects"] and entry["clean_on_good"]
        report["rules"][rule] = entry
        report["passed"] = report["passed"] and entry["passed"]
    return report
