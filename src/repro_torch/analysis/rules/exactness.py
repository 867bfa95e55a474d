"""Exactness discipline: no unseeded/global-state randomness in sampler
and DA modules.

Every sampler in `uq/` takes an explicit `np.random.Generator`; a stray
`np.random.uniform()` (legacy global-state API) or bare `random.random()`
in a detailed-balance-critical path silently breaks reproducibility AND
the Christen–Fox exactness tests, because the draw is neither seeded nor
threaded through the chain state. Benchmarks are held to the same bar so
recorded numbers replay.

Allowed (the lookalikes): ``np.random.default_rng(seed)`` WITH a seed
argument, `np.random.Generator` / `SeedSequence` type usage, and seeded
``random.Random(seed)`` instances.

torch has a global stream too. In the same scopes a torch draw
(`torch.randn(...)` and the other factory samplers, or an in-place sampler
such as `x.uniform_()`) must name its `generator=`, and nothing may reseed
the global stream (`torch.manual_seed`, `torch.cuda.manual_seed(_all)`):
a fused block draws from its own `torch.Generator`, which the caller
seeds. A `torch.Generator(...)` and its `.manual_seed(s)` are the
lookalikes that stay silent.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import FileCtx, Finding, ScopedVisitor, dotted

#: module path fragments the rule applies to (samplers, DA, benchmarks)
SCOPES = ("uq/", "benchmarks/")

#: numpy.random attributes that are fine to reference
NP_RANDOM_OK = {"Generator", "SeedSequence", "BitGenerator", "PCG64", "Philox", "MT19937"}

#: stdlib `random` module functions that consume hidden global state
STDLIB_RANDOM_FNS = {
    "random", "uniform", "randint", "randrange", "choice", "choices",
    "sample", "shuffle", "gauss", "normalvariate", "betavariate",
    "expovariate", "seed", "getrandbits", "triangular", "vonmisesvariate",
}


#: torch factory samplers that draw from the global stream unless given
#: `generator=`
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial"}

#: in-place tensor samplers, global stream unless given `generator=`
TORCH_INPLACE_DRAWS = {
    "uniform_", "normal_", "exponential_", "bernoulli_", "random_",
    "cauchy_", "log_normal_", "geometric_",
}

#: calls that reseed torch's global streams
TORCH_GLOBAL_SEEDS = {
    "torch.manual_seed", "torch.random.manual_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
}


def _in_scope(relpath: str) -> bool:
    return any(f"/{s}" in f"/{relpath}" for s in SCOPES)


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


class _Visitor(ScopedVisitor):
    def __init__(self, ctx: FileCtx, rule: str):
        super().__init__()
        self.ctx = ctx
        self.rule = rule
        self.findings: list[Finding] = []
        self.has_import_random = False
        self.from_random: set[str] = set()  # names imported from stdlib random
        self.from_torch: set[str] = set()  # draws imported from torch

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "random" and alias.asname is None:
                self.has_import_random = True
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "random":
            for alias in node.names:
                if alias.name in STDLIB_RANDOM_FNS:
                    self.from_random.add(alias.asname or alias.name)
        elif node.module == "torch":
            for alias in node.names:
                if alias.name in TORCH_DRAWS:
                    self.from_torch.add(alias.asname or alias.name)
        self.generic_visit(node)

    def _flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            self.rule, self.ctx.relpath, node.lineno, self.symbol, message
        ))

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        if name:
            parts = name.split(".")
            # -- numpy legacy / unseeded API --------------------------------
            if len(parts) == 3 and parts[0] in ("np", "numpy") and parts[1] == "random":
                fn = parts[2]
                if fn == "default_rng":
                    if not node.args and not node.keywords:
                        self._flag(node, "np.random.default_rng() without a seed "
                                         "— pass an explicit seed or Generator")
                elif fn == "RandomState":
                    self._flag(node, "np.random.RandomState is the legacy "
                                     "global-state API — use "
                                     "np.random.default_rng(seed)")
                elif fn not in NP_RANDOM_OK:
                    self._flag(node, f"np.random.{fn}() draws from the hidden "
                                     f"global stream — thread a seeded "
                                     f"np.random.Generator through instead")
            # -- stdlib random ----------------------------------------------
            elif (
                len(parts) == 2
                and parts[0] == "random"
                and self.has_import_random
                and parts[1] in STDLIB_RANDOM_FNS
            ):
                self._flag(node, f"random.{parts[1]}() uses the process-global "
                                 f"stdlib stream — use a seeded "
                                 f"np.random.Generator (or random.Random(seed))")
            elif (
                len(parts) == 2
                and parts[0] == "random"
                and self.has_import_random
                and parts[1] == "Random"
                and not node.args
                and not node.keywords
            ):
                self._flag(node, "random.Random() without a seed")
            elif len(parts) == 1 and parts[0] in self.from_random:
                self._flag(node, f"{parts[0]}() (from random import ...) uses "
                                 f"the process-global stdlib stream")
            # -- torch's global stream ----------------------------------------
            elif name in TORCH_GLOBAL_SEEDS:
                self._flag(node, f"{name}() reseeds torch's process-global "
                                 f"stream — seed a torch.Generator and pass it")
            elif (
                (len(parts) == 2 and parts[0] == "torch" and parts[1] in TORCH_DRAWS)
                or (len(parts) == 1 and parts[0] in self.from_torch)
            ) and not _has_generator(node):
                self._flag(node, f"{name}() without generator= draws from "
                                 f"torch's process-global stream — pass a "
                                 f"seeded torch.Generator")
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in TORCH_INPLACE_DRAWS
            and not _has_generator(node)
        ):
            self._flag(node, f".{node.func.attr}() without generator= draws "
                             f"from torch's process-global stream — pass a "
                             f"seeded torch.Generator")
        self.generic_visit(node)


class ExactnessDisciplineRule:
    rule = "exactness"

    def visit_file(self, ctx: FileCtx) -> list[Finding]:
        if not _in_scope(ctx.relpath):
            return []
        v = _Visitor(ctx, self.rule)
        v.visit(ctx.tree)
        return v.findings

    def finish(self) -> list[Finding]:
        return []
