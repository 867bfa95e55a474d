"""Wave discipline: no per-point model calls inside loops over thetas in
the hot dispatch/sampler modules.

The whole fabric economics rest on batched waves; a Python loop that calls
the model once per theta inside `core/fabric.py`, `core/pool.py`,
`core/service.py`, `uq/inference.py`, `uq/mcmc.py` or `uq/mlda.py`
silently shatters a wave into N dispatches.
The per-point fallback belongs ONLY in the `Model` base class
(`core/interface.py`), which is deliberately outside this rule's scope.

Loops over host-side quantities (priors, densities, bookkeeping) are fine:
only calls whose target looks like a model dispatch (`model(...)`,
`self.model(...)`, `.evaluate(...)`, `.__call__(...)`) are flagged.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import FileCtx, Finding, ScopedVisitor, dotted

#: the wave-native modules this rule polices
HOT_MODULES = (
    "core/fabric.py",
    "core/pool.py",
    "core/service.py",
    "uq/fused.py",
    "uq/inference.py",
    "uq/mcmc.py",
    "uq/mlda.py",
)

#: loop variables that carry a wave of evaluation points
THETA_NAMES = {"thetas", "props", "proposals", "points", "theta_batch"}

#: call targets that mean "dispatch the model on ONE point"
MODEL_CALLS = {"model", "evaluate", "__call__"}


def _iter_over_thetas(it: ast.AST) -> str | None:
    """The theta-wave name a loop iterates over, if any (handles bare
    names plus zip(...)/enumerate(...)/reversed(...) wrappers)."""
    if isinstance(it, ast.Name) and it.id in THETA_NAMES:
        return it.id
    if isinstance(it, ast.Call):
        fn = dotted(it.func)
        if fn in ("zip", "enumerate", "reversed"):
            for arg in it.args:
                got = _iter_over_thetas(arg)
                if got:
                    return got
    return None


def _model_call_in(body_nodes) -> ast.Call | None:
    for root in body_nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Call):
                name = (dotted(node.func) or "").split(".")[-1]
                if name in MODEL_CALLS:
                    return node
            # a nested loop body belongs to this loop too; fine to rescan
    return None


class _Visitor(ScopedVisitor):
    def __init__(self, ctx: FileCtx, rule: str):
        super().__init__()
        self.ctx = ctx
        self.rule = rule
        self.findings: list[Finding] = []

    def _flag(self, line: int, theta: str, call: ast.Call) -> None:
        target = dotted(call.func) or "<call>"
        self.findings.append(Finding(
            self.rule, self.ctx.relpath, line, self.symbol,
            f"per-point model call {target}(...) inside a loop over "
            f"{theta!r} — dispatch one wave (evaluate_batch / fabric) instead",
        ))

    def visit_For(self, node: ast.For) -> None:
        theta = _iter_over_thetas(node.iter)
        if theta:
            call = _model_call_in(node.body)
            if call is not None:
                self._flag(node.lineno, theta, call)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            theta = _iter_over_thetas(gen.iter)
            if theta:
                elts = [node.elt] if hasattr(node, "elt") else [node.key, node.value]
                call = _model_call_in(elts)
                if call is not None:
                    self._flag(node.lineno, theta, call)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp


class WaveDisciplineRule:
    rule = "wave"

    def visit_file(self, ctx: FileCtx) -> list[Finding]:
        if not any(ctx.relpath.endswith(mod) for mod in HOT_MODULES):
            return []
        v = _Visitor(ctx, self.rule)
        v.visit(ctx.tree)
        return v.findings

    def finish(self) -> list[Finding]:
        return []
