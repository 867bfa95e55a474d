"""Capability conformance: a `Model` subclass must implement every op its
`capabilities()` literal advertises, and must advertise every op surface it
natively implements.

The check is cross-file: class hierarchies are resolved by name over every
linted file (`core/interface.py` supplies `Model`/`TorchModel`, `apps/*.py`
the concrete models). Semantics mirror the fabric's dispatch contract:

* an advertised ``<op>_batch`` means a NATIVE batched program — the
  base-class per-point/FD fallbacks in `Model` do not count as evidence
  (that is exactly the lie the fabric's native-dispatch path would act on);
* `TorchModel` implements all eight ops natively, so subclasses inheriting
  its surface conform by inheritance;
* classes whose `capabilities()` is dynamic (negotiated at runtime, e.g.
  an HTTP client returning the server's descriptor) are skipped — only a
  literal ``return Capabilities(...)`` is checkable statically.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

from repro_torch.analysis.common import FileCtx, Finding, dotted

#: descriptor fields -> methods whose override satisfies the advertisement
EVIDENCE = {
    "evaluate": ("__call__",),
    "evaluate_batch": ("evaluate_batch",),
    "gradient": ("gradient", "gradient_batch"),
    "gradient_batch": ("gradient_batch",),
    "apply_jacobian": ("apply_jacobian", "apply_jacobian_batch"),
    "apply_jacobian_batch": ("apply_jacobian_batch",),
    "apply_hessian": ("apply_hessian", "apply_hessian_batch"),
    "apply_hessian_batch": ("apply_hessian_batch",),
}

#: methods that, when defined by the class ITSELF, must be advertised
DEFINES = {
    "evaluate_batch": "evaluate_batch",
    "gradient": "gradient",
    "gradient_batch": "gradient_batch",
    "apply_jacobian": "apply_jacobian",
    "apply_jacobian_batch": "apply_jacobian_batch",
    "apply_hessian": "apply_hessian",
    "apply_hessian_batch": "apply_hessian_batch",
}

#: the universal-fallback base: its method bodies are per-point/FD loops
#: and never count as native evidence for subclasses
FALLBACK_BASES = {"Model"}


@dataclass
class ClassInfo:
    name: str
    bases: list[str]
    methods: set[str]
    relpath: str
    line: int
    # None: no capabilities() defined; "dynamic": defined but not a literal
    caps: dict | None | str = None
    supports_true: set[str] = field(default_factory=set)
    fd_gradients: bool = False


def _literal_caps(func: ast.FunctionDef) -> dict | str:
    """Parse ``return Capabilities(a=True, ...)`` into a dict, or "dynamic"."""
    returns = [n for n in ast.walk(func) if isinstance(n, ast.Return) and n.value]
    if len(returns) != 1:
        return "dynamic"
    call = returns[0].value
    if not (
        isinstance(call, ast.Call)
        and (dotted(call.func) or "").split(".")[-1] == "Capabilities"
        and not call.args
    ):
        return "dynamic"
    caps: dict = {}
    for kw in call.keywords:
        if kw.arg is None or not isinstance(kw.value, ast.Constant):
            return "dynamic"
        caps[kw.arg] = bool(kw.value.value)
    return caps


class CapabilityConformanceRule:
    rule = "capability"

    def __init__(self) -> None:
        self.classes: dict[str, ClassInfo] = {}

    def visit_file(self, ctx: FileCtx) -> list[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases = [
                (dotted(b) or "?").split(".")[-1]
                for b in node.bases
                if dotted(b) is not None
            ]
            info = ClassInfo(
                name=node.name,
                bases=bases,
                methods=set(),
                relpath=ctx.relpath,
                line=node.lineno,
            )
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods.add(stmt.name)
                    if stmt.name == "capabilities":
                        info.caps = _literal_caps(stmt)
                    if stmt.name.startswith("supports_"):
                        rets = [
                            n for n in ast.walk(stmt)
                            if isinstance(n, ast.Return) and n.value is not None
                        ]
                        if (
                            len(rets) == 1
                            and isinstance(rets[0].value, ast.Constant)
                            and rets[0].value.value is True
                        ):
                            info.supports_true.add(stmt.name[len("supports_"):])
                elif isinstance(stmt, ast.Assign):
                    for tgt in stmt.targets:
                        if (
                            isinstance(tgt, ast.Name)
                            and tgt.id == "fd_gradients"
                            and isinstance(stmt.value, ast.Constant)
                        ):
                            info.fd_gradients = bool(stmt.value.value)
            # first definition wins (fixture shadowing a real name is rare
            # and the real tree is linted in one pass anyway)
            self.classes.setdefault(node.name, info)
        return []

    # -- resolution ---------------------------------------------------------
    def _ancestors(self, name: str) -> list[ClassInfo]:
        """The class and its registry-resolvable ancestors, nearest first."""
        out: list[ClassInfo] = []
        seen: set[str] = set()
        queue = [name]
        while queue:
            n = queue.pop(0)
            if n in seen or n not in self.classes:
                continue
            seen.add(n)
            info = self.classes[n]
            out.append(info)
            queue.extend(info.bases)
        return out

    def _in_model_hierarchy(self, name: str) -> bool:
        return any(
            c.name in ("Model", "TorchModel") or bool(set(c.bases) & {"Model", "TorchModel"})
            for c in self._ancestors(name)
        )

    def _nearest_caps(self, chain: list[ClassInfo]):
        for c in chain:
            if c.caps is not None:
                return c.caps
        return None

    def _has_native(self, chain: list[ClassInfo], methods: tuple[str, ...]) -> bool:
        for c in chain:
            if c.name in FALLBACK_BASES:
                continue  # universal fallbacks are not native evidence
            if any(m in c.methods for m in methods):
                return True
        return False

    def finish(self) -> list[Finding]:
        findings: list[Finding] = []
        for name, info in sorted(self.classes.items()):
            if name in ("Model", "TorchModel") or not self._in_model_hierarchy(name):
                continue
            chain = self._ancestors(name)
            caps = self._nearest_caps(chain)
            if caps == "dynamic":
                continue  # negotiated at runtime — not statically checkable
            if isinstance(caps, dict):
                for cap, advertised in sorted(caps.items()):
                    if cap not in EVIDENCE:
                        continue
                    if advertised and not self._has_native(chain, EVIDENCE[cap]):
                        findings.append(Finding(
                            self.rule, info.relpath, info.line, name,
                            f"capabilities() advertises {cap!r} but neither the "
                            f"class nor a non-fallback ancestor implements "
                            f"{' / '.join(EVIDENCE[cap])}",
                        ))
                for method, cap in sorted(DEFINES.items()):
                    if method in info.methods and not caps.get(cap, False):
                        findings.append(Finding(
                            self.rule, info.relpath, info.line, name,
                            f"implements {method}() natively but capabilities() "
                            f"does not advertise {cap!r}",
                        ))
            else:
                # legacy v1 surface: supports_<op> returning a literal True
                # advertises the op; it still needs an implementation
                for op in sorted(info.supports_true):
                    cap = {"evaluate": "evaluate"}.get(op, op)
                    methods = EVIDENCE.get(cap)
                    if methods is None:
                        continue
                    if info.fd_gradients and cap in (
                        "gradient", "apply_jacobian"
                    ):
                        continue
                    if not self._has_native(chain, methods):
                        findings.append(Finding(
                            self.rule, info.relpath, info.line, name,
                            f"supports_{op}() returns True but neither the class "
                            f"nor a non-fallback ancestor implements "
                            f"{' / '.join(methods)}",
                        ))
        return findings
