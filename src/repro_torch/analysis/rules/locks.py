"""Lock discipline: shared mutable state of a lock-owning class is only
written under its lock.

Scope: any class that creates a lock attribute in a method body
(``self._lock = threading.Lock()`` / ``named_lock(...)`` / RLock /
Condition variants). For such a class, the protected attribute set is

* every attribute written at least once inside a ``with self.<lock>:``
  block anywhere in the class (the class's own discipline defines the
  contract), plus
* attributes whose name matches the known shared-telemetry shapes
  (``*stats*``, ``*cache*``, ``*ewma*``) and is written in a non-init
  method.

A write (assign / augmented assign / mutating method call like
`.append`/`.update`/`.move_to_end`) to a protected attribute outside any
with-lock block is a finding. Exemptions, matching the repo's idiom:

* ``__init__`` (construction precedes sharing);
* methods annotated ``# caller holds the lock`` on/next to the def line,
  or whose docstring says so — their writes count as locked evidence;
* explicit ``# repro-lint: allow locks`` waivers (driver-level).
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.common import FileCtx, Finding, dotted

LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
    "named_lock", "named_rlock", "named_condition",
    "races.named_lock", "races.named_rlock", "races.named_condition",
}

#: attribute-name shapes that are shared telemetry by convention
PROTECTED_PATTERN = re.compile(r"stats|cache|ewma", re.IGNORECASE)

#: method calls that mutate their receiver
MUTATORS = {
    "append", "appendleft", "extend", "add", "update", "setdefault",
    "pop", "popitem", "popleft", "remove", "discard", "clear",
    "move_to_end", "insert",
}

_CALLER_HOLDS_RE = re.compile(r"caller\s+holds\s+the\s+lock", re.IGNORECASE)


def _self_attr(node: ast.AST) -> str | None:
    """'x' for `self.x` or the root attr of `self.x[...]` / `self.x.y`."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        node = node.value
    return None


def _is_lock_ctor(value: ast.AST) -> bool:
    return (
        isinstance(value, ast.Call)
        and (dotted(value.func) or "") in LOCK_FACTORIES
    )


def _caller_holds_lock(func, ctx: FileCtx) -> bool:
    # comment on the def line (or the line above), or in the docstring
    for line_no in (func.lineno, func.lineno - 1):
        if _CALLER_HOLDS_RE.search(ctx.line_text(line_no)):
            return True
    doc = ast.get_docstring(func)
    return bool(doc and _CALLER_HOLDS_RE.search(doc))


class _Write:
    __slots__ = ("attr", "line", "locked", "method", "kind")

    def __init__(self, attr: str, line: int, locked: bool, method: str, kind: str):
        self.attr = attr
        self.line = line
        self.locked = locked
        self.method = method
        self.kind = kind


def _collect_writes(func, lock_attrs: set[str], base_locked: bool) -> list[_Write]:
    """Walk one method, tracking lexical `with self.<lock>` nesting."""
    writes: list[_Write] = []

    def is_lock_item(item: ast.withitem) -> bool:
        attr = _self_attr(item.context_expr)
        return attr in lock_attrs

    def walk(node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.With):
            inner = locked or any(is_lock_item(i) for i in node.items)
            for item in node.items:
                walk(item.context_expr, locked)
            for stmt in node.body:
                walk(stmt, inner)
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is not None:
                    writes.append(_Write(attr, node.lineno, locked, func.name, "write"))
        elif isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in MUTATORS
            ):
                attr = _self_attr(node.func.value)
                if attr is not None:
                    writes.append(_Write(attr, node.lineno, locked, func.name, "mutate"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # a closure's execution time is unknowable statically; treat its
            # body with the surrounding lock state (lexical approximation)
            pass
        for child in ast.iter_child_nodes(node):
            walk(child, locked)

    for stmt in func.body:
        walk(stmt, base_locked)
    return writes


class LockDisciplineRule:
    rule = "locks"

    def visit_file(self, ctx: FileCtx) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, ctx))
        return findings

    def _check_class(self, cls: ast.ClassDef, ctx: FileCtx) -> list[Finding]:
        methods = [
            s for s in cls.body if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        # which self.<attr> hold locks?
        lock_attrs: set[str] = set()
        for m in methods:
            for sub in ast.walk(m):
                if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                    for tgt in sub.targets:
                        attr = _self_attr(tgt)
                        if attr is not None:
                            lock_attrs.add(attr)
        if not lock_attrs:
            return []

        all_writes: list[_Write] = []
        exempt_methods: set[str] = set()
        for m in methods:
            exempt = m.name == "__init__" or _caller_holds_lock(m, ctx)
            if exempt:
                exempt_methods.add(m.name)
            # exempt methods' writes are treated as locked evidence
            all_writes.extend(_collect_writes(m, lock_attrs, base_locked=exempt))

        locked_attrs = {w.attr for w in all_writes if w.locked and w.method != "__init__"}
        pattern_attrs = {
            w.attr
            for w in all_writes
            if w.method != "__init__" and PROTECTED_PATTERN.search(w.attr)
        }
        protected = (locked_attrs | pattern_attrs) - lock_attrs

        findings: list[Finding] = []
        for w in all_writes:
            if w.locked or w.method in exempt_methods:
                continue
            if w.attr not in protected:
                continue
            findings.append(Finding(
                self.rule, ctx.relpath, w.line, f"{cls.name}.{w.method}",
                f"write to shared field self.{w.attr} outside "
                f"`with self.{sorted(lock_attrs)[0]}` (class owns a lock; "
                f"guard the write or annotate '# caller holds the lock')",
            ))
        return findings

    def finish(self) -> list[Finding]:
        return []
