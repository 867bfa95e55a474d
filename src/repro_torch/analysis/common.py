"""Shared plumbing for the port's invariant linter: findings, file
contexts, waiver comments, and small AST helpers used by every rule. The
waiver syntax is the JAX package's, so one comment reads the same in both
packages."""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

#: the five rule families the gate enforces (ids used in waivers/baselines)
RULE_IDS = ("capability", "wave", "exactness", "torch", "locks")

_WAIVER_RE = re.compile(r"#\s*repro-lint:\s*allow\s+([A-Za-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Finding:
    """One invariant violation at a specific site."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    symbol: str  # "Class.method" context, or "<module>"
    message: str

    def key(self) -> str:
        """Baseline identity: stable across pure line-number drift."""
        return f"{self.rule}|{self.path}|{self.symbol}|{self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "key": self.key(),
        }

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.symbol}: {self.message}"


def dotted(node: ast.AST) -> str | None:
    """'jax.jit' for Attribute(Name('jax'), 'jit'); None for anything that
    is not a pure Name/Attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def parse_waivers(lines: list[str]) -> dict[int, set[str]]:
    """Map 1-based line numbers to the rule ids waived on them.

    A ``# repro-lint: allow <rule>[, <rule>...]`` comment waives the named
    rules ("all" waives everything) on its own line AND on the next
    non-comment, non-blank line — so the annotation can sit above the
    statement it excuses, matching the repo's comment style.
    """
    waivers: dict[int, set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _WAIVER_RE.search(line)
        if not m:
            continue
        tokens = re.split(r"[,\s]+", m.group(1).strip())
        rules: set[str] = set()
        for tok in tokens:
            tl = tok.lower()
            if tl == "all":
                rules.add("*")
            elif tl in RULE_IDS:
                rules.add(tl)
            else:
                break  # free-text reason starts here
        if not rules:
            continue
        waivers.setdefault(i, set()).update(rules)
        for j in range(i + 1, len(lines) + 1):
            stripped = lines[j - 1].strip()
            if stripped and not stripped.startswith("#"):
                waivers.setdefault(j, set()).update(rules)
                break
    return waivers


@dataclass
class FileCtx:
    """One parsed source file handed to every rule."""

    path: Path
    relpath: str  # posix, relative to the lint root
    source: str
    lines: list[str] = field(repr=False, default_factory=list)
    tree: ast.AST | None = field(repr=False, default=None)
    waivers: dict[int, set[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: Path, root: Path) -> "FileCtx":
        source = path.read_text()
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        tree = ast.parse(source, filename=str(path))
        lines = source.splitlines()
        return cls(
            path=path,
            relpath=rel,
            source=source,
            lines=lines,
            tree=tree,
            waivers=parse_waivers(lines),
        )

    def waived(self, rule: str, line: int) -> bool:
        rules = self.waivers.get(line)
        return bool(rules) and (rule in rules or "*" in rules)

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the Class.method qualname of the current
    scope in `self.symbol` — every rule reports findings against it."""

    def __init__(self) -> None:
        self._scope: list[str] = []

    @property
    def symbol(self) -> str:
        return ".".join(self._scope) if self._scope else "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._scope.pop()

    def _visit_func(self, node) -> None:
        self._scope.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def names_in(node: ast.AST) -> set[str]:
    """All Name ids referenced anywhere under `node`."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def iter_py_files(paths: list[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    # dedupe, keep order
    seen: set[Path] = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out
