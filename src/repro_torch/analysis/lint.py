"""Invariant-linter driver: walk files, run rules, apply waivers/baseline.

`run_lint(paths)` is the library entry; ``python -m repro_torch.analysis`` the
CLI. Findings carry a stable `key()` (rule|path|symbol|message — line
numbers excluded so pure drift never churns the baseline); the checked-in
baseline (`analysis/baseline.json`) grandfathers old findings so the gate
is strict on NEW violations from day one.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.analysis.common import FileCtx, Finding, iter_py_files

#: the port's checked-in baseline
DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")

#: repo root (…/src/repro_torch/analysis/lint.py -> repo)
REPO_ROOT = Path(__file__).resolve().parents[3]


def run_lint(
    paths,
    rules=None,
    root: Path | None = None,
) -> list[Finding]:
    """Lint `paths` (files or directories) with the named rules (default:
    all five). Returns waiver-filtered findings sorted by site."""
    from repro_torch.analysis.rules import get_rules

    paths = [Path(p) for p in paths]
    root = Path(root) if root is not None else _common_root(paths)
    rule_objs = get_rules(rules)
    findings: list[Finding] = []
    ctxs: list[FileCtx] = []
    for f in iter_py_files(paths):
        try:
            ctxs.append(FileCtx.parse(f, root))
        except SyntaxError as e:
            findings.append(Finding(
                "parse", _rel(f, root), e.lineno or 0, "<module>",
                f"syntax error: {e.msg}",
            ))
    for rule in rule_objs:
        for ctx in ctxs:
            findings.extend(rule.visit_file(ctx))
        findings.extend(rule.finish())
    ctx_by_path = {c.relpath: c for c in ctxs}
    kept = []
    for f in findings:
        ctx = ctx_by_path.get(f.path)
        if ctx is not None and ctx.waived(f.rule, f.line):
            continue
        kept.append(f)
    return sorted(kept, key=lambda f: (f.path, f.line, f.rule, f.message))


def _rel(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def _common_root(paths) -> Path:
    # prefer the repo root when everything linted lives under it — keys in
    # the baseline then stay stable no matter where the CLI is invoked from
    try:
        if all(Path(p).resolve().is_relative_to(REPO_ROOT) for p in paths):
            return REPO_ROOT
    except AttributeError:  # pragma: no cover - py<3.9
        pass
    resolved = [Path(p).resolve() for p in paths]
    if len(resolved) == 1:
        p = resolved[0]
        return p if p.is_dir() else p.parent
    import os

    return Path(os.path.commonpath([str(p) for p in resolved]))


# -- baseline ---------------------------------------------------------------


def load_baseline(path: Path | None) -> set[str]:
    if path is None or not Path(path).exists():
        return set()
    doc = json.loads(Path(path).read_text())
    return set(doc.get("baselined", []))


def write_baseline(path: Path, findings) -> dict:
    doc = {
        "version": 1,
        "comment": (
            "Grandfathered lint findings. The gate fails only on findings "
            "NOT listed here; shrink this file, never grow it."
        ),
        "baselined": sorted({f.key() for f in findings}),
    }
    Path(path).write_text(json.dumps(doc, indent=2) + "\n")
    return doc


def apply_baseline(findings, baseline: set[str]):
    """(new, grandfathered) split."""
    new, old = [], []
    for f in findings:
        (old if f.key() in baseline else new).append(f)
    return new, old


# -- reports ----------------------------------------------------------------


def render_text(new, old, checked_paths) -> str:
    lines = []
    for f in new:
        lines.append(str(f))
    summary = (
        f"repro_torch.analysis: {len(new)} finding(s)"
        + (f" ({len(old)} baselined)" if old else "")
        + f" in {', '.join(str(p) for p in checked_paths)}"
    )
    lines.append(summary)
    return "\n".join(lines)


def render_json(new, old, checked_paths) -> dict:
    return {
        "schema": "repro-analysis-lint-v1",
        "paths": [str(p) for p in checked_paths],
        "findings": [f.to_json() for f in new],
        "baselined": [f.to_json() for f in old],
        "counts": {"new": len(new), "baselined": len(old)},
    }
