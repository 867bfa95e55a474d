"""repro_torch.analysis — the port's correctness tooling: invariant linter
+ race detector.

Two halves:

* `repro_torch.analysis.lint` / `repro_torch.analysis.rules` — an AST
  linter enforcing the five project invariants (capability conformance,
  wave discipline, exactness discipline, torch discipline over captured
  CUDA-graph bodies, lock discipline).
  CLI: ``python -m repro_torch.analysis`` (default path: src/repro_torch).
* `repro_torch.analysis.races` / `repro_torch.analysis.stress` —
  instrumented locks, lock-order cycle detection, unguarded-write auditing,
  and the schedule-perturbing stress harness for the fabric stack. The
  fabric stack imports `races` (its `named_*` lock factories) at module
  load, so this package imports no `stress` here.
"""
from repro_torch.analysis.common import Finding, RULE_IDS
from repro_torch.analysis.lint import (
    DEFAULT_BASELINE,
    apply_baseline,
    load_baseline,
    run_lint,
    write_baseline,
)

__all__ = [
    "Finding",
    "RULE_IDS",
    "run_lint",
    "load_baseline",
    "write_baseline",
    "apply_baseline",
    "DEFAULT_BASELINE",
]
