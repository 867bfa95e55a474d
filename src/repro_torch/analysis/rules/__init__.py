"""Rule registry for the invariant linter.

Each rule is a class with two hooks:

* ``visit_file(ctx) -> list[Finding]`` — called once per parsed file;
* ``finish() -> list[Finding]`` — called after every file, for rules that
  need cross-file context (capability conformance resolves inheritance
  across `core/interface.py` and `apps/*.py` here).

The five rules are the JAX package's, with `torch` (captured CUDA-graph
bodies, `rules/torch_discipline.py`) in the place of its `jax` rule.

`get_rules()` returns FRESH instances — rules are stateful across files.
"""
from __future__ import annotations

from repro_torch.analysis.rules.capability import CapabilityConformanceRule
from repro_torch.analysis.rules.exactness import ExactnessDisciplineRule
from repro_torch.analysis.rules.locks import LockDisciplineRule
from repro_torch.analysis.rules.torch_discipline import TorchDisciplineRule
from repro_torch.analysis.rules.wave import WaveDisciplineRule

ALL_RULES = {
    "capability": CapabilityConformanceRule,
    "wave": WaveDisciplineRule,
    "exactness": ExactnessDisciplineRule,
    "torch": TorchDisciplineRule,
    "locks": LockDisciplineRule,
}


def get_rules(names=None):
    names = list(ALL_RULES) if names is None else list(names)
    unknown = [n for n in names if n not in ALL_RULES]
    if unknown:
        raise ValueError(f"unknown lint rules: {unknown} (have {sorted(ALL_RULES)})")
    return [ALL_RULES[n]() for n in names]
