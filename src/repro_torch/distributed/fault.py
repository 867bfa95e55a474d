"""Fault injection + handling policies (port of `repro.distributed.fault`;
the standard library only).

On a real multi-pod deployment failures surface as (a) a device/step raising,
(b) NaN/inf loss (silent data corruption or numerics), (c) stragglers. The
train loop (`repro_torch.launch.train.train`) handles the first two with the
policies here; `core.fleet.FaultInjector` lifts `FlakyStep` to the fabric
layer, and tests inject failures through both on the CPU.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable


class StepFailure(RuntimeError):
    pass


@dataclass
class FlakyStep:
    """Wraps a step function; raises/corrupts on a schedule (test harness)."""

    fn: Callable
    fail_steps: tuple = ()  # steps that raise StepFailure once
    nan_steps: tuple = ()  # steps that return NaN loss once
    _fired: set = field(default_factory=set)

    def __call__(self, params, opt_state, batch, step: int):
        if step in self.fail_steps and ("f", step) not in self._fired:
            self._fired.add(("f", step))
            raise StepFailure(f"injected failure at step {step}")
        params, opt_state, metrics = self.fn(params, opt_state, batch)
        if step in self.nan_steps and ("n", step) not in self._fired:
            self._fired.add(("n", step))
            metrics = dict(metrics, loss=float("nan") * metrics["loss"])
        return params, opt_state, metrics


@dataclass
class FaultPolicy:
    max_retries_per_step: int = 2
    restore_on_nan: bool = True
    backoff_s: float = 0.0

    def handle(self, step: int, attempt: int, err: Exception | None) -> str:
        """Returns 'retry' | 'restore' — the train loop acts on it."""
        if attempt < self.max_retries_per_step:
            if self.backoff_s:
                time.sleep(self.backoff_s * (2**attempt))
            return "retry"
        return "restore"


def loss_is_bad(loss) -> bool:
    try:
        v = float(loss)
    except Exception:  # noqa: BLE001
        return True
    return math.isnan(v) or math.isinf(v)
