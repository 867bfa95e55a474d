"""Request batching: per-point `submit()` futures on top of the device pool.

The collector thread that packs per-point submits into waves lives in
`repro_torch.core.fabric.EvaluationFabric` (with adaptive linger/wave
sizing, request coalescing and an optional result cache); `BatchingExecutor`
is the thin, non-caching view of it — prototype-grade UQ threads submit
single points, the fabric packs everything that arrives within the linger
window into one `ModelPool` wave (paper §3.1, §4.1).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.fabric import EvaluationFabric
from repro_torch.core.pool import ModelPool


class BatchingExecutor(EvaluationFabric):
    """Per-point futures over a `ModelPool` — a fixed-window, cache-free
    `EvaluationFabric` (the paper's §3.1 semantics: transparent batching
    with no result reuse across waves; identical requests IN FLIGHT at the
    same moment still share one evaluation)."""

    def __init__(self, pool: ModelPool, max_batch: int | None = None, linger_s: float = 0.002):
        super().__init__(
            pool,
            max_batch=max_batch or 4 * pool.n_instances,
            linger_s=linger_s,
            adaptive=False,
            cache_size=0,
        )
        self.pool = pool

    def evaluate(self, theta) -> np.ndarray:
        """Blocking single-point evaluation (legacy signature)."""
        return self.submit(theta).result()

    __call__ = evaluate
