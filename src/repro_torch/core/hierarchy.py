"""Multilevel model hierarchies (paper §2.1, §4.3).

MLDA/MLMC-style methods operate on a stack of models of increasing fidelity
and cost. Each level is an UM-Bridge `Model` (or a plain callable); the
hierarchy tracks per-level evaluation counts and wall time so benchmarks can
report the paper's cost split (e.g. §4.3: 1400 smoothed / 800 fine solves).

A hierarchy can also be a first-class *fabric citizen*: bind it to an
`EvaluationFabric` (optionally with per-level backend subsets on a
`FabricRouter`) and every level evaluation — per-point or whole waves via
`evaluate_batch(level, thetas)` — flows through the fabric's dispatch layer
and result cache, with per-level telemetry surfaced in `fabric.telemetry()
["per_label"]` (labels ``level0``, ``level1``, ...).
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from repro_torch.core.interface import Model
from repro_torch.core.protocol import config_key


class MultilevelModel:
    def __init__(
        self,
        levels: Sequence | None = None,
        configs: Sequence[dict] | None = None,
        *,
        fabric=None,
        level_backends: dict[int, Sequence[int]] | None = None,
    ):
        """levels[0] = coarsest ... levels[-1] = finest. Each level is a
        Model or a callable theta -> np.ndarray.

        Fabric-backed form: pass `fabric=` (an `EvaluationFabric`) and
        `configs=` (one UM-Bridge config per level, e.g. `{"level": l}`) with
        `levels=None` — evaluations then dispatch through the fabric (waves,
        cache, router). `level_backends={level: [backend indices]}` pins each
        level to a subset of a `FabricRouter`'s backends (the paper's
        sub-clusters sized per fidelity)."""
        if levels is None and fabric is None:
            raise ValueError("pass levels=, or fabric= with configs=")
        if fabric is not None and levels is None and not configs:
            raise ValueError("fabric-backed hierarchies need configs= "
                             "(one per level, coarsest first)")
        self.levels = list(levels) if levels is not None else [None] * len(configs)
        self.configs = list(configs) if configs else [None] * len(self.levels)
        self.fabric = None
        self.counts = [0] * len(self.levels)
        self.time_s = [0.0] * len(self.levels)
        if fabric is not None:
            self.bind_fabric(fabric, level_backends)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def bind_fabric(self, fabric, level_backends: dict[int, Sequence[int]] | None = None):
        """Route this hierarchy's evaluations through `fabric` from now on
        (same semantics as the constructor's fabric-backed form)."""
        # distinct configs are what keep the levels apart in the fabric's
        # result cache — colliding keys would silently serve level-l results
        # for level-m requests (and merge their telemetry labels)
        if len(self.configs) > 1:
            keys = [config_key(c) for c in self.configs]
            if len(set(keys)) != len(keys):
                raise ValueError(
                    "fabric-backed hierarchies need DISTINCT per-level "
                    f"configs (e.g. {{'level': l}}); got {self.configs}"
                )
        self.fabric = fabric
        for l, config in enumerate(self.configs):
            fabric.label_config(config, f"level{l}")
        for l, subset in (level_backends or {}).items():
            fabric.bind(self.configs[int(l)], subset)
        return self

    def _call_level(self, level: int, theta) -> np.ndarray:
        if self.fabric is not None:
            # submit (not evaluate_batch): single points ride the collector,
            # so concurrent chains pack into shared waves and hit the cache
            return np.asarray(
                self.fabric.submit(np.asarray(theta, float).ravel(),
                                   self.configs[level]).result()
            )
        m = self.levels[level]
        if isinstance(m, Model):
            out = m([list(np.asarray(theta, float).ravel())], self.configs[level])
            return np.asarray(out[0])
        return np.asarray(m(np.asarray(theta)))

    def evaluate(self, level: int, theta) -> np.ndarray:
        t0 = time.monotonic()
        out = self._call_level(level, theta)
        self.time_s[level] += time.monotonic() - t0
        self.counts[level] += 1
        return out

    def evaluate_batch(self, level: int, thetas) -> np.ndarray:
        """[N, n] -> [N, m] at one level in ONE wave — through the fabric
        (router + cache) when bound, else the level model's own batch path.
        This is what lockstep ensemble samplers call per subchain step."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        t0 = time.monotonic()
        if self.fabric is not None:
            out = self.fabric.evaluate_batch(thetas, self.configs[level])
        else:
            m = self.levels[level]
            if isinstance(m, Model):
                out = np.atleast_2d(
                    np.asarray(m.evaluate_batch(thetas, self.configs[level]))
                )
            else:
                out = np.atleast_2d(np.asarray([np.asarray(m(t)).ravel() for t in thetas]))
        self.time_s[level] += time.monotonic() - t0
        self.counts[level] += len(thetas)
        return out

    def __call__(self, level: int, theta) -> np.ndarray:
        return self.evaluate(level, theta)

    def report(self) -> dict:
        out = {
            "counts": list(self.counts),
            "time_s": [round(t, 3) for t in self.time_s],
        }
        if self.fabric is not None:
            tel = self.fabric.telemetry()
            out["fabric_levels"] = {
                k: v for k, v in tel["per_label"].items() if k.startswith("level")
            }
            if "router_imbalance" in tel:
                out["router"] = {
                    "imbalance": tel["router_imbalance"],
                    "steals": tel["router_steals"],
                    "backend_share": tel["backend_share"],
                }
        return out
