"""The UM-Bridge model interface (paper §2.1-§2.2) for the PyTorch port — v2,
capability-typed.

A model is a map F: R^n -> R^m exposing the four UM-Bridge operations
    Evaluate        F(theta)
    Gradient        sens^T J_F(theta)      (VJP)
    ApplyJacobian   J_F(theta) vec         (JVP)
    ApplyHessian    d/de [J_F(theta + e vec)^T sens]   (HVP)
each with a BATCHED variant ([N, n] lockstep waves). What a model actually
implements is advertised through one typed `Capabilities` descriptor
(`model.capabilities()`), which every dispatch layer — fabric, router, HTTP
server/client — reads instead of probing ad-hoc `supports_*` methods. UQ
drivers negotiate against the descriptor: a gradient-based sampler refuses
an evaluate-only backend up front instead of failing mid-wave.

Models that implement no derivatives still get batched derivatives: the
base class ships a finite-difference fallback with RELATIVE step sizing
(h scales with |theta|), issued as one `evaluate_batch` wave. (The AD-derived
model wrapper of the JAX package waits for its `torch.func` counterpart.)

The list-of-lists parameter layout mirrors the UM-Bridge HTTP protocol: a
model may take several input vectors (blocks); most UQ methods use one block.
The batched surface uses the flattened single-row view ([N, n_flat]).

Legacy surface (one release of back-compat, see README migration notes):
`supports_evaluate_batch()` still answers but emits a DeprecationWarning —
probe `capabilities().evaluate_batch` instead; dispatch layers that have to
shatter a wave into bare per-point `__call__`s warn likewise.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, ClassVar

import numpy as np


class UnsupportedCapability(RuntimeError):
    """A dispatch layer was asked for an operation no eligible backend/model
    advertises in its `Capabilities` descriptor."""


#: snake-case capability name -> UM-Bridge wire name (``/ModelInfo`` keys)
CAPABILITY_WIRE_NAMES = {
    "evaluate": "Evaluate",
    "gradient": "Gradient",
    "apply_jacobian": "ApplyJacobian",
    "apply_hessian": "ApplyHessian",
    "evaluate_batch": "EvaluateBatch",
    "gradient_batch": "GradientBatch",
    "apply_jacobian_batch": "ApplyJacobianBatch",
    "apply_hessian_batch": "ApplyHessianBatch",
}


@dataclass(frozen=True)
class Capabilities:
    """Typed descriptor of a model's operation surface.

    One flag per UM-Bridge operation plus one per batched variant; the wire
    form (`to_json`/`from_json`) is what `/ModelInfo` serves, so clients
    never probe endpoints. Replaces the v1 `supports_*()` method zoo and the
    `ModelSupport` wire dataclass (kept as a deprecated alias).
    """

    evaluate: bool = False
    gradient: bool = False
    apply_jacobian: bool = False
    apply_hessian: bool = False
    evaluate_batch: bool = False
    gradient_batch: bool = False
    apply_jacobian_batch: bool = False
    apply_hessian_batch: bool = False

    #: the four base operations (capability *families*); `op_supported`
    #: treats a native batched variant as implying the family
    OPS: ClassVar[tuple[str, ...]] = (
        "evaluate", "gradient", "apply_jacobian", "apply_hessian"
    )

    def __contains__(self, name: str) -> bool:
        return bool(getattr(self, name, False))

    def names(self) -> frozenset[str]:
        """Snake-case names of every advertised capability."""
        return frozenset(k for k in CAPABILITY_WIRE_NAMES if getattr(self, k))

    def op_supported(self, op: str) -> bool:
        """True when the base operation `op` can be served at all (either the
        per-point or the native batched form is advertised)."""
        if op not in self.OPS:
            raise ValueError(f"unknown capability family {op!r}")
        return bool(getattr(self, op) or getattr(self, f"{op}_batch"))

    def batched(self, op: str) -> bool:
        """True when `op` has a NATIVE batched implementation (one dispatch
        per wave rather than a per-point loop)."""
        return bool(getattr(self, f"{op}_batch"))

    def issubset(self, other: "Capabilities") -> bool:
        return self.names() <= other.names()

    def union(self, other: "Capabilities") -> "Capabilities":
        return Capabilities(**{
            k: bool(getattr(self, k) or getattr(other, k))
            for k in CAPABILITY_WIRE_NAMES
        })

    def intersection(self, other: "Capabilities") -> "Capabilities":
        return Capabilities(**{
            k: bool(getattr(self, k) and getattr(other, k))
            for k in CAPABILITY_WIRE_NAMES
        })

    def to_json(self) -> dict:
        return {wire: bool(getattr(self, k)) for k, wire in CAPABILITY_WIRE_NAMES.items()}

    @classmethod
    def from_json(cls, d: dict) -> "Capabilities":
        return cls(**{
            k: bool(d.get(wire, False)) for k, wire in CAPABILITY_WIRE_NAMES.items()
        })


def model_capabilities(model, config: dict | None = None) -> Capabilities:
    """Capability descriptor for anything model-shaped. `Model` instances
    answer directly; duck-typed objects are probed through whatever legacy
    `supports_*` methods they expose (without triggering the base-class
    deprecation shims)."""
    caps = getattr(model, "capabilities", None)
    if callable(caps):
        return caps(config)

    def probe(name: str) -> bool:
        fn = getattr(model, name, None)
        try:
            return bool(fn()) if callable(fn) else False
        except Exception:  # noqa: BLE001 — a failing probe is a "no"
            return False

    return Capabilities(
        evaluate=probe("supports_evaluate"),
        gradient=probe("supports_gradient"),
        apply_jacobian=probe("supports_apply_jacobian"),
        apply_hessian=probe("supports_apply_hessian"),
        evaluate_batch=probe("supports_evaluate_batch"),
        gradient_batch=probe("supports_gradient_batch"),
        apply_jacobian_batch=probe("supports_apply_jacobian_batch"),
        apply_hessian_batch=probe("supports_apply_hessian_batch"),
    )


def _warn_deprecated(msg: str):
    warnings.warn(msg, DeprecationWarning, stacklevel=3)


class Model:
    """Abstract UM-Bridge model (mirror of umbridge.Model), capability-typed.

    Subclasses either override `capabilities()` directly (v2 style) or keep
    overriding the legacy `supports_*` probes — the base `capabilities()`
    derives the descriptor from whichever probes the subclass overrides, so
    both styles interoperate behind one negotiation surface.
    """

    #: True = dispatch layers (fabric / pools) should pad waves to power-of-2
    #: sizes before `evaluate_batch` so the jitted batch program only ever
    #: sees log2(N) distinct shapes (bounded trace cache). Models that chunk
    #: and pad INTERNALLY (tsunami, composite) leave this False — dispatcher
    #: padding would turn into real extra solves on top of their own.
    batch_bucket = False

    #: RELATIVE finite-difference step for the derivative fallbacks:
    #: h_i = fd_step * max(|theta_i|, 1). Tuned for float32 forward solvers
    #: (FD error ~ eps/h + h); float64 models may lower it to ~1e-6.
    fd_step = 1e-4

    #: opt a model with no derivative implementation into advertising the
    #: gradient/apply_jacobian families anyway, served by the FD fallback —
    #: dispatch layers will then route derivative waves to it
    fd_gradients = False

    def __init__(self, name: str = "forward"):
        self.name = name

    def _overrides(self, method: str) -> bool:
        return getattr(type(self), method, None) is not getattr(Model, method, None)

    # -- metadata -----------------------------------------------------------
    def get_input_sizes(self, config: dict | None = None) -> list[int]:
        raise NotImplementedError

    def get_output_sizes(self, config: dict | None = None) -> list[int]:
        raise NotImplementedError

    # -- capability surface (v2) -------------------------------------------
    def capabilities(self, config: dict | None = None) -> Capabilities:
        """Typed capability descriptor. The default derives it from the
        legacy v1 surface: `supports_*` probes the subclass overrides are
        honored, and implementing a derivative method (`gradient`,
        `apply_jacobian`, ...) or setting `fd_gradients` advertises that
        family. v2-style models override this method directly."""
        ov = self._overrides
        grad = (
            (ov("supports_gradient") and bool(self.supports_gradient()))
            or ov("gradient") or self.fd_gradients
        )
        jac = (
            (ov("supports_apply_jacobian") and bool(self.supports_apply_jacobian()))
            or ov("apply_jacobian") or self.fd_gradients
        )
        hess = (
            (ov("supports_apply_hessian") and bool(self.supports_apply_hessian()))
            or ov("apply_hessian")
        )
        return Capabilities(
            evaluate=ov("supports_evaluate") and bool(self.supports_evaluate()),
            gradient=grad,
            apply_jacobian=jac,
            apply_hessian=hess,
            evaluate_batch=(
                ov("supports_evaluate_batch") and bool(self.supports_evaluate_batch())
            ),
            gradient_batch=ov("gradient_batch") and grad,
            apply_jacobian_batch=ov("apply_jacobian_batch") and jac,
            apply_hessian_batch=ov("apply_hessian_batch") and hess,
        )

    # -- legacy capability probes (v1; thin shims over `capabilities`) ------
    def supports_evaluate(self) -> bool:
        if self._overrides("capabilities"):
            return self.capabilities().evaluate
        return False

    def supports_gradient(self) -> bool:
        if self._overrides("capabilities"):
            return self.capabilities().gradient
        return False

    def supports_apply_jacobian(self) -> bool:
        if self._overrides("capabilities"):
            return self.capabilities().apply_jacobian
        return False

    def supports_apply_hessian(self) -> bool:
        if self._overrides("capabilities"):
            return self.capabilities().apply_hessian
        return False

    def supports_evaluate_batch(self) -> bool:
        """DEPRECATED probe — read `capabilities().evaluate_batch` instead.
        Kept for one release of back-compat; dispatch layers no longer call
        it (they negotiate on the `Capabilities` descriptor)."""
        _warn_deprecated(
            "Model.supports_evaluate_batch() is deprecated; probe "
            "model.capabilities().evaluate_batch instead"
        )
        if self._overrides("capabilities"):
            return self.capabilities().evaluate_batch
        return False

    # -- operations ---------------------------------------------------------
    def __call__(self, parameters: list[list[float]], config: dict | None = None):
        raise NotImplementedError

    def evaluate_batch(self, thetas, config: dict | None = None) -> np.ndarray:
        """[N, n_flat] -> [N, m_flat]. Default: per-point loop over
        `__call__`, un-flattening each theta into the model's input blocks.
        Native-batch models override this with one vectorized program and
        advertise `evaluate_batch` in `capabilities()`."""
        from repro_torch.core.protocol import split_blocks

        thetas = np.atleast_2d(np.asarray(thetas, float))
        sizes = self.get_input_sizes(config)
        rows = []
        for t in thetas:
            out = self(split_blocks(t, sizes), config)
            rows.append(np.concatenate([np.asarray(b, float).ravel() for b in out]))
        return np.asarray(rows)

    def gradient(self, out_wrt: int, in_wrt: int, parameters, sens, config=None):
        raise NotImplementedError

    def apply_jacobian(self, out_wrt: int, in_wrt: int, parameters, vec, config=None):
        raise NotImplementedError

    def apply_hessian(self, out_wrt, in_wrt1, in_wrt2, parameters, sens, vec, config=None):
        raise NotImplementedError

    # -- batched derivative surface (v2) ------------------------------------
    def gradient_batch(self, thetas, senss, config: dict | None = None) -> np.ndarray:
        """Batched VJP: [N, n_flat] x [N, m_flat] -> [N, n_flat] with
        row k = senss[k]^T J_F(thetas[k]).

        Default: a per-point loop over `gradient` when the subclass
        implements it, else the finite-difference fallback (ONE
        `evaluate_batch` wave of N*(1+n) points, RELATIVE steps). Models
        with a native lockstep VJP override this and advertise
        `gradient_batch`."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        senss = np.atleast_2d(np.asarray(senss, float))
        if self._overrides("gradient"):
            from repro_torch.core.protocol import split_blocks

            sizes = self.get_input_sizes(config)
            rows = []
            for t, s in zip(thetas, senss):
                blocks = split_blocks(t, sizes)
                rows.append(np.concatenate([
                    np.asarray(
                        self.gradient(0, b, blocks, list(map(float, s)), config),
                        float,
                    ).ravel()
                    for b in range(len(sizes))
                ]))
            return np.asarray(rows)
        return self._fd_gradient_batch(thetas, senss, config)

    def _fd_gradient_batch(self, thetas, senss, config=None) -> np.ndarray:
        """Forward-difference VJP fallback with RELATIVE step sizing:
        h_i = fd_step * max(|theta_i|, 1), so a model parameterized in
        kilometres and one in fractions both difference at a scale the
        solver resolves (an absolute h under-flows large |theta| into
        round-off and overshoots small |theta|). The N*(1+n) shifted points
        ship as ONE `evaluate_batch` wave."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        senss = np.atleast_2d(np.asarray(senss, float))
        N, n = thetas.shape
        h = self.fd_step * np.maximum(np.abs(thetas), 1.0)  # [N, n] relative
        shifted = [thetas]
        for i in range(n):
            s = thetas.copy()
            s[:, i] += h[:, i]
            shifted.append(s)
        ys = np.atleast_2d(np.asarray(
            self.evaluate_batch(np.concatenate(shifted, axis=0), config), float
        ))
        y0 = ys[:N]
        grads = np.empty((N, n))
        for i in range(n):
            dyi = (ys[(i + 1) * N:(i + 2) * N] - y0) / h[:, i:i + 1]
            grads[:, i] = np.sum(dyi * senss, axis=1)
        return grads

    def apply_jacobian_batch(self, thetas, vecs, config: dict | None = None) -> np.ndarray:
        """Batched JVP: [N, n_flat] x [N, n_flat] -> [N, m_flat] with
        row k = J_F(thetas[k]) vecs[k]. Default: per-point `apply_jacobian`
        when implemented, else a forward-difference fallback (ONE 2N-point
        `evaluate_batch` wave, step relative to |theta| and |vec|)."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        vecs = np.atleast_2d(np.asarray(vecs, float))
        if self._overrides("apply_jacobian"):
            from repro_torch.core.protocol import split_blocks

            sizes = self.get_input_sizes(config)
            rows = []
            for t, v in zip(thetas, vecs):
                blocks = split_blocks(t, sizes)
                out = np.zeros(sum(self.get_output_sizes(config)))
                for b, vb in enumerate(split_blocks(v, sizes)):
                    out = out + np.asarray(
                        self.apply_jacobian(0, b, blocks, vb, config), float
                    ).ravel()
                rows.append(out)
            return np.asarray(rows)
        return self._fd_apply_jacobian_batch(thetas, vecs, config)

    def _fd_apply_jacobian_batch(self, thetas, vecs, config=None) -> np.ndarray:
        """Forward-difference JVP fallback, step relative to |theta| and
        |vec| (same sizing rationale as `_fd_gradient_batch`); ONE 2N-point
        `evaluate_batch` wave."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        vecs = np.atleast_2d(np.asarray(vecs, float))
        N = len(thetas)
        tscale = np.maximum(np.linalg.norm(thetas, axis=1, keepdims=True), 1.0)
        vnorm = np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)
        h = self.fd_step * tscale / vnorm  # relative to both scales
        ys = np.atleast_2d(np.asarray(
            self.evaluate_batch(np.concatenate([thetas, thetas + h * vecs], 0), config),
            float,
        ))
        return (ys[N:] - ys[:N]) / h

    def value_and_gradient_batch(
        self, thetas, sens_fn: Callable, config: dict | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Fused forward + VJP wave: returns (ys [N, m], grads [N, n]) with
        grads[k] = sens_fn(ys[k])^T J_F(thetas[k]). `sens_fn` maps ONE
        output row to one sensitivity row (e.g. the data-misfit gradient of
        a Gaussian likelihood). Default: an evaluate wave followed by a
        gradient wave; AD-native models fuse both into ONE dispatch (the VJP
        computes the primal anyway), which is what makes gradient-based
        lockstep samplers cost one wave per step."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        ys = np.atleast_2d(np.asarray(self.evaluate_batch(thetas, config), float))
        senss = np.stack([np.asarray(sens_fn(y), float).ravel() for y in ys])
        return ys, self.gradient_batch(thetas, senss, config)

    def apply_hessian_batch(self, thetas, senss, vecs, config: dict | None = None) -> np.ndarray:
        """Batched HVP; default per-point loop (no FD fallback — second
        differences of a float32 solver are noise)."""
        if not self._overrides("apply_hessian"):
            raise UnsupportedCapability(
                f"{type(self).__name__} implements no apply_hessian"
            )
        from repro_torch.core.protocol import split_blocks

        thetas = np.atleast_2d(np.asarray(thetas, float))
        senss = np.atleast_2d(np.asarray(senss, float))
        vecs = np.atleast_2d(np.asarray(vecs, float))
        sizes = self.get_input_sizes(config)
        rows = []
        for t, s, v in zip(thetas, senss, vecs):
            blocks = split_blocks(t, sizes)
            rows.append(np.asarray(self.apply_hessian(
                0, 0, 0, blocks, list(map(float, s)),
                list(map(float, v)), config,
            ), float).ravel())
        return np.asarray(rows)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (the batch-shape bucket boundary)."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def pad_to_bucket(thetas: np.ndarray, bucket: int) -> tuple[np.ndarray, int]:
    """Pad [N, n] up to `bucket` rows by repeating the last row; returns the
    padded array and the pad count (padding telemetry)."""
    pad = bucket - len(thetas)
    if pad <= 0:
        return thetas, 0
    return np.concatenate([thetas, np.repeat(thetas[-1:], pad, 0)], 0), pad
