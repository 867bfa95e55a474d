"""Shared checks of the parity tests of `LMUQModel`'s derivative surface
(`test_torch_lm_grad.py`, `test_torch_lm_grad_zoo.py`): the eight UM-Bridge
operations of the port's `repro_torch.apps.lm_model.LMUQModel` against the
JAX package's `repro.apps.lm_model.LMUQModel` (a `JAXModel`: every
derivative by `jax.vjp`/`jax.jvp` of its XLA path), on the CPU in float32
at the reduced configs, with the JAX package's weights and batch carried
across (`_torch_zoo.carry`, `jax_lm_model`, `port_lm_model`).

Bounds (relative: the largest error over the largest value; measured values
print with -s):

* gradients, Jacobian actions and the fused value-and-gradient:
  `grad_rtol(arch)`, `tests/test_torch_train.py`'s split: 1e-4 for
  qwen3-0.6b, mamba2-1.3b and minicpm3-4b (qk-norm, no attention, latents
  normalised); 1e-3 for the families without qk-norm, whose random
  reduced float32 forwards are ill-conditioned (`_torch_zoo.py`).
  Measured: qwen3 <= 3.8e-7 (both paths), mamba2 4.4e-7, minicpm3
  4.2e-7, deepseek 3.2e-6, llama 5.0e-6, zamba2 1.6e-5;
* Hessian actions: `hess_rtol(arch)`, their own bound: reverse over
  reverse doubles the float32 reordering of the stack. 1e-5 for the three
  above (measured <= 2.5e-7), 1e-3 for the others (measured: llama 8.0e-7,
  deepseek 7.8e-6, zamba2 4.6e-5);
* the values of the fused wave: `_torch_zoo.NLL_RTOL` (1e-5).
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_zoo import NLL_RTOL, carry, jax_lm_model, port_lm_model, rel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention, ssm

SEQ = 64
WELL_CONDITIONED = ("qwen3-0.6b", "mamba2-1.3b", "minicpm3-4b")


def grad_rtol(arch: str) -> float:
    return 1e-4 if arch in WELL_CONDITIONED else 1e-3


def hess_rtol(arch: str) -> float:
    return 1e-5 if arch in WELL_CONDITIONED else 1e-3


#: 4 points, the tied head's theta_0 off 1 in three of them
THETAS = np.array([[1.0, 1.0], [0.8, 1.2], [1.25, 0.75], [1.1, 0.9]])
SENSS = np.array([[1.0], [0.5], [-2.0], [1.5]])
VECS = np.array([[1.0, 0.0], [0.3, -0.7], [0.0, 1.0], [-0.6, 0.4]])


def sens_fn(y):
    """A sensitivity of the output row (numpy in the port, traced in the
    JAX package's fused wave)."""
    return 2.0 * y - 20.0


def reference(arch: str) -> dict:
    """The carried weights, the JAX package's model on them, and its values
    of every operation at THETAS (the per-point ones at the first three)."""
    c = carry(arch, seq=SEQ)
    jm = jax_lm_model(c, seq=SEQ)
    ys, vg = jm.value_and_gradient_batch(THETAS, sens_fn)
    points = [[list(t)] for t in THETAS[:3]]
    return {
        "carried": c, "jm": jm,
        "gradient_batch": jm.gradient_batch(THETAS, SENSS),
        "apply_jacobian_batch": jm.apply_jacobian_batch(THETAS, VECS),
        "apply_hessian_batch": jm.apply_hessian_batch(THETAS, SENSS, VECS),
        "value_and_gradient_batch": (ys, vg),
        "gradient": np.array([jm.gradient(0, 0, p, list(s)) for p, s in zip(points, SENSS)]),
        "apply_jacobian": np.array([jm.apply_jacobian(0, 0, p, list(v))
                                    for p, v in zip(points, VECS)]),
        "apply_hessian": np.array([jm.apply_hessian(0, 0, 0, p, list(s), list(v))
                                   for p, s, v in zip(points, SENSS, VECS)]),
    }


def port_model(ref: dict, impl: str):
    return port_lm_model(ref["carried"], ref["jm"], impl)


def check_capabilities(ref: dict, impl: str) -> None:
    pm = port_model(ref, impl)
    assert pm.capabilities().to_json() == ref["jm"].capabilities().to_json()
    assert len(pm.capabilities().names()) == 8


def check_batched(ref: dict, arch: str, impl: str) -> None:
    """gradient_batch, apply_jacobian_batch, apply_hessian_batch and
    value_and_gradient_batch at THETAS against the JAX package's."""
    pm = port_model(ref, impl)
    got = {
        "gradient_batch": pm.gradient_batch(THETAS, SENSS),
        "apply_jacobian_batch": pm.apply_jacobian_batch(THETAS, VECS),
        "apply_hessian_batch": pm.apply_hessian_batch(THETAS, SENSS, VECS),
    }
    ys, vg = pm.value_and_gradient_batch(THETAS, sens_fn)
    jys, jvg = ref["value_and_gradient_batch"]
    errs = {k: rel(v, ref[k]) for k, v in got.items()}
    errs["value_and_gradient_batch"] = rel(vg, jvg)
    y_err = float(np.abs(ys / jys - 1).max())
    print(f"{arch} {impl}: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f", values {y_err:.3g}")
    for k, v in got.items():
        assert v.shape == ref[k].shape, k
    assert ys.shape == jys.shape == (len(THETAS), 1) and vg.shape == jvg.shape
    assert y_err < NLL_RTOL
    assert errs["apply_hessian_batch"] < hess_rtol(arch)
    for k in ("gradient_batch", "apply_jacobian_batch", "value_and_gradient_batch"):
        assert errs[k] < grad_rtol(arch), k
    # the fused wave's values are the evaluate wave's NLLs
    np.testing.assert_allclose(ys, pm.evaluate_batch(THETAS), rtol=NLL_RTOL)


def check_points(ref: dict, arch: str, impl: str) -> None:
    """The per-point gradient, apply_jacobian and apply_hessian (each a wave
    of one) at three points against the JAX package's."""
    pm = port_model(ref, impl)
    points = [[list(t)] for t in THETAS[:3]]
    got = {
        "gradient": np.array([pm.gradient(0, 0, p, list(s)) for p, s in zip(points, SENSS)]),
        "apply_jacobian": np.array([pm.apply_jacobian(0, 0, p, list(v))
                                    for p, v in zip(points, VECS)]),
        "apply_hessian": np.array([pm.apply_hessian(0, 0, 0, p, list(s), list(v))
                                   for p, s, v in zip(points, SENSS, VECS)]),
    }
    errs = {k: rel(v, ref[k]) for k, v in got.items()}
    print(f"{arch} {impl} per point: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    for k, v in got.items():
        assert v.shape == ref[k].shape, k
    assert errs["gradient"] < grad_rtol(arch) and errs["apply_jacobian"] < grad_rtol(arch)
    assert errs["apply_hessian"] < hess_rtol(arch)


class KernelCalls:
    """Counts, on the CPU, the calls a wave makes into the kernel wrappers
    the model reaches: `flash_attention` (as `models/attention.py` calls
    it), the flash backward (`ops.flash_attention_bwd`, which
    `FlashAttention.backward` calls) and the SSD (`ssd_ops.ssd`, as
    `models/ssm.py` calls it). On the CPU each runs its plain version and
    the launch counters stay 0, so the calls stand in for the launches."""

    def __init__(self, monkeypatch: pytest.MonkeyPatch):
        self.n = {"flash": 0, "flash_bwd": 0, "ssd": 0}
        for owner, name, key in ((attention, "flash_attention", "flash"),
                                 (flash_ops, "flash_attention_bwd", "flash_bwd"),
                                 (ssm.ssd_ops, "ssd", "ssd")):
            monkeypatch.setattr(owner, name, self._counted(getattr(owner, name), key))

    def _counted(self, fn, key):
        def counted(*args, **kwargs):
            self.n[key] += 1
            return fn(*args, **kwargs)
        return counted

    def take(self) -> dict:
        out, self.n = self.n, dict.fromkeys(self.n, 0)
        return out
