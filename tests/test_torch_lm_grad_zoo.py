"""PyTorch port: `LMUQModel`'s derivative surface against the JAX package
for the families without qk-norm (checks and bounds in `_torch_lm_grad.py`):
deepseek-moe-16b (the MoE, each point routed on its own), zamba2-1.2b (the
hybrid: its first derivatives on the plain SSD, as it trains) and
llama-3.2-vision-90b (cross-attention over the batch's `ctx_embed`), each on
the kernel path (on the CPU the plain versions)."""
import pytest
import torch

import _torch_lm_grad as G

torch.set_num_threads(1)

ARCHS = ["deepseek-moe-16b", "zamba2-1.2b", "llama-3.2-vision-90b"]

_REFS: dict = {}


def _ref(arch: str) -> dict:
    if arch not in _REFS:
        _REFS[arch] = G.reference(arch)
    return _REFS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_capabilities_match_jax(arch):
    G.check_capabilities(_ref(arch), "kernel")


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_derivatives_match_jax(arch):
    G.check_batched(_ref(arch), arch, "kernel")


@pytest.mark.parametrize("arch", ARCHS)
def test_point_derivatives_match_jax(arch):
    G.check_points(_ref(arch), arch, "kernel")


def test_vlm_batch_carries_its_context():
    """The llama model's batch holds the JAX package's ctx_embed, which
    every derivative wave repeats per point."""
    pm = G.port_model(_ref("llama-3.2-vision-90b"), "kernel")
    ce = pm.batch["ctx_embed"]
    assert ce.shape[0] == pm.batch["tokens"].shape[0] and ce.dtype == torch.float32
