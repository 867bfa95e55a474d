"""AdamW over a parameter tree, with global-norm clipping and a
warmup-cosine schedule (port of `repro.optim.adamw`; no `torch.optim`).

The reference's behaviour is kept: the decay mask chooses leaves by their
path (no decay on norms, scales and leaves of one dimension or none); the
moments are stored in `tc.opt_state_dtype` (bfloat16 halves their memory)
and computed in float32; the gradient is clipped to a global norm of
`tc.grad_clip`; new parameters are cast back to each leaf's dtype; `step` is
an int32 0-d tensor. A tree is dicts, lists and tuples of tensors, its
leaves taken in `jax.tree.flatten`'s order (`models/params.py::
tree_leaves`).

`adamw_update` writes the caller's parameters and moments IN PLACE and
returns the same trees, where the JAX package returns new ones and donates
the old buffers to its jitted step (`repro/launch/train.py:56`): either way
the inputs are consumed, so a step that fails after the update restores
from a checkpoint (`launch.train`).

On a mesh the parameters are DTensors (`models.model.shard_params`): the
moments are DTensors placed as their parameters (`adamw_init`;
`opt_state_specs` gives their specs, `adamw_init_abstract` the dry run's
meta stand-ins), the update runs on each rank's shards, and the global
gradient norm is DTensor's sum over every shard. Call `adamw_update` inside
`distributed.sharding.on_mesh(ctx)` (`models.model.train_step` does), where
its plain 0-d step tensors meet the DTensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import P
from repro_torch.models.params import tree_leaves, tree_leaves_with_path, tree_map
from repro_torch.types import TrainConfig, dtype_of


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup over `tc.warmup_steps`, then a cosine from `tc.lr` to
    0.1 `tc.lr` at `tc.total_steps`, in float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves)
    return torch.sqrt(total)


def _decay_mask(path: tuple, leaf) -> bool:
    """No weight decay on norms / biases / 1-d params."""
    names = "/".join(str(p) for p in path)
    if leaf.ndim <= 1:
        return False
    if "norm" in names or "scale" in names:
        return False
    return True


def adamw_init(params, tc: TrainConfig) -> dict:
    """Zero moments in `tc.opt_state_dtype` beside each parameter (a
    DTensor's placed as it is), and step 0 (int32) on the first parameter's
    device."""
    dt = dtype_of(tc.opt_state_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros_like(p):
        return torch.zeros_like(p, dtype=dt)

    return {
        "mu": tree_map(zeros_like, params),
        "nu": tree_map(zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def adamw_init_abstract(params_abstract, tc: TrainConfig) -> dict:
    """Meta stand-ins of `adamw_init`'s state for abstract parameters."""
    dt = dtype_of(tc.opt_state_dtype)

    def z(p):
        return torch.empty(p.shape, dtype=dt, device="meta")

    return {
        "mu": tree_map(z, params_abstract),
        "nu": tree_map(z, params_abstract),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


def opt_state_specs(param_specs) -> dict:
    """The moments sharded as their parameters; the step replicated."""
    return {"mu": param_specs, "nu": param_specs, "step": P()}


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, tc: TrainConfig):
    """One AdamW step: returns (params, opt_state, {"grad_norm", "lr"}),
    the parameters and moments updated in place (the same trees) and
    `step` one more (a new 0-d tensor in the same dict)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(tc, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(tc.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = tc.beta1, tc.beta2
    corr1 = 1.0 - b1 ** step.to(torch.float32)
    corr2 = 1.0 - b2 ** step.to(torch.float32)
    flat_grads = tree_leaves(grads)
    flat_mu = tree_leaves(opt_state["mu"])
    flat_nu = tree_leaves(opt_state["nu"])
    for (path, p), g, mu, nu in zip(tree_leaves_with_path(params), flat_grads, flat_mu, flat_nu):
        g32 = g.to(torch.float32) * clip
        mu32 = b1 * mu.to(torch.float32) + (1 - b1) * g32
        nu32 = b2 * nu.to(torch.float32) + (1 - b2) * torch.square(g32)
        del g32
        upd = (mu32 / corr1) / (torch.sqrt(nu32 / corr2) + tc.eps)
        if _decay_mask(path, p):
            upd = upd + tc.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * upd)
        mu.copy_(mu32)
        nu.copy_(nu32)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
