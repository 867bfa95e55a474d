"""LM-as-UQ-model bridge (counterpart of `repro.apps.lm_model`): an
architecture of the LM zoo as an UM-Bridge model.

The expensive "numerical model" behind the UM-Bridge interface is an LM
forward pass. theta parameterizes a model perturbation:

    theta = (embedding_scale, logit_temperature)
    F(theta) = mean eval NLL on a fixed batch under the perturbed model

The port advertises `evaluate` and `evaluate_batch` only: its gradient is
ROADMAP queue 1, item 13d (the `torch.func` machinery of `TorchModel` is in
place).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.interface import Capabilities, Model
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.models.layers import lm_head
from repro_torch.types import dtype_of


class LMUQModel(Model):
    """theta = (embedding scale, logit temperature) -> [mean NLL].

    `batch` is the number of sequences of a synthetic batch drawn from
    `seed + 1` (as the JAX package draws it), or the batch itself: a mapping
    with numpy ``tokens`` and ``targets`` [B, S] and, for the vlm family,
    float ``ctx_embed [B, n_ctx_tokens, d_ctx]``. `params` replaces the
    weights drawn from `seed` (e.g. weights carried across from the JAX
    package by `repro_torch.convert.lm_params_from_numpy`). `n_layers` cuts
    the architecture's depth (widths kept; a vlm model's must be a multiple
    of its cross-attention period). Runs on `device` (default: the GPU;
    raises if there is none)."""

    # one forward per wave of N points, over N·B sequences. No `batch_bucket`:
    # the JAX package pads waves to powers of two to bound its jit trace
    # cache; the port runs eagerly and has no such cache, so padding would
    # only add thrown-away forwards (41 points as a 64-point wave)

    def __init__(self, arch: str, reduced: bool = True, batch=2, seq: int = 64,
                 seed: int = 0, device=None, params=None, n_layers: int | None = None):
        super().__init__(f"lm-{arch}")
        self.cfg = get_config(arch, reduced=reduced)
        if n_layers is not None:
            self.cfg = self.cfg.replace(n_layers=int(n_layers))
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(self.cfg, gen)
        self.params = params
        if isinstance(batch, Mapping):
            self.batch = {k: torch.as_tensor(np.array(batch[k]), dtype=torch.long,
                                             device=self.device)
                          for k in ("tokens", "targets")}
            if batch.get("ctx_embed") is not None:
                self.batch["ctx_embed"] = torch.as_tensor(
                    np.array(batch["ctx_embed"], np.float32), device=self.device
                ).to(dtype_of(self.cfg.act_dtype))
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            self.batch = M.make_synth_batch(self.cfg, int(batch), seq, gen)

    def get_input_sizes(self, config=None):
        return [2]

    def get_output_sizes(self, config=None):
        return [1]

    def capabilities(self, config=None) -> Capabilities:
        return Capabilities(evaluate=True, evaluate_batch=True)

    def __call__(self, parameters, config=None):
        theta = np.asarray(parameters[0], float)
        return [[float(self.evaluate_batch(theta[None, :], config)[0, 0])]]

    @torch.inference_mode()
    def evaluate_batch(self, thetas, config=None) -> np.ndarray:
        """[K, 2] -> [K, 1]: ONE forward over the K points' [K*B, S] tokens
        (point k's copy of the batch has its embedding rows scaled by
        theta_k[0]; a vlm batch's context embeddings ride along unscaled;
        a MoE routes each point's B sequences on their own, as the JAX
        package's vmap does); then per point the head, the padded-vocab
        mask and the log-softmax over its [B*S, V] logits at temperature
        theta_k[1], so the wave's logits are never held at once. A tied head
        reads point k's table scaled by theta_k[0], as the JAX package's
        does."""
        thetas = np.atleast_2d(np.asarray(thetas, np.float32))
        K = len(thetas)
        cfg, params = self.cfg, self.params
        tokens, targets = self.batch["tokens"], self.batch["targets"]
        B = tokens.shape[0]
        theta = torch.as_tensor(thetas, device=self.device)
        ctx_embed = self.batch.get("ctx_embed")
        hidden, _, _ = transformer.forward(
            cfg, params, tokens.repeat(K, 1), mode="train", skip_head=True,
            embed_scale=theta[:, 0].repeat_interleave(B), points=K,
            ctx_embed=None if ctx_embed is None else ctx_embed.repeat(K, 1, 1),
        )
        out = torch.empty(K, dtype=torch.float32, device=self.device)
        for k in range(K):
            logits = lm_head(params["embed"], hidden[k * B:(k + 1) * B], theta[k, 0])
            logits = M.mask_padded_logits(cfg, logits.float()) / theta[k, 1]
            logz = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
            out[k] = torch.mean(logz - tgt)
        return out.cpu().numpy().astype(float)[:, None]
