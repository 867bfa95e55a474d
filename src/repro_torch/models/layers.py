"""Shared layers: RMSNorm, RoPE, the SwiGLU MLP, embeddings and the LM head
(counterpart of `repro.models.layers`; plain PyTorch, as the reference is
plain jnp: the norms do not call the RMSNorm kernel, as the JAX package's
do not)."""
from __future__ import annotations

import torch

from repro_torch.models.params import ParamDecl
from repro_torch.types import ModelConfig


def decl_rmsnorm(dim: int) -> dict:
    return {"scale": ParamDecl((dim,), init="ones", dtype="float32")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rmsnorm_scaleless(x, params["scale"], eps)


def rmsnorm_scaleless(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with an explicit scale array (also the gated-norm variant),
    reduced in float32, returned in x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, n_heads, head_dim]; positions: [..., S] (broadcastable).
    Rotates in float32 and returns x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def decl_mlp(d_model: int, d_ff: int, use_bias: bool = False) -> dict:
    decls = {
        "w_gate": ParamDecl((d_model, d_ff)),
        "w_up": ParamDecl((d_model, d_ff)),
        "w_down": ParamDecl((d_ff, d_model)),
    }
    if use_bias:
        decls["b_gate"] = ParamDecl((d_ff,), init="zeros")
        decls["b_up"] = ParamDecl((d_ff,), init="zeros")
        decls["b_down"] = ParamDecl((d_model,), init="zeros")
    return decls


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) * (x W_up)) W_down, with optional biases."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    if "b_gate" in params:
        g = g + params["b_gate"]
        u = u + params["b_up"]
    y = (torch.nn.functional.silu(g) * u) @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return y


def decl_embed(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    decls = {"embedding": ParamDecl((v, cfg.d_model), init="embed")}
    if not cfg.tie_embeddings:
        decls["head"] = ParamDecl((cfg.d_model, v))
    return decls


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def lm_head(params: dict, x: torch.Tensor, embed_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Logits of hidden states x. A tied head reads the embedding table; with
    `embed_scale` (a scalar) it reads the table scaled as the embedding was,
    `table * embed_scale` in the parameter dtype, as the JAX package's
    `LMUQModel` scales the one table both use. An untied head is not scaled."""
    if "head" in params:
        return x @ params["head"]
    table = params["embedding"]
    if embed_scale is not None:
        table = table * embed_scale.to(table.dtype)
    return x @ table.T.to(x.dtype)
