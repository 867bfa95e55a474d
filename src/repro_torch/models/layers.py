"""Shared layers: RMSNorm, embeddings and the LM head (counterpart of
`repro.models.layers`; plain PyTorch, as the reference is plain jnp). The
SwiGLU MLP and rotary embeddings come with the attention families (ROADMAP
queue 1, item 13)."""
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


def decl_embed(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    decls = {"embedding": ParamDecl((v, cfg.d_model), init="embed")}
    if not cfg.tie_embeddings:
        decls["head"] = ParamDecl((cfg.d_model, v))
    return decls


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return x @ params["head"]
    return x @ params["embedding"].T.to(x.dtype)
