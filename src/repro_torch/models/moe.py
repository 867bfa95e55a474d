"""Fine-grained MoE: shared experts + routed top-k (counterpart of
`repro.models.moe`, DeepSeekMoE / Kimi-K2 style).

The JAX package shards the experts over its 'model' mesh axis and runs the
dispatch inside a `shard_map`; with the experts replicated on one device its
path is `body_nomodel` with one model shard, which is what this module
computes, with the same capacity-gather semantics:

* the router's logits in float32, softmax, top-k, the k weights
  renormalised over the selected experts and cast to x's dtype; the
  Switch-style load-balance loss beside them;
* the T·k (token, choice) pairs sorted STABLY by expert (`jnp.argsort` is
  stable), so within an expert they keep token order; each expert takes its
  first `capacity` pairs, capacity = max(ceil(T·k / E · capacity_factor), 8),
  and the rest are dropped;
* the kept tokens gathered per expert into ``[E, slots, d]``, the SwiGLU
  experts as batched products over the experts, each slot's output times
  its combine weight, and the slots added into their tokens' rows in slot
  order (the order the reference's scatter-add takes them), plus the shared
  experts' MLP.

The experts run as library GEMMs (`torch.bmm`), as the reference runs them
as XLA einsums outside any Pallas kernel.

**A wave of points.** The JAX package evaluates a wave of UQ points under
`vmap`, so each point's dispatch sees only its own B·S tokens and has its
own capacity. The port runs one forward over the wave's stacked sequences;
`points=K` says the batch is K points of equal size, and each is routed on
its own: the sort key is (expert, point, pair), capacity is per (point,
expert), and each expert's slots of all points lie side by side, so there
is still one batched product per weight. A point's result then does not
depend on the wave it rides in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import decl_mlp, mlp
from repro_torch.models.params import ParamDecl
from repro_torch.types import ModelConfig


def decl_moe(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    decls = {
        "router": ParamDecl((d, E), scale=0.02, dtype="float32"),
        "w_gate": ParamDecl((E, d, f)),
        "w_up": ParamDecl((E, d, f)),
        "w_down": ParamDecl((E, f, d)),
    }
    if cfg.n_shared_experts:
        decls["shared"] = decl_mlp(d, cfg.moe_d_ff * cfg.n_shared_experts)
    return decls


def router_topk(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """Returns (weights [B,S,k] in x's dtype, expert ids [B,S,k], aux
    scalar). The aux loss is E · sum_e (mean router prob of e) · (share of
    the selected pairs that went to e), over all of x's tokens."""
    logits = x.float() @ params["router"]  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.sum(w, dim=-1, keepdim=True)  # renormalize over selected
    E = cfg.n_experts
    me = torch.mean(probs, dim=(0, 1))
    n_tokens = idx.shape[0] * idx.shape[1]
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / n_tokens / cfg.top_k
    aux = E * torch.sum(me * ce)
    return w.to(x.dtype), idx, aux


def capacity_of(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for `tokens` tokens (one point's B·S), as the
    reference computes it on one device."""
    return max(int(math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)), 8)


def dispatch(idx: torch.Tensor, n_experts: int, points: int, capacity: int):
    """The capacity-gather plan of the flat ``[T, k]`` expert ids of
    `points` points of T / points tokens each: returns (tok [E·P·C], the
    token of each slot, 0 for a slot no pair took; pos [T, k], the slot each
    pair landed in, or -1 where it was dropped). Slot (e, p, c) is expert
    e's c-th pair of point p, in the stable (expert, point, pair) order."""
    T, k = idx.shape
    N = T * k
    E, P, C = n_experts, points, capacity
    pair = torch.arange(N, device=idx.device)
    # (expert, point); a point's pairs are contiguous, so a stable sort keeps
    # them in pair order within each group
    group = idx.reshape(N) * P + pair // (N // P)
    order = torch.argsort(group, stable=True)
    s_group = group[order]
    counts = torch.bincount(s_group, minlength=E * P)
    starts = torch.cumsum(counts, 0) - counts
    rank = pair - starts[s_group]
    kept = rank < C
    slot = (s_group * C + rank)[kept]
    tok = torch.zeros(E * P * C, dtype=torch.long, device=idx.device)
    tok[slot] = order[kept] // k
    pos = torch.full((N,), -1, dtype=torch.long, device=idx.device)
    pos[order[kept]] = slot
    return tok, pos.reshape(T, k)


def moe_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *, points: int = 1,
              capacity: int | None = None):
    """Returns (y [B,S,d], aux). x's B sequences are `points` points of
    B / points sequences each, each routed on its own (module docstring);
    `capacity` (slots per expert and point) defaults to `capacity_of` one
    point's tokens."""
    B, S, d = x.shape
    if points < 1 or B % points:
        raise ValueError(f"moe_block: {B} sequences do not split into {points} points")
    E, k = cfg.n_experts, cfg.top_k
    w, idx, aux = router_topk(cfg, params, x)
    T = B * S
    C = capacity_of(cfg, T // points) if capacity is None else capacity
    tok, pos = dispatch(idx.reshape(T, k), E, points, C)
    xf = x.reshape(T, d)
    # combine weight of each slot, in x's dtype (0 for a slot no pair took)
    kept = pos >= 0
    cw = torch.zeros(E * points * C, dtype=x.dtype, device=x.device)
    cw[pos[kept]] = w.reshape(T, k)[kept]
    xg = xf.index_select(0, tok).reshape(E, points * C, d)
    g = torch.bmm(xg, params["w_gate"])
    u = torch.bmm(xg, params["w_up"])
    del xg
    h = F.silu(g) * u
    del g, u
    y = torch.bmm(h, params["w_down"]).reshape(E * points * C, d)
    del h
    y = y * cw[:, None]
    # each token's slots in slot order (by expert id), as the reference's
    # scatter-add into zeros takes them; a dropped pair adds 0
    pos_e = torch.gather(pos, 1, torch.argsort(idx.reshape(T, k), dim=-1))
    out = torch.zeros_like(xf)
    for j in range(k):
        pj = pos_e[:, j]
        out += y.index_select(0, pj.clamp_min(0)) * (pj >= 0).to(y.dtype)[:, None]
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp(params["shared"], x)
    return out, aux
