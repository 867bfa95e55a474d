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

**On a mesh** (`ctx=`, DTensor weights placed by their specs: experts over
'model', their d over 'data') the dispatch is the JAX package's
`_expert_shard_body`, run on each rank's local shards by `local_map`: the
expert weights are all-gathered over 'data' (FSDP) as they enter it, each
rank sorts its own tokens and capacity-gathers the pairs routed to its own
expert range (the other ranks' pairs sort last and are dropped), and the
ranks' outputs are partial sums over 'model', which one all-reduce
combines. Capacity comes from the rank's own token count (a wave's points
split over the batch axes, each point still routed on its own). Where
'model' does not divide the experts, they are replicated over it and every
model rank computes the whole block, which then equals the one-device
block. The router and its load-balance loss run on the DTensors
themselves, over every rank's tokens.

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

from repro_torch.distributed.sharding import P
from repro_torch.models.layers import decl_mlp, mlp
from repro_torch.models.params import ParamDecl
from repro_torch.types import ModelConfig


def decl_moe(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    decls = {
        "router": ParamDecl((d, E), P(None, None), scale=0.02, dtype="float32"),
        "w_gate": ParamDecl((E, d, f), P("model", "data", None)),
        "w_up": ParamDecl((E, d, f), P("model", "data", None)),
        "w_down": ParamDecl((E, f, d), P("model", None, "data")),
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
    if _is_dtensor(idx):
        # DTensor has no sharding rule for bincount: the JAX package's
        # one-hot count, whose means DTensor takes over every rank's tokens
        hits = (idx[..., None] == torch.arange(E, device=idx.device)).float()
        ce = torch.mean(torch.sum(hits, dim=2), dim=(0, 1)) / cfg.top_k
    else:
        n_tokens = idx.shape[0] * idx.shape[1]
        ce = torch.bincount(idx.reshape(-1), minlength=E).float() / n_tokens / cfg.top_k
    aux = E * torch.sum(me * ce)
    return w.to(x.dtype), idx, aux


def _is_dtensor(t) -> bool:
    # imported here: torch.distributed.tensor takes seconds to import
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


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
    # static shapes throughout (the dry run traces this on fake tensors): a
    # count by scatter-add, a dropped pair written to a last dump slot
    counts = torch.zeros(E * P, dtype=torch.long, device=idx.device).scatter_add_(
        0, s_group, torch.ones_like(s_group))
    starts = torch.cumsum(counts, 0) - counts
    rank = pair - starts[s_group]
    kept = rank < C
    slot = torch.where(kept, s_group * C + rank, E * P * C)
    tok = torch.zeros(E * P * C + 1, dtype=torch.long, device=idx.device)
    tok.scatter_(0, slot, order // k)
    pos = torch.empty(N, dtype=torch.long, device=idx.device)
    pos.scatter_(0, order, torch.where(kept, slot, -1))
    return tok[:E * P * C], pos.reshape(T, k)


def _experts(cfg: ModelConfig, xf, idx, w, w_gate, w_up, w_down, *, points: int,
             capacity: int, e0: int = 0) -> torch.Tensor:
    """The routed experts of the flat tokens ``xf [T, d]`` (their ids ``idx``
    and combine weights ``w``, ``[T, k]``) through the experts e0 ..
    e0 + E_loc - 1 whose weights are given (E_loc = w_gate.shape[0]; all of
    them on one device): ``[T, d]``, the pairs routed elsewhere adding 0."""
    T, k = idx.shape
    d = xf.shape[1]
    E, C = w_gate.shape[0], capacity
    key, groups = idx, E
    if E != cfg.n_experts:  # another rank's experts: a last group, dropped
        local = idx - e0
        key, groups = torch.where((local >= 0) & (local < E), local, E), E + 1
    tok, pos = dispatch(key, groups, points, C)
    n_slots = E * points * C
    tok, pos = tok[:n_slots], torch.where(pos < n_slots, pos, -1)
    # combine weight of each slot, in x's dtype (0 for a slot no pair took;
    # a dropped pair's weight goes to a last dump slot)
    dump = torch.where(pos >= 0, pos, n_slots).reshape(-1)
    cw = torch.zeros(n_slots + 1, dtype=xf.dtype, device=xf.device).scatter(
        0, dump, w.reshape(-1))[:n_slots]
    xg = xf.index_select(0, tok).reshape(E, points * C, d)
    g = torch.bmm(xg, w_gate)
    u = torch.bmm(xg, w_up)
    del xg
    h = F.silu(g) * u
    del g, u
    y = torch.bmm(h, w_down).reshape(n_slots, d)
    del h
    y = y * cw[:, None]
    # each token's slots in slot order (by expert id), as the reference's
    # scatter-add into zeros takes them; a dropped pair adds 0
    pos_e = torch.gather(pos, 1, torch.argsort(idx, dim=-1))
    out = torch.zeros_like(xf)
    for j in range(k):
        pj = pos_e[:, j]
        out += y.index_select(0, pj.clamp_min(0)) * (pj >= 0).to(y.dtype)[:, None]
    return out


def _experts_on_mesh(cfg: ModelConfig, params: dict, xf, idx, w, *, n_seq: int, points: int,
                     capacity: int | None, ctx) -> torch.Tensor:
    """`_experts` on each rank's local shards (module docstring): returns
    ``[T, d]``, a partial sum over 'model' where the experts are sharded
    over it."""
    E = cfg.n_experts
    # the tokens stay split over the batch axes where a rank's rows are whole
    # points (or one point, points=1, each rank's tokens routed on their
    # own); else every rank takes all of them (gathered on entry)
    split = n_seq % ctx.n_data == 0 and (points == 1 or points % ctx.n_data == 0)
    n_loc = ctx.n_data if split else 1
    p_loc = max(points // n_loc, 1)
    T_loc = xf.shape[0] // n_loc
    C = capacity_of(cfg, T_loc // p_loc) if capacity is None else capacity
    ep = E % ctx.n_model == 0
    E_loc = E // ctx.n_model if ep else E
    e0 = ctx.coordinate["model"] * E_loc if ep else 0
    tok_spec = P(ctx.batch_axes if split else None, None)
    w_spec = P("model" if ep else None, None, None)  # gathered over 'data' on entry
    tok_grad = ctx.partial_over(tok_spec, "model") if ep else tok_spec
    w_grad = ctx.partial_over(w_spec, *ctx.batch_axes) if split else w_spec

    def body(xl, il, wl, g, u, dn):
        return _experts(cfg, xl, il, wl, g, u, dn, points=p_loc, capacity=C, e0=e0)

    return ctx.local_map(body, tok_grad, (tok_spec,) * 3 + (w_spec,) * 3,
                         in_grad_specs=(tok_grad, tok_spec, tok_grad) + (w_grad,) * 3)(
        xf, idx, w, params["w_gate"], params["w_up"], params["w_down"])


def moe_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *, points: int = 1,
              capacity: int | None = None, ctx=None):
    """Returns (y [B,S,d], aux). x's B sequences are `points` points of
    B / points sequences each, each routed on its own (module docstring);
    `capacity` (slots per expert and point) defaults to `capacity_of` one
    point's tokens (on a mesh: of one point's tokens on a rank). `ctx`: the
    mesh of DTensor weights and x (module docstring)."""
    B, S, d = x.shape
    if points < 1 or B % points:
        raise ValueError(f"moe_block: {B} sequences do not split into {points} points")
    k = cfg.top_k
    w, idx, aux = router_topk(cfg, params, x)
    T = B * S
    xf, idx, w = x.reshape(T, d), idx.reshape(T, k), w.reshape(T, k)
    if ctx is not None:
        out = _experts_on_mesh(cfg, params, xf, idx, w, n_seq=B, points=points,
                               capacity=capacity, ctx=ctx)
    else:
        C = capacity_of(cfg, T // points) if capacity is None else capacity
        out = _experts(cfg, xf, idx, w, params["w_gate"], params["w_up"], params["w_down"],
                       points=points, capacity=C)
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp(params["shared"], x)
    return out, aux
