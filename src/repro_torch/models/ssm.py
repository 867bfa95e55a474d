"""Mamba-2 (SSD — state-space duality) block (counterpart of
`repro.models.ssm`).

Chunked algorithm (Dao & Gu, arXiv:2405.21060): the sequence is processed in
chunks of length Q with a loop carrying the inter-chunk SSM state
[B, g, r, N, P]; within a chunk the quadratic 'dual' form is a few batched
matrix products. `ssd_scan` is that plain path in torch ops (the JAX
package's XLA path); `ssm_block(use_kernel=True)` runs the hand-written CUDA
kernel through `repro_torch.kernels.ssd` instead.

Head layout: nh heads of dim P, grouped into g groups sharing B/C (r = nh/g
heads per group). `ssm_decode` is the single-token recurrent step of the
serving loop, plain PyTorch as the JAX package's is plain XLA; it updates
the caller's conv window and state in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import rmsnorm_scaleless
from repro_torch.models.params import ParamDecl
from repro_torch.types import ModelConfig

# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def decl_ssm(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, ns, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    proj_out = 2 * di + 2 * g * ns + nh  # z, xBC, dt
    return {
        "in_proj": ParamDecl((d, proj_out), P("data", "model")),
        "conv_w": ParamDecl((cfg.ssm_conv, conv_dim(cfg)), P(None, "model"), scale=0.1),
        "conv_b": ParamDecl((conv_dim(cfg),), P("model"), init="zeros"),
        "A_log": ParamDecl((nh,), P("model"), init="a_log", dtype="float32"),
        "D": ParamDecl((nh,), P("model"), init="ones", dtype="float32"),
        "dt_bias": ParamDecl((nh,), P("model"), init="dt_bias", dtype="float32"),
        "norm_scale": ParamDecl((di,), P("model"), init="ones", dtype="float32"),
        "out_proj": ParamDecl((di, d), P("model", "data")),
    }


# ---------------------------------------------------------------------------
# Depthwise causal conv (k small; expressed as shifted adds)
# ---------------------------------------------------------------------------


def causal_conv(params: dict, x: torch.Tensor, conv_state: torch.Tensor | None = None):
    """x: [B, S, C]; conv_state: [B, k-1, C] tail of the previous segment."""
    w, b = params["conv_w"], params["conv_b"]
    k = w.shape[0]
    S = x.shape[1]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = xp[:, 0:S, :] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i : i + S, :] * w[i].to(x.dtype)
    y = F.silu(y + b.to(x.dtype))
    return y, xp[:, -(k - 1) :, :]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _split_heads(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    g = cfg.ssm_ngroups
    return x.reshape(B, S, g, cfg.ssm_nheads // g, cfg.ssm_headdim)


def ssd_chunk_body(state, x_c, dt_c, B_c, C_c, A):
    """One SSD chunk: returns (new_state, y_c). All math in fp32.
    state [B,g,r,N,P]; x_c [B,Q,g,r,P]; dt_c [B,Q,g,r] (post-softplus);
    B_c, C_c [B,Q,g,N]; A [g,r] (negative)."""
    dA = dt_c * A  # [B,Q,g,r]
    cum = torch.cumsum(dA, dim=1)  # [B,Q,g,r]
    total = cum[:, -1]  # [B,g,r]

    # intra-chunk (dual quadratic form)
    cum_t = torch.movedim(cum, 1, -1)  # [B,g,r,Q]
    Q = x_c.shape[1]
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x_c.device))
    # masked before the exp: above the diagonal cum_i - cum_j > 0 can
    # overflow to inf, and exp's backward would then give 0 * inf = NaN
    # there (the same values forward: exp(-inf) = 0)
    seg = (cum_t[..., :, None] - cum_t[..., None, :]).masked_fill(~causal, float("-inf"))
    L = torch.exp(seg)
    CB = torch.einsum("bign,bjgn->bgij", C_c, B_c)
    dtj = torch.movedim(dt_c, 1, -1)  # [B,g,r,Q] indexed by j
    scores = CB[:, :, None] * L * dtj[..., None, :]  # [B,g,r,i,j]
    y_intra = torch.einsum("bgrij,bjgrp->bigrp", scores, x_c)

    # inter-chunk contribution from the carried state
    y_inter = torch.einsum("bign,bgrnp->bigrp", C_c, state)
    y_inter = y_inter * torch.exp(cum)[..., None]

    # state update
    decay_out = torch.exp(total[:, None] - cum)  # [B,Q,g,r]
    state_new = state * torch.exp(total)[..., None, None] + torch.einsum(
        "bjgn,bjgr,bjgrp->bgrnp", B_c, dt_c * decay_out, x_c
    )
    return state_new, y_intra + y_inter


def ssd_scan(cfg: ModelConfig, x, dt, Bm, Cm, A, init_state=None):
    """The plain chunked scan, chunk `cfg.ssm_chunk`: x [B,S,g,r,P],
    dt [B,S,g,r], Bm/Cm [B,S,g,N] (all fp32), A [g,r]. Returns
    (y [B,S,g,r,P], final state [B,g,r,N,P])."""
    B, S, g, r, Pdim = x.shape
    N = Bm.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    S_orig = S
    pad = (-S) % Q
    if pad:
        # zero-pad the tail; dt=0 there => no state decay, no contribution
        x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    state = init_state
    if state is None:
        state = torch.zeros(B, g, r, N, Pdim, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        state, y_c = ssd_chunk_body(state, x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], A)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    if pad:
        y = y[:, :S_orig]
    return y, state


def ssd_reference_sequential(x, dt, Bm, Cm, A, init_state=None):
    """O(S) sequential recurrence — slow oracle for tests."""
    B, S, g, r, Pdim = x.shape
    N = Bm.shape[-1]
    state = init_state
    if state is None:
        state = torch.zeros(B, g, r, N, Pdim, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        x_t, dt_t, B_t, C_t = x[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        dA = torch.exp(dt_t * A)  # [B,g,r]
        state = state * dA[..., None, None] + torch.einsum(
            "bgn,bgr,bgrp->bgrnp", B_t, dt_t, x_t
        )
        ys.append(torch.einsum("bgn,bgrnp->bgrp", C_t, state))
    return torch.stack(ys, dim=1), state


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------


def _in_proj_split(cfg: ModelConfig, params: dict, x: torch.Tensor, ctx=None):
    di, g, ns = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    zxbcdt = x @ params["in_proj"]
    if ctx is not None:  # TP over the projection's columns, forward and backward
        zxbcdt = ctx.fence(zxbcdt, "batch", None, "tp")
    return torch.split(zxbcdt, [di, di + 2 * g * ns, cfg.ssm_nheads], dim=-1)


def _ssm_pre(cfg: ModelConfig, params: dict, xBC: torch.Tensor, dt_raw: torch.Tensor):
    di, g, ns = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    x_ssm, B_mat, C_mat = torch.split(xBC, [di, g * ns, g * ns], dim=-1)
    Bn = B_mat.reshape(*B_mat.shape[:2], g, ns).float()
    Cn = C_mat.reshape(*C_mat.shape[:2], g, ns).float()
    r = cfg.ssm_nheads // g
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float()).reshape(*dt_raw.shape[:2], g, r)
    xh = _split_heads(cfg, x_ssm).float()
    A = -torch.exp(params["A_log"].float()).reshape(g, r)
    return xh, dt, Bn, Cn, A


def ssm_block(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,
    *,
    cache: dict | None = None,
    want_cache: bool = False,
    use_kernel: bool = False,
    ctx=None,
):
    """Full-sequence (train/prefill) Mamba-2 block. Returns (out, cache|None).
    On a mesh (`ctx`, DTensor inputs) the chunk scan, the kernel or the
    plain one, runs on each rank's local shard (`_ssd_local`)."""
    B, S, _ = x.shape
    z, xBC, dt_raw = _in_proj_split(cfg, params, x, ctx)
    conv_state = cache["conv"] if cache is not None else None
    xBC, conv_tail = causal_conv(params, xBC, conv_state)
    xh, dt, Bn, Cn, A = _ssm_pre(cfg, params, xBC, dt_raw)
    init_state = cache["state"] if cache is not None else None
    if ctx is not None:
        y, final_state = _ssd_local(cfg, ctx, xh, dt, Bn, Cn, A, init_state, use_kernel)
    elif use_kernel:
        y, final_state = ssd_ops.ssd(cfg, xh, dt, Bn, Cn, A, init_state)
    else:
        y, final_state = ssd_scan(cfg, xh, dt, Bn, Cn, A, init_state)
    D = params["D"].float().reshape(cfg.ssm_ngroups, -1)
    y = y + xh * D[None, None, :, :, None]
    y = _merge_heads(cfg, ctx, y).to(x.dtype)
    y = rmsnorm_scaleless(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"]
    new_cache = {"conv": conv_tail, "state": final_state} if want_cache else None
    return out, new_cache


def _merge_heads(cfg: ModelConfig, ctx, y):
    """``[B, S, g, r, P] -> [B, S, d_inner]``. On a mesh with one group and
    the heads over 'model', on each rank's local shard (`local_map`): a
    rank's heads are then one contiguous block of d_inner, where DTensor's
    own view gives a strided shard whose propagation into `out_proj` takes
    minutes."""
    B, S = y.shape[:2]
    r = cfg.ssm_nheads // cfg.ssm_ngroups
    if ctx is None or cfg.ssm_ngroups != 1 or r % ctx.n_model:
        return y.reshape(B, S, cfg.d_inner)
    bat = ctx.batch_axes if B % ctx.n_data == 0 else None
    return ctx.local_map(lambda yl: yl.flatten(2), P(bat, None, "model"),
                         (P(bat, None, None, "model", None),))(y)


def _ssd_local(cfg: ModelConfig, ctx, xh, dt, Bn, Cn, A, init_state, use_kernel: bool):
    """The chunk scan on each rank's local shard (`local_map`), the SSD
    kernel or `ssd_scan`: batch over the batch axes where B divides, the
    heads of each group over 'model' where they divide (the JAX package's
    `ssm.py` TP layout), B and C replicated over 'model' (their gradient a
    partial sum over it). The plain scan runs here too, not as DTensor
    operations: with a batch that the whole mesh does not divide, DTensor's
    propagation shards it unevenly over 'model' as well, and the backward
    of its einsums then fails on the ragged shards."""
    bat = ctx.batch_axes if xh.shape[0] % ctx.n_data == 0 else None
    r = "model" if xh.shape[3] % ctx.n_model == 0 else None
    x_spec, state_spec = P(bat, None, None, r, None), P(bat, None, r, None, None)
    bc_spec = P(bat, None, None, None)
    bc_grad = ctx.partial_over(bc_spec, "model") if r else bc_spec
    s_spec = None if init_state is None else state_spec
    scan = ssd_ops.ssd if use_kernel else ssd_scan

    def local(x_l, dt_l, b_l, c_l, a_l, s_l):
        return scan(cfg, x_l, dt_l, b_l, c_l, a_l, s_l)

    in_specs = (x_spec, P(bat, None, None, r), bc_spec, bc_spec, P(None, r), s_spec)
    # A is the same on every batch rank: its gradient a partial sum over them
    a_grad = ctx.partial_over(P(None, r), *ctx.batch_axes) if bat else P(None, r)
    return ctx.local_map(local, (x_spec, state_spec), in_specs,
                         in_grad_specs=in_specs[:2] + (bc_grad, bc_grad, a_grad, s_spec))(
        xh, dt, Bn, Cn, A, init_state)


def ssm_decode(cfg: ModelConfig, params: dict, x: torch.Tensor, cache: dict):
    """Single-token recurrent step: x ``[B, 1, d]`` against the cache
    ``{"conv": [B, k-1, C] (activation dtype), "state": [B, g, r, N, P]
    (float32)}``. One conv step over the window ``cat(conv, xBC)`` (the
    shifted adds of `causal_conv`, so a token's conv output rounds as the
    prefill's does), then ``state·exp(dt·A) + B⊗(dt·x)`` in float32,
    ``y = C·state + D·x``, the gated scaleless norm and `out_proj`. The
    window's last k-1 rows and the new state are written into the cache in
    place. Returns (out ``[B, 1, d]``, cache)."""
    B = x.shape[0]
    z, xBC, dt_raw = _in_proj_split(cfg, params, x)
    xBC, conv_tail = causal_conv(params, xBC, cache["conv"])
    cache["conv"].copy_(conv_tail)
    xh, dt, Bn, Cn, A = _ssm_pre(cfg, params, xBC, dt_raw)
    x_t, dt_t, B_t, C_t = xh[:, 0], dt[:, 0], Bn[:, 0], Cn[:, 0]
    state = cache["state"] * torch.exp(dt_t * A)[..., None, None] + torch.einsum(
        "bgn,bgr,bgrp->bgrnp", B_t, dt_t, x_t)
    cache["state"].copy_(state)
    y_t = torch.einsum("bgn,bgrnp->bgrp", C_t, state)
    D = params["D"].float().reshape(cfg.ssm_ngroups, -1)
    y_t = y_t + x_t * D[None, :, :, None]
    y = y_t.reshape(B, 1, cfg.d_inner).to(x.dtype)
    y = rmsnorm_scaleless(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    return y @ params["out_proj"], cache
