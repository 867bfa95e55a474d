"""Plain PyTorch versions of the SSD chunk-scan kernel, in the kernel layout
``x [B,H,S,P]``, ``dt [B,H,S]`` (post-softplus), ``Bm, Cm [B,G,S,N]``,
``A [H]`` (negative), ``init_state [B,H,N,P]``.

* `ssd_ref`: the sequential O(S) recurrence, the oracle (counterpart of
  `repro.kernels.ssd.ref.ssd_ref`).
* `ssd_chunked_ref`: the kernel's own arithmetic in torch ops, chunk by
  chunk with Q = 128 (counterpart of the Pallas body
  `repro.kernels.ssd.ssd._ssd_kernel`). `ops.ssd_chunk_scan` takes it for
  CPU tensors, and `chip_smoke.py` holds the CUDA kernel against it.
"""
from __future__ import annotations

import torch

#: chunk length of the kernel and of `ssd_chunked_ref`
CHUNK = 128


def ssd_ref(x, dt, Bm, Cm, A, init_state):
    """Returns (y [B,H,S,P] in x's dtype, final state [B,H,N,P] float32)."""
    H, S = x.shape[1], x.shape[2]
    group = H // Bm.shape[1]
    Bh = Bm.repeat_interleave(group, dim=1)  # [B,H,S,N]
    Ch = Cm.repeat_interleave(group, dim=1)
    state = init_state.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, :, t] * A[None, :])  # [B,H]
        upd = torch.einsum("bhn,bh,bhp->bhnp", Bh[:, :, t], dt[:, :, t], x[:, :, t])
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, :, t], state))
    return torch.stack(ys, dim=2).to(x.dtype), state


def ssd_chunked_ref(x, dt, Bm, Cm, A, init_state):
    """The kernel's chunked dual form, chunks of `CHUNK` in order; S must be
    a multiple of CHUNK (the adapter `ops.ssd` pads). B and C are shared by
    the H / G heads of a group, so C B^T is formed once per group here (the
    kernel recomputes it per head: the same values). Returns (y [B,H,S,P],
    final state [B,H,N,P]), both float32."""
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    r = H // G
    Q = CHUNK
    if S % Q:
        raise ValueError(f"ssd_chunked_ref: S={S} is not a multiple of {Q}")
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    A_g = A.float().reshape(G, r)
    state = init_state.float().reshape(Bsz, G, r, N, P)
    y = torch.empty(Bsz, G, r, S, P, dtype=torch.float32, device=x.device)
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        x_c = x[:, :, sl].float().reshape(Bsz, G, r, Q, P)
        dt_c = dt[:, :, sl].float().reshape(Bsz, G, r, Q)
        B_c = Bm[:, :, sl].float()[:, :, None]  # [B,G,1,Q,N]
        C_c = Cm[:, :, sl].float()[:, :, None]
        cum = torch.cumsum(dt_c * A_g[None, :, :, None], dim=-1)  # [B,G,r,Q]
        total = cum[..., -1:]
        L = torch.exp(cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, 0.0)
        CB = C_c @ B_c.transpose(-1, -2)  # [B,G,1,Q,Q]
        scores = CB * L * dt_c[..., None, :]
        y_c = scores @ x_c + (C_c @ state) * torch.exp(cum)[..., None]
        decay_out = dt_c * torch.exp(total - cum)  # [B,G,r,Q]
        state = state * torch.exp(total)[..., None] + (
            B_c * decay_out[..., None]
        ).transpose(-1, -2) @ x_c
        y[:, :, :, sl] = y_c
    return y.reshape(Bsz, H, S, P), state.reshape(Bsz, H, N, P)
