"""Plain PyTorch version of the fused RMSNorm kernel (counterpart of the
oracle `repro.kernels.rmsnorm.ref.rmsnorm_ref`, the same operations in the
same order). `ops.rmsnorm_fused` takes it for CPU tensors, and
`chip_smoke.py` holds the CUDA kernel against it."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x [..., d]``, ``w [d]`` -> ``x · rsqrt(mean(x²) + eps) · w``,
    reduced in float32, returned in x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
