from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm_fused", "rmsnorm_ref"]
