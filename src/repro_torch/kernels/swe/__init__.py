from repro_torch.kernels.swe.ops import swe_solve, swe_step
from repro_torch.kernels.swe.ref import swe_solve_ref, swe_step_ref, swe_step_ref_into

__all__ = ["swe_solve", "swe_solve_ref", "swe_step", "swe_step_ref", "swe_step_ref_into"]
