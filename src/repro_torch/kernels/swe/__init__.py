from repro_torch.kernels.swe.ops import SweSolve, swe_solve, swe_solve_vjp, swe_step
from repro_torch.kernels.swe.ref import (
    swe_solve_ref,
    swe_solve_vjp_ref,
    swe_step_ref,
    swe_step_ref_into,
    swe_step_vjp_ref,
)

__all__ = ["SweSolve", "swe_solve", "swe_solve_ref", "swe_solve_vjp", "swe_solve_vjp_ref",
           "swe_step", "swe_step_ref", "swe_step_ref_into", "swe_step_vjp_ref"]
