// The SWE step's arithmetic shared by the whole-wave solve (swe_solve.cu) and
// its adjoint (swe_solve_vjp.cu), so that the adjoint's recomputed states are
// the solve's own, bit for bit: the desingularized velocity, the Rusanov face
// flux with hydrostatic reconstruction and torch.maximum's NaN rule, term by
// term in the order of src/repro_torch/kernels/swe/ref.py::swe_step_ref. Both
// sources are built with -fmad=false and IEEE sqrtf and division.
#pragma once

__device__ __forceinline__ float pow4(float x) {
  const float x2 = x * x;  // (x^2)^2, as jax.lax.integer_pow lowers x**4
  return x2 * x2;
}

// desingularized velocity (no division blow-up at the shoreline). A zero
// numerator (a cell at rest) gives its own signed zero, which is what the
// division gives (the denominator is at least h_dry^2 > 0), without the IEEE
// division's slow path for a zero dividend.
__device__ __forceinline__ float velocity(float h, float hu, float h_dry) {
  const float sqrt2 = 1.41421356237309515f;
  const float num = sqrt2 * h * hu;
  const float den = sqrtf(pow4(h) + pow4(fmaxf(h, h_dry)));
  return num == 0.0f ? num : num / den;
}

// sqrtf(x), with a zero (a dry face) returned as it is, as sqrtf returns it,
// without the IEEE square root's slow path for zero
__device__ __forceinline__ float sqrt_or_zero(float x) {
  return x == 0.0f ? x : sqrtf(x);
}

struct Face {
  float Fh;  // mass flux
  float A;   // momentum flux + well-balanced correction, seen from the left cell
  float B;   // the same, seen from the right cell
};

// Rusanov flux with hydrostatic reconstruction at the face between a left
// cell (hl, ul, bl) and a right cell (hr, ur, br); as in swe_step.cu.
__device__ __forceinline__ Face face(float hl, float ul, float bl, float hr,
                                     float ur, float br, float g) {
  const float hg = 0.5f * g;
  const float bstar = fmaxf(bl, br);
  const float hsL = fmaxf(hl + bl - bstar, 0.0f);
  const float hsR = fmaxf(hr + br - bstar, 0.0f);
  const float mL = hsL * ul;
  const float mR = hsR * ur;
  const float a =
      fmaxf(fabsf(ul) + sqrt_or_zero(g * hsL), fabsf(ur) + sqrt_or_zero(g * hsR));
  Face f;
  f.Fh = 0.5f * (mL + mR) - 0.5f * a * (hsR - hsL);
  const float Fq =
      0.5f * ((mL * ul + hg * hsL * hsL) + (mR * ur + hg * hsR * hsR)) -
      0.5f * a * (mR - mL);
  f.A = Fq + hg * (hl * hl - hsL * hsL);
  f.B = Fq + hg * (hr * hr - hsR * hsR);
  return f;
}

// torch.maximum(a, b): NaN if either is NaN, else the larger (a on a tie)
__device__ __forceinline__ float maximum_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? b : a;
}

