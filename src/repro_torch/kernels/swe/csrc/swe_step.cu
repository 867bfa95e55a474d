// One forward-Euler finite-volume step of the 1-D shallow-water equations
// on a [cells, batch] float32 state, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/swe/swe.py::swe_step_kernel (Pallas body
// `_swe_step_kernel`); the arithmetic is exactly
// src/repro_torch/kernels/swe/ref.py::swe_step_ref (which mirrors
// src/repro/kernels/swe/ref.py::swe_step_ref): desingularized velocity,
// Audusse hydrostatic reconstruction against max(bL, bR), Rusanov flux,
// well-balanced momentum correction, reflective walls, and the limiter
// that zeroes hu where h <= h_dry.
//
// What bounds it on this card: each step must move at least 16 B per
// cell-lane (h and hu read once, written once; b is [C] and stays in L1/L2)
// and does ~67 float operations per cell-lane, among them one IEEE division
// and three IEEE square roots (a velocity and a face). At the widest
// main-path shapes the bytes bound it: 16.8 MB at [2048, 512], 5.0 us at
// 3.35 TB/s; 4.2 MB at [512, 512], 1.25 us. At the narrow shapes ([C, N]
// with N = 4..64) the bytes take 0.01-0.6 us, below the ~2.7 us that one
// launch of the smallest step, [2, 1], takes back to back on an H100
// (PERF.md): there that floor, not bytes or operations, sets the time.
//
// What the design does about it: the Pallas version tiles the batch axis
// and keeps the whole cell axis of a tile in VMEM. Here one thread owns a
// strip of T consecutive cells of one lane (T = 1, 2, 4 or 8, a template
// parameter; the wrapper's plan, ops.py::_strip_plan, picks it from the
// shape so that narrow waves still give enough threads to fill the SMs).
// Threads of a warp take neighbouring lanes, so every load and store of the
// row-major [C, N] arrays is coalesced across lanes. A thread loads its T
// cells and one neighbour on each side (clamped into the column, so every
// load is unconditional and all of them are in flight at once), evaluates
// each of the T + 2 velocities once and each of the T + 1 faces once,
// carrying the left face down the strip in registers, and updates its
// cells: per cell 1 + 2/T velocities and 1 + 1/T faces, where one thread a
// cell evaluated 3 velocities and 2 faces (3 divisions, 7 square roots). A
// face on a strip boundary is computed by both neighbouring threads, with
// the same expressions on the same inputs, so both get the same bits and
// mass stays conserved. Built with -fmad=false and IEEE sqrtf and
// division, with the expressions of swe_step_ref in its order, so the step
// equals the eager plain version bit for bit at every strip depth; the walls
// and the dry-cell limiter come last, as there. A zero numerator of the
// velocity and a zero argument of a face's square root are returned as they
// are (what the IEEE operation gives, without its slow path for zero), as
// swe_solve.cu does. The launch overhead itself is left to the persistent
// whole-solve kernel, swe_solve.cu (one launch per wave).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pow4(float x) {
  const float x2 = x * x;  // (x^2)^2, as jax.lax.integer_pow lowers x**4
  return x2 * x2;
}

// desingularized velocity (no division blow-up at the shoreline); a zero
// numerator gives its own signed zero, which is what the division gives
// (the denominator is at least h_dry^2 > 0)
__device__ __forceinline__ float velocity(float h, float hu, float h_dry) {
  const float sqrt2 = 1.41421356237309515f;
  const float num = sqrt2 * h * hu;
  const float den = sqrtf(pow4(h) + pow4(fmaxf(h, h_dry)));
  return num == 0.0f ? num : num / den;
}

// sqrtf(x), with a zero (a dry face) returned as it is, as sqrtf returns it
__device__ __forceinline__ float sqrt_or_zero(float x) {
  return x == 0.0f ? x : sqrtf(x);
}

struct Face {
  float Fh;  // mass flux
  float A;   // momentum flux + well-balanced correction, seen from the left cell
  float B;   // the same, seen from the right cell
};

// Rusanov flux with hydrostatic reconstruction at the face between a left
// cell (hl, ul, bl) and a right cell (hr, ur, br). Operation order follows
// swe_step_ref term by term.
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

// Thread (s, n) owns cells [s T, min(s T + T, C)) of lane n.
template <int T>
__global__ void __launch_bounds__(kThreads)
swe_step_kernel(const float* __restrict__ h, const float* __restrict__ hu,
                const float* __restrict__ b, float* __restrict__ h_out,
                float* __restrict__ hu_out, int C, int N, long long n_threads, float dt_dx,
                float g, float h_dry) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_threads) return;
  const int s = (int)(idx / N);
  const int n = (int)(idx - (long long)s * N);
  const int i0 = s * T;
  const float hg = 0.5f * g;

  // extended cell m is cell i0 - 1 + m, clamped into [0, C): the strip's T
  // cells (m = 1..T) and a neighbour on each side
  float hh[T + 2], qq[T + 2], bb[T + 2], uu[T + 2];
#pragma unroll
  for (int m = 0; m < T + 2; ++m) {
    const int i = min(max(i0 - 1 + m, 0), C - 1);
    const long long at = (long long)i * N + n;
    hh[m] = h[at];
    qq[m] = hu[at];
    bb[m] = b[i];
  }
#pragma unroll
  for (int m = 0; m < T + 2; ++m) uu[m] = velocity(hh[m], qq[m], h_dry);

  // face m - 1 | m, carried down the strip
  Face left = face(hh[0], uu[0], bb[0], hh[1], uu[1], bb[1], g);
#pragma unroll
  for (int m = 1; m <= T; ++m) {
    const Face right = face(hh[m], uu[m], bb[m], hh[m + 1], uu[m + 1], bb[m + 1], g);
    const int i = i0 - 1 + m;
    if (i < C) {
      const float hc = hh[m];
      float div_h, div_hu;
      if (i == 0) {
        // reflective left wall: zero mass flux, hydrostatic pressure g/2 h^2
        div_h = right.Fh;
        div_hu = right.A - hg * (hc * hc);
      } else if (i == C - 1) {
        // reflective right wall
        div_h = -left.Fh;
        div_hu = hg * (hc * hc) - left.B;
      } else {
        div_h = right.Fh - left.Fh;
        div_hu = right.A - left.B;
      }
      // positivity / dry-cell limiter, applied last
      const float h_new = fmaxf(hc - dt_dx * div_h, 0.0f);
      const long long at = (long long)i * N + n;
      h_out[at] = h_new;
      hu_out[at] = (h_new > h_dry) ? (qq[m] - dt_dx * div_hu) : 0.0f;
    }
    left = right;
  }
}

template <int T>
int launch(const float* h, const float* hu, const float* b, float* h_out, float* hu_out, int C,
           int N, float dt_dx, float g, float h_dry, void* stream) {
  const long long n_threads = (long long)((C + T - 1) / T) * N;
  const long long blocks = (n_threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swe_step_kernel<T><<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      h, hu, b, h_out, hu_out, C, N, n_threads, dt_dx, g, h_dry);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. `strip` is the cells a thread owns (1,
// 2, 4 or 8; ops.py::_strip_plan). Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int swe_step_f32(const float* h, const float* hu, const float* b,
                            float* h_out, float* hu_out, int C, int N,
                            float dt_dx, float g, float h_dry, int strip, void* stream) {
  if (C < 2 || N < 1) return (int)cudaErrorInvalidValue;
  switch (strip) {
    case 1: return launch<1>(h, hu, b, h_out, hu_out, C, N, dt_dx, g, h_dry, stream);
    case 2: return launch<2>(h, hu, b, h_out, hu_out, C, N, dt_dx, g, h_dry, stream);
    case 4: return launch<4>(h, hu, b, h_out, hu_out, C, N, dt_dx, g, h_dry, stream);
    case 8: return launch<8>(h, hu, b, h_out, hu_out, C, N, dt_dx, g, h_dry, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
