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
// and does ~60 float operations per cell-lane. At the main path's shapes
// ([512, N] and [2048, N] with N = 4..512) that is at most 2048*512*16 B =
// 16.8 MB, about 5 us at 3.35 TB/s, and at [2048, 64] only 2.1 MB, about
// 0.6 us: far below the few microseconds one kernel launch costs. So the
// step is bound by launch overhead, not by bytes or operations.
//
// What the design does about it: the Pallas version tiles the batch axis
// and keeps the whole cell axis of a tile in VMEM. A TPU-shaped column tile
// would leave most of the 132 SMs idle at these narrow waves, so here every
// (cell i, lane n) gets its own thread: C*N threads, lanes adjacent so the
// loads of the row-major [C, N] arrays coalesce. Each thread reads h, hu
// and b at i-1, i, i+1 and evaluates the two faces (i-1, i) and (i, i+1)
// itself, with the same expressions in the same order as the plain version;
// neighbouring threads therefore compute bit-identical face fluxes and mass
// stays conserved, with no shared memory and no second pass. It is built
// with -fmad=false so no multiply-add is contracted and the rounding matches
// the eager plain version op for op. The launch overhead itself is left to
// the persistent whole-solve kernel (one launch per wave, ROADMAP queue 2,
// item 1b).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float pow4(float x) {
  const float x2 = x * x;  // (x^2)^2, as jax.lax.integer_pow lowers x**4
  return x2 * x2;
}

// desingularized velocity (no division blow-up at the shoreline)
__device__ __forceinline__ float velocity(float h, float hu, float h_dry) {
  const float sqrt2 = 1.41421356237309515f;
  return sqrt2 * h * hu / sqrtf(pow4(h) + pow4(fmaxf(h, h_dry)));
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
  const float a = fmaxf(fabsf(ul) + sqrtf(g * hsL), fabsf(ur) + sqrtf(g * hsR));
  Face f;
  f.Fh = 0.5f * (mL + mR) - 0.5f * a * (hsR - hsL);
  const float Fq =
      0.5f * ((mL * ul + hg * hsL * hsL) + (mR * ur + hg * hsR * hsR)) -
      0.5f * a * (mR - mL);
  f.A = Fq + hg * (hl * hl - hsL * hsL);
  f.B = Fq + hg * (hr * hr - hsR * hsR);
  return f;
}

__global__ void swe_step_kernel(const float* __restrict__ h,
                                const float* __restrict__ hu,
                                const float* __restrict__ b,
                                float* __restrict__ h_out,
                                float* __restrict__ hu_out, int C, int N,
                                float dt_dx, float g, float h_dry) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * N) return;
  const int i = (int)(idx / N);
  const float hc = h[idx];
  const float huc = hu[idx];
  const float bc = b[i];
  const float uc = velocity(hc, huc, h_dry);
  const float hg = 0.5f * g;

  float div_h, div_hu;
  if (i == 0) {
    // reflective left wall: zero mass flux, hydrostatic pressure g/2 h^2
    const float hr = h[idx + N];
    const Face fr = face(hc, uc, bc, hr, velocity(hr, hu[idx + N], h_dry),
                         b[i + 1], g);
    div_h = fr.Fh;
    div_hu = fr.A - hg * (hc * hc);
  } else if (i == C - 1) {
    // reflective right wall
    const float hl = h[idx - N];
    const Face fl = face(hl, velocity(hl, hu[idx - N], h_dry), b[i - 1], hc,
                         uc, bc, g);
    div_h = -fl.Fh;
    div_hu = hg * (hc * hc) - fl.B;
  } else {
    const float hl = h[idx - N];
    const float hr = h[idx + N];
    const Face fl = face(hl, velocity(hl, hu[idx - N], h_dry), b[i - 1], hc,
                         uc, bc, g);
    const Face fr = face(hc, uc, bc, hr, velocity(hr, hu[idx + N], h_dry),
                         b[i + 1], g);
    div_h = fr.Fh - fl.Fh;
    div_hu = fr.A - fl.B;
  }
  // positivity / dry-cell limiter, applied last
  const float h_new = fmaxf(hc - dt_dx * div_h, 0.0f);
  h_out[idx] = h_new;
  hu_out[idx] = (h_new > h_dry) ? (huc - dt_dx * div_hu) : 0.0f;
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int swe_step_f32(const float* h, const float* hu, const float* b,
                            float* h_out, float* hu_out, int C, int N,
                            float dt_dx, float g, float h_dry, void* stream) {
  const int threads = 256;
  const long long total = (long long)C * N;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  swe_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      h, hu, b, h_out, hu_out, C, N, dt_dx, g, h_dry);
  return (int)cudaGetLastError();
}
