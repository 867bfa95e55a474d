// A whole tsunami wave in one launch: all n_steps forward-Euler steps of the
// 1-D shallow-water equations on a [cells, batch] float32 state, with the
// buoy observables (max free surface, first arrival step) reduced inside the
// time loop, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/swe/swe.py::swe_step_kernel (one Pallas launch
// per step) together with the jax.lax.scan around it in
// src/repro/apps/tsunami.py::_solve_batch (the step body, the in-scan buoy
// reduction and the scan itself). The step's arithmetic is exactly that of
// swe_step.cu and src/repro_torch/kernels/swe/ref.py::swe_step_ref, term by
// term and in the same order; the buoy reduction is exactly that of
// ref.py::swe_solve_ref: eta = h[r] - h0[r], mx = maximum(mx, eta) with
// NaN propagating as in torch.maximum, and arr = the first step index
// (float32) at which |eta| > thresh.
//
// What bounds it on this card: the work is ~67 float operations per
// (cell, lane, step), so a coarse 16-lane wave (512 x 16 x 2,224) is 1.2e9
// operations, 18 us at the float32 peak, and a fine one (2,048 x 16 x 8,899)
// 2.0e10, 0.29 ms; the bytes (the state read once, [R, N] written once) are
// negligible. But lanes are few: at 16 lanes only 16 of the 132 SMs have
// work, and every step is a chain of dependent phases (a face needs its
// neighbours' velocities, a cell its neighbour face), so a step costs the
// latency of two block barriers and of the IEEE sqrt and division chains,
// not the throughput of the SM. That latency times n_steps is the wave's
// time; the per-step launch (and the host work around it) that the step
// kernel paid is gone.
//
// What the design does about it: lanes are independent and the stencil only
// couples neighbouring cells of one lane, so one block owns one lane for the
// whole solve and nothing leaves the SM between steps. Thread t owns cells
// t, t + T, ... (T = min(1024, C rounded up to a warp), CPT = ceil(C / T)
// cells each) and keeps their h, hu, u, b and its own face terms in
// registers; shared memory holds what neighbours read: h and u per cell, and
// the face terms Fh and B per face (4 C floats, 32 KB at 2,048 cells, the
// fine level: C <= 2,048, so CPT <= 2). Device
// memory is read once at the start and [R, N] is written once at the end.
// A step is two phases: (1) every face once (owner of its left cell): Fh, A,
// B; barrier; (2) every cell: divergence from its own face and its left
// neighbour's, limiter, update in place, and the new velocity; barrier.
// Computing each face once, where swe_step.cu computes each twice, gives the
// same bits: the same expression on the same inputs. After (2) threads 0
// and 1 read the new h of the two buoy rows r0 and r1. Built with
// -fmad=false and IEEE sqrtf and division (no fast math), so the solve
// equals the plain PyTorch loop bit for bit. Splitting a fine column over a
// thread block cluster (halo cells through distributed shared memory) would
// shorten each step's chain; that is a later redesign (ROADMAP queue 2).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRows = 2;  // buoy rows a solve reduces (wrapper: N_ROWS)

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
// cell (hl, ul, bl) and a right cell (hr, ur, br); as in swe_step.cu.
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

// torch.maximum(a, b): NaN if either is NaN, else the larger (a on a tie)
__device__ __forceinline__ float maximum_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? b : a;
}

template <int CPT>
__global__ void __launch_bounds__(kMaxThreads)
    swe_solve_kernel(const float* __restrict__ h, const float* __restrict__ hu,
                     const float* __restrict__ b,
                     const float* __restrict__ h0_rows,
                     float* __restrict__ mx_out, float* __restrict__ arr_out,
                     int C, int N, int n_steps, int r0, int r1,
                     float dt_dx, float g, float h_dry, float thresh) {
  extern __shared__ float smem[];
  float* sh_h = smem;           // [C] depth after the last update
  float* sh_u = smem + C;       // [C] velocity of that state
  float* sh_Fh = smem + 2 * C;  // [C - 1] mass flux per face
  float* sh_B = smem + 3 * C;   // [C - 1] momentum term seen from the right

  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const float hg = 0.5f * g;

  float hc[CPT], huc[CPT], uc[CPT], bc[CPT], br[CPT], Fh[CPT], A[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int i = t + k * T;
    if (i < C) {
      const long long idx = (long long)i * N + lane;
      hc[k] = h[idx];
      huc[k] = hu[idx];
      bc[k] = b[i];
      br[k] = (i + 1 < C) ? b[i + 1] : 0.0f;
      uc[k] = velocity(hc[k], huc[k], h_dry);
      sh_h[i] = hc[k];
      sh_u[i] = uc[k];
    }
  }
  // buoy slot t (threads 0 and 1): its row, depth at rest and reductions
  const int row = t == 0 ? r0 : (t == 1 ? r1 : -1);
  const float h0 = t < kRows ? h0_rows[t] : 0.0f;
  float mx = __int_as_float(0xff800000);  // -inf
  float arr = -1.0f;
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    // (1) each face once, by the owner of its left cell
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int i = t + k * T;
      if (i < C - 1) {
        const Face f = face(hc[k], uc[k], bc[k], sh_h[i + 1], sh_u[i + 1], br[k], g);
        Fh[k] = f.Fh;
        A[k] = f.A;
        sh_Fh[i] = f.Fh;
        sh_B[i] = f.B;
      }
    }
    __syncthreads();
    // (2) divergence, limiter and update of each cell, in place
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int i = t + k * T;
      if (i < C) {
        float div_h, div_hu;
        if (i == 0) {
          // reflective left wall: zero mass flux, hydrostatic pressure g/2 h^2
          div_h = Fh[k];
          div_hu = A[k] - hg * (hc[k] * hc[k]);
        } else if (i == C - 1) {
          // reflective right wall
          div_h = -sh_Fh[i - 1];
          div_hu = hg * (hc[k] * hc[k]) - sh_B[i - 1];
        } else {
          div_h = Fh[k] - sh_Fh[i - 1];
          div_hu = A[k] - sh_B[i - 1];
        }
        // positivity / dry-cell limiter, applied last
        const float h_new = fmaxf(hc[k] - dt_dx * div_h, 0.0f);
        const float hu_new = (h_new > h_dry) ? (huc[k] - dt_dx * div_hu) : 0.0f;
        hc[k] = h_new;
        huc[k] = hu_new;
        uc[k] = velocity(h_new, hu_new, h_dry);
        sh_h[i] = h_new;
        sh_u[i] = uc[k];
      }
    }
    __syncthreads();
    // buoy reduction of step s; sh_h is not written again before the next
    // step's barrier
    if (row >= 0) {
      const float eta = sh_h[row] - h0;
      mx = maximum_nan(mx, eta);
      if (fabsf(eta) > thresh && arr < 0.0f) arr = (float)s;
    }
  }
  if (t < kRows) {
    mx_out[(long long)t * N + lane] = mx;
    arr_out[(long long)t * N + lane] = arr;
  }
}

template <int CPT>
int launch(const float* h, const float* hu, const float* b,
           const float* h0_rows, float* mx, float* arr, int C, int N,
           int n_steps, int r0, int r1, float dt_dx, float g, float h_dry,
           float thresh, int threads, cudaStream_t stream) {
  // 4 C floats: 32 KB at most, within the 48 KB a launch gets by default
  const size_t smem = 4 * (size_t)C * sizeof(float);
  swe_solve_kernel<CPT><<<N, threads, smem, stream>>>(
      h, hu, b, h0_rows, mx, arr, C, N, n_steps, r0, r1, dt_dx, g, h_dry,
      thresh);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. h, hu: [C, N] row-major; b: [C];
// h0_rows: [2], the depths at rest of buoy rows r0 and r1; mx, arr: [2, N]
// outputs. Launches on `stream` and returns cudaGetLastError() (0 on
// success); it never synchronises. The wrapper checks the arguments; this
// rejects what the kernel cannot take (2 <= C <= 2048, N >= 1,
// 0 <= n_steps, r0 and r1 in [0, C)).
extern "C" int swe_solve_f32(const float* h, const float* hu, const float* b,
                             const float* h0_rows, float* mx, float* arr,
                             int C, int N, int n_steps, int r0, int r1,
                             float dt_dx, float g, float h_dry, float thresh,
                             void* stream) {
  if (C < 2 || C > 2 * kMaxThreads || N < 1 || n_steps < 0 || r0 < 0 ||
      r0 >= C || r1 < 0 || r1 >= C)
    return (int)cudaErrorInvalidValue;
  const int threads = C < kMaxThreads ? (C + 31) / 32 * 32 : kMaxThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C <= threads)
    return launch<1>(h, hu, b, h0_rows, mx, arr, C, N, n_steps, r0, r1, dt_dx,
                     g, h_dry, thresh, threads, s);
  return launch<2>(h, hu, b, h0_rows, mx, arr, C, N, n_steps, r0, r1, dt_dx, g,
                   h_dry, thresh, threads, s);
}
