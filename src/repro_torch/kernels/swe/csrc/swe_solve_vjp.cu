// The reverse mode of a whole tsunami wave in one launch, hand-written for
// Hopper (sm_90a): the cotangents (gh0, ghu0) of a wave's initial state for a
// cotangent of its running buoy max, through all n_steps steps of the 1-D
// shallow-water solve of swe_solve.cu.
//
// Replaces: no TPU kernel. The JAX package differentiates its lax.scan over a
// jax.checkpoint'ed step (src/repro/apps/tsunami.py:172-267, the scan body
// that src/repro/kernels/swe/swe.py:54 swe_step_kernel computes); XLA runs the
// reverse scan. This is the same adjoint, by hand: the transpose of one step,
// derived term by term from src/repro_torch/kernels/swe/ref.py::swe_step_ref
// with the JAX package's rules at the kinks (slope 1/2 at a tie of a maximum,
// slope 1 of |u| at u == 0, a wave speed's square root with slope
// 0.5 / max(sqrt, 1e-3), the wet mask as a select), in the expression order
// of ref.py::swe_step_vjp_ref, and the running max's reverse at the buoy rows
// in the order of ref.py::swe_solve_vjp_ref.
//
// Checkpoints: the forward (swe_solve.cu with a checkpoint pointer) keeps the
// state (h, hu) and the running max before every k-th step, ck [n_seg, 2, C,
// N] and ck_mx [n_seg, 2, N]. This kernel walks the segments from last to
// first: it loads a segment's checkpoint, recomputes its (at most k) steps
// with swe_solve.cu's own arithmetic (swe_math.cuh; built with -fmad=false
// and IEEE sqrtf and division, so each recomputed state is the forward's, bit
// for bit, and every kink branch is taken as the primal took it), writing
// each step's input to a global scratch [k, 2, C, N] and the buoy max before
// and the buoy height after each step to [k, 2, 2, N]; then it sweeps the
// segment's steps backwards. Both scratches come from the caller (the torch
// allocator: no cudaMalloc while a CUDA graph is captured).
//
// Layout: one block a lane, swe_solve.cu's cs = 1 layout: min(1,024, C
// rounded up to a warp) threads, thread t owning cells t, t + T (1 or 2 a
// thread). A reverse step is five phases with four block barriers:
//   (0) each cell's input from the scratch, its velocity; the buoy slots
//       (threads 0 and 1) split the running max's cotangent between the max
//       before the step and the buoy row's depth after it;
//   (1) every face once (the owner of its left cell): Fh, A, B, as forward;
//   (2) every cell: the divergence, the limiter's argument and the wet mask,
//       as forward; the buoy share added to the cotangent of the new depth;
//       the update's transpose into the divergences' cotangents;
//   (3) every face: the divergences' transpose into the face's Fh, A and B
//       cotangents (the walls at the ends), then the face's adjoint through
//       the wave speed, the reconstructed depths and the velocities; its
//       left cell's share stays in registers, its right cell's goes to
//       shared memory;
//   (4) every cell: the update's own term, its two faces' shares and the
//       walls' pressure in a fixed order, then the velocity's adjoint.
// No atomics: two calls give the same bits.
//
// What bounds it: as swe_solve.cu at cs = 1, the chain of dependent phases a
// step and the SMs' issue rate, about three forward steps of work a step
// (the recomputation, the reverse's own forward, the adjoint), plus the
// scratch's traffic, [k, 2, C, N] written and read once a segment (L2 for the
// main path's waves).
#include <cuda_runtime.h>

#include "swe_math.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRows = 2;  // buoy rows of a solve (wrapper: ops.N_ROWS)

// g times d max(x, y) / dx: g above, g / 2 at a tie, 0 below, as a select
__device__ __forceinline__ float tie(float x, float y, float g) {
  return x > y ? g : (x == y ? 0.5f * g : 0.0f);
}

// The adjoint of one face between a left cell (hl, ul, bl) and a right cell
// (hr, ur, br), given the cotangents of its Fh, A and B: the left cell's
// share of (gh, gu) in (ghl, gul), the right cell's in (ghr, gur). The
// forward quantities are recomputed as face() computes them.
__device__ __forceinline__ void face_vjp(float hl, float ul, float bl, float hr,
                                         float ur, float br, float g, float gFh,
                                         float gA, float gB, float& ghl, float& gul,
                                         float& ghr, float& gur) {
  const float bstar = fmaxf(bl, br);
  const float argL = hl + bl - bstar;
  const float argR = hr + br - bstar;
  const float hsL = fmaxf(argL, 0.0f);
  const float hsR = fmaxf(argR, 0.0f);
  const float mL = hsL * ul;
  const float mR = hsR * ur;
  const float rL = sqrt_or_zero(g * hsL);
  const float rR = sqrt_or_zero(g * hsR);
  const float cL = fabsf(ul) + rL;
  const float cR = fabsf(ur) + rR;
  const float a = fmaxf(cL, cR);

  const float gFq = gA + gB;
  ghl = g * hl * gA;
  ghr = g * hr * gB;
  float ghsL = -(g * hsL * gA);
  float ghsR = -(g * hsR * gB);
  // Fh = 0.5 (mL + mR) - 0.5 a (hsR - hsL)
  float ga = -0.5f * gFh * (hsR - hsL);
  float gmL = 0.5f * gFh;
  float gmR = 0.5f * gFh;
  ghsR = ghsR - 0.5f * a * gFh;
  ghsL = ghsL + 0.5f * a * gFh;
  // Fq = 0.5 ((mL uL + g/2 hsL^2) + (mR uR + g/2 hsR^2)) - 0.5 a (mR - mL)
  const float hq = 0.5f * gFq;
  gmL = gmL + hq * ul + 0.5f * a * gFq;
  gmR = gmR + hq * ur - 0.5f * a * gFq;
  gul = hq * mL;
  gur = hq * mR;
  ghsL = ghsL + hq * g * hsL;
  ghsR = ghsR + hq * g * hsR;
  ga = ga - 0.5f * gFq * (mR - mL);
  // m = hs u
  ghsL = ghsL + gmL * ul;
  gul = gul + gmL * hsL;
  ghsR = ghsR + gmR * ur;
  gur = gur + gmR * hsR;
  // a = max(|uL| + sqrt(g hsL), |uR| + sqrt(g hsR))
  const float gcL = tie(cL, cR, ga);
  const float gcR = tie(cR, cL, ga);
  gul = gul + (ul >= 0.0f ? gcL : -gcL);
  gur = gur + (ur >= 0.0f ? gcR : -gcR);
  ghsL = ghsL + g * (gcL * 0.5f / fmaxf(rL, 1e-3f));
  ghsR = ghsR + g * (gcR * 0.5f / fmaxf(rR, 1e-3f));
  // hs = max(h + b - bstar, 0)
  ghl = ghl + tie(argL, 0.0f, ghsL);
  ghr = ghr + tie(argR, 0.0f, ghsR);
}

template <int CPT>
__global__ void __launch_bounds__(kMaxThreads)
    swe_solve_vjp_kernel(const float* __restrict__ b,
                         const float* __restrict__ h0_rows,
                         const float* __restrict__ ck,
                         const float* __restrict__ ck_mx,
                         const float* __restrict__ cot_mx,
                         float* __restrict__ scr, float* __restrict__ bscr,
                         float* __restrict__ gh_out, float* __restrict__ ghu_out,
                         int C, int N, int n_steps, int k, int r0, int r1,
                         float dt_dx, float g, float h_dry) {
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const float hg = 0.5f * g;
  const float sqrt2 = 1.41421356237309515f;

  extern __shared__ float smem[];
  // two pairs of arrays, each reused once a reverse step (see the phases):
  // depth and velocity of the step's input, read by the left neighbour in
  // phase (1), then the divergences' cotangents, read by the left
  // neighbour in (3); the face terms Fh and B (face e | e + 1 at e + 1),
  // read in (2), then the right cells' shares of the faces' adjoints, read
  // in (4)
  float* sh_h = smem;                // [C] h, then the cotangent of div_h
  float* sh_u = smem + C;            // [C] u, then the cotangent of div_hu
  float* sh_Fh = smem + 2 * C;       // [C + 1] Fh, then a right cell's gh share
  float* sh_B = smem + 3 * C + 1;    // [C + 1] B, then a right cell's gu share
  float* sh_gb = smem + 4 * C + 2;   // [2] the buoy rows' shares of gh
  float* sh_gdh = sh_h;
  float* sh_gdhu = sh_u;
  float* sh_gRh = sh_Fh;
  float* sh_gRu = sh_B;

  float hc[CPT], huc[CPT], uc[CPT], bc[CPT], br[CPT], Fh[CPT], A[CPT];
  float hr[CPT], ur[CPT];  // the right neighbour's input, from phase (1) to (3)
  float gh[CPT], ghu[CPT];  // cotangent of the state after the current step
  float g_arg[CPT], g_hun[CPT], gdhu[CPT], ghl[CPT], gul[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int e = t + m * T;
    gh[m] = 0.0f;
    ghu[m] = 0.0f;
    if (e < C) {
      bc[m] = b[e];
      br[m] = (e + 1 < C) ? b[e + 1] : 0.0f;
    }
  }
  // buoy slot t (threads 0 and 1): its row, its depth at rest, the
  // cotangent of the running max after the current step
  const int row = t == 0 ? r0 : (t == 1 ? r1 : -1);
  const float h0 = row >= 0 ? h0_rows[t] : 0.0f;
  float gmx = row >= 0 ? cot_mx[(long long)t * N + lane] : 0.0f;
  const long long plane = (long long)C * N;  // one [C, N] array

  const int n_seg = (n_steps + k - 1) / k;
  for (int seg = n_seg - 1; seg >= 0; --seg) {
    const int lo = seg * k;
    const int cnt = n_steps - lo < k ? n_steps - lo : k;
    // the segment's checkpoint
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int e = t + m * T;
      if (e < C) {
        const long long idx = (long long)e * N + lane;
        hc[m] = ck[2 * seg * plane + idx];
        huc[m] = ck[(2 * seg + 1) * plane + idx];
        uc[m] = velocity(hc[m], huc[m], h_dry);
        sh_h[e] = hc[m];
        sh_u[e] = uc[m];
      }
    }
    float mx = row >= 0 ? ck_mx[((long long)seg * kRows + t) * N + lane] : 0.0f;
    __syncthreads();
    // recompute the segment's steps, as swe_solve.cu computes them, keeping
    // each step's input and the buoy max around it
    for (int j = 0; j < cnt; ++j) {
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < C) {
          const long long idx = (long long)e * N + lane;
          scr[2 * j * plane + idx] = hc[m];
          scr[(2 * j + 1) * plane + idx] = huc[m];
        }
      }
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e + 1 < C) {
          const Face f = face(hc[m], uc[m], bc[m], sh_h[e + 1], sh_u[e + 1], br[m], g);
          Fh[m] = f.Fh;
          A[m] = f.A;
          sh_Fh[e + 1] = f.Fh;
          sh_B[e + 1] = f.B;
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < C) {
          float div_h, div_hu;
          if (e == 0) {
            div_h = Fh[m];
            div_hu = A[m] - hg * (hc[m] * hc[m]);
          } else if (e == C - 1) {
            div_h = -sh_Fh[e];
            div_hu = hg * (hc[m] * hc[m]) - sh_B[e];
          } else {
            div_h = Fh[m] - sh_Fh[e];
            div_hu = A[m] - sh_B[e];
          }
          const float h_new = fmaxf(hc[m] - dt_dx * div_h, 0.0f);
          const float hu_new = (h_new > h_dry) ? (huc[m] - dt_dx * div_hu) : 0.0f;
          hc[m] = h_new;
          huc[m] = hu_new;
          uc[m] = velocity(h_new, hu_new, h_dry);
          sh_h[e] = h_new;
          sh_u[e] = uc[m];
        }
      }
      __syncthreads();
      if (row >= 0) {
        const float eta = sh_h[row] - h0;
        const long long at = ((long long)(2 * j) * kRows + t) * N + lane;
        bscr[at] = mx;                             // the max before step j
        bscr[at + (long long)kRows * N] = eta;     // the buoy height after it
        mx = maximum_nan(mx, eta);
      }
    }
    // the buoy slots read sh_h above; phase (0) writes it
    __syncthreads();
    // sweep the segment's steps back
    for (int j = cnt - 1; j >= 0; --j) {
      // (0) the step's input; the running max's reverse
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < C) {
          const long long idx = (long long)e * N + lane;
          hc[m] = scr[2 * j * plane + idx];
          huc[m] = scr[(2 * j + 1) * plane + idx];
          uc[m] = velocity(hc[m], huc[m], h_dry);
          sh_h[e] = hc[m];
          sh_u[e] = uc[m];
        }
      }
      if (row >= 0) {
        const long long at = ((long long)(2 * j) * kRows + t) * N + lane;
        const float mx_before = bscr[at];
        const float eta = bscr[at + (long long)kRows * N];
        sh_gb[t] = tie(eta, mx_before, gmx);
        gmx = tie(mx_before, eta, gmx);
      }
      __syncthreads();
      // (1) each face once, by the owner of its left cell, as forward
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e + 1 < C) {
          hr[m] = sh_h[e + 1];
          ur[m] = sh_u[e + 1];
          const Face f = face(hc[m], uc[m], bc[m], hr[m], ur[m], br[m], g);
          Fh[m] = f.Fh;
          A[m] = f.A;
          sh_Fh[e + 1] = f.Fh;
          sh_B[e + 1] = f.B;
        }
      }
      __syncthreads();
      // (2) each cell: the update as forward, then its transpose
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < C) {
          float div_h, div_hu;
          if (e == 0) {
            div_h = Fh[m];
            div_hu = A[m] - hg * (hc[m] * hc[m]);
          } else if (e == C - 1) {
            div_h = -sh_Fh[e];
            div_hu = hg * (hc[m] * hc[m]) - sh_B[e];
          } else {
            div_h = Fh[m] - sh_Fh[e];
            div_hu = A[m] - sh_B[e];
          }
          const float arg_h = hc[m] - dt_dx * div_h;
          const bool wet = fmaxf(arg_h, 0.0f) > h_dry;
          if (e == r0) gh[m] = gh[m] + sh_gb[0];
          if (e == r1) gh[m] = gh[m] + sh_gb[1];
          g_arg[m] = tie(arg_h, 0.0f, gh[m]);
          g_hun[m] = wet ? ghu[m] : 0.0f;
          gdhu[m] = -dt_dx * g_hun[m];
          // sh_h and sh_u were last read in (1)
          sh_gdh[e] = -dt_dx * g_arg[m];
          sh_gdhu[e] = gdhu[m];
        }
      }
      __syncthreads();
      // (3) each face's adjoint; Fh and B were last read in (2)
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e + 1 < C) {
          const float gFh = sh_gdh[e] - sh_gdh[e + 1];
          const float gA = sh_gdhu[e];
          const float gB = -sh_gdhu[e + 1];
          float ghr, gur;
          face_vjp(hc[m], uc[m], bc[m], hr[m], ur[m], br[m], g, gFh, gA, gB, ghl[m],
                   gul[m], ghr, gur);
          sh_gRh[e + 1] = ghr;
          sh_gRu[e + 1] = gur;
        }
      }
      __syncthreads();
      // (4) each cell: its faces' shares, the walls, the velocity's adjoint
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < C) {
          const float h = hc[m], hu = huc[m];
          float gh_in = g_arg[m];
          if (e > 0) gh_in = gh_in + sh_gRh[e];
          if (e + 1 < C) gh_in = gh_in + ghl[m];
          if (e == 0) gh_in = gh_in + g * h * -gdhu[m];
          if (e == C - 1) gh_in = gh_in + g * h * gdhu[m];
          float gu = e > 0 ? sh_gRu[e] : 0.0f;
          if (e + 1 < C) gu = gu + gul[m];
          // u = sqrt2 h hu / sqrt(h^4 + max(h, h_dry)^4)
          const float h2 = h * h;
          const float hm = fmaxf(h, h_dry);
          const float hm2 = hm * hm;
          const float root = sqrtf(h2 * h2 + hm2 * hm2);
          const float gnum = gu / root;
          const float groot = -(gu * uc[m]) / root;
          ghu[m] = g_hun[m] + gnum * (sqrt2 * h);
          gh_in = gh_in + gnum * hu * sqrt2;
          const float gsq = groot * 0.5f / root;
          gh_in = gh_in + 2.0f * (2.0f * (gsq * h2) * h);
          const float ghm = 2.0f * (2.0f * (gsq * hm2) * hm);
          gh[m] = gh_in + tie(h, h_dry, ghm);
        }
      }
      // the next step's (0) writes sh_h, sh_u and sh_gb, none of which (4)
      // reads; the last readers of each passed a barrier since
    }
  }
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int e = t + m * T;
    if (e < C) {
      const long long idx = (long long)e * N + lane;
      gh_out[idx] = gh[m];
      ghu_out[idx] = ghu[m];
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. b: [C]; h0_rows: [2], the depths at rest
// of buoy rows r0 and r1; ck [n_seg, 2, C, N] and ck_mx [n_seg, 2, N], the
// forward's checkpoints every k steps (swe_solve_f32 with the same k), n_seg
// = ceil(n_steps / k); cot_mx: [2, N], the cotangent of the running max;
// scr [k, 2, C, N] and bscr [k, 2, 2, N]: scratch; gh, ghu: [C, N] outputs,
// the cotangents of the initial (h, hu). Launches on `stream` and returns the
// launch's cudaError (0 on success); it never synchronises. The wrapper checks
// the arguments; this rejects what the kernel cannot take (2 <= C <= 2048,
// N >= 1, 0 <= n_steps, k >= 1, r0 and r1 in [0, C)).
extern "C" int swe_solve_vjp_f32(const float* b, const float* h0_rows,
                                 const float* ck, const float* ck_mx,
                                 const float* cot_mx, float* scr, float* bscr,
                                 float* gh, float* ghu, int C, int N, int n_steps,
                                 int k, int r0, int r1, float dt_dx, float g,
                                 float h_dry, void* stream) {
  if (C < 2 || C > 2 * kMaxThreads || N < 1 || n_steps < 0 || k < 1 || r0 < 0 ||
      r0 >= C || r1 < 0 || r1 >= C)
    return (int)cudaErrorInvalidValue;
  const int threads = C < kMaxThreads ? (C + 31) / 32 * 32 : kMaxThreads;
  const int cpt = (C + threads - 1) / threads;
  const size_t smem = (4 * (size_t)C + 2 + kRows) * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  if (cpt == 1)
    swe_solve_vjp_kernel<1><<<N, threads, smem, s>>>(b, h0_rows, ck, ck_mx, cot_mx, scr,
                                                     bscr, gh, ghu, C, N, n_steps, k, r0,
                                                     r1, dt_dx, g, h_dry);
  else
    swe_solve_vjp_kernel<2><<<N, threads, smem, s>>>(b, h0_rows, ck, ck_mx, cot_mx, scr,
                                                     bscr, gh, ghu, C, N, n_steps, k, r0,
                                                     r1, dt_dx, g, h_dry);
  return (int)cudaGetLastError();
}
