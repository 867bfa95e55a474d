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
// state (h, hu) and the running max before every k-th step, ck [N, n_seg, 2,
// C] (lane-major: a warp's threads touch consecutive cells) and ck_mx [n_seg,
// 2, N]. This kernel walks the segments from last to first: it loads a
// segment's checkpoint, recomputes its (at most k) steps with swe_solve.cu's
// own arithmetic (swe_math.cuh; built with -fmad=false and IEEE sqrtf and
// division, so each recomputed state is the forward's, bit for bit, and
// every kink branch is taken as the primal took it), writing each step's
// input to a global scratch [N, k, 2, C] (lane-major, coalesced) and the
// buoy max before and the buoy height after each step to [N, k, 2, 2]; then
// it sweeps the segment's steps backwards. The scratches come from the
// caller (the torch allocator: no cudaMalloc while a CUDA graph is
// captured).
//
// Layout: as swe_solve.cu, a lane's column over a thread block cluster of cs
// blocks (1, 2, 4 or 8; the wrapper's plan picks it from C, N and the card,
// `cluster=` forces it). Cluster rank r owns the contiguous cells [lo, lo +
// n) (C / cs each, the first C % cs ranks one more) and computes an extended
// slice with k_g = min(32, C / cs) ghost cells on each side that has a
// neighbour (none at cs = 1), whose ends it treats as walls. Thread t owns
// extended cells t, t + T (1 or 2 a thread). A recomputed step is two phases
// (faces, then cells) and a reverse step five, with four block barriers:
//   (0) each cell's input from the scratch (loaded during the step
//       before), its velocity; the buoy slots (threads 0 and 1) split the
//       running max's cotangent between the max before the step and the
//       buoy row's depth after it;
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
//
// The cluster's blocks meet only through the scratch and the cluster
// barrier, never through a load from another block's shared memory:
// - a recomputed state at distance d from an extended end is wrong after d
//   steps, so an owned cell (d >= k_g) is exact for k_g steps. Every block
//   stores its owned cells' input of each step in the scratch; every k_g
//   steps of a segment, after a cluster barrier, each block reloads its
//   ghost cells' states from it (the neighbours' owned cells);
// - the sweep reads every extended cell's state from the scratch, exact;
//   a cotangent has radius 1, and the wall at an extended end spoils its
//   cell and the next one in the first reverse step and one more cell each
//   step after: an owned cell is exact for k_g - 1 reverse steps. So every
//   k_g - 1 reverse steps (and at each segment's start) each block stores
//   its owned cotangents in an exchange buffer [N, 2, 2, C] (two parities,
//   so that a block never overwrites what a neighbour has still to read)
//   and, after a cluster barrier, loads its ghost cells' cotangents;
// - a cluster barrier after each segment's recomputation (the scratch
//   complete) and after its sweep (nobody reads it any more). The buoy
//   rows' values are written by their owners and read by every block.
// Every cell computes the same expressions in the same order at every cs,
// so every cluster size gives the same bits; the scratch is read with
// ld.global.cg (L2), where the cluster barrier's release and acquire order
// the other blocks' stores. No atomics: two calls give the same bits.
//
// What bounds it: the chain of dependent phases a step (a forward step
// recomputed, and the reverse's forward and adjoint, about three forward
// steps of work) and the SMs' issue rate; the scratch's traffic, [k, 2, C]
// a lane written and read once a segment, is coalesced (L2 for 16 lanes).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "swe_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRows = 2;    // buoy rows of a solve (wrapper: ops.N_ROWS)
constexpr int kGhost = 32;  // ghost cells a side of a cluster's block

#ifdef SWE_VJP_PHASES
// The phase-stamped variant (scripts/swe_vjp_phases.py builds it with
// -DSWE_VJP_PHASES): block 0's thread 0 adds the clock64() cycles of each
// part of the wave, each part up to and including the barrier after it.
#define PHASE_PARTS                                                               \
  "checkpoint_load,recompute_scratch_store,recompute_exchange,recompute_faces,"   \
  "recompute_update,segment_barriers,sweep_exchange,sweep_scratch_load,"         \
  "sweep_faces,sweep_cells,sweep_face_adjoints,sweep_cell_adjoints"
constexpr int kParts = 12;
__device__ unsigned long long g_phase_cycles[kParts + 1];
#define STAMP(i)                      \
  do {                                \
    const long long now_ = clock64(); \
    cycles_[i] += now_ - then_;       \
    then_ = now_;                     \
  } while (0)
#else
#define STAMP(i) \
  do {           \
  } while (0)
#endif

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

// k_g, the ghost cells a side of a cluster's block (none at cs = 1), and the
// largest extended slice of a C-cell column cut in cs (swe_solve.cu's)
__host__ __device__ inline int ghost_cells(int C, int cs) {
  return cs == 1 ? 0 : (C / cs < kGhost ? C / cs : kGhost);
}
__host__ __device__ inline int max_extended(int C, int cs) {
  return (C + cs - 1) / cs + 2 * ghost_cells(C, cs);
}

// Reverse step j's input from this lane's scratch, every extended cell
// [elo, elo + nE) (ld.global.cg: another block's owned cells, ordered by the
// cluster barrier after the recomputation), and the buoy values around it
// (threads 0 and 1)
template <int CPT>
__device__ __forceinline__ void load_step(const float* lscr, const float* lbscr, int j,
                                          int C, int elo, int nE, int t, int T, int row,
                                          float (&h)[CPT], float (&hu)[CPT], float& mx,
                                          float& eta) {
  const float* const s_h = lscr + (long long)j * 2 * C;
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int e = t + m * T;
    if (e < nE) {
      h[m] = __ldcg(s_h + elo + e);
      hu[m] = __ldcg(s_h + C + elo + e);
    }
  }
  if (row >= 0) {
    const float* const at = lbscr + (long long)j * 2 * kRows + t;
    mx = __ldcg(at);
    eta = __ldcg(at + kRows);
  }
}

// the cluster barrier (release and acquire: the blocks' stores to global
// memory before it are seen by the loads after it); a block barrier at cs = 1
template <bool kCluster>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (kCluster) cg::this_cluster().sync();
  else __syncthreads();
}

template <int CPT, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
    swe_solve_vjp_kernel(const float* __restrict__ b,
                         const float* __restrict__ h0_rows,
                         const float* __restrict__ ck,
                         const float* __restrict__ ck_mx,
                         const float* __restrict__ cot_mx,
                         float* __restrict__ scr, float* __restrict__ bscr,
                         float* __restrict__ lam, float* __restrict__ gh_out,
                         float* __restrict__ ghu_out, int C, int N, int n_steps,
                         int k, int r0, int r1, float dt_dx, float g, float h_dry) {
  int cs = 1, rank = 0;
  if constexpr (kCluster) {
    cs = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int lane = blockIdx.x / cs;
  // this block's slice [lo, hi), extended by kg ghost cells on each side
  // that has a neighbour (swe_solve.cu's cut)
  const int q = C / cs, rem = C % cs;
  const int lo = rank * q + (rank < rem ? rank : rem);
  const int n = q + (rank < rem ? 1 : 0);
  const int hi = lo + n;
  const int kg = ghost_cells(C, cs);
  const int gl = lo > 0 ? kg : 0, gr = hi < C ? kg : 0;
  const int elo = lo - gl;     // global index of extended cell 0
  const int nE = gl + n + gr;  // extended cells

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const float hg = 0.5f * g;
  const float sqrt2 = 1.41421356237309515f;

  const int SE = max_extended(C, cs);
  extern __shared__ float smem[];
  // two pairs of arrays, each reused once a reverse step (see the phases):
  // depth and velocity of the step's input, read by the left neighbour in
  // phase (1), then the divergences' cotangents, read by the left
  // neighbour in (3); the face terms Fh and B (face e | e + 1 at e + 1),
  // read in (2), then the right cells' shares of the faces' adjoints, read
  // in (4)
  float* sh_h = smem;                // [SE] h, then the cotangent of div_h
  float* sh_u = smem + SE;           // [SE] u, then the cotangent of div_hu
  float* sh_Fh = smem + 2 * SE;      // [SE + 1] Fh, then a right cell's gh share
  float* sh_B = smem + 3 * SE + 1;   // [SE + 1] B, then a right cell's gu share
  float* sh_gb = smem + 4 * SE + 2;  // [2] the buoy rows' shares of gh
  float* sh_gdh = sh_h;
  float* sh_gdhu = sh_u;
  float* sh_gRh = sh_Fh;
  float* sh_gRu = sh_B;

  // this lane's scratch: states [k, 2, C], buoy values [k, 2, 2], the
  // cotangents' exchange [2 parities, 2, C]
  float* const lscr = scr + (long long)lane * k * 2 * C;
  float* const lbscr = bscr + (long long)lane * k * 2 * kRows;
  float* const llam = lam + (long long)lane * 2 * 2 * C;

  float hc[CPT], huc[CPT], uc[CPT], bc[CPT], br[CPT], Fh[CPT], A[CPT];
  float hr[CPT], ur[CPT];  // the right neighbour's input, from phase (1) to (3)
  float gh[CPT], ghu[CPT];  // cotangent of the state after the current step
  float g_arg[CPT], g_hun[CPT], gdhu[CPT], ghl[CPT], gul[CPT];
  // the next reverse step's input and buoy values, loaded a step ahead
  float hn[CPT], hun[CPT], mx_n = 0.0f, eta_n = 0.0f;
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int e = t + m * T;
    gh[m] = 0.0f;
    ghu[m] = 0.0f;
    if (e < nE) {
      const int i = elo + e;
      bc[m] = b[i];
      br[m] = (i + 1 < C) ? b[i + 1] : 0.0f;
    }
  }
  // buoy slot t (threads 0 and 1): its row in extended cells (-1 outside
  // the extended slice), whether this block owns it (and so records the
  // running max in the recomputation), its depth at rest, and the
  // cotangent of the running max after the current step
  const int row = t == 0 ? r0 : (t == 1 ? r1 : -1);
  const int erow0 = r0 - elo >= 0 && r0 - elo < nE ? r0 - elo : -1;
  const int erow1 = r1 - elo >= 0 && r1 - elo < nE ? r1 - elo : -1;
  const bool owner = row >= lo && row < hi;
  const float h0 = owner ? h0_rows[t] : 0.0f;
  float gmx = row >= 0 ? cot_mx[(long long)t * N + lane] : 0.0f;
  const int n_seg = (n_steps + k - 1) / k;
  // rounds of the cotangents' exchange: each one's parity
  int xround = 0;

#ifdef SWE_VJP_PHASES
  unsigned long long cycles_[kParts] = {};
  const long long first_ = clock64();
  long long then_ = first_;
#endif
  for (int seg = n_seg - 1; seg >= 0; --seg) {
    const int cnt = n_steps - seg * k < k ? n_steps - seg * k : k;
    // the segment's checkpoint: every extended cell exact
    const float* cks = ck + ((long long)lane * n_seg + seg) * 2 * C;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int e = t + m * T;
      if (e < nE) {
        hc[m] = cks[elo + e];
        huc[m] = cks[C + elo + e];
        uc[m] = velocity(hc[m], huc[m], h_dry);
        sh_h[e] = hc[m];
        sh_u[e] = uc[m];
      }
    }
    float mx = owner ? ck_mx[((long long)seg * kRows + t) * N + lane] : 0.0f;
    __syncthreads();
    STAMP(0);
    // recompute the segment's steps, as swe_solve.cu computes them, keeping
    // each step's input (the owned cells) and the buoy max around it
    for (int j = 0; j < cnt; ++j) {
      float* const s_h = lscr + (long long)j * 2 * C;
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e >= gl && e < gl + n) {
          s_h[elo + e] = hc[m];
          s_h[C + elo + e] = huc[m];
        }
      }
      STAMP(1);
      if constexpr (kCluster) {
        if (j > 0 && j % kg == 0) {
          // a new round: the ghost cells' state j, from their owners
          cluster_barrier<kCluster>();
#pragma unroll
          for (int m = 0; m < CPT; ++m) {
            const int e = t + m * T;
            if (e < nE && (e < gl || e >= gl + n)) {
              hc[m] = __ldcg(s_h + elo + e);
              huc[m] = __ldcg(s_h + C + elo + e);
              uc[m] = velocity(hc[m], huc[m], h_dry);
              sh_h[e] = hc[m];
              sh_u[e] = uc[m];
            }
          }
          __syncthreads();
        }
      }
      STAMP(2);
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e + 1 < nE) {
          const Face f = face(hc[m], uc[m], bc[m], sh_h[e + 1], sh_u[e + 1], br[m], g);
          Fh[m] = f.Fh;
          A[m] = f.A;
          sh_Fh[e + 1] = f.Fh;
          sh_B[e + 1] = f.B;
        }
      }
      __syncthreads();
      STAMP(3);
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < nE) {
          float div_h, div_hu;
          if (e == 0) {
            div_h = Fh[m];
            div_hu = A[m] - hg * (hc[m] * hc[m]);
          } else if (e == nE - 1) {
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
      if (owner) {
        const float eta = sh_h[row - elo] - h0;
        float* const at = lbscr + (long long)j * 2 * kRows + t;
        at[0] = mx;       // the max before step j
        at[kRows] = eta;  // the buoy height after it
        mx = maximum_nan(mx, eta);
      }
      STAMP(4);
    }
    // every block's scratch of the segment is complete (the buoy slots read
    // sh_h above; phase (0) writes it); the first exchange of the sweep
    // rides on this barrier: the owned cotangents go out before it
    if constexpr (kCluster) {
      float* const x = llam + (long long)(xround & 1) * 2 * C;
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e >= gl && e < gl + n) {
          x[elo + e] = gh[m];
          x[C + elo + e] = ghu[m];
        }
      }
    }
    cluster_barrier<kCluster>();
    STAMP(5);
    // the first reverse step's input (later ones are loaded a step ahead)
    load_step(lscr, lbscr, cnt - 1, C, elo, nE, t, T, row, hn, hun, mx_n, eta_n);
    // sweep the segment's steps back
    for (int j = cnt - 1; j >= 0; --j) {
      if constexpr (kCluster) {
        const int r = cnt - 1 - j;  // reverse steps of this segment done
        if (r % (kg - 1) == 0) {
          // a new round: the ghost cells' cotangents, from their owners
          // (sent before the barrier: above at a segment's first step)
          float* const x = llam + (long long)(xround & 1) * 2 * C;
          if (r > 0) {
#pragma unroll
            for (int m = 0; m < CPT; ++m) {
              const int e = t + m * T;
              if (e >= gl && e < gl + n) {
                x[elo + e] = gh[m];
                x[C + elo + e] = ghu[m];
              }
            }
            cluster_barrier<kCluster>();
          }
#pragma unroll
          for (int m = 0; m < CPT; ++m) {
            const int e = t + m * T;
            if (e < nE && (e < gl || e >= gl + n)) {
              gh[m] = __ldcg(x + elo + e);
              ghu[m] = __ldcg(x + C + elo + e);
            }
          }
          ++xround;
        }
      }
      STAMP(6);
      // (0) the step's input, every extended cell's exact state (loaded a
      // step ahead); the running max's reverse
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < nE) {
          hc[m] = hn[m];
          huc[m] = hun[m];
          uc[m] = velocity(hc[m], huc[m], h_dry);
          sh_h[e] = hc[m];
          sh_u[e] = uc[m];
        }
      }
      if (row >= 0) {
        sh_gb[t] = tie(eta_n, mx_n, gmx);
        gmx = tie(mx_n, eta_n, gmx);
      }
      __syncthreads();
      // the next step's input, in flight through phases (1)-(4)
      if (j > 0) load_step(lscr, lbscr, j - 1, C, elo, nE, t, T, row, hn, hun, mx_n, eta_n);
      STAMP(7);
      // (1) each face once, by the owner of its left cell, as forward
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e + 1 < nE) {
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
      STAMP(8);
      // (2) each cell: the update as forward, then its transpose
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < nE) {
          float div_h, div_hu;
          if (e == 0) {
            div_h = Fh[m];
            div_hu = A[m] - hg * (hc[m] * hc[m]);
          } else if (e == nE - 1) {
            div_h = -sh_Fh[e];
            div_hu = hg * (hc[m] * hc[m]) - sh_B[e];
          } else {
            div_h = Fh[m] - sh_Fh[e];
            div_hu = A[m] - sh_B[e];
          }
          const float arg_h = hc[m] - dt_dx * div_h;
          const bool wet = fmaxf(arg_h, 0.0f) > h_dry;
          if (e == erow0) gh[m] = gh[m] + sh_gb[0];
          if (e == erow1) gh[m] = gh[m] + sh_gb[1];
          g_arg[m] = tie(arg_h, 0.0f, gh[m]);
          g_hun[m] = wet ? ghu[m] : 0.0f;
          gdhu[m] = -dt_dx * g_hun[m];
          // sh_h and sh_u were last read in (1)
          sh_gdh[e] = -dt_dx * g_arg[m];
          sh_gdhu[e] = gdhu[m];
        }
      }
      __syncthreads();
      STAMP(9);
      // (3) each face's adjoint; Fh and B were last read in (2)
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e + 1 < nE) {
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
      STAMP(10);
      // (4) each cell: its faces' shares, the walls, the velocity's adjoint
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int e = t + m * T;
        if (e < nE) {
          const float h = hc[m], hu = huc[m];
          float gh_in = g_arg[m];
          if (e > 0) gh_in = gh_in + sh_gRh[e];
          if (e + 1 < nE) gh_in = gh_in + ghl[m];
          if (e == 0) gh_in = gh_in + g * h * -gdhu[m];
          if (e == nE - 1) gh_in = gh_in + g * h * gdhu[m];
          float gu = e > 0 ? sh_gRu[e] : 0.0f;
          if (e + 1 < nE) gu = gu + gul[m];
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
      STAMP(11);
      // the next step's (0) writes sh_h, sh_u and sh_gb, none of which (4)
      // reads; the last readers of each passed a barrier since
    }
    // nobody reads this segment's scratch any more before the next one's
    // recomputation overwrites it
    cluster_barrier<kCluster>();
    STAMP(5);
  }
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int e = t + m * T;
    if (e >= gl && e < gl + n) {
      const long long idx = (long long)(elo + e) * N + lane;
      gh_out[idx] = gh[m];
      ghu_out[idx] = ghu[m];
    }
  }
#ifdef SWE_VJP_PHASES
  if (blockIdx.x == 0 && t == 0) {
    for (int i = 0; i < kParts; ++i) g_phase_cycles[i] = cycles_[i];
    g_phase_cycles[kParts] = clock64() - first_;
  }
#endif
}

// Block size, cells per thread and dynamic shared memory of an adjoint of C
// cells cut in cs: 4 floats a cell of the largest extended slice, 2 more
// faces and the 2 buoy shares (33 KB at most: within the 48 KB a launch
// gets by default).
struct Shape {
  int threads, cpt;
  size_t smem;
};

Shape shape_of(int C, int cs) {
  const int SE = max_extended(C, cs);
  const int cpt = (SE + kMaxThreads - 1) / kMaxThreads;
  const int threads = cs == 1 ? (SE < kMaxThreads ? (SE + 31) / 32 * 32 : kMaxThreads)
                              : ((SE + cpt - 1) / cpt + 31) / 32 * 32;
  return {threads, (SE + threads - 1) / threads, (4 * (size_t)SE + 2 + kRows) * sizeof(float)};
}

cudaLaunchConfig_t cluster_config(int blocks, int cs, const Shape& sh,
                                  cudaLaunchAttribute* attr, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(sh.threads);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CPT>
cudaError_t launch(const float* b, const float* h0_rows, const float* ck,
                   const float* ck_mx, const float* cot_mx, float* scr, float* bscr,
                   float* lam, float* gh, float* ghu, int C, int N, int n_steps, int k,
                   int r0, int r1, float dt_dx, float g, float h_dry, int cs,
                   const Shape& sh, cudaStream_t stream) {
  if (cs == 1) {
    swe_solve_vjp_kernel<CPT, false><<<N, sh.threads, sh.smem, stream>>>(
        b, h0_rows, ck, ck_mx, cot_mx, scr, bscr, lam, gh, ghu, C, N, n_steps, k, r0,
        r1, dt_dx, g, h_dry);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(N * cs, cs, sh, &attr, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, swe_solve_vjp_kernel<CPT, true>, b, h0_rows, ck, ck_mx, cot_mx, scr, bscr,
      lam, gh, ghu, C, N, n_steps, k, r0, r1, dt_dx, g, h_dry);
  // read and clear the launch error either way, so that it is not reported
  // later against another kernel
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// a power of two whose blocks own 2 cells or more (a ghost round is k_g - 1
// reverse steps long)
bool valid_cluster(int C, int cs) {
  return cs >= 1 && (cs & (cs - 1)) == 0 && (cs == 1 || 2 * cs <= C);
}

}  // namespace

// C entry point, bound with ctypes. b: [C]; h0_rows: [2], the depths at rest
// of buoy rows r0 and r1; ck [N, n_seg, 2, C] and ck_mx [n_seg, 2, N], the
// forward's checkpoints every k steps (swe_solve_f32 with the same k), n_seg
// = ceil(n_steps / k); cot_mx: [2, N], the cotangent of the running max;
// scr [N, k, 2, C], bscr [N, k, 2, 2] and lam [N, 2, 2, C]: scratch; gh,
// ghu: [C, N] outputs, the cotangents of the initial (h, hu); cs: the
// cluster size, blocks a lane (a power of two, at most C / 2 above 1; a
// Hopper card schedules at most 8, the portable limit). Launches on
// `stream` and returns the launch's cudaError (0 on success); it never
// synchronises. The wrapper checks the arguments; this rejects what the
// kernel cannot take (2 <= C <= 2048, N >= 1, 0 <= n_steps, k >= 1, r0 and
// r1 in [0, C)). A cluster size the card refuses is returned as the
// launch's error, never retried at another.
extern "C" int swe_solve_vjp_f32(const float* b, const float* h0_rows,
                                 const float* ck, const float* ck_mx,
                                 const float* cot_mx, float* scr, float* bscr,
                                 float* lam, float* gh, float* ghu, int C, int N,
                                 int n_steps, int k, int r0, int r1, float dt_dx,
                                 float g, float h_dry, int cs, void* stream) {
  if (C < 2 || C > 2 * kMaxThreads || N < 1 || n_steps < 0 || k < 1 || r0 < 0 ||
      r0 >= C || r1 < 0 || r1 >= C || !valid_cluster(C, cs))
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(C, cs);
  const cudaStream_t s = (cudaStream_t)stream;
  if (sh.cpt == 1)
    return (int)launch<1>(b, h0_rows, ck, ck_mx, cot_mx, scr, bscr, lam, gh, ghu, C, N,
                          n_steps, k, r0, r1, dt_dx, g, h_dry, cs, sh, s);
  return (int)launch<2>(b, h0_rows, ck, ck_mx, cot_mx, scr, bscr, lam, gh, ghu, C, N,
                        n_steps, k, r0, r1, dt_dx, g, h_dry, cs, sh, s);
}

// How many clusters of cs blocks of a C-cell adjoint the current device
// holds at once (cudaOccupancyMaxActiveClusters; at cs = 1, blocks a SM
// times the SMs), into *out. Returns the cudaError (0 on success).
extern "C" int swe_solve_vjp_max_active_clusters(int C, int cs, int* out) {
  if (C < 2 || C > 2 * kMaxThreads || !valid_cluster(C, cs))
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(C, cs);
  cudaError_t err;
  if (cs == 1) {
    int device, sms, per_sm;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = sh.cpt == 1
                ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, swe_solve_vjp_kernel<1, false>, sh.threads, sh.smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, swe_solve_vjp_kernel<2, false>, sh.threads, sh.smem);
    if (err == cudaSuccess) *out = per_sm * sms;
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(cs, cs, sh, &attr, nullptr);
    err = sh.cpt == 1
              ? cudaOccupancyMaxActiveClusters(out, swe_solve_vjp_kernel<1, true>, &cfg)
              : cudaOccupancyMaxActiveClusters(out, swe_solve_vjp_kernel<2, true>, &cfg);
  }
  cudaGetLastError();  // clear it: the caller gets it as the return value
  return (int)err;
}

#ifdef SWE_VJP_PHASES
// The phase-stamped variant's readout: the parts' names (comma-separated),
// and, after a launch has finished, block 0's cycles in each part and over
// the whole kernel into out[0 .. parts] (parts + 1 values). Returns the
// cudaError.
extern "C" const char* swe_solve_vjp_phase_parts() { return PHASE_PARTS; }
extern "C" int swe_solve_vjp_phase_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
}
#endif
