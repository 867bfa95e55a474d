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
// negligible. But lanes are few, and every step is a chain of dependent
// phases (a face needs its neighbours' velocities, a cell its neighbour
// face). With one block a lane, 16 lanes keep 16 of the 132 SMs busy: a
// fine step (2,048 cells on one SM) is bound by that SM's issue rate, a
// coarse one by the latency of the barriers and of the IEEE sqrt and
// division chains.
//
// What the design does about it: lanes are independent and the stencil only
// couples neighbouring cells, so nothing leaves the SMs of a lane between
// steps, and a lane's column is split over a thread block cluster of cs
// blocks (cs = 1, 2, 4 or 8, Hopper's portable cluster sizes; the wrapper's
// plan picks it from C, N and the card, `cluster=` forces it). At cs = 1 one block owns one lane, for
// waves whose lanes fill the card.
//
// Cluster rank r owns the contiguous cells [lo, lo + n) of its lane (C / cs
// each, the first C % cs ranks one more), and also computes k ghost cells
// on each side that has a neighbour (k = min(32, C / cs); none at cs = 1):
// an extended slice of n + 2k cells at most. Its thread t owns extended
// cells t, t + T, ... (CPT = 1 or 2 cells each; T = the largest extended
// slice over CPT, rounded up to a warp, and at cs = 1 min(1024, C rounded
// up to a warp)) and keeps their h, hu, u, b and its own face terms in
// registers; shared memory holds what neighbours read: h
// and u per cell and the face terms Fh and B per face. A step is two
// phases, as with one block a lane: (1) every face once (owner of its left
// cell): Fh, A, B; block barrier; (2) every cell: divergence from its own
// face and its left neighbour's, limiter, update in place, and the new
// velocity; block barrier; then the owner of each buoy row reads its new h.
// The extended slice's ends are treated as walls: a ghost cell at distance
// d from an end is wrong after d steps and an owned cell (distance >= k) is
// exact for k steps, so the blocks exchange only every k steps, not every
// step. Each block then pushes its first and last k owned cells (h, hu)
// into the neighbours' ghost slots of that round's parity through
// distributed shared memory (st.async, which completes 8 bytes on the
// slot's mbarrier: posted stores, no remote load), and each ghost thread
// waits on its side's mbarrier phase before taking its cell (and computing
// its velocity, the same expression on the same inputs as the owner's, so
// the same bits). A block cannot push into a slot before the neighbour has
// read it: the push ends a round that needed the neighbour's push, which
// came after its read. One cluster.sync() comes before the first push
// (every block has started and armed its mbarriers) and one before any
// block exits (no push into its shared memory is in flight). On an H100 a
// cluster-wide barrier a step (barrier.cluster), and an exchange of one
// edge cell a step, each measured slower (PERF.md).
//
// Device memory is read once at the start and [R, N] is written once at the
// end; with a checkpoint pointer (the reverse mode's forward, swe_solve_vjp.cu)
// each block also writes its owned cells' state and the running max every
// k_ck steps, and nothing else changes. Built with -fmad=false and IEEE sqrtf
// and division (no fast math), so the solve equals the plain PyTorch loop bit
// for bit at every cs. The step's arithmetic is in swe_math.cuh, shared with
// the adjoint, whose recomputed states must be these bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "swe_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRows = 2;  // buoy rows a solve reduces (wrapper: N_ROWS)
constexpr int kGhost = 32;  // ghost cells a side of a cluster's block: steps between exchanges

// The ghost cells' transport. Shared-memory addresses are 32-bit
// (`.shared::cta` of this block; `.shared::cluster` after `mapa`, of another
// block). An mbarrier's phase completes when its one expected arrival (the
// consumer arming it for the bytes of one side's ghost cells) and those
// bytes, 8 a cell from the producer's st.async, have all come, in any order.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1u) : "memory");
}
// one arrival that also expects `bytes` (the ghost cells of one side)
__device__ __forceinline__ void mbar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}
// (h, hu) of one cell into another block's ghost slot, completing 8 bytes
// on its mbarrier
__device__ __forceinline__ void push(unsigned remote, float h, float hu,
                                     unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
      ::"r"(remote), "f"(h), "f"(hu), "r"(remote_bar)
      : "memory");
}

// k, the ghost cells a side of a cluster's block (none at cs = 1), and the
// largest extended slice of a C-cell column cut in cs: every block of a
// cluster lays its shared memory out for it, so that an offset means the
// same thing in every block.
__host__ __device__ inline int ghost_cells(int C, int cs) {
  return cs == 1 ? 0 : (C / cs < kGhost ? C / cs : kGhost);
}
__host__ __device__ inline int max_extended(int C, int cs) {
  return (C + cs - 1) / cs + 2 * ghost_cells(C, cs);
}

template <int CPT, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
    swe_solve_kernel(const float* __restrict__ h, const float* __restrict__ hu,
                     const float* __restrict__ b,
                     const float* __restrict__ h0_rows,
                     float* __restrict__ mx_out, float* __restrict__ arr_out,
                     float* __restrict__ ck, float* __restrict__ ck_mx, int k_ck,
                     int C, int N, int n_steps, int r0, int r1,
                     float dt_dx, float g, float h_dry, float thresh) {
  int cs = 1, rank = 0;
  if constexpr (kCluster) {
    cs = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int lane = blockIdx.x / cs;
  // this block's slice [lo, hi): C / cs cells, the first C % cs ranks one
  // more; extended by k ghost cells on each side that has a neighbour
  const int q = C / cs, rem = C % cs;
  const int lo = rank * q + (rank < rem ? rank : rem);
  const int n = q + (rank < rem ? 1 : 0);
  const int hi = lo + n;
  const int k = ghost_cells(C, cs);
  const int gl = lo > 0 ? k : 0, gr = hi < C ? k : 0;
  const int elo = lo - gl;     // global index of extended cell 0
  const int nE = gl + n + gr;  // extended cells

  const int SE = max_extended(C, cs);
  extern __shared__ unsigned long long smem_bars[];
  // [2 sides][2 parities] mbarriers: of the left ghost cells (side 0), of the right
  unsigned long long* bars = smem_bars;
  float* sh_h = reinterpret_cast<float*>(smem_bars + 4);  // [SE] depth after the last update
  float* sh_u = sh_h + SE;                 // [SE] velocity of that state
  float* sh_Fh = sh_h + 2 * SE;            // [SE + 1] mass flux of face e | e + 1 at e + 1
  float* sh_B = sh_h + 3 * SE + 1;         // [SE + 1] momentum term seen from the right
  float* ghost = sh_h + 4 * SE + 2;        // [2 parities][2 sides][k][h, hu]

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const float hg = 0.5f * g;

  float hc[CPT], huc[CPT], uc[CPT], bc[CPT], br[CPT], Fh[CPT], A[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int e = t + m * T;
    if (e < nE) {
      const int i = elo + e;
      const long long idx = (long long)i * N + lane;
      hc[m] = h[idx];
      huc[m] = hu[idx];
      bc[m] = b[i];
      br[m] = (i + 1 < C) ? b[i + 1] : 0.0f;
      uc[m] = velocity(hc[m], huc[m], h_dry);
      sh_h[e] = hc[m];
      sh_u[e] = uc[m];
    }
  }
  // the neighbours' ghost slots, by side, and their mbarriers; ours armed
  // for their first push (the round 0 -> 1 exchange fills parity 1)
  unsigned push_left = 0, push_left_bar = 0, push_right = 0, push_right_bar = 0;
  if constexpr (kCluster) {
    const unsigned side_bytes = 8u * (unsigned)k;
    if (t == 0) {
      for (int side = 0; side < 2; ++side) {
        if (side == 0 ? gl == 0 : gr == 0) continue;
        for (int par = 0; par < 2; ++par) {
          mbar_init(smem_addr(&bars[side * 2 + par]));
          mbar_arm(smem_addr(&bars[side * 2 + par]), side_bytes);
        }
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // our first k owned cells are the left neighbour's right ghosts (side
    // 1), our last k the right neighbour's left ghosts (side 0)
    if (gl > 0) {
      push_left = map_rank(smem_addr(&ghost[(0 * 2 + 1) * k * 2]), rank - 1);
      push_left_bar = map_rank(smem_addr(&bars[2]), rank - 1);
    }
    if (gr > 0) {
      push_right = map_rank(smem_addr(&ghost[0]), rank + 1);
      push_right_bar = map_rank(smem_addr(&bars[0]), rank + 1);
    }
  }
  // buoy slot t (threads 0 and 1): its row, if this block owns it, its depth
  // at rest and reductions
  const int row = t == 0 ? r0 : (t == 1 ? r1 : -1);
  const int erow = (t < kRows && row >= lo && row < hi) ? row - elo : -1;
  const float h0 = erow >= 0 ? h0_rows[t] : 0.0f;
  float mx = __int_as_float(0xff800000);  // -inf
  float arr = -1.0f;
  // every block of the cluster has started and armed its mbarriers before
  // any block pushes into it
  if constexpr (kCluster) cg::this_cluster().sync();
  else __syncthreads();

  // the exchange rounds (clustered): round `round` computes steps
  // [round k, round k + k) from the ghost cells of state round k; `left`
  // steps of it remain (counted down: no division in the step loop)
  int round = 0, left = k;
  // the checkpoints (with a non-null ck): every k_ck steps, counted down;
  // this lane's [n_seg, 2, C] of ck (lane-major: a warp stores consecutive
  // cells)
  int ck_left = 0, seg = 0;
  const int n_seg = ck != nullptr ? (n_steps + k_ck - 1) / k_ck : 0;
  float* const lck = ck != nullptr ? ck + (long long)lane * n_seg * 2 * C : nullptr;
  for (int s = 0; s < n_steps; ++s) {
    if (ck != nullptr) {
      if (ck_left == 0) {
        // state s = seg k_ck of the owned cells, exact in registers (a ghost
        // cell may be stale), and the running max before step s
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int e = t + m * T;
          if (e >= gl && e < gl + n) {
            const long long i = elo + e;
            lck[(long long)(2 * seg) * C + i] = hc[m];
            lck[(long long)(2 * seg + 1) * C + i] = huc[m];
          }
        }
        if (erow >= 0) ck_mx[((long long)seg * kRows + t) * N + lane] = mx;
        ++seg;
        ck_left = k_ck;
      }
      --ck_left;
    }
    if constexpr (kCluster) {
      if (left == 0) {
        // a new round: the ghost cells of state s, pushed at the end of the
        // last round into the slots of parity round & 1, the
        // ((round - 1) / 2)-th phase of their mbarriers
        ++round;
        left = k;
        const int par = round & 1;
        const unsigned parity = (unsigned)((round - 1) >> 1) & 1u;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int e = t + m * T;
          if (e < nE && (e < gl || e >= gl + n)) {
            const int side = e < gl ? 0 : 1;
            const int slot = e < gl ? e : e - gl - n;
            const unsigned bar = smem_addr(&bars[side * 2 + par]);
            mbar_wait(bar, parity);
            // the first ghost thread of each side arms it for its next push
            if (e == 0 || e == nE - 1) mbar_arm(bar, 8u * (unsigned)k);
            const float* cell = &ghost[((par * 2 + side) * k + slot) * 2];
            hc[m] = cell[0];
            huc[m] = cell[1];
            uc[m] = velocity(hc[m], huc[m], h_dry);
            sh_h[e] = hc[m];
            sh_u[e] = uc[m];
          }
        }
        __syncthreads();
      }
    }
    // (1) each face once, by the owner of its left cell
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
    // (2) divergence, limiter and update of each cell, in place; the
    // extended slice's ends as walls (the column's own walls at cells 0 and
    // C - 1)
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int e = t + m * T;
      if (e < nE) {
        float div_h, div_hu;
        if (e == 0) {
          // reflective left wall: zero mass flux, hydrostatic pressure g/2 h^2
          div_h = Fh[m];
          div_hu = A[m] - hg * (hc[m] * hc[m]);
        } else if (e == nE - 1) {
          // reflective right wall
          div_h = -sh_Fh[e];
          div_hu = hg * (hc[m] * hc[m]) - sh_B[e];
        } else {
          div_h = Fh[m] - sh_Fh[e];
          div_hu = A[m] - sh_B[e];
        }
        // positivity / dry-cell limiter, applied last
        const float h_new = fmaxf(hc[m] - dt_dx * div_h, 0.0f);
        const float hu_new = (h_new > h_dry) ? (huc[m] - dt_dx * div_hu) : 0.0f;
        hc[m] = h_new;
        huc[m] = hu_new;
        uc[m] = velocity(h_new, hu_new, h_dry);
        sh_h[e] = h_new;
        sh_u[e] = uc[m];
      }
    }
    if constexpr (kCluster) {
      if (--left == 0 && s + 1 < n_steps) {
        // the end of a round: our edge cells of state s + 1 into the
        // neighbours' ghost slots of the next round's parity
        const int par = (round + 1) & 1;
        const unsigned slots = (unsigned)(par * 2 * k * 2 * sizeof(float));
        const unsigned bar = 8u * (unsigned)par;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int e = t + m * T;
          const int own = e - gl;  // owned cell index
          if (gl > 0 && own >= 0 && own < k)
            push(push_left + slots + 8u * own, hc[m], huc[m], push_left_bar + bar);
          if (gr > 0 && own >= n - k && own < n)
            push(push_right + slots + 8u * (own - (n - k)), hc[m], huc[m],
                 push_right_bar + bar);
        }
      }
    }
    __syncthreads();
    // buoy reduction of step s; sh_h is not written again before the next
    // step's block barrier
    if (erow >= 0) {
      const float eta = sh_h[erow] - h0;
      mx = maximum_nan(mx, eta);
      if (fabsf(eta) > thresh && arr < 0.0f) arr = (float)s;
    }
  }
  // no block exits while a push into its shared memory may be in flight
  if constexpr (kCluster) cg::this_cluster().sync();
  if (erow >= 0) {
    mx_out[(long long)t * N + lane] = mx;
    arr_out[(long long)t * N + lane] = arr;
  }
}

// Block size, cells per thread and dynamic shared memory of a solve of C
// cells cut in cs: 4 mbarriers, 4 floats a cell of the largest extended
// slice, 2 more faces, and 2 parities x 2 sides of k ghost cells (33 KB at
// most, at cs = 1: within the 48 KB a launch gets by default).
struct Shape {
  int threads, cpt;
  size_t smem;
};

Shape shape_of(int C, int cs) {
  const int SE = max_extended(C, cs);
  // one block a lane: min(1,024, C rounded up to a warp) threads; a
  // cluster's block: the same number of cells for every thread
  const int cpt = (SE + kMaxThreads - 1) / kMaxThreads;
  const int threads = cs == 1 ? (SE < kMaxThreads ? (SE + 31) / 32 * 32 : kMaxThreads)
                              : ((SE + cpt - 1) / cpt + 31) / 32 * 32;
  return {threads, (SE + threads - 1) / threads,
          4 * sizeof(unsigned long long) +
              (4 * (size_t)SE + 2 + 8 * (size_t)ghost_cells(C, cs)) * sizeof(float)};
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
cudaError_t launch(const float* h, const float* hu, const float* b,
                   const float* h0_rows, float* mx, float* arr, float* ck,
                   float* ck_mx, int k_ck, int C, int N,
                   int n_steps, int r0, int r1, float dt_dx, float g,
                   float h_dry, float thresh, int cs, const Shape& sh,
                   cudaStream_t stream) {
  if (cs == 1) {
    swe_solve_kernel<CPT, false><<<N, sh.threads, sh.smem, stream>>>(
        h, hu, b, h0_rows, mx, arr, ck, ck_mx, k_ck, C, N, n_steps, r0, r1, dt_dx,
        g, h_dry, thresh);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(N * cs, cs, sh, &attr, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, swe_solve_kernel<CPT, true>, h, hu, b, h0_rows, mx, arr, ck, ck_mx, k_ck,
      C, N, n_steps, r0, r1, dt_dx, g, h_dry, thresh);
  // read and clear the launch error either way, so that it is not reported
  // later against another kernel
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

bool valid_cluster(int C, int cs) {
  return cs >= 1 && (cs & (cs - 1)) == 0 && cs <= C;
}

}  // namespace

// C entry point, bound with ctypes. h, hu: [C, N] row-major; b: [C];
// h0_rows: [2], the depths at rest of buoy rows r0 and r1; mx, arr: [2, N]
// outputs; cs: the cluster size, blocks a lane (a power of two, at most C;
// a Hopper card schedules at most 8, the portable limit). With a non-null
// ck, also the checkpoints of the adjoint (swe_solve_vjp.cu): before each
// step s = j k_ck, the state (h, hu) into ck [N, n_seg, 2, C] at j and the
// running max into ck_mx [n_seg, 2, N] at j, n_seg = ceil(n_steps / k_ck);
// they change nothing else (null: none are written). Launches on `stream`
// and returns the launch's cudaError (0 on success); it never synchronises.
// The wrapper checks the arguments; this rejects what the kernel cannot take
// (2 <= C <= 2048, N >= 1, 0 <= n_steps, r0 and r1 in [0, C), k_ck >= 1 with
// a ck). A cluster size the card refuses is returned as the launch's error,
// never retried at another.
extern "C" int swe_solve_f32(const float* h, const float* hu, const float* b,
                             const float* h0_rows, float* mx, float* arr,
                             int C, int N, int n_steps, int r0, int r1,
                             float dt_dx, float g, float h_dry, float thresh,
                             int cs, float* ck, float* ck_mx, int k_ck,
                             void* stream) {
  if (C < 2 || C > 2 * kMaxThreads || N < 1 || n_steps < 0 || r0 < 0 ||
      r0 >= C || r1 < 0 || r1 >= C || !valid_cluster(C, cs) ||
      (ck != nullptr && (k_ck < 1 || ck_mx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(C, cs);
  const cudaStream_t s = (cudaStream_t)stream;
  if (sh.cpt == 1)
    return (int)launch<1>(h, hu, b, h0_rows, mx, arr, ck, ck_mx, k_ck, C, N,
                          n_steps, r0, r1, dt_dx, g, h_dry, thresh, cs, sh, s);
  return (int)launch<2>(h, hu, b, h0_rows, mx, arr, ck, ck_mx, k_ck, C, N,
                        n_steps, r0, r1, dt_dx, g, h_dry, thresh, cs, sh, s);
}

// How many clusters of cs blocks of a C-cell solve the current device holds
// at once (cudaOccupancyMaxActiveClusters; at cs = 1, blocks a SM times the
// SMs), into *out. Returns the cudaError (0 on success).
extern "C" int swe_solve_max_active_clusters(int C, int cs, int* out) {
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
                      &per_sm, swe_solve_kernel<1, false>, sh.threads, sh.smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, swe_solve_kernel<2, false>, sh.threads, sh.smem);
    if (err == cudaSuccess) *out = per_sm * sms;
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(cs, cs, sh, &attr, nullptr);
    err = sh.cpt == 1
              ? cudaOccupancyMaxActiveClusters(out, swe_solve_kernel<1, true>, &cfg)
              : cudaOccupancyMaxActiveClusters(out, swe_solve_kernel<2, true>, &cfg);
  }
  cudaGetLastError();  // clear it: the caller gets it as the return value
  return (int)err;
}
