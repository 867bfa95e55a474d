// Causal or full GQA flash-attention backward for bf16 on Hopper's tensor
// cores (sm_90a): wgmma for every product, TMA for the tiles, no atomics.
//
// Replaces: no TPU kernel. The JAX package cannot differentiate its
// `pallas_call` (src/repro/kernels/flash_attention/flash_attention.py:129
// has no VJP rule) and trains on its XLA path only; the port's attention
// path is the forward kernel, so its gradient needs a kernel of its own.
// float32 inputs go to flash_attention_bwd.cu (3xBF16 on mma.sync). The
// plain version is src/repro_torch/kernels/flash_attention/ref.py::
// attention_bwd_ref, the same arithmetic in tensor ops. For q, o, dO [B, nq,
// Sq, hd], k, v [B, nkv, Sk, hd] (q head h reads kv head h / (nq / nkv)),
// the forward's per-row log-sum-exp LSE [B, nq, Sq] (float32, of the
// scaled, masked scores) and the runtime `scale`:
//   P  = exp(scale q k^T - LSE)             (masked entries 0)
//   D  = rowsum(dO o o)                     (float32)
//   dV = sum over the group of P^T dO
//   dS = P o (dO v^T - D)
//   dK = scale * sum over the group of dS^T q
//   dQ = scale * dS k
// P and dS are rounded to bf16 before their products (as the forward rounds
// P); every sum is float32. Causal needs Sq == Sk.
//
// What bounds it on this card: operations. The gradient's five products
// (S, dV, dP, dK, dQ) at qwen3-0.6b's training shape [4, 16, 8, 4096, 128],
// causal, are 0.69 TFLOP a layer for 0.27 GB: ~2,600 operations a byte,
// far above the bf16 ridge (~295). Only wgmma reaches the tensor cores'
// full rate.
//
// What the design does about it (FlashAttention-3's backward, without its
// atomic dQ): three kernels on one stream.
// 1. bwd_stats_kernel, one warp a row: D = rowsum(dO o o), and LSE in log2
//    units, into a float32 scratch [2][B nq][Sq_pad] whose rows are padded
//    to ROW_PAD with LSE = +inf (P = 0) and D = 0, so that the next two
//    kernels read whole tiles of it with no bounds check.
// 2. dkdv_wgmma_kernel: one block of three warpgroups per (b, kv head,
//    128-key tile), the longest causal sweeps first. Warpgroup 0 is the
//    producer: one thread issues every TMA load, and the warpgroup gives its
//    registers away (setmaxnreg 24). K and V are resident, loaded once; the
//    group's q heads and their q tiles of 64 rows (causal: those at or below
//    the diagonal) stream through a ring of STAGES stages, each Q, dO and
//    the tile's rows of the scratch, with a full and an empty mbarrier as in
//    the forward. Warpgroups 1 and 2 (setmaxnreg 240) own 64 keys each (the
//    m64 of wgmma) and keep their dK and dV rows in float32 registers for
//    the whole sweep, so the group's sum happens in the block. Per q tile:
//    S^T = K Q^T and dP^T = V dO^T (both operands in shared memory, both
//    K-major), P^T and dS^T in registers (the accumulator's fragment), then
//    dV += P^T dO and dK += dS^T Q with P^T and dS^T, packed to bf16, as the
//    register A operand and dO and Q as the MN-major B operand: the tile that
//    was K-major for the first two products, read through a second
//    descriptor.
// 3. dq_wgmma_kernel: the forward's structure. One block per (b, q head,
//    128-row q tile), Q and dO resident, the KV tiles (causal: up to the
//    diagonal) streaming through the ring; per tile S = Q K^T and dP = dO
//    V^T (shared memory, K-major), dS in registers, dQ += dS K (K MN-major).
//    This recomputes P and dP (seven products for FlashAttention-2's five)
//    so that dQ, like dK and dV, is a sum in a fixed order: no atomics, and
//    a replayed training step is bit for bit.
// Masks: the dK/dV kernel masks only the diagonal tile (its rows are keys:
// a key >= Sk gives nothing to a row that is stored); the dQ kernel masks
// the diagonal tile and keys >= Sk. q rows >= Sq and keys >= Sk arrive
// zero-filled by TMA, and the scratch's LSE = +inf zeroes P on rows >= Sq.
// Layout through strides: q, k, v and dO are read through one 4-D tensor
// map each over the strided [B, S, n, hd] view (the forward's maps and
// swizzles, wgmma_tma.cuh), o through its strides, and dq, dk, dv written
// through theirs with 4-byte stores; rows >= Sq (>= Sk) are never written.
#include "wgmma_tma.cuh"

namespace {

constexpr int THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int STAGES = 2;     // tiles in flight in either kernel's ring
constexpr int BKV = 128;      // dK/dV kernel: keys of a block, 64 per consumer
constexpr int BQT = 64;       // dK/dV kernel: q rows of a streamed tile
constexpr int BQ = 128;       // dQ kernel: q rows of a block, 64 per consumer
constexpr int ROW_PAD = 128;  // the scratch's rows per (b, q head): Sq rounded up
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// ---- what the forward does not use (the rest: wgmma_tma.cuh) -------------------

// `bytes` (a multiple of 16) contiguous bytes from global memory into shared
// memory, both 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

// ---- tiles -----------------------------------------------------------------------

// the box geometry (wgmma_tma.cuh) and both kernels' tiles of head dim D.
// BK is the dQ kernel's key tile: 128 at every D, since its S, dP and dQ
// accumulators (192 floats a thread at D = 128) fit the consumers' 240
// registers without a spill (the build log's -Xptxas -v)
template <int D>
struct Tile : Swizzle<D> {
  static constexpr int BK = 128;
  // bytes of a K or V tile and of a q or dO tile, in each kernel
  static constexpr int KV_BYTES = BKV * D * 2, QT_BYTES = BQT * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2, KT_BYTES = BK * D * 2;
  // 1024 bytes to align the tiles to the swizzle's 1 KB pattern, the tiles,
  // (dK/dV: the scratch rows of each stage) and 2 * STAGES + 1 mbarriers
  static constexpr int DKDV_SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * QT_BYTES +
                                   STAGES * 2 * BQT * 4 + 8 * (2 * STAGES + 1);
  static constexpr int DQ_SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * KT_BYTES + 8 * (2 * STAGES + 1);
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// acc[64 x D] (this thread's rows r_lo, r_lo + 8 of the wgmma fragment) times
// `mul` into one head's slice of a gradient (row stride `rs`), rows < S
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, long long rs, int r_lo, int S,
                                           const float (&acc)[D / 2], float mul) {
  const int col_base = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r_lo + 8 * half;
    if (row >= S) continue;
    bf16* grow = g + (long long)row * rs + col_base;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(grow + 8 * j) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// ---- 1. the rows' statistics: LSE in log2 units and D = rowsum(dO o o) -----------

template <int D>
__global__ void __launch_bounds__(256)
bwd_stats_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ stats, long long o_sb,
             long long o_sn, long long o_ss, long long do_sb, long long do_sn, long long do_ss,
             int nq, int Sq, int Sq_pad, long long rows) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = r / Sq_pad, b = bh / nq, h = bh % nq;
  const int i = (int)(r % Sq_pad);
  float s = 0.f;
  if (i < Sq) {
    const bf16* orow = o + b * o_sb + h * o_sn + i * o_ss;
    const bf16* drow = dout + b * do_sb + h * do_sn + i * do_ss;
#pragma unroll
    for (int c = lane; c < D; c += 32) s += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  }
  if (lane == 0) {
    stats[r] = i < Sq ? lse[bh * Sq + i] * LOG2E : __int_as_float(0x7f800000);  // +inf: P = 0
    stats[rows + r] = s;
  }
}

// ---- 2. dK and dV -------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  long long dk_sb, long long dk_sn, long long dk_ss, long long dv_sb,
                  long long dv_sn, long long dv_ss, int nq, int nkv, int Sq, int Sk, int Sq_pad,
                  long long stats_half, long long n_bkv, float scale_log2, float scale,
                  int causal, int perm_q, int perm_k, int perm_v, int perm_do) {
  using T = Tile<D>;
  constexpr int KV_BYTES = T::KV_BYTES, QT_BYTES = T::QT_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + KV_BYTES;
  uint8_t* Qs = Vs + KV_BYTES;  // stage s: Q at s * 2 * QT_BYTES, dO after it
  // stage s: the tile's LSE (log2 units) at s * 2 * BQT, its D after it
  float* rows_s = reinterpret_cast<float*>(Qs + STAGES * 2 * QT_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_s + STAGES * 2 * BQT);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const long long blk = blockIdx.x;
  const int kt = (int)(blk / n_bkv);  // causal: the longest sweeps (low kt) first
  const long long bkv = blk % n_bkv;
  const int b = (int)(bkv / nkv), hkv = (int)(bkv % nkv);
  const int group = nq / nkv, k0 = kt * BKV;
  const int n_qt = (Sq + BQT - 1) / BQT;
  const int qt_first = causal ? k0 / BQT : 0;  // the first q tile with a row >= k0
  const int per_head = n_qt - qt_first;
  const int n_steps = group * per_head;  // the group's heads, each over its q tiles

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; TMA completes the bytes
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * KV_BYTES);
      load_tile<D>(Ks, &tk, perm_k, hkv, k0, b, BKV, kvbar);
      load_tile<D>(Vs, &tv, perm_v, hkv, k0, b, BKV, kvbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int step = 0; step < n_steps; ++step) {
        const int h = hkv * group + step / per_head, q0 = (qt_first + step % per_head) * BQT;
        mbar_wait(&empty[stage], phase ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[stage], 2 * QT_BYTES + 2 * BQT * 4);
        uint8_t* qs = Qs + stage * 2 * QT_BYTES;
        load_tile<D>(qs, &tq, perm_q, h, q0, b, BQT, &full[stage]);
        load_tile<D>(qs + QT_BYTES, &tdo, perm_do, h, q0, b, BQT, &full[stage]);
        const float* src = stats + ((long long)b * nq + h) * Sq_pad + q0;
        bulk_load(rows_s + stage * 2 * BQT, src, BQT * 4, &full[stage]);
        bulk_load(rows_s + stage * 2 * BQT + BQT, src + stats_half, BQT * 4, &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int key_first = k0 + cw * 64;
    const int r_lo = key_first + warp * 16 + lane / 4;  // this thread's keys: r_lo, r_lo + 8
    const int col_base = (lane % 4) * 2;
    const uint32_t k_addr = smem_addr(Ks) + cw * 64 * T::SW;
    const uint32_t v_addr = smem_addr(Vs) + cw * 64 * T::SW;

    float dK[D / 2], dV[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dK[i] = dV[i] = 0.f;

    mbar_wait(kvbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int step = 0; step < n_steps; ++step) {
      const int q0 = (qt_first + step % per_head) * BQT;
      mbar_wait(&full[stage], phase);
      // causal: keys all past the tile's last row have P = 0
      if (!(causal && key_first > q0 + BQT - 1)) {
        const uint32_t q_addr = smem_addr(Qs + stage * 2 * QT_BYTES);
        const uint32_t do_addr = q_addr + QT_BYTES;
        const float* lse2 = rows_s + stage * 2 * BQT;
        const float* dd = lse2 + BQT;

        // S^T = K Q^T and dP^T = V dO^T: D / 16 k-steps of 32 bytes along
        // the rows, box after box
        float s[BQT / 2], dp[BQT / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int box = kk * 16 / T::CPB, off = (kk * 16 % T::CPB) * 2;
          const uint64_t da = gmma_desc(k_addr + box * BKV * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
          const uint64_t db = gmma_desc(q_addr + box * BQT * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
          wgmma_ss<BQT>(s, da, db, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int box = kk * 16 / T::CPB, off = (kk * 16 % T::CPB) * 2;
          const uint64_t da = gmma_desc(v_addr + box * BKV * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
          const uint64_t db = gmma_desc(do_addr + box * BQT * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
          wgmma_ss<BQT>(dp, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // P^T = exp2(scale log2(e) S^T - LSE) and dS^T = P^T o (dP^T - D).
        // Element i of the fragment: key r_lo + 8 * ((i >> 1) & 1), q row
        // q0 + (i >> 2) * 8 + col_base + (i & 1). Masked on the diagonal tile.
        const bool diag = causal && key_first + 63 > q0;
        uint32_t pt[BQT / 4], dst[BQT / 4];
#pragma unroll
        for (int j = 0; j < BQT / 8; ++j) {
          const int col = j * 8 + col_base;
          const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
          const float2 d = *reinterpret_cast<const float2*>(dd + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const int key = r_lo + ((e & 2) ? 8 : 0), row = q0 + col + (e & 1);
            float p = ex2(s[i] * scale_log2 - ((e & 1) ? l.y : l.x));
            if (diag && key > row) p = 0.f;
            s[i] = p;
            dp[i] = p * (dp[i] - ((e & 1) ? d.y : d.x));
          }
          pt[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
          pt[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
          dst[2 * j] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
          dst[2 * j + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
        }

        // dV += P^T dO and dK += dS^T Q: the A operand from registers (the
        // accumulator layout is the A fragment), dO and Q MN-major: k-steps
        // of 16 q rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQT / 16; ++kk) {
          const uint32_t a[4] = {pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2], pt[4 * kk + 3]};
          wgmma_rs<D>(dV, a, gmma_desc(do_addr + kk * 16 * T::SW, BQT * T::SW, 8 * T::SW,
                                       T::LAYOUT));
        }
#pragma unroll
        for (int kk = 0; kk < BQT / 16; ++kk) {
          const uint32_t a[4] = {dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2], dst[4 * kk + 3]};
          wgmma_rs<D>(dK, a, gmma_desc(q_addr + kk * 16 * T::SW, BQT * T::SW, 8 * T::SW,
                                       T::LAYOUT));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dV);
        fence_regs(dK);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_rows<D>(dk + (long long)b * dk_sb + (long long)hkv * dk_sn, dk_ss, r_lo, Sk, dK, scale);
    store_rows<D>(dv + (long long)b * dv_sb + (long long)hkv * dv_sn, dv_ss, r_lo, Sk, dV, 1.f);
  }
}

// ---- 3. dQ ----------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ stats, bf16* __restrict__ dq, long long dq_sb,
                long long dq_sn, long long dq_ss, int nq, int nkv, int Sq, int Sk, int Sq_pad,
                long long stats_half, int n_qt, long long n_bh, float scale_log2, float scale,
                int causal, int perm_q, int perm_k, int perm_v, int perm_do) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  constexpr int Q_BYTES = T::Q_BYTES, KV_BYTES = T::KT_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* DOs = Qs + Q_BYTES;
  uint8_t* KVs = DOs + Q_BYTES;  // stage s: K at s * 2 * KV_BYTES, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + STAGES * 2 * KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const long long blk = blockIdx.x;
  const int qt = n_qt - 1 - (int)(blk / n_bh);  // causal: the longest sweeps first
  const long long bh = blk % n_bh;              // b * nq + h
  const int b = (int)(bh / nq), h = (int)(bh % nq), hkv = h / (nq / nkv);
  const int q0 = qt * BQ;
  const int n_kt_all = (Sk + BK - 1) / BK;
  // causal (Sq == Sk): KV tiles wholly above the diagonal are never loaded
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / BK + 1) : n_kt_all;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, 2 * Q_BYTES);
      load_tile<D>(Qs, &tq, perm_q, h, q0, b, BQ, qbar);
      load_tile<D>(DOs, &tdo, perm_do, h, q0, b, BQ, qbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * KV_BYTES);
        uint8_t* ks = KVs + stage * 2 * KV_BYTES;
        load_tile<D>(ks, &tk, perm_k, hkv, kt * BK, b, BK, &full[stage]);
        load_tile<D>(ks + KV_BYTES, &tv, perm_v, hkv, kt * BK, b, BK, &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row_first = q0 + cw * 64;
    const int r_lo = row_first + warp * 16 + lane / 4;  // this thread's rows: r_lo, r_lo + 8
    const int col_base = (lane % 4) * 2;
    const uint32_t q_addr = smem_addr(Qs) + cw * 64 * T::SW;
    const uint32_t do_addr = smem_addr(DOs) + cw * 64 * T::SW;
    // the rows' LSE (log2 units) and D: rows < Sq_pad, +inf and 0 past Sq
    const float* st = stats + bh * Sq_pad;
    const float lse0 = st[r_lo], lse1 = st[r_lo + 8];
    const float d0 = st[stats_half + r_lo], d1 = st[stats_half + r_lo + 8];

    float dQ[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dQ[i] = 0.f;

    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BK;
      mbar_wait(&full[stage], phase);
      // causal: rows all before the tile's first key have P = 0
      if (!(causal && k0 > row_first + 63)) {
        const uint32_t k_addr = smem_addr(KVs + stage * 2 * KV_BYTES);
        const uint32_t v_addr = k_addr + KV_BYTES;

        // S = Q K^T and dP = dO V^T
        float s[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int box = kk * 16 / T::CPB, off = (kk * 16 % T::CPB) * 2;
          const uint64_t da = gmma_desc(q_addr + box * BQ * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
          const uint64_t db = gmma_desc(k_addr + box * BK * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
          wgmma_ss<BK>(s, da, db, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int box = kk * 16 / T::CPB, off = (kk * 16 % T::CPB) * 2;
          const uint64_t da = gmma_desc(do_addr + box * BQ * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
          const uint64_t db = gmma_desc(v_addr + box * BK * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
          wgmma_ss<BK>(dp, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // dS = P o (dP - D), P = exp2(scale log2(e) S - LSE). Element i of
        // the fragment: row r_lo + 8 * ((i >> 1) & 1), key
        // k0 + (i >> 2) * 8 + col_base + (i & 1). Masked on the diagonal
        // tile and past Sk.
        const bool masked = (causal && k0 + BK - 1 > row_first) || k0 + BK > Sk;
        uint32_t ds[BK / 4];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const bool hi = i & 2;
          float p = ex2(s[i] * scale_log2 - (hi ? lse1 : lse0));
          if (masked) {
            const int row = r_lo + (hi ? 8 : 0), key = k0 + (i >> 2) * 8 + col_base + (i & 1);
            if ((causal && key > row) || key >= Sk) p = 0.f;
          }
          dp[i] = p * (dp[i] - (hi ? d1 : d0));
        }
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) ds[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);

        // dQ += dS K: dS from registers, K MN-major: k-steps of 16 keys
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
          wgmma_rs<D>(dQ, a, gmma_desc(k_addr + kk * 16 * T::SW, BK * T::SW, 8 * T::SW,
                                       T::LAYOUT));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dQ);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_rows<D>(dq + (long long)b * dq_sb + (long long)h * dq_sn, dq_ss, r_lo, Sq, dQ, scale);
  }
}

// ---- host side ----------------------------------------------------------------------

// the maps of q, k, v and dO of one kernel: q and dO in boxes of `q_rows`
// rows, k and v in boxes of `k_rows`; st as the entry point's `strides`
struct Maps {
  CUtensorMap q, k, v, dout;
  int pq, pk, pv, pdo;
};

template <int D>
int make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int B,
              int nq, int nkv, int Sq, int Sk, const long long* st, int q_rows, int k_rows) {
  int err;
  if ((err = make_map<D>(&m->q, q, B, nq, Sq, st, q_rows, &m->pq))) return err;
  if ((err = make_map<D>(&m->k, k, B, nkv, Sk, st + 3, k_rows, &m->pk))) return err;
  if ((err = make_map<D>(&m->v, v, B, nkv, Sk, st + 6, k_rows, &m->pv))) return err;
  return make_map<D>(&m->dout, dout, B, nq, Sq, st + 12, q_rows, &m->pdo);
}

// The scratch's rows per (b, q head): Sq rounded up to ROW_PAD.
int padded_rows(int Sq) { return (Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD; }

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* stats, void* dq, void* dk, void* dv, int B, int nq, int nkv,
           int Sq, int Sk, const long long* st, int causal, double scale, void* stream) {
  using T = Tile<D>;
  const cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = (float)(1.4426950408889634 * scale), fscale = (float)scale;
  const int Sq_pad = padded_rows(Sq);
  const long long rows = (long long)B * nq * Sq_pad;
  if ((rows + 7) / 8 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Maps m1, m2;
  int err;
  if ((err = make_maps<D>(&m1, q, k, v, dout, B, nq, nkv, Sq, Sk, st, BQT, BKV))) return err;
  if ((err = make_maps<D>(&m2, q, k, v, dout, B, nq, nkv, Sq, Sk, st, BQ, T::BK))) return err;
  float* fstats = static_cast<float*>(stats);

  cudaError_t e;
  bwd_stats_kernel<D><<<(unsigned int)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), fstats, st[9], st[10], st[11], st[12], st[13], st[14], nq,
      Sq, Sq_pad, rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto kv_kernel = dkdv_wgmma_kernel<D>;
  e = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::DKDV_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long n_bkv = (long long)B * nkv;
  const long long kv_blocks = n_bkv * ((Sk + BKV - 1) / BKV);
  if (kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kv_kernel<<<(unsigned int)kv_blocks, THREADS, T::DKDV_SMEM, s>>>(
      m1.q, m1.k, m1.v, m1.dout, fstats, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      st[18], st[19], st[20], st[21], st[22], st[23], nq, nkv, Sq, Sk, Sq_pad, rows, n_bkv,
      scale_log2, fscale, causal, m1.pq, m1.pk, m1.pv, m1.pdo);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto q_kernel = dq_wgmma_kernel<D>;
  e = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long n_bh = (long long)B * nq;
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (n_bh * n_qt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  q_kernel<<<(unsigned int)(n_bh * n_qt), THREADS, T::DQ_SMEM, s>>>(
      m2.q, m2.k, m2.v, m2.dout, fstats, static_cast<bf16*>(dq), st[15], st[16], st[17], nq, nkv,
      Sq, Sk, Sq_pad, rows, n_qt, n_bh, scale_log2, fscale, causal, m2.pq, m2.pk, m2.pv, m2.pdo);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 values of the scratch `stats` that flash_attention_bwd_wgmma takes
// for q of [B, nq, Sq, hd]: the rows' D and their log-sum-exp in log2 units,
// each [B, nq, Sq_pad], Sq_pad = Sq rounded up to a multiple of ROW_PAD.
extern "C" long long flash_attention_bwd_wgmma_scratch(int B, int nq, int Sq) {
  return 2LL * B * nq * padded_rows(Sq);
}

// Launch the three kernels on `stream` (the rows' statistics, dK/dV, dQ);
// returns 0, the first cudaError_t of a launch, or 10000 + the CUresult of a
// tensor map that could not be encoded. q, o, dout, dq [B, nq, Sq, hd]; k,
// v, dk, dv [B, nkv, Sk, hd]; all bf16; `strides` holds the element strides
// of the B, n and S dims of q, k, v, o, dout, dq, dk and dv in that order (24
// values; hd has stride 1), each a multiple of 8 elements, every base 16-byte
// aligned; lse float32 [B, nq, Sq] contiguous (the forward's, natural log of
// the scaled scores); `stats` float32 scratch of
// flash_attention_bwd_wgmma_scratch(B, nq, Sq) values, 16-byte aligned, which
// the first kernel writes; hd in {32, 64, 128}; nq a multiple of nkv; causal
// (1) needs Sq == Sk; `scale` (> 0) as in the forward.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* stats, void* dq, void* dk, void* dv, int B, int nq,
                                         int nkv, int Sq, int Sk, int hd,
                                         const long long* strides, int causal, double scale,
                                         void* stream) {
  if (B <= 0 || nq <= 0 || nkv <= 0 || nq % nkv != 0 || Sq <= 0 || Sk <= 0 ||
      (causal && Sq != Sk) || !(scale > 0.0))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, dout, lse, stats, dq, dk, dv, B, nq, nkv, Sq, Sk, strides,
                        causal, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, stats, dq, dk, dv, B, nq, nkv, Sq, Sk, strides,
                        causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, stats, dq, dk, dv, B, nq, nkv, Sq, Sk, strides,
                         causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
