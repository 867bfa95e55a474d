// Causal or full GQA flash-attention backward for float32 on Hopper's tensor
// cores (sm_90a): every product in 3xBF16 on wgmma, the tiles by TMA, no
// atomics. bf16 inputs go to flash_attention_bwd_wgmma.cu, whose structure
// this kernel keeps.
//
// Replaces: no TPU kernel. The JAX package cannot differentiate its
// `pallas_call` (src/repro/kernels/flash_attention/flash_attention.py:129
// has no VJP rule) and trains on its XLA path only; the port's float32
// attention path is the forward kernel flash_attention.cu, so its gradient
// needs a kernel of its own. The plain version is
// src/repro_torch/kernels/flash_attention/ref.py::attention_bwd_ref, the
// same arithmetic in tensor ops (and bwd_split_ref beside it, the plain
// version of the pre-pass). For q, o, dO [B, nq, Sq, hd], k, v [B, nkv, Sk,
// hd] (q head h reads kv head h / (nq / nkv)), the forward's per-row
// log-sum-exp LSE [B, nq, Sq] (float32, of the scaled, masked scores) and
// the runtime `scale`:
//   P  = exp(scale q k^T - LSE)             (masked entries 0)
//   D  = rowsum(dO o o)
//   dV = sum over the group of P^T dO
//   dS = P o (dO v^T - D)
//   dK = scale * sum over the group of dS^T q
//   dQ = scale * dS k
// Causal needs Sq == Sk.
//
// Precision: every product is 3xBF16. Each float32 operand x is split into
// bf16 parts hi = bf16_rn(x) and lo = bf16_rn(x - hi) (x - hi is exact in
// float32, so x = hi + lo within 2^-17 |x|), and a product A B is lo(A)
// hi(B) + hi(A) lo(B) + hi(A) hi(B), the small terms first, each k-step of
// 16 as three wgmmas into one float32 accumulator: about 2^-16 of each term
// (a CPU emulation at hd 128: 1.4e-5 of each gradient's largest element,
// against the float32 bound of 1e-4). 3xTF32 would be closer (~1e-6) but
// cannot be fed this way: wgmma reads a tf32 operand from shared memory
// K-major only, and the backward contracts q and dO along hd and along the
// rows, k along hd and along the keys, so each would need a transposed
// second copy, and each tf32 part is a float32 tile: K and V resident for
// 64 keys at hd 128 take 128 KB, a stage of q, q^T, dO and dO^T at 32 rows
// another 128 KB, over the 227 KB a block has (ROADMAP 3i).
//
// What bounds it on this card: operations. The five products of the
// gradient (S, dV, dP, dK, dQ; this design computes seven) at qwen3-0.6b's
// widths in float32, [2, 16, 8, 2048, 128], causal, are 86 GFLOP for 0.20
// GB of q, k, v, o, dO, dq, dk, dv: 3xBF16 runs three times that on the
// tensor cores (0.261 ms at 989 TFLOP/s bf16), far above the bf16 ridge.
// The float32 CUDA cores would take 1.283 ms; only wgmma reaches the tensor
// cores' full rate.
//
// What the design does about it: three kernels on one stream,
// FlashAttention-3's backward without its atomic dQ.
// 1. bwd_split_kernel, one warp a row, each lane the columns lane, lane +
//    32, ... (every load and store of a warp contiguous, and D summed in the
//    order of the earlier mma.sync backward, whose gradients these equal bit
//    for bit: the same bf16 products are added in the same order): reads
//    float32 q, k, v, dO and o through their strides once, writes q, k, v
//    and dO as bf16 hi and lo parts into a scratch laid out for TMA ([B, n,
//    S, hd] each, contiguous), and each q row's D and its LSE in log2 units
//    into float32 rows padded to ROW_PAD with LSE = +inf (P = 0) and D = 0,
//    so the next two kernels read whole tiles of them with no bounds check.
//    The split is done once here rather than in shared memory after each
//    load: the dK/dV kernel reads each q tile once per KV tile and the dQ
//    kernel each KV tile once per q tile, so a split at the consumer would
//    repeat it that often.
// 2. dkdv_3xbf16_kernel: one block of three warpgroups per (b, kv head,
//    128-key tile), the longest causal sweeps first. Warpgroup 0 is the
//    producer: one thread issues every TMA load, and the warpgroup gives its
//    registers away (setmaxnreg 24). K and V (hi and lo) are resident,
//    loaded once; the group's q heads and their q tiles of BQT rows (causal:
//    those at or below the diagonal) stream through a ring of KV_STAGES
//    stages, each Q and dO (hi and lo) and the tile's rows of LSE and D,
//    with a full and an empty mbarrier a stage. Warpgroups 1 and 2
//    (setmaxnreg 240) own 64 keys each and keep their dK and dV rows in
//    float32 registers for the whole sweep, so the group's sum happens in
//    the block. Per q tile: S^T = K Q^T and dP^T = V dO^T (both operands in
//    shared memory, K-major), P^T and dS^T in registers, split there into
//    hi and lo bf16 A fragments, then dV += P^T dO and dK += dS^T Q with dO
//    and Q read MN-major through a second descriptor of the same tiles.
// 3. dq_3xbf16_kernel: one block per (b, q head, 128-row q tile), Q and dO
//    (hi and lo) resident, the KV tiles of BK keys (causal: up to the
//    diagonal) streaming through a ring of Q_STAGES; per tile S = Q K^T and
//    dP = dO V^T, dS split in registers, dQ += dS K (K MN-major). It
//    recomputes S and dP so that dQ, like dK and dV, is a sum in a fixed
//    order: no atomics, two calls give the same bits.
// Shared memory sets the tiles at hd 128: K and V as hi and lo for 128 keys
// take 128 KB, so a stage of Q and dO (hi and lo) at 32 rows (32 KB) leaves
// room for two; the dQ kernel likewise holds 128 rows of Q and dO and three
// stages of 32 keys. Config<hd> holds each head dim's tiling, chosen on an
// H100 by scripts/flash_bwd_f32_sweep.py (each kernel's time from a trace;
// PERF.md has the numbers): at hd 128, (BQT, KV_STAGES, BK, Q_STAGES) =
// (32, 2, 32, 3); tried (32, 2, 32, 2) (dQ 6% slower), (32, 3, 32, 3) (the
// same), (64, 1, 64, 1) (dK/dV 11% slower: one stage, and 12 bytes of
// spills) and (32, 2, 64, 1) (dQ 8% slower); at hd 64 (64, 2, 64, 2); tried
// (64, 3, 64, 3) (dQ 6% slower), (32, 3, 32, 3) (16% slower) and
// (64, 2, 128, 2) (the same); at hd 32 (64, 2, 64, 2); tried (64, 4, 64,
// 4) (the same), (32, 2, 32, 2) (17% slower) and (64, 3, 128, 2) (5%
// slower).
// Masks: the dK/dV kernel masks only the diagonal tile (its rows are keys:
// a key >= Sk gives nothing to a row that is stored); the dQ kernel masks
// the diagonal tile and keys >= Sk. q rows >= Sq and keys >= Sk arrive
// zero-filled by TMA, and LSE = +inf zeroes P on rows >= Sq. dq, dk and dv
// are written through their strides with 8-byte stores and 64-bit offsets;
// rows >= Sq (>= Sk) are never written.
#include "wgmma_tma.cuh"

namespace {

constexpr int THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int BKV = 128;      // dK/dV kernel: keys of a block, 64 per consumer
constexpr int BQ = 128;       // dQ kernel: q rows of a block, 64 per consumer
constexpr int ROW_PAD = 128;  // the LSE and D rows per (b, q head): Sq rounded up
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// The tiling of head dim D: BQT q rows a streamed tile and KV_STAGES stages
// in the dK/dV kernel, BK keys a streamed tile and Q_STAGES stages in the
// dQ kernel (each a divisor of ROW_PAD, each kernel within 227 KB)
template <int D>
struct Config;
template <>
struct Config<32> { static constexpr int BQT = 64, KV_STAGES = 2, BK = 64, Q_STAGES = 2; };
template <>
struct Config<64> { static constexpr int BQT = 64, KV_STAGES = 2, BK = 64, Q_STAGES = 2; };
template <>
struct Config<128> { static constexpr int BQT = 32, KV_STAGES = 2, BK = 32, Q_STAGES = 3; };

// the box geometry (wgmma_tma.cuh), the tiles and both kernels' shared memory
template <int D>
struct Tile : Swizzle<D>, Config<D> {
  using C = Config<D>;
  // bytes of one part (hi or lo) of a K or V tile and of a q or dO tile, in
  // each kernel
  static constexpr int KV_BYTES = BKV * D * 2, QT_BYTES = C::BQT * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2, KT_BYTES = C::BK * D * 2;
  // 1024 bytes to align the tiles to the swizzle's 1 KB pattern, the tiles,
  // (dK/dV: the LSE and D rows of each stage) and 2 * STAGES + 1 mbarriers
  static constexpr int DKDV_SMEM = 1024 + 4 * KV_BYTES + C::KV_STAGES * 4 * QT_BYTES +
                                   C::KV_STAGES * 2 * C::BQT * 4 + 8 * (2 * C::KV_STAGES + 1);
  static constexpr int DQ_SMEM =
      1024 + 4 * Q_BYTES + C::Q_STAGES * 4 * KT_BYTES + 8 * (2 * C::Q_STAGES + 1);
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448, "over the 227 KB of a block");
  static_assert(ROW_PAD % C::BQT == 0 && C::BQT % 16 == 0 && C::BK % 16 == 0, "tile rows");
};

// the tensor maps of the scratch's hi and lo parts of q, dO, k and v
struct Maps {
  CUtensorMap q[2], dout[2], k[2], v[2];
};

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

// D[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
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
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

// x = hi + lo for a pair of values, as bf16x2 A-fragment registers
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d[64 x N] (+)= A[64 x D] B[N x D]^T in 3xBF16: A the 64 rows at a_hi / a_lo
// of a tile of `a_rows` rows, B a tile of N rows at b_hi / b_lo, all K-major
// (hd along the rows): D / 16 k-steps of 32 bytes along the rows, box after
// box, each lo*hi, hi*lo, hi*hi. The first wgmma overwrites d.
template <int N, int D>
__device__ __forceinline__ void abt_3x(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                       int a_rows, uint32_t b_hi, uint32_t b_lo) {
  using T = Swizzle<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / T::CPB, off = (kk * 16 % T::CPB) * 2;
    const uint32_t a_off = box * a_rows * T::SW + off, b_off = box * N * T::SW + off;
    const uint64_t ah = gmma_desc(a_hi + a_off, 16, 8 * T::SW, T::LAYOUT);
    const uint64_t al = gmma_desc(a_lo + a_off, 16, 8 * T::SW, T::LAYOUT);
    const uint64_t bh = gmma_desc(b_hi + b_off, 16, 8 * T::SW, T::LAYOUT);
    const uint64_t bl = gmma_desc(b_lo + b_off, 16, 8 * T::SW, T::LAYOUT);
    wgmma_ss<N>(d, al, bh, kk > 0);
    wgmma_ss<N>(d, ah, bl, 1);
    wgmma_ss<N>(d, ah, bh, 1);
  }
}

// d[64 x D] += X[64 x 16 KS] B[16 KS x D] in 3xBF16: X's hi and lo A
// fragments in registers (k-step kk: x[4 kk .. 4 kk + 3]), B a tile of 16 KS
// rows at b_hi / b_lo read MN-major (k along its rows): k-steps of 16 rows,
// each lo*hi, hi*lo, hi*hi
template <int D, int KS>
__device__ __forceinline__ void xb_3x(float (&d)[D / 2], const uint32_t (&x_hi)[4 * KS],
                                      const uint32_t (&x_lo)[4 * KS], uint32_t b_hi,
                                      uint32_t b_lo) {
  using T = Swizzle<D>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t ah[4] = {x_hi[4 * kk], x_hi[4 * kk + 1], x_hi[4 * kk + 2], x_hi[4 * kk + 3]};
    const uint32_t al[4] = {x_lo[4 * kk], x_lo[4 * kk + 1], x_lo[4 * kk + 2], x_lo[4 * kk + 3]};
    const uint64_t bh = gmma_desc(b_hi + kk * 16 * T::SW, 16 * KS * T::SW, 8 * T::SW, T::LAYOUT);
    const uint64_t bl = gmma_desc(b_lo + kk * 16 * T::SW, 16 * KS * T::SW, 8 * T::SW, T::LAYOUT);
    wgmma_rs<D>(d, al, bh);
    wgmma_rs<D>(d, ah, bl);
    wgmma_rs<D>(d, ah, bh);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// acc[64 x D] (this thread's rows r_lo, r_lo + 8 of the wgmma fragment) times
// `mul` into one head's slice of a gradient (row stride `rs`), rows < S
template <int D>
__device__ __forceinline__ void store_rows(float* g, long long rs, int r_lo, int S,
                                           const float (&acc)[D / 2], float mul) {
  const int col_base = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r_lo + 8 * half;
    if (row >= S) continue;
    float* grow = g + (long long)row * rs + col_base;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<float2*>(grow + 8 * j) = make_float2(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// ---- 1. the split, and the rows' LSE in log2 units and D = rowsum(dO o o) ---

// element strides of the B, n and S dims of q, k, v, o and dO (hd has stride 1)
struct InStrides {
  long long q[3], k[3], v[3], o[3], dout[3];
};

// this lane's values of a row (columns lane, lane + 32, ...) into the hi and
// lo parts of the scratch's row
template <int D>
__device__ __forceinline__ void split_row(const float* __restrict__ x, bf16* __restrict__ hi,
                                          bf16* __restrict__ lo, int lane) {
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    const float v = x[c];
    const bf16 h = __float2bfloat16_rn(v);
    hi[c] = h;
    lo[c] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

template <int D>
__global__ void __launch_bounds__(256)
bwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse, InStrides st,
                 bf16* __restrict__ q_hi, bf16* __restrict__ q_lo, bf16* __restrict__ do_hi,
                 bf16* __restrict__ do_lo, bf16* __restrict__ k_hi, bf16* __restrict__ k_lo,
                 bf16* __restrict__ v_hi, bf16* __restrict__ v_lo, float* __restrict__ stats,
                 int nq, int nkv, int Sq, int Sk, int Sq_pad, long long q_rows,
                 long long kv_rows) {
  long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r < q_rows) {
    // a q row: q and dO split, D and the LSE row (+inf and 0 past Sq)
    const long long bh = r / Sq_pad, b = bh / nq, h = bh % nq;
    const int i = (int)(r % Sq_pad);
    float s = 0.f;
    if (i < Sq) {
      const float* qrow = q + b * st.q[0] + h * st.q[1] + i * st.q[2];
      const float* orow = o + b * st.o[0] + h * st.o[1] + i * st.o[2];
      const float* drow = dout + b * st.dout[0] + h * st.dout[1] + i * st.dout[2];
      const long long at = (bh * Sq + i) * D;
      split_row<D>(qrow, q_hi + at, q_lo + at, lane);
      split_row<D>(drow, do_hi + at, do_lo + at, lane);
#pragma unroll
      for (int c = lane; c < D; c += 32) s += orow[c] * drow[c];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    }
    if (lane == 0) {
      stats[r] = i < Sq ? lse[bh * Sq + i] * LOG2E : __int_as_float(0x7f800000);  // +inf: P = 0
      stats[q_rows + r] = s;
    }
    return;
  }
  r -= q_rows;
  if (r >= kv_rows) return;
  // a key row: k and v split
  const long long bh = r / Sk, b = bh / nkv, h = bh % nkv;
  const long long i = r % Sk;
  split_row<D>(k + b * st.k[0] + h * st.k[1] + i * st.k[2], k_hi + r * D, k_lo + r * D, lane);
  split_row<D>(v + b * st.v[0] + h * st.v[1] + i * st.v[2], v_hi + r * D, v_lo + r * D, lane);
}

// ---- 2. dK and dV -------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_3xbf16_kernel(const __grid_constant__ Maps m, const float* __restrict__ stats,
                   float* __restrict__ dk, float* __restrict__ dv, long long dk_sb,
                   long long dk_sn, long long dk_ss, long long dv_sb, long long dv_sn,
                   long long dv_ss, int nq, int nkv, int Sq, int Sk, int Sq_pad,
                   long long stats_half, long long n_bkv, float scale_log2, float scale,
                   int causal, int perm_q, int perm_k) {
  using T = Tile<D>;
  constexpr int BQT = T::BQT, STAGES = T::KV_STAGES;
  constexpr int KV_BYTES = T::KV_BYTES, QT_BYTES = T::QT_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* KV = align1024(smem_raw);  // K hi, K lo, V hi, V lo
  uint8_t* Qs = KV + 4 * KV_BYTES;     // stage s at s * 4 * QT_BYTES: Q hi, Q lo, dO hi, dO lo
  // stage s: the tile's LSE (log2 units) at s * 2 * BQT, its D after it
  float* rows_s = reinterpret_cast<float*>(Qs + STAGES * 4 * QT_BYTES);
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
      mbar_expect_tx(kvbar, 4 * KV_BYTES);
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        load_tile<D>(KV + part * KV_BYTES, &m.k[part], perm_k, hkv, k0, b, BKV, kvbar);
        load_tile<D>(KV + (2 + part) * KV_BYTES, &m.v[part], perm_k, hkv, k0, b, BKV, kvbar);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int step = 0; step < n_steps; ++step) {
        const int h = hkv * group + step / per_head, q0 = (qt_first + step % per_head) * BQT;
        mbar_wait(&empty[stage], phase ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[stage], 4 * QT_BYTES + 2 * BQT * 4);
        uint8_t* qs = Qs + stage * 4 * QT_BYTES;
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          load_tile<D>(qs + part * QT_BYTES, &m.q[part], perm_q, h, q0, b, BQT, &full[stage]);
          load_tile<D>(qs + (2 + part) * QT_BYTES, &m.dout[part], perm_q, h, q0, b, BQT,
                       &full[stage]);
        }
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
    const uint32_t k_hi = smem_addr(KV) + cw * 64 * T::SW, k_lo = k_hi + KV_BYTES;
    const uint32_t v_hi = k_hi + 2 * KV_BYTES, v_lo = k_hi + 3 * KV_BYTES;

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
        const uint32_t q_hi = smem_addr(Qs + stage * 4 * QT_BYTES), q_lo = q_hi + QT_BYTES;
        const uint32_t do_hi = q_hi + 2 * QT_BYTES, do_lo = q_hi + 3 * QT_BYTES;
        const float* lse2 = rows_s + stage * 2 * BQT;
        const float* dd = lse2 + BQT;

        // S^T = K Q^T and dP^T = V dO^T
        float s[BQT / 2], dp[BQT / 2];
        wgmma_fence();
        abt_3x<BQT, D>(s, k_hi, k_lo, BKV, q_hi, q_lo);
        abt_3x<BQT, D>(dp, v_hi, v_lo, BKV, do_hi, do_lo);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // P^T = exp2(scale log2(e) S^T - LSE) and dS^T = P^T o (dP^T - D),
        // split into hi and lo A fragments. Element i of the fragment: key
        // r_lo + 8 * ((i >> 1) & 1), q row q0 + (i >> 2) * 8 + col_base +
        // (i & 1). Masked on the diagonal tile.
        const bool diag = causal && key_first + 63 > q0;
        uint32_t pt_hi[BQT / 4], pt_lo[BQT / 4], ds_hi[BQT / 4], ds_lo[BQT / 4];
#pragma unroll
        for (int j = 0; j < BQT / 8; ++j) {
          const int col = j * 8 + col_base;
          const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
          const float2 d = *reinterpret_cast<const float2*>(dd + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const int key = r_lo + ((e & 2) ? 8 : 0), row = q0 + col + (e & 1);
            float p = exp2f(s[i] * scale_log2 - ((e & 1) ? l.y : l.x));
            if (diag && key > row) p = 0.f;
            s[i] = p;
            dp[i] = p * (dp[i] - ((e & 1) ? d.y : d.x));
          }
          split_pack(s[4 * j], s[4 * j + 1], pt_hi[2 * j], pt_lo[2 * j]);
          split_pack(s[4 * j + 2], s[4 * j + 3], pt_hi[2 * j + 1], pt_lo[2 * j + 1]);
          split_pack(dp[4 * j], dp[4 * j + 1], ds_hi[2 * j], ds_lo[2 * j]);
          split_pack(dp[4 * j + 2], dp[4 * j + 3], ds_hi[2 * j + 1], ds_lo[2 * j + 1]);
        }

        // dV += P^T dO and dK += dS^T Q, dO and Q MN-major: k-steps of 16 q rows
        wgmma_fence();
        xb_3x<D, BQT / 16>(dV, pt_hi, pt_lo, do_hi, do_lo);
        xb_3x<D, BQT / 16>(dK, ds_hi, ds_lo, q_hi, q_lo);
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
dq_3xbf16_kernel(const __grid_constant__ Maps m, const float* __restrict__ stats,
                 float* __restrict__ dq, long long dq_sb, long long dq_sn, long long dq_ss,
                 int nq, int nkv, int Sq, int Sk, int Sq_pad, long long stats_half, int n_qt,
                 long long n_bh, float scale_log2, float scale, int causal, int perm_q,
                 int perm_k) {
  using T = Tile<D>;
  constexpr int BK = T::BK, STAGES = T::Q_STAGES;
  constexpr int Q_BYTES = T::Q_BYTES, KT_BYTES = T::KT_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* QD = align1024(smem_raw);  // Q hi, Q lo, dO hi, dO lo
  uint8_t* KVs = QD + 4 * Q_BYTES;     // stage s at s * 4 * KT_BYTES: K hi, K lo, V hi, V lo
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + STAGES * 4 * KT_BYTES);
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
      mbar_expect_tx(qbar, 4 * Q_BYTES);
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        load_tile<D>(QD + part * Q_BYTES, &m.q[part], perm_q, h, q0, b, BQ, qbar);
        load_tile<D>(QD + (2 + part) * Q_BYTES, &m.dout[part], perm_q, h, q0, b, BQ, qbar);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 4 * KT_BYTES);
        uint8_t* ks = KVs + stage * 4 * KT_BYTES;
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          load_tile<D>(ks + part * KT_BYTES, &m.k[part], perm_k, hkv, kt * BK, b, BK,
                       &full[stage]);
          load_tile<D>(ks + (2 + part) * KT_BYTES, &m.v[part], perm_k, hkv, kt * BK, b, BK,
                       &full[stage]);
        }
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
    const uint32_t q_hi = smem_addr(QD) + cw * 64 * T::SW, q_lo = q_hi + Q_BYTES;
    const uint32_t do_hi = q_hi + 2 * Q_BYTES, do_lo = q_hi + 3 * Q_BYTES;
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
        const uint32_t k_hi = smem_addr(KVs + stage * 4 * KT_BYTES), k_lo = k_hi + KT_BYTES;
        const uint32_t v_hi = k_hi + 2 * KT_BYTES, v_lo = k_hi + 3 * KT_BYTES;

        // S = Q K^T and dP = dO V^T
        float s[BK / 2], dp[BK / 2];
        wgmma_fence();
        abt_3x<BK, D>(s, q_hi, q_lo, BQ, k_hi, k_lo);
        abt_3x<BK, D>(dp, do_hi, do_lo, BQ, v_hi, v_lo);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // dS = P o (dP - D), P = exp2(scale log2(e) S - LSE), split into hi
        // and lo A fragments. Element i of the fragment: row r_lo + 8 * ((i
        // >> 1) & 1), key k0 + (i >> 2) * 8 + col_base + (i & 1). Masked on
        // the diagonal tile and past Sk.
        const bool masked = (causal && k0 + BK - 1 > row_first) || k0 + BK > Sk;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const bool hi = i & 2;
          float p = exp2f(s[i] * scale_log2 - (hi ? lse1 : lse0));
          if (masked) {
            const int row = r_lo + (hi ? 8 : 0), key = k0 + (i >> 2) * 8 + col_base + (i & 1);
            if ((causal && key > row) || key >= Sk) p = 0.f;
          }
          dp[i] = p * (dp[i] - (hi ? d1 : d0));
        }
        uint32_t ds_hi[BK / 4], ds_lo[BK / 4];
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) split_pack(dp[2 * j], dp[2 * j + 1], ds_hi[j], ds_lo[j]);

        // dQ += dS K: dS from registers, K MN-major: k-steps of 16 keys
        wgmma_fence();
        xb_3x<D, BK / 16>(dQ, ds_hi, ds_lo, k_hi, k_lo);
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

// The LSE and D rows per (b, q head): Sq rounded up to ROW_PAD.
long long padded_rows(int Sq) { return (Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD; }

// The scratch: the rows' LSE and D (float32, 2 x B nq Sq_pad), then the
// bf16 hi and lo parts of q, dO (B nq Sq hd each) and of k, v (B nkv Sk hd
// each), in that order.
struct Scratch {
  float* stats;
  bf16 *q[2], *dout[2], *k[2], *v[2];
};

Scratch carve(void* scratch, int B, int nq, int nkv, int Sq, int Sk, int hd) {
  Scratch s;
  s.stats = static_cast<float*>(scratch);
  const long long qn = (long long)B * nq * Sq * hd, kn = (long long)B * nkv * Sk * hd;
  bf16* p = reinterpret_cast<bf16*>(s.stats + 2LL * B * nq * padded_rows(Sq));
  for (int part = 0; part < 2; ++part) s.q[part] = p + part * qn;
  for (int part = 0; part < 2; ++part) s.dout[part] = p + (2 + part) * qn;
  for (int part = 0; part < 2; ++part) s.k[part] = p + 4 * qn + part * kn;
  for (int part = 0; part < 2; ++part) s.v[part] = p + 4 * qn + (2 + part) * kn;
  return s;
}

// the maps of the scratch's parts for one kernel: q and dO in boxes of
// `q_rows` rows, k and v in boxes of `k_rows`
template <int D>
int make_maps(Maps* m, int* pq, int* pk, const Scratch& s, int B, int nq, int nkv, int Sq,
              int Sk, int q_rows, int k_rows) {
  const long long qst[3] = {(long long)nq * Sq * D, (long long)Sq * D, D};
  const long long kst[3] = {(long long)nkv * Sk * D, (long long)Sk * D, D};
  int err;
  for (int part = 0; part < 2; ++part) {
    if ((err = make_map<D>(&m->q[part], s.q[part], B, nq, Sq, qst, q_rows, pq))) return err;
    if ((err = make_map<D>(&m->dout[part], s.dout[part], B, nq, Sq, qst, q_rows, pq))) return err;
    if ((err = make_map<D>(&m->k[part], s.k[part], B, nkv, Sk, kst, k_rows, pk))) return err;
    if ((err = make_map<D>(&m->v[part], s.v[part], B, nkv, Sk, kst, k_rows, pk))) return err;
  }
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* scratch, void* dq, void* dk, void* dv, int B, int nq, int nkv,
           int Sq, int Sk, const long long* st, int causal, double scale, void* stream) {
  using T = Tile<D>;
  const cudaStream_t cs = (cudaStream_t)stream;
  const float scale_log2 = (float)(1.4426950408889634 * scale), fscale = (float)scale;
  const int Sq_pad = (int)padded_rows(Sq);
  const long long q_rows = (long long)B * nq * Sq_pad, kv_rows = (long long)B * nkv * Sk;
  if ((q_rows + kv_rows + 7) / 8 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Scratch s = carve(scratch, B, nq, nkv, Sq, Sk, D);
  Maps m1, m2;
  int pq, pk, err;
  if ((err = make_maps<D>(&m1, &pq, &pk, s, B, nq, nkv, Sq, Sk, T::BQT, BKV))) return err;
  if ((err = make_maps<D>(&m2, &pq, &pk, s, B, nq, nkv, Sq, Sk, BQ, T::BK))) return err;

  InStrides in;
  for (int i = 0; i < 3; ++i) {
    in.q[i] = st[i];
    in.k[i] = st[3 + i];
    in.v[i] = st[6 + i];
    in.o[i] = st[9 + i];
    in.dout[i] = st[12 + i];
  }
  cudaError_t e;
  bwd_split_kernel<D><<<(unsigned int)((q_rows + kv_rows + 7) / 8), 256, 0, cs>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), in, s.q[0], s.q[1], s.dout[0], s.dout[1], s.k[0], s.k[1],
      s.v[0], s.v[1], s.stats, nq, nkv, Sq, Sk, Sq_pad, q_rows, kv_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto kv_kernel = dkdv_3xbf16_kernel<D>;
  e = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::DKDV_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long n_bkv = (long long)B * nkv;
  const long long kv_blocks = n_bkv * ((Sk + BKV - 1) / BKV);
  if (kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kv_kernel<<<(unsigned int)kv_blocks, THREADS, T::DKDV_SMEM, cs>>>(
      m1, s.stats, static_cast<float*>(dk), static_cast<float*>(dv), st[18], st[19], st[20],
      st[21], st[22], st[23], nq, nkv, Sq, Sk, Sq_pad, q_rows, n_bkv, scale_log2, fscale, causal,
      pq, pk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto q_kernel = dq_3xbf16_kernel<D>;
  e = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long n_bh = (long long)B * nq;
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (n_bh * n_qt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  q_kernel<<<(unsigned int)(n_bh * n_qt), THREADS, T::DQ_SMEM, cs>>>(
      m2, s.stats, static_cast<float*>(dq), st[15], st[16], st[17], nq, nkv, Sq, Sk, Sq_pad,
      q_rows, n_qt, n_bh, scale_log2, fscale, causal, pq, pk);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 values of the scratch that flash_attention_bwd_3xbf16 takes for q
// of [B, nq, Sq, hd] and k of [B, nkv, Sk, hd]: the rows' LSE (log2 units)
// and D, each [B, nq, Sq_pad] (Sq rounded up to ROW_PAD), then the bf16 hi
// and lo parts of q, dO, k and v (two bf16 a float32 value).
extern "C" long long flash_attention_bwd_3xbf16_scratch(int B, int nq, int Sq, int nkv, int Sk,
                                                        int hd) {
  return 2LL * B * nq * padded_rows(Sq) + 2LL * B * nq * Sq * hd + 2LL * B * nkv * Sk * hd;
}

// Launch the three kernels on `stream` (the split with the rows' statistics,
// dK/dV, dQ); returns 0, the first cudaError_t of a launch, or 10000 + the
// CUresult of a tensor map that could not be encoded. q, o, dout, dq [B, nq,
// Sq, hd]; k, v, dk, dv [B, nkv, Sk, hd]; all float32; `strides` holds the
// element strides of the B, n and S dims of q, k, v, o, dout, dq, dk and dv
// in that order (24 values; hd has stride 1), each a multiple of 16 bytes,
// every base 16-byte aligned; lse float32 [B, nq, Sq] contiguous (the
// forward's, natural log of the scaled scores); `scratch` float32 of
// flash_attention_bwd_3xbf16_scratch(B, nq, Sq, nkv, Sk, hd) values,
// 16-byte aligned, which the first kernel writes; hd in {32, 64, 128}; nq a
// multiple of nkv; causal (1) needs Sq == Sk; `scale` (> 0) as in the
// forward.
extern "C" int flash_attention_bwd_3xbf16(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* scratch, void* dq, void* dk, void* dv, int B,
                                          int nq, int nkv, int Sq, int Sk, int hd,
                                          const long long* strides, int causal, double scale,
                                          void* stream) {
  if (B <= 0 || nq <= 0 || nkv <= 0 || nq % nkv != 0 || Sq <= 0 || Sk <= 0 ||
      (causal && Sq != Sk) || !(scale > 0.0))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, nq, nkv, Sq, Sk, strides,
                        causal, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, nq, nkv, Sq, Sk, strides,
                        causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, nq, nkv, Sq, Sk, strides,
                         causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
