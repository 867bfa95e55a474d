// Causal or full GQA flash-attention backward on Hopper's tensor cores
// (sm_90a), for float32: FlashAttention-2's algorithm, with no atomics.
// bf16 inputs go to flash_attention_bwd_wgmma.cu (wgmma and TMA).
//
// Replaces: no TPU kernel. The JAX package cannot differentiate its
// `pallas_call` (src/repro/kernels/flash_attention/flash_attention.py:129
// has no VJP rule) and trains on its XLA path only; the port's attention
// path is the forward kernel (flash_attention_wgmma.cu for bf16,
// flash_attention.cu for float32), so its gradient needs a kernel of its
// own. The plain version is
// src/repro_torch/kernels/flash_attention/ref.py::attention_bwd_ref, the same
// arithmetic in tensor ops. For q, o, dO [B, nq, Sq, hd], k, v [B, nkv, Sk,
// hd] (q head h reads kv head h / (nq / nkv)), the forward's per-row
// log-sum-exp LSE [B, nq, Sq] (float32, of the scaled, masked scores) and
// the runtime `scale`:
//   P  = exp(scale q k^T - LSE)             (masked entries 0)
//   D  = rowsum(dO o o)                     (float32)
//   dV = sum over the group of P^T dO
//   dS = P o (dO v^T - D)
//   dK = scale * sum over the group of dS^T q
//   dQ = scale * dS k
// Three kernels, launched in this order on one stream:
//   1. dsum_kernel: D, one warp a row.
//   2. dkdv_kernel: one block per (b, kv head, 64-key tile). Each of its 4
//      warps owns 16 keys and keeps their dK and dV rows in float32
//      registers for the whole sweep: over the group's q heads and their q
//      tiles (causal: only the tiles at or below the diagonal), it
//      recomputes P^T = exp(scale K Q^T - LSE), adds P^T dO into dV,
//      computes dP^T = V dO^T and dS^T, and adds dS^T Q into dK. The GQA sum
//      over the group happens inside the block: no atomics.
//   3. dq_kernel: one block per (b, q head, 64-row q tile); each warp owns 16
//      q rows, and loops over the KV tiles (causal: up to the diagonal),
//      recomputing P and dS (two products) and adding dS K into dQ. The
//      recomputation of P and dP costs two products more than
//      FlashAttention-2's single pass with an atomic dQ, and makes every
//      gradient a fixed sum: a replayed step is bit for bit.
// Masking follows the forward exactly: causal (needs Sq == Sk; the wrapper
// and the entry point refuse Sq != Sk) drops key > row; keys >= Sk and rows
// >= Sq are zero-filled and drop out (P = 0 there).
//
// What bounds it on this card: operations. The five products of the
// gradient (S, dV, dP, dK, dQ; this design computes seven) are 2.5 x the
// forward's: at qwen3-0.6b's widths in float32, [2, 16, 8, 2048, 128],
// causal, 86 GFLOP for 0.20 GB of q, k, v, o, dO, dq, dk, dv, ~430
// operations a byte; in 3xBF16 three times that runs on the tensor cores,
// far above the bf16 ridge (~295).
//
// What the design does about it: every product runs on the tensor cores as
// mma.sync m16n8k16 bf16 with float32 sums. Tiles go to shared memory as
// bf16 rows padded by 8 elements (16 B), so ldmatrix's eight row addresses
// fall in eight different bank groups; ldmatrix (plain, and .trans for an
// operand read along its rows' other axis) loads every fragment. A product's
// float32 accumulator tile is the A fragment of the next product as it lies
// in the registers (P and dS never go through shared memory). The float32
// inputs are split once, when a tile lands, into bf16 high and low parts, x
// = hi + lo (+ |x| 2^-18 at most), and each product is lo*hi + hi*lo +
// hi*hi (3xBF16, the split of flash_attention.cu's 3xTF32 in bf16
// fragments): about 2^-16 of each product term, within the float32 bound of
// 1e-4 of each gradient's largest element, for three times the tensor-core
// work. q, k, v, o, dO and the gradients are read and written through
// strides (the model's [B, S, n, hd] tensors arrive as transposed views),
// with 64-bit offsets.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int BK = 16 * WARPS;   // keys of a KV tile (dK/dV kernel: 16 a warp)
constexpr int BQ2 = 16 * WARPS;  // q rows of the dQ kernel's tile (16 a warp)

// q rows of a q tile in the dK/dV kernel: 32 at hd = 128 keeps its dK and dV
// rows (128 float32 registers a thread) and two score tiles in registers
template <int D>
struct Config { static constexpr int BQ = D == 128 ? 32 : 64; };

// element strides of the B, n and S dims of q, k, v, o, dO, dq, dk, dv
// (hd has stride 1)
struct Strides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo, both bf16 (lo = bf16(x - hi), x - hi exact in float32)
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = x - hi;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A tile in shared memory: R rows of D columns as bf16 high and low parts,
// row stride D + 8
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// rows [row0, row0 + R) of one head's [S, D] slice (row stride `rs`
// elements) into hi and lo, zeros past S
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* hi, bf16* lo, const float* g, long long rs,
                                          int row0, int S) {
  constexpr int RS = row_stride<D>();
  constexpr int CH = D / 8;  // 8-element chunks of a row
  for (int e = threadIdx.x; e < R * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool in = row0 + r < S;
    float x[8];
    if (in) {
      const float4 a = *reinterpret_cast<const float4*>(g + (long long)(row0 + r) * rs + c);
      const float4 b = *reinterpret_cast<const float4*>(g + (long long)(row0 + r) * rs + c + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h0, l0, h1, l1;
      split(x[2 * i], h0, l0);
      split(x[2 * i + 1], h1, l1);
      h[i] = pack(h0, h1);
      l[i] = pack(l0, l1);
    }
    *reinterpret_cast<uint4*>(hi + r * RS + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * RS + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// acc[16 x 8 NT] += A[16 x D] B^T, A the 16 rows at `a` and B the 8 NT rows
// at `b` of two tiles in shared memory (k along the rows of both), in 3xBF16
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a_hi,
                                        const bf16* a_lo, const bf16* b_hi, const bf16* b_lo) {
  constexpr int RS = row_stride<D>();
  const int lane = threadIdx.x & 31;
  const int a_off = (lane & 15) * RS + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t ah[4], al[4];
    ldsm4(ah, a_hi + a_off + kk * 16);
    ldsm4(al, a_lo + a_off + kk * 16);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bh[4], bl[4];
      ldsm4(bh, b_hi + b_off + j * 8 * RS + kk * 16);
      ldsm4(bl, b_lo + b_off + j * 8 * RS + kk * 16);
      mma(acc[j], al, bh[0], bh[1]);
      mma(acc[j], ah, bl[0], bl[1]);
      mma(acc[j + 1], al, bh[2], bh[3]);
      mma(acc[j + 1], ah, bl[2], bl[3]);
      mma(acc[j], ah, bh[0], bh[1]);
      mma(acc[j + 1], ah, bh[2], bh[3]);
    }
  }
}

// acc[16 x D] += X[16 x 16 KS] B, X in registers in the accumulator layout
// (x[j] the 16 x 8 tile of columns 8j..), B the 16 KS rows of D columns of a
// tile in shared memory (k along its rows: ldmatrix .trans), in 3xBF16 from
// X's high and low parts.
template <int D, int KS>
__device__ __forceinline__ void mma_xb(float (&acc)[D / 8][4], const float (&x)[2 * KS][4],
                                       const bf16* b_hi, const bf16* b_lo) {
  constexpr int RS = row_stride<D>();
  const int lane = threadIdx.x & 31;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    // the A fragment of rows g, g + 8 and columns 16 kk + 2t (+1, +8, +9)
    const float* x0 = x[2 * kk];
    const float* x1 = x[2 * kk + 1];
    uint32_t ah[4], al[4];
    float h[8], l[8];
    const float v[8] = {x0[0], x0[1], x0[2], x0[3], x1[0], x1[1], x1[2], x1[3]};
#pragma unroll
    for (int i = 0; i < 8; ++i) split(v[i], h[i], l[i]);
    ah[0] = pack(h[0], h[1]); ah[1] = pack(h[2], h[3]);
    ah[2] = pack(h[4], h[5]); ah[3] = pack(h[6], h[7]);
    al[0] = pack(l[0], l[1]); al[1] = pack(l[2], l[3]);
    al[2] = pack(l[4], l[5]); al[3] = pack(l[6], l[7]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bh[4], bl[4];
      ldsm4t(bh, b_hi + b_off + kk * 16 * RS + n * 8);
      ldsm4t(bl, b_lo + b_off + kk * 16 * RS + n * 8);
      mma(acc[n], al, bh[0], bh[1]);
      mma(acc[n], ah, bl[0], bl[1]);
      mma(acc[n + 1], al, bh[2], bh[3]);
      mma(acc[n + 1], ah, bl[2], bl[3]);
      mma(acc[n], ah, bh[0], bh[1]);
      mma(acc[n + 1], ah, bh[2], bh[3]);
    }
  }
}

// rows g and g + 8 (of 16 from `row0`) of a [16 x D] accumulator times `mul`
// into one head's slice of a gradient, rows < S
template <int D>
__device__ __forceinline__ void store_rows(float* g, long long rs, int row0, int S,
                                           const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + gr + 8 * half;
    if (row >= S) continue;
    float* p = g + (long long)row * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) =
          make_float2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// ---- 1. D = rowsum(dO o o), one warp a row ------------------------------------------

template <int D>
__global__ void __launch_bounds__(256) dsum_kernel(const float* __restrict__ o,
                                                   const float* __restrict__ dout,
                                                   float* __restrict__ dsum, Strides st, int nq,
                                                   int Sq, long long rows) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = r / Sq, b = bh / nq, h = bh % nq, i = r % Sq;
  const float* orow = o + b * st.o[0] + h * st.o[1] + i * st.o[2];
  const float* drow = dout + b * st.dout[0] + h * st.dout[1] + i * st.dout[2];
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s += orow[c] * drow[c];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) dsum[r] = s;
}

// ---- 2. dK and dV ------------------------------------------------------------------------

template <int D>
constexpr int dkdv_smem() {
  return 2 * 2 * (2 * BK + 2 * Config<D>::BQ) * row_stride<D>() + 4 * 2 * Config<D>::BQ;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            float* __restrict__ dk, float* __restrict__ dv, Strides st, int nq, int nkv, int Sq,
            int Sk, long long n_bkv, float scale_log2, float scale, int causal) {
  constexpr int BQ = Config<D>::BQ, RS = row_stride<D>(), NQ = BQ / 8, ND = D / 8;
  extern __shared__ uint4 smem4[];
  bf16* Kh = reinterpret_cast<bf16*>(smem4);  // [BK][RS]
  bf16* Vh = Kh + BK * RS;                      // [BK][RS]
  bf16* Qh = Vh + BK * RS;                      // [BQ][RS]
  bf16* Oh = Qh + BQ * RS;                      // [BQ][RS] dO
  bf16* Kl = Oh + BQ * RS;                      // low parts
  bf16* Vl = Kl + BK * RS;
  bf16* Ql = Vl + BK * RS;
  bf16* Ol = Ql + BQ * RS;
  float* lse2 = reinterpret_cast<float*>(Ol + BQ * RS);  // [BQ], log2 units
  float* dd = lse2 + BQ;                                                // [BQ] D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const long long blk = blockIdx.x;
  const int kt = (int)(blk / n_bkv);  // causal: the longest sweeps (low kt) first
  const long long bkv = blk % n_bkv, b = bkv / nkv, hkv = bkv % nkv;
  const int group = nq / nkv, k0 = kt * BK;
  load_tile<D, BK>(Kh, Kl, k + b * st.k[0] + hkv * st.k[1], st.k[2], k0, Sk);
  load_tile<D, BK>(Vh, Vl, v + b * st.v[0] + hkv * st.v[1], st.v[2], k0, Sk);

  float dK[ND][4], dV[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.f;
  const int key_lo = k0 + 16 * warp + gr;  // this thread's keys: key_lo, key_lo + 8
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt_first = causal ? k0 / BQ : 0;  // the first q tile with a row >= k0

  for (int hg = 0; hg < group; ++hg) {
    const long long h = hkv * group + hg;
    const float* qg = q + b * st.q[0] + h * st.q[1];
    const float* og = dout + b * st.dout[0] + h * st.dout[1];
    const float* lse_h = lse + (b * nq + h) * Sq;
    const float* d_h = dsum + (b * nq + h) * Sq;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D, BQ>(Qh, Ql, qg, st.q[2], q0, Sq);
      load_tile<D, BQ>(Oh, Ol, og, st.dout[2], q0, Sq);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = q0 + i < Sq;
        lse2[i] = in ? lse_h[q0 + i] * LOG2E : __int_as_float(0x7f800000);  // +inf: P = 0
        dd[i] = in ? d_h[q0 + i] : 0.f;
      }
      __syncthreads();
      // causal: a warp whose keys all lie past the tile's last row has P = 0
      if (causal && k0 + 16 * warp > q0 + BQ - 1) continue;

      // P^T = exp(scale K Q^T - LSE): this warp's 16 keys against the BQ rows
      float p[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
      mma_abt<D, NQ>(p, Kh + 16 * warp * RS, Kl + 16 * warp * RS, Qh, Ql);
      const bool diag = causal && k0 + 16 * warp + 15 > q0;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), key = key_lo + 8 * (e >> 1);
          const float x = exp2f(p[j][e] * scale_log2 - lse2[col]);
          p[j][e] = (diag && key > q0 + col) ? 0.f : x;
        }
      // dV += P^T dO
      mma_xb<D, BQ / 16>(dV, p, Oh, Ol);
      // dP^T = V dO^T, then dS^T = P^T o (dP^T - D)
      float ds[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
      mma_abt<D, NQ>(ds, Vh + 16 * warp * RS, Vl + 16 * warp * RS, Oh, Ol);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dd[8 * j + 2 * t + (e & 1)]);
      // dK += dS^T Q
      mma_xb<D, BQ / 16>(dK, ds, Qh, Ql);
    }
  }
  store_rows<D>(dk + b * st.dk[0] + hkv * st.dk[1], st.dk[2], k0 + 16 * warp, Sk, dK, scale);
  store_rows<D>(dv + b * st.dv[0] + hkv * st.dv[1], st.dv[2], k0 + 16 * warp, Sk, dV, 1.f);
}

// ---- 3. dQ -------------------------------------------------------------------------------

template <int D>
constexpr int dq_smem() {
  return 2 * 2 * (2 * BK + 2 * BQ2) * row_stride<D>();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, float* __restrict__ dq, Strides st, int nq, int nkv,
          int Sq, int Sk, int n_qt, long long n_bh, float scale_log2, float scale, int causal) {
  constexpr int RS = row_stride<D>(), NK = BK / 8, ND = D / 8;
  extern __shared__ uint4 smem4[];
  bf16* Qh = reinterpret_cast<bf16*>(smem4);  // [BQ2][RS]
  bf16* Oh = Qh + BQ2 * RS;                     // [BQ2][RS] dO
  bf16* Kh = Oh + BQ2 * RS;                     // [BK][RS]
  bf16* Vh = Kh + BK * RS;                      // [BK][RS]
  bf16* Ql = Vh + BK * RS;                      // low parts
  bf16* Ol = Ql + BQ2 * RS;
  bf16* Kl = Ol + BQ2 * RS;
  bf16* Vl = Kl + BK * RS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const long long blk = blockIdx.x;
  const int qt = n_qt - 1 - (int)(blk / n_bh);  // causal: the longest sweeps first
  const long long bh = blk % n_bh, b = bh / nq, h = bh % nq, hkv = h / (nq / nkv);
  const int q0 = qt * BQ2;
  load_tile<D, BQ2>(Qh, Ql, q + b * st.q[0] + h * st.q[1], st.q[2], q0, Sq);
  load_tile<D, BQ2>(Oh, Ol, dout + b * st.dout[0] + h * st.dout[1], st.dout[2], q0, Sq);
  const float* kg = k + b * st.k[0] + hkv * st.k[1];
  const float* vg = v + b * st.v[0] + hkv * st.v[1];
  // this thread's rows: row_lo, row_lo + 8
  const int row_lo = q0 + 16 * warp + gr;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    lse2[r] = row < Sq ? lse[bh * Sq + row] * LOG2E : __int_as_float(0x7f800000);
    dd[r] = row < Sq ? dsum[bh * Sq + row] : 0.f;
  }

  float dQ[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dQ[n][0] = dQ[n][1] = dQ[n][2] = dQ[n][3] = 0.f;
  const int n_kt_all = (Sk + BK - 1) / BK;
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ2 - 1) / BK + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous KV tile
    load_tile<D, BK>(Kh, Kl, kg, st.k[2], k0, Sk);
    load_tile<D, BK>(Vh, Vl, vg, st.v[2], k0, Sk);
    __syncthreads();
    // causal: a warp whose rows all lie before the tile's first key has P = 0
    if (causal && k0 > q0 + 16 * warp + 15) continue;

    // P = exp(scale Q K^T - LSE): this warp's 16 rows against the BK keys
    float p[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    mma_abt<D, NK>(p, Qh + 16 * warp * RS, Ql + 16 * warp * RS, Kh, Kl);
    const bool edge = (causal && k0 + BK - 1 > q0 + 16 * warp) || k0 + BK > Sk;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1), row = row_lo + 8 * (e >> 1);
        const float x = exp2f(p[j][e] * scale_log2 - lse2[e >> 1]);
        p[j][e] = (edge && ((causal && key > row) || key >= Sk)) ? 0.f : x;
      }
    // dP = dO V^T, then dS = P o (dP - D)
    float ds[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
    mma_abt<D, NK>(ds, Oh + 16 * warp * RS, Ol + 16 * warp * RS, Vh, Vl);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dd[e >> 1]);
    // dQ += dS K
    mma_xb<D, BK / 16>(dQ, ds, Kh, Kl);
  }
  store_rows<D>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], q0 + 16 * warp, Sq, dQ, scale);
}

// ---- host side ------------------------------------------------------------------------------

template <int D>
int launch(const void* q_, const void* k_, const void* v_, const void* o_, const void* dout_,
           const void* lse_, void* dsum_, void* dq_, void* dk_, void* dv_, int B, int nq,
           int nkv, int Sq, int Sk, const Strides& st, int causal, double scale, void* stream) {
  const float *q = static_cast<const float*>(q_), *k = static_cast<const float*>(k_),
              *v = static_cast<const float*>(v_), *o = static_cast<const float*>(o_),
              *dout = static_cast<const float*>(dout_), *lse = static_cast<const float*>(lse_);
  float *dsum = static_cast<float*>(dsum_), *dq = static_cast<float*>(dq_),
        *dk = static_cast<float*>(dk_), *dv = static_cast<float*>(dv_);
  const cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = (float)(1.4426950408889634 * scale), fscale = (float)scale;
  const long long rows = (long long)B * nq * Sq;
  if ((rows + 7) / 8 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  dsum_kernel<D><<<(unsigned int)((rows + 7) / 8), 256, 0, s>>>(o, dout, dsum, st, nq, Sq, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto kv_kernel = dkdv_kernel<D>;
  constexpr int kv_smem = dkdv_smem<D>();
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_bkv = (long long)B * nkv;
  const long long kv_blocks = n_bkv * ((Sk + BK - 1) / BK);
  if (kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kv_kernel<<<(unsigned int)kv_blocks, THREADS, kv_smem, s>>>(
      q, k, v, dout, lse, dsum, dk, dv, st, nq, nkv, Sq, Sk, n_bkv, scale_log2, fscale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto q_kernel = dq_kernel<D>;
  constexpr int q_smem = dq_smem<D>();
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_bh = (long long)B * nq;
  const int n_qt = (Sq + BQ2 - 1) / BQ2;
  if (n_bh * n_qt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  q_kernel<<<(unsigned int)(n_bh * n_qt), THREADS, q_smem, s>>>(
      q, k, v, dout, lse, dsum, dq, st, nq, nkv, Sq, Sk, n_qt, n_bh, scale_log2, fscale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 values of the scratch `dsum` that flash_attention_bwd takes for q of
// [B, nq, Sq, hd]: the rows' D, [B, nq, Sq].
extern "C" long long flash_attention_bwd_scratch(int B, int nq, int Sq) {
  return (long long)B * nq * Sq;
}

// Launch the three kernels on `stream` (D, dK/dV, dQ); returns the first
// cudaError_t of a launch (0 = success). q, o, dout, dq [B, nq, Sq, hd]; k,
// v, dk, dv [B, nkv, Sk, hd]; all float32; `strides` holds the element
// strides of the B, n and S dims of q, k, v, o, dout, dq, dk and dv in that
// order (24 values; hd has stride 1), each a multiple of 16 bytes, every base
// 16-byte aligned; lse float32 [B, nq, Sq] contiguous (the forward's, natural
// log of the scaled scores); dsum float32 scratch of
// flash_attention_bwd_scratch(B, nq, Sq) values the first kernel writes; hd
// in {32, 64, 128}; nq a multiple of nkv; causal (1) needs Sq == Sk; `scale`
// (> 0) as in the forward.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dsum, void* dq,
                                   void* dk, void* dv, int B, int nq, int nkv, int Sq, int Sk,
                                   int hd, const long long* strides, int causal, double scale,
                                   void* stream) {
  if (B <= 0 || nq <= 0 || nkv <= 0 || nq % nkv != 0 || Sq <= 0 || Sk <= 0 ||
      (causal && Sq != Sk) || !(scale > 0.0))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.dout[i] = strides[12 + i];
    st.dq[i] = strides[15 + i];
    st.dk[i] = strides[18 + i];
    st.dv[i] = strides[21 + i];
  }
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, nq, nkv, Sq, Sk, st, causal,
                        scale, stream);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, nq, nkv, Sq, Sk, st, causal,
                        scale, stream);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, nq, nkv, Sq, Sk, st, causal,
                         scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
