// Mamba-2 SSD chunk scan on float32, on Hopper's tensor cores (sm_90a).
//
// Replaces: src/repro/kernels/ssd/ssd.py:89 `ssd_kernel` (its pallas_call at
// :110, Pallas body `_ssd_kernel`). For every (batch b, head h) it walks the
// sequence in chunks of Q = 128 in order and, per chunk, with
// cum = cumsum(dt * A):
//   y = (C B^T * L * dt) X + (C S) * exp(cum),  L[i, j] = exp(cum_i - cum_j), j <= i
//   S <- S * exp(total) + B^T diag(dt * exp(total - cum)) X
// with a float32 [N, P] state S. Layouts: x, y [B, H, S, P]; dt [B, H, S]
// (post-softplus); B, C [B, G, S, N] shared by the H / G heads of a group;
// A [H] (negative); s0, s_out [B, H, N, P]. S is a multiple of Q (the
// adapter `ops.ssd` pads with dt = 0); N and P are multiples of 8, P at
// most 128. The plain version with the same arithmetic is
// src/repro_torch/kernels/ssd/ref.py::ssd_chunked_ref.
//
// What bounds it on this card: operations on the tensor cores. The four
// products of a chunk (C B^T over N, the masked scores times X over the
// chunk, C S over N, the state update B^T (w X) over the chunk) run as
// mma.sync m16n8k8 in TF32 with float32 sums. The model's SSD is float32 and
// the kernel is held to its plain version within 1e-4 relative
// (kernels/ssd/testing.py), which one TF32 pass (11-bit mantissas) does not
// promise, so every product is 3xTF32: each operand is split as
// big = tf32(x), small = tf32(x - big), both rounded as cvt.rna rounds, and
// a product is small*big + big*small + big*big, small terms first, which
// keeps it at float32 accuracy for three times the tensor-core work. At
// mamba2-1.3b's grid wave (B = 82, S = 2048, 64 heads, N = 128, P = 64) the
// scan needs 618 GFLOP (the causal triangle counted once;
// chip_smoke.py::ssd_work), so 1.85 TFLOP of TF32 work, 3.75 ms at
// 495 TFLOP/s, above the 1.81 ms its 6.06 GB take at 3.35 TB/s.
//
// What the design does about it: ONE block owns one (b, h) and loops over
// the chunks itself, the state in shared memory for the whole
// sequence (Hopper runs blocks in no order; on the TPU the chunk axis is the
// sequential grid dimension). Its 8 warps each own 16 rows of the chunk's y.
// - One copy of each operand in shared memory serves every product: C and
//   B as they come, [Q][N + 4]; X [Q][P + 4]; the state transposed,
//   [P][N + 4]. Where a fragment's k runs along a row (C in C B^T and C S,
//   B in C B^T, the state in C S), ldmatrix loads it, four 8 x 4 float
//   matrices at a time (as 8 x 8 b16 ones); the others (B read down the
//   chunk as B^T, X) take 32-bit loads. The paddings keep both free of bank
//   conflicts: a row stride of 4 mod 8 words for ldmatrix's 16-byte rows,
//   and for the loads down the chunk the contraction takes k = t <-> row
//   2t, k = t + 4 <-> row 2t + 1 (a permutation that A and B operands
//   share), so that a stride of 4 mod 16 words spreads a warp over 32 banks.
// - The same permutation lets the C B^T accumulator of a 16 x 8 tile serve
//   as the A fragment of scores times X as it lies in the registers: the
//   scores never go through shared memory.
// - The causal mask at tile granularity: a warp computes only the 16 x 16
//   score blocks at or below its diagonal, 32 columns at a time (four
//   independent sums, the small and big terms apart), and masks inside
//   them. The decay exp(cum_i - cum_j) dt_j is applied to the float32 sums
//   before the split; exp(cum) (C S) and w = dt exp(total - cum) (the state
//   update) scale the A operand's rows.
// - Balance: warps k and k + 4 share an SM sub-partition and take row
//   blocks k and 7 - k (9 of the triangle's 36 score blocks each pair); the
//   state update's jobs go to the warps with the fewest score blocks, so
//   all warps meet at the chunk's last barrier at about one time. Every
//   warp reads the old state (C S) before the barrier after which the jobs
//   write the new one, S exp(total) + acc, from their accumulators.
// - Loads by cp.async (16 bytes, .cg) straight into the padded rows, no
//   register round trip; at N = 128, P = 64 the sum below (205,840 B) leaves
//   no room for a second buffer of any operand, so each chunk waits for its
//   own loads.
// - The cumulative sum is a warp scan over the chunk's 128 values in four
//   warps.
// What holds it back (PERF.md): the 32-bit fragment loads and the split
// (four integer and float operations an element) feed each mma triple, and
// a warp owns too few outputs to reuse them much; the chunk's loads are not
// overlapped. Left for later (ROADMAP queue 2): wgmma in TF32 (needs both
// operands K-major in swizzled shared memory, i.e. transposed copies of X
// and B); C B^T is recomputed for every head of a group, as the Pallas
// kernel does; the adapter transposes the model layout in and out (no
// strides).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 128;             // chunk length, as the Pallas kernel's
constexpr int THREADS = 256;       // 8 warps, 16 rows of the chunk each
constexpr int WARPS = THREADS / 32;

// row strides in shared memory, in floats (bank-conflict-free fragments)
__host__ __device__ constexpr int cb_stride(int N) { return N + 4; }
__host__ __device__ constexpr int x_stride(int P) { return P + 4; }

// x = big + small, both TF32, rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero), on the bit pattern: cvt.rna compiles to an
// add, an infinity test and a select on sm_90a, and the test changes nothing
// here (an infinite or NaN operand gives a NaN product either way). big has
// half an ulp added and its low 13 bits cleared; small = x - big gets half an
// ulp added and keeps its low bits, which the tensor core does not read (a
// TF32 operand is the top 19 bits of its register), so it enters the product
// rounded to nearest as well.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

struct FragA {  // 16 x 8 (rows g, g + 8; k = t, t + 4)
  uint32_t big[4], small[4];
};
struct FragB {  // 8 x 8 (k = t, t + 4; column g)
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_a(FragA& f, float a0, float a1, float a2, float a3) {
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
}

__device__ __forceinline__ void split_b(FragB& f, float b0, float b1) {
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Four 8 x 4 float matrices as ldmatrix's four 8 x 8 b16 ones: lane l gives
// the address of row l % 8 of matrix l / 8, and each lane (g, t) gets word t
// of row g of every matrix, which is the TF32 fragments' layout when the
// fragment's k runs along the row (C and B as the operands of C B^T and C S,
// and the transposed state). One instruction loads what four 32-bit loads
// would.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// `rows` rows of `cols` floats, contiguous at `src`, into shared rows of `stride`
__device__ __forceinline__ void copy_rows(float* dst, int stride, const float* src, int rows,
                                          int cols) {
  const int per_row = cols / 4;
  for (int e = threadIdx.x; e < rows * per_row; e += THREADS) {
    const int r = e / per_row, c = (e - r * per_row) * 4;
    cp16(dst + r * stride + c, src + (int64_t)r * cols + c);
  }
}

// The scores of the warp's 16 rows (ia, ib = ia + 8) and the KW * 8 columns
// from j0: C B^T over N, with the small terms and the big ones summed apart
// so that no chain of dependent mma is longer than two; then the causal
// mask and exp(cum_i - cum_j) dt_j on the float32 sums, and the scores
// times X added to acc.
template <int NT, int KW>
__device__ __forceinline__ void intra(float (&acc)[NT][4], const float* c_lane,
                                      const float* b_lane, const float* Xs, const float* cum,
                                      const float* dts, int N, int cs, int xs, int j0, int ia,
                                      int ib, int g, int t) {
  float lo[KW][4], hi[KW][4];
#pragma unroll
  for (int k = 0; k < KW; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) lo[k][e] = hi[k][e] = 0.f;
#pragma unroll 4
  for (int n0 = 0; n0 < N; n0 += 8) {
    uint32_t r[4];
    ldsm4(r, c_lane + n0);
    FragA fa;
    split_a(fa, __uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
            __uint_as_float(r[3]));
#pragma unroll
    for (int k = 0; k < KW; k += 2) {
      ldsm4(r, b_lane + (j0 + k * 8) * cs + n0);  // columns j0 + 8k .. + 15
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        FragB fb;
        split_b(fb, __uint_as_float(r[2 * u]), __uint_as_float(r[2 * u + 1]));
        mma(lo[k + u], fa.small, fb.big);
        mma(lo[k + u], fa.big, fb.small);
        mma(hi[k + u], fa.big, fb.big);
      }
    }
  }
  const float cum_a = cum[ia], cum_b = cum[ib];
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    // the sums hold (ia, ja), (ia, jb), (ib, ja), (ib, jb), jb = ja + 1
    const int ja = j0 + k * 8 + 2 * t, jb = ja + 1;
    const float2 cj = *reinterpret_cast<const float2*>(&cum[ja]);
    const float2 dj = *reinterpret_cast<const float2*>(&dts[ja]);
    const float cja = cj.x, cjb = cj.y, dja = dj.x, djb = dj.y;
    const float v0 = ja <= ia ? (lo[k][0] + hi[k][0]) * expf(cum_a - cja) * dja : 0.f;
    const float v1 = jb <= ia ? (lo[k][1] + hi[k][1]) * expf(cum_a - cjb) * djb : 0.f;
    const float v2 = ja <= ib ? (lo[k][2] + hi[k][2]) * expf(cum_b - cja) * dja : 0.f;
    const float v3 = jb <= ib ? (lo[k][3] + hi[k][3]) * expf(cum_b - cjb) * djb : 0.f;
    // the scores as they lie in the registers are the A operand with
    // k = t <-> column ja and k = t + 4 <-> jb, the permutation of X's rows
    FragA fa;
    split_a(fa, v0, v2, v1, v3);
    const float* x_lo = &Xs[ja * xs + g];
    const float* x_hi = &Xs[jb * xs + g];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      FragB fb;
      split_b(fb, x_lo[nt * 8], x_hi[nt * 8]);
      mma3(acc[nt], fa, fb);
    }
  }
}

// One job of the state update: rows na = n0 + g and nb = na + 8 of S and
// NS n-tiles from column pb: S <- S exp(total) + (diag(w) B)^T X, S kept
// transposed (St [P][N + 4])
template <int NS>
__device__ __forceinline__ void state_job(float* St, const float* Bs, const float* Xs,
                                          const float* wv, int N, int cs, int xs, int n0,
                                          int pb, float et, int g, int t) {
  const int na = n0 + g, nb = na + 8;
  const bool has_b = nb < N;  // N = 8 mod 16 leaves half a block
  float acc[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
  for (int j0 = 0; j0 < Q; j0 += 8) {
    // k = t <-> row ja, k = t + 4 <-> row jb, for both operands
    const int ja = j0 + 2 * t, jb = ja + 1;
    const float2 w2 = *reinterpret_cast<const float2*>(&wv[ja]);
    const float wa = w2.x, wb = w2.y;
    const float* row_a = &Bs[ja * cs];
    const float* row_b = &Bs[jb * cs];
    FragA fa;
    split_a(fa, row_a[na] * wa, has_b ? row_a[nb] * wa : 0.f, row_b[na] * wb,
            has_b ? row_b[nb] * wb : 0.f);
    const float* x_lo = &Xs[ja * xs + pb + g];
    const float* x_hi = &Xs[jb * xs + pb + g];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      FragB fb;
      split_b(fb, x_lo[nt * 8], x_hi[nt * 8]);
      mma3(acc[nt], fa, fb);
    }
  }
  // the accumulator holds (na, p), (na, p + 1), (nb, p), (nb, p + 1)
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    float* s0 = &St[(pb + nt * 8 + 2 * t) * cs];
    float* s1 = s0 + cs;
    s0[na] = s0[na] * et + acc[nt][0];
    s1[na] = s1[na] * et + acc[nt][1];
    if (has_b) {
      s0[nb] = s0[nb] * et + acc[nt][2];
      s1[nb] = s1[nb] * et + acc[nt][3];
    }
  }
}

// NT = P / 8: the n-tiles of a row of y, all held by one warp
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_out,
                      int H, int G, int S, int N) {
  constexpr int P = NT * 8;
  constexpr int xs = x_stride(P);
  // a state job holds NS n-tiles; an even NT gives two jobs per 16 rows
  constexpr int NS = NT % 2 ? NT : NT / 2;
  extern __shared__ float4 smem4[];
  const int cs = cb_stride(N);
  float* Cs = reinterpret_cast<float*>(smem4);  // [Q][cs] C of the chunk
  float* Bs = Cs + Q * cs;                      // [Q][cs] B of the chunk
  float* Xs = Bs + Q * cs;                      // [Q][xs] x of the chunk
  float* St = Xs + Q * xs;                      // [P][cs] the carried state, transposed
  float* dts = St + P * cs;                     // [Q] dt
  float* cum = dts + Q;                         // [Q] cumsum(dt * A)
  float* ecum = cum + Q;                        // [Q] exp(cum)
  float* wv = ecum + Q;                         // [Q] dt * exp(total - cum)
  float* tot = wv + Q;                          // [Q / 32] the scan's warp sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and lane in it
  const int64_t bh = blockIdx.x;          // b * H + h
  const int h = (int)(bh % H);
  const int64_t bg = (bh / H) * G + h / (H / G);
  const float a = A[h];
  const float* xg = x + bh * S * P;  // 64-bit offsets: x can exceed 2^31 elements
  const float* dtg = dt + bh * S;
  const float* Bg = Bm + bg * S * N;
  const float* Cg = Cm + bg * S * N;
  float* yg = y + bh * S * P;

  // The warp's rows of y: warps k and k + 4 share an SM sub-partition (warp
  // slot mod 4), so they take row blocks k and 7 - k, 9 of the causal
  // triangle's 36 blocks of 16 x 16 scores between them.
  const int rb = warp < 4 ? warp : 11 - warp;  // warps 4..7 take blocks 7..4
  const int i0 = rb * 16, ia = i0 + g, ib = ia + 8;
  // The state update's jobs (16 rows of S, NS n-tiles each) go, in order,
  // to the warp with the least work so far (in mma: a score block costs
  // 6 (N / 8 + NT), a job 3 (Q / 8) NS), so that the warps with few score
  // blocks take the jobs and every warp ends its chunk at about one time.
  const int n_jobs = (N + 15) / 16 * (NT / NS);
  uint64_t my_jobs = 0;
  {
    int load[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) load[w] = ((w < 4 ? w : 11 - w) + 1) * 6 * (N / 8 + NT);
    for (int j = 0; j < n_jobs; ++j) {
      int best = 0;
#pragma unroll
      for (int w = 1; w < WARPS; ++w) best = load[w] < load[best] ? w : best;
      load[best] += 3 * (Q / 8) * NS;
      if (best == warp) my_jobs |= 1ull << j;
    }
  }

  for (int e = tid; e < N * P; e += THREADS) {
    const int n = e / P, p = e - n * P;
    St[p * cs + n] = s0[bh * N * P + e];
  }
  const int n_chunks = S / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int64_t r0 = (int64_t)c * Q;
    copy_rows(Cs, cs, Cg + r0 * N, Q, N);
    copy_rows(Bs, cs, Bg + r0 * N, Q, N);
    copy_rows(Xs, xs, xg + r0 * P, Q, P);
    if (tid < Q / 4) cp16(dts + tid * 4, dtg + r0 + tid * 4);
    cp_commit();
    cp_wait_all();
    __syncthreads();  // the chunk's C, B, x and dt have landed

    // inclusive cumsum of dt * A: a scan in each of four warps, then the
    // warp sums in order
    float part = 0.f;
    if (tid < Q) {
      part = dts[tid] * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, part, o);
        if (lane >= o) part += v;
      }
      if (lane == 31) tot[warp] = part;
    }
    __syncthreads();
    float prefix = 0.f, total = 0.f;
#pragma unroll
    for (int k = 0; k < Q / 32; ++k) {
      if (k == warp) prefix = total;
      total += tot[k];
    }
    if (tid < Q) {
      const float cv = part + prefix;  // the last row's equals `total`
      cum[tid] = cv;
      ecum[tid] = expf(cv);
      wv[tid] = dts[tid] * expf(total - cv);
    }
    __syncthreads();

    // y's inter-chunk part: (diag(exp(cum)) C) S, from the state carried in.
    // Lane l's rows for ldmatrix: C rows i0 + l % 16 (columns + 4 for
    // l >= 16) give the A fragment of the warp's rows; B rows (l % 8) +
    // 8 (l / 16) (columns + 4 for l % 16 >= 8) and the transposed state's
    // rows the same way give the B fragments of two n-tiles.
    const float* c_lane = &Cs[(i0 + (lane & 15)) * cs + (lane >> 4) * 4];
    const int ldsm_row = (lane & 7) + ((lane >> 4) << 3), ldsm_col = ((lane >> 3) & 1) * 4;
    const float* b_lane = &Bs[ldsm_row * cs + ldsm_col];
    const float* s_lane = &St[ldsm_row * cs + ldsm_col];
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    {
      const float e_a = ecum[ia], e_b = ecum[ib];
#pragma unroll 4
      for (int n0 = 0; n0 < N; n0 += 8) {
        uint32_t r[4];
        ldsm4(r, c_lane + n0);
        FragA fa;
        split_a(fa, __uint_as_float(r[0]) * e_a, __uint_as_float(r[1]) * e_b,
                __uint_as_float(r[2]) * e_a, __uint_as_float(r[3]) * e_b);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          FragB fb;
          if (nt + 1 < NT) {
            ldsm4(r, s_lane + nt * 8 * cs + n0);  // n-tiles nt and nt + 1
          } else {  // the last of an odd NT
            const float* sr = &St[(nt * 8 + g) * cs + n0 + t];
            r[0] = __float_as_uint(sr[0]);
            r[1] = __float_as_uint(sr[4]);
          }
          split_b(fb, __uint_as_float(r[0]), __uint_as_float(r[1]));
          mma3(acc[nt], fa, fb);
          if (nt + 1 < NT) {
            split_b(fb, __uint_as_float(r[2]), __uint_as_float(r[3]));
            mma3(acc[nt + 1], fa, fb);
          }
        }
      }
    }
    __syncthreads();  // every warp has read the old state

    // y's intra-chunk part: the score columns [0, i0 + 16) in groups of 32
    // (and one of 16), none of them wholly above the diagonal
    int j0 = 0;
    for (; j0 + 32 <= i0 + 16; j0 += 32)
      intra<NT, 4>(acc, c_lane, b_lane, Xs, cum, dts, N, cs, xs, j0, ia, ib, g, t);
    if (j0 <= i0) intra<NT, 2>(acc, c_lane, b_lane, Xs, cum, dts, N, cs, xs, j0, ia, ib, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int p = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(&yg[(r0 + ia) * P + p]) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(&yg[(r0 + ib) * P + p]) = make_float2(acc[nt][2], acc[nt][3]);
    }

    // the state update, this warp's jobs
    const float et = expf(total);
    for (int j = 0; j < n_jobs; ++j)
      if (my_jobs >> j & 1)
        state_job<NS>(St, Bs, Xs, wv, N, cs, xs, (j / (NT / NS)) * 16, (j % (NT / NS)) * NS * 8,
                      et, g, t);
    __syncthreads();  // the state is updated; C, B, x and dt are read
  }
  for (int e = tid; e < N * P; e += THREADS) {
    const int n = e / P, p = e - n * P;
    s_out[bh * N * P + e] = St[p * cs + n];
  }
}

// Dynamic shared memory of one block, in bytes: C and B [Q][N + 4], x
// [Q][P + 4], the transposed state [P][N + 4], four [Q] vectors and the
// scan's four warp sums (ops.py::smem_bytes checks the same sum): 205,840 B
// at N = 128, P = 64.
long long smem_bytes(int N, int P) {
  return 4LL * (2LL * Q * cb_stride(N) + (long long)Q * x_stride(P) +
                (long long)P * cb_stride(N) + 4LL * Q + Q / 32);
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, float*, float*, int, int, int, int);

// the kernel of each P = 8, 16, ..., 128
constexpr Kernel KERNELS[] = {
    ssd_chunk_scan_kernel<1>,  ssd_chunk_scan_kernel<2>,  ssd_chunk_scan_kernel<3>,
    ssd_chunk_scan_kernel<4>,  ssd_chunk_scan_kernel<5>,  ssd_chunk_scan_kernel<6>,
    ssd_chunk_scan_kernel<7>,  ssd_chunk_scan_kernel<8>,  ssd_chunk_scan_kernel<9>,
    ssd_chunk_scan_kernel<10>, ssd_chunk_scan_kernel<11>, ssd_chunk_scan_kernel<12>,
    ssd_chunk_scan_kernel<13>, ssd_chunk_scan_kernel<14>, ssd_chunk_scan_kernel<15>,
    ssd_chunk_scan_kernel<16>};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Shapes: B batches, H heads in G groups, S a multiple of 128, N a multiple
// of 8, P a multiple of 8 up to 128; every pointer 16-byte aligned.
extern "C" int ssd_chunk_scan_f32(const float* x, const float* dt, const float* Bm,
                                  const float* Cm, const float* A, const float* s0,
                                  float* y, float* s_out, int B, int H, int G, int S,
                                  int N, int P, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || S <= 0 || S % Q != 0 || N < 8 ||
      N % 8 != 0 || P < 8 || P % 8 != 0 || P > 128 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = KERNELS[P / 8 - 1];
  const long long smem = smem_bytes(N, P);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)(B * H), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      x, dt, Bm, Cm, A, s0, y, s_out, H, G, S, N);
  return (int)cudaGetLastError();
}
