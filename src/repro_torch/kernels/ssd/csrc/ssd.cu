// Mamba-2 SSD chunk scan on float32, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd/ssd.py::ssd_kernel (Pallas body
// `_ssd_kernel`). For every (batch b, head h) it walks the sequence in chunks
// of Q = 128 in order and, per chunk, with cum = cumsum(dt * A):
//   y = (C B^T * L * dt) X + (C S) * exp(cum),  L[i, j] = exp(cum_i - cum_j), j <= i
//   S <- S * exp(total) + B^T diag(dt * exp(total - cum)) X
// with a float32 [N, P] state S. Layouts: x, y [B, H, S, P]; dt [B, H, S]
// (post-softplus); B, C [B, G, S, N] shared by the H / G heads of a group;
// A [H] (negative); s0, s_out [B, H, N, P]. S is a multiple of Q (the
// adapter `ops.ssd` pads with dt = 0). The plain version with the same
// arithmetic is src/repro_torch/kernels/ssd/ref.py::ssd_chunked_ref.
//
// What bounds it on this card: operations. One chunk of one head needs
// Q^2 N (C B^T) + Q^2 P (scores X) + 2 Q N P (C S and the state update)
// multiply-adds, half of the first two for the causal triangle alone; at
// mamba2-1.3b (N = 128, P = 64) that is 7.4 MFLOP per chunk with the
// triangle, 10.5 MFLOP without it, against ~66 KB of x, y, dt that must
// move. 15-22 GFLOP per point and layer (B = 2, S = 2048) is 0.22-0.32 ms
// at the 67 TFLOP/s float32 peak, while its 147 MB take 44 us at 3.35 TB/s.
// The products stay in IEEE float32 on the CUDA cores, not in TF32 on the
// tensor cores, because the model's SSD is float32 (ROADMAP queue 2 note).
//
// What the design does about it: on the TPU the chunk axis is the innermost,
// sequential grid dimension and VMEM scratch carries the state; Hopper runs
// blocks in no order, so here ONE block of 256 threads owns one (b, h) and
// loops over the chunks itself, keeping the state in shared memory for the
// whole sequence (no second pass, nothing carried through device memory).
// The chunk's working set does not fit in 227 KB at once (x 32 KB, B and C
// 64 KB each, S 32 KB, a [Q, Q] score tile 64 KB), so the scores are built
// and consumed in two halves of 64 rows (32 KB). Every product is a
// register-tiled loop over shared memory: each thread owns a 4 x 8 (scores)
// or 4 x 4 (y, state) tile of outputs, reads its operands as float4, and
// skips what the causal mask zeroes (the upper half of the first score half,
// and every j > i of the scores-times-X product). B and C are stored
// transposed ([N][Q]) so both products that contract over N read contiguous
// float4s; they are written to shared memory by threads along the row so
// the transposing stores hit distinct banks. Multiply-adds may be contracted
// (FMA): the summation order differs from the plain version's anyway.
// Known waste, left for later (ROADMAP queue 2): C B^T is recomputed for
// every head of a group, as the Pallas kernel does; no wgmma or TMA; the
// adapter transposes the model layout in and out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 128;        // chunk length, as the Pallas kernel's
constexpr int HALF = Q / 2;   // rows of the score tile held at once
constexpr int THREADS = 256;  // 16 x 16 tiles of 4 rows

__device__ __forceinline__ void load4(float (&d)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, const float (&s)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}

// Sc[il + r][j] for the 4 rows i0 + r of this thread and the columns
// jA..jA+3 (and jA+HALF..jA+HALF+3 when kTwo): (C B^T)[i][j] * exp(cum_i -
// cum_j) * dt_j where j <= i, else 0.
template <bool kTwo>
__device__ __forceinline__ void score_tile(const float* Ct, const float* Bt, float* Sc,
                                           const float* cum, const float* dts, int N,
                                           int il, int i0, int jA) {
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float c[4], b0[4], b1[4];
    load4(c, &Ct[n * Q + i0]);
    load4(b0, &Bt[n * Q + jA]);
    if (kTwo) load4(b1, &Bt[n * Q + jA + HALF]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[r][k] += c[r] * b0[k];
        if (kTwo) acc[r][4 + k] += c[r] * b1[k];
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + r;
    const float ci = cum[i];
#pragma unroll
    for (int half = 0; half < (kTwo ? 2 : 1); ++half) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = jA + half * HALF + k;
        v[k] = j <= i ? acc[r][half * 4 + k] * expf(ci - cum[j]) * dts[j] : 0.f;
      }
      store4(&Sc[(il + r) * Q + jA + half * HALF], v);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_out,
                      int H, int G, int S, int N, int P) {
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // [N][Q] C of the chunk, transposed
  float* Bt = Ct + N * Q;                       // [N][Q] B of the chunk, transposed
  float* X = Bt + N * Q;                        // [Q][P] x of the chunk (later w-scaled)
  float* St = X + Q * P;                        // [N][P] the carried state
  float* Sc = St + N * P;                       // [HALF][Q] scores of half the rows
  float* dts = Sc + HALF * Q;                   // [Q] dt
  float* cum = dts + Q;                         // [Q] cumsum(dt * A)
  float* ecum = cum + Q;                        // [Q] exp(cum)
  float* w = ecum + Q;                          // [Q] dt * exp(total - cum)

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;  // b * H + h
  const int h = (int)(bh % H);
  const int64_t bg = (bh / H) * G + h / (H / G);
  const float a = A[h];
  const float* xg = x + bh * S * P;  // 64-bit offsets: x can exceed 2^31 elements
  const float* dtg = dt + bh * S;
  const float* Bg = Bm + bg * S * N;
  const float* Cg = Cm + bg * S * N;
  float* yg = y + bh * S * P;
  const int PT = P / 4;  // float4 columns of a P row

  for (int e = tid * 4; e < N * P; e += THREADS * 4) {
    float v[4];
    load4(v, &s0[bh * N * P + e]);
    store4(&St[e], v);
  }

  const int n_chunks = S / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int64_t r0 = (int64_t)c * Q;
    __syncthreads();  // the previous chunk is done with every buffer
    // consecutive threads take consecutive rows j, so the transposing
    // stores into Bt / Ct hit distinct banks
    for (int e = tid; e < Q * (N / 4); e += THREADS) {
      const int j = e % Q, n = (e / Q) * 4;
      float bv[4], cv[4];
      load4(bv, &Bg[(r0 + j) * N + n]);
      load4(cv, &Cg[(r0 + j) * N + n]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Bt[(n + k) * Q + j] = bv[k];
        Ct[(n + k) * Q + j] = cv[k];
      }
    }
    for (int e = tid * 4; e < Q * P; e += THREADS * 4) {
      float v[4];
      load4(v, &xg[r0 * P + e]);
      store4(&X[e], v);
    }
    if (tid < Q) dts[tid] = dtg[r0 + tid];
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum in sequence order
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += dts[i] * a;
        cum[i] = s;
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    if (tid < Q) {
      ecum[tid] = expf(cum[tid]);
      w[tid] = dts[tid] * expf(total - cum[tid]);
    }

    for (int hh = 0; hh < 2; ++hh) {
      const int ibase = hh * HALF;
      {
        const int il = (tid / 16) * 4, jA = (tid % 16) * 4;
        // rows < HALF see only columns < HALF
        if (hh == 0) score_tile<false>(Ct, Bt, Sc, cum, dts, N, il, ibase + il, jA);
        else score_tile<true>(Ct, Bt, Sc, cum, dts, N, il, ibase + il, jA);
      }
      __syncthreads();  // Sc complete; ecum and w visible
      for (int t = tid; t < (HALF / 4) * PT; t += THREADS) {
        const int il = (t / PT) * 4, i0 = ibase + il, p0 = (t % PT) * 4;
        float acc[4][4], accs[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = accs[r][k] = 0.f;
        // intra-chunk: Sc is 0 for j > i, so stop after this tile's last row
        for (int j = 0; j < i0 + 4; j += 4) {
          float s[4][4], xv[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) load4(s[r], &Sc[(il + r) * Q + j]);
#pragma unroll
          for (int q = 0; q < 4; ++q) load4(xv[q], &X[(j + q) * P + p0]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[r][k] += s[r][q] * xv[q][k];
        }
        // inter-chunk: C S from the state carried in
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], sv[4];
          load4(cv, &Ct[n * Q + i0]);
          load4(sv, &St[n * P + p0]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) accs[r][k] += cv[r] * sv[k];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = ecum[i0 + r];
          float out[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) out[k] = acc[r][k] + accs[r][k] * e;
          store4(&yg[(r0 + i0 + r) * P + p0], out);
        }
      }
      __syncthreads();  // Sc is rewritten by the next half; St is updated next
    }

    // state update: S <- S exp(total) + B^T (w X)
    for (int e = tid * 4; e < Q * P; e += THREADS * 4) {
      const float wj = w[e / P];
      float v[4];
      load4(v, &X[e]);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] *= wj;
      store4(&X[e], v);
    }
    __syncthreads();
    const float et = expf(total);
    for (int t = tid; t < (N / 4) * PT; t += THREADS) {
      const int n0 = (t / PT) * 4, p0 = (t % PT) * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int j = 0; j < Q; j += 4) {
        float bv[4][4], xv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) load4(bv[r], &Bt[(n0 + r) * Q + j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) load4(xv[q], &X[(j + q) * P + p0]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] += bv[r][q] * xv[q][k];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float sv[4];
        load4(sv, &St[(n0 + r) * P + p0]);
#pragma unroll
        for (int k = 0; k < 4; ++k) sv[k] = sv[k] * et + acc[r][k];
        store4(&St[(n0 + r) * P + p0], sv);
      }
    }
  }
  __syncthreads();
  for (int e = tid * 4; e < N * P; e += THREADS * 4) {
    float v[4];
    load4(v, &St[e]);
    store4(&s_out[bh * N * P + e], v);
  }
}

// Dynamic shared memory of one block, in bytes: Ct, Bt, X, St, the score
// half, and four [Q] vectors (ops.py::smem_bytes checks the same sum).
long long smem_bytes(int N, int P) {
  return 4LL * (2LL * N * Q + (long long)Q * P + (long long)N * P + (long long)HALF * Q + 4LL * Q);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Shapes: B batches, H heads in G groups, S a multiple of 128, N and P
// multiples of 4; every pointer 16-byte aligned.
extern "C" int ssd_chunk_scan_f32(const float* x, const float* dt, const float* Bm,
                                  const float* Cm, const float* A, const float* s0,
                                  float* y, float* s_out, int B, int H, int G, int S,
                                  int N, int P, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || S <= 0 || S % Q != 0 || N < 4 ||
      N % 4 != 0 || P < 4 || P % 4 != 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<<<(unsigned int)(B * H), THREADS, (size_t)smem,
                          (cudaStream_t)stream>>>(x, dt, Bm, Cm, A, s0, y, s_out, H, G, S, N, P);
  return (int)cudaGetLastError();
}
