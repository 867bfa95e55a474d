// Causal or full GQA flash-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel (Pallas body `_attn_kernel`). For q [B, nq, Sq, hd]
// and k, v [B, nkv, Sk, hd] (q head h reads kv head h / (nq / nkv)):
//   o = softmax(q k^T / sqrt(hd), masked) v
// with a float32 running max, sum and accumulator per q row (online
// softmax), the KV tiles wholly above the diagonal skipped, the diagonal tile
// masked per element, and o = acc / max(l, 1e-30) at the end, cast to q's
// dtype. Causal needs Sq == Sk (the wrapper raises otherwise). q, k, v and o
// are float32 or bfloat16, read and written through strides (the model's
// [B, S, n, hd] tensors arrive as transposed views, no copy); everything
// inside is IEEE float32 on the CUDA cores, never TF32 (the f32 bound, 2e-5,
// is below TF32's error). The wrapper sends float32 here and bf16 to the
// tensor-core kernel, flash_attention_wgmma.cu; this kernel's bf16 path is
// kept as the yardstick that kernel was measured against. The plain version
// is src/repro_torch/kernels/flash_attention/ref.py::attention_ref.
//
// What bounds it on this card: operations. One (b, head) of qwen3-0.6b
// (S = 2,048, hd = 128, causal) needs 2 * 2 * S^2/2 * hd = 1.07 GFLOP for
// 2.1 MB of q, k, v and o in bf16: ~500 operations per byte, above the bf16
// ridge (~295) and far above the float32 one (~20). At the float32 CUDA-core
// peak of 67 TFLOP/s one point ([2, 16, 8, 2048, 128]) is 0.51 ms; its bytes
// take 15 us.
//
// What the design does about it: on the TPU the KV sweep is the innermost,
// sequential grid axis and VMEM scratch carries (m, l, acc) across it; Hopper
// runs blocks in no order, so here one block of 256 threads owns one
// (b, q head, 64-row q tile) and loops over the 64-row KV tiles itself,
// keeping m, l and acc in registers for the whole sweep (nothing is carried
// through device memory). Each thread owns 4 q rows: 4 keys of a score tile
// and hd / 16 columns of the accumulator, so a row's max and sum are a
// register reduction plus four shuffles across the 16 lanes that share it.
// Both products are register-tiled loops over shared memory, float4 reads
// on both operands: q is stored row-major (pre-scaled by log2(e) / sqrt(hd),
// so exp2 of a score difference is exp of the scaled one), K transposed
// ([hd][64], written by threads along the keys so the transposing stores hit
// distinct banks), V and the probabilities row-major. K and V are converted
// to float32 as they are staged. At hd = 128 a block holds 112 KB of shared
// memory, two blocks per SM. Tiles are scheduled longest first (the last q
// tiles of causal attention sweep the most KV tiles). Offsets are 64-bit
// (from the strides of the B, n and S dims): q of a 64-point qwen3 wave
// holds 537 M elements. No tensor cores and no overlap of the next tile's
// loads with this tile's products: float32 has no tensor-core path within
// its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows of a block
constexpr int BK = 64;        // keys of a KV tile
constexpr int THREADS = 256;  // 16 row groups of 4 x 16 lanes
constexpr float NEG_INF = -1e30f;  // the Pallas kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

// one 16-byte vector of T, as floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(float (&d)[N], const float* p) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(float (&d)[N], const __nv_bfloat16* p) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      d[2 * i] = f.x; d[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void load4(float (&d)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, const float (&s)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}

// W consecutive floats of shared memory (W = 2 or 4)
template <int W>
__device__ __forceinline__ void load_smem(float (&d)[W], const float* p) {
  if constexpr (W == 4) {
    load4(d, p);
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    d[0] = t.x; d[1] = t.y;
  }
}

// N floats (a multiple of 4) into shared memory
template <int N>
__device__ __forceinline__ void store_smem(float* p, const float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
}

// W consecutive outputs (W = 2 or 4) in o's dtype
template <int W>
__device__ __forceinline__ void store_out(float* p, const float (&s)[W]) {
  if constexpr (W == 4) store4(p, s);
  else *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
}

template <int W>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float (&s)[W]) {
#pragma unroll
  for (int i = 0; i < W; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(s[i], s[i + 1]);
}

// element strides of the B, n and S dims of q, k, v and o (hd has stride 1)
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// Dynamic shared memory of one block, in bytes: q, K transposed, V, and the
// probabilities, all float32.
constexpr int smem_bytes(int D) { return 4 * (BQ * D + D * BK + BK * D + BQ * BK); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides st, int nq,
                       int nkv, int Sq, int Sk, int n_qt, long long n_bh, float q_scale,
                       int causal) {
  constexpr int EV = Vec<T>::N;       // elements of one 16-byte load
  constexpr int NC = D / 16;          // accumulator columns of a thread
  constexpr int VW = NC < 4 ? NC : 4; // read and written VW at a time
  constexpr int NCH = NC / VW;        // column chunks, 16 * VW apart
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][D] q * q_scale
  float* Kt = Qs + BQ * D;                      // [D][BK] the KV tile's keys, transposed
  float* Vs = Kt + D * BK;                      // [BK][D] its values
  float* Ps = Vs + BK * D;                      // [BQ][BK] probabilities

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long blk = blockIdx.x;
  const int qt = n_qt - 1 - (int)(blk / n_bh);  // the longest sweeps first
  const long long bh = blk % n_bh;              // b * nq + h
  const long long b = bh / nq, h = bh % nq, hkv = h / (nq / nkv);
  const T* qg = q + b * st.q[0] + h * st.q[1];  // 64-bit offsets throughout
  const T* kg = k + b * st.k[0] + hkv * st.k[1];
  const T* vg = v + b * st.v[0] + hkv * st.v[1];
  T* og = o + b * st.o[0] + h * st.o[1];
  const int q0 = qt * BQ;

  for (int e = tid; e < BQ * (D / EV); e += THREADS) {
    const int r = e / (D / EV), c = (e % (D / EV)) * EV;
    float t[EV];
    if (q0 + r < Sq) {
      Vec<T>::load(t, qg + (long long)(q0 + r) * st.q[2] + c);
    } else {
#pragma unroll
      for (int i = 0; i < EV; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < EV; ++i) t[i] *= q_scale;
    store_smem<EV>(&Qs[r * D + c], t);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int n_kt_all = (Sk + BK - 1) / BK;
  // causal (Sq == Sk): KV tiles wholly above the diagonal are never visited
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / BK + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // q is staged; the previous tile is done with Kt, Vs, Ps
    for (int e = tid; e < BK * (D / EV); e += THREADS) {
      const int j = e % BK, c = (e / BK) * EV;  // consecutive threads: consecutive keys
      float t[EV];
      if (k0 + j < Sk) {
        Vec<T>::load(t, kg + (long long)(k0 + j) * st.k[2] + c);
      } else {
#pragma unroll
        for (int i = 0; i < EV; ++i) t[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < EV; ++i) Kt[(c + i) * BK + j] = t[i];
    }
    for (int e = tid; e < BK * (D / EV); e += THREADS) {
      const int j = e / (D / EV), c = (e % (D / EV)) * EV;
      float t[EV];
      if (k0 + j < Sk) {
        Vec<T>::load(t, vg + (long long)(k0 + j) * st.v[2] + c);
      } else {
#pragma unroll
        for (int i = 0; i < EV; ++i) t[i] = 0.f;
      }
      store_smem<EV>(&Vs[j * D + c], t);
    }
    __syncthreads();

    // scores of rows 4ty..4ty+3 against keys 4tx..4tx+3 (log2 units)
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) load4(qv[r], &Qs[(4 * ty + r) * D + d]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) load4(kv[dd], &Kt[(d + dd) * BK + 4 * tx]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] += qv[r][dd] * kv[dd][c];
    }
    const bool diagonal = causal && k0 + BK - 1 > q0;
    if (diagonal || k0 + BK > Sk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = q0 + 4 * ty + r, col = k0 + 4 * tx + c;
          if ((causal && col > row) || col >= Sk) s[r][c] = NEG_INF;
        }
    }

    // online softmax: a row's 64 scores sit in the 16 lanes that share ty
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float p[4], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = exp2f(s[r][c] - m_new);
        sum += p[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      store4(&Ps[(4 * ty + r) * BK + 4 * tx], p);
    }
    __syncthreads();

    // acc += P V; on the diagonal tile P is 0 past the thread's last row
    const int j_end = diagonal ? min(BK, q0 + 4 * ty + 4 - k0) : BK;
#pragma unroll 2
    for (int j = 0; j < j_end; j += 4) {
      float pv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) load4(pv[r], &Ps[(4 * ty + r) * BK + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          float vv[VW];
          load_smem<VW>(vv, &Vs[(j + jj) * D + ch * 16 * VW + tx * VW]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < VW; ++c) acc[r][ch * VW + c] += pv[r][jj] * vv[c];
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float out[VW];
#pragma unroll
      for (int c = 0; c < VW; ++c) out[c] = acc[r][ch * VW + c] / denom;
      store_out<VW>(og + (long long)row * st.o[2] + ch * 16 * VW + tx * VW, out);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int nq, int nkv,
           int Sq, int Sk, const Strides& st, int causal, void* stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's unified memory as shared memory: two blocks at hd = 128
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long n_bh = (long long)B * nq;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const long long blocks = n_bh * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float q_scale = (float)(1.4426950408889634 / sqrt((double)D));  // log2(e) / sqrt(hd)
  kernel<<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, nq, nkv, Sq, Sk, n_qt, n_bh, q_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int nq, int nkv,
              int Sq, int Sk, int hd, const Strides& st, int causal, void* stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, nq, nkv, Sq, Sk, st, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, nq, nkv, Sq, Sk, st, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, nq, nkv, Sq, Sk, st, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q, o [B, nq, Sq, hd]; k, v [B, nkv, Sk, hd]; all of one dtype (0 =
// float32, 1 = bfloat16); `strides` holds the element strides of the B, n
// and S dims of q, k, v and o in that order (12 values; hd has stride 1),
// each a multiple of 16 bytes, every base 16-byte aligned; hd in
// {32, 64, 128}; nq a multiple of nkv; causal (1) needs Sq == Sk.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int nq, int nkv, int Sq, int Sk, int hd, int dtype,
                                   const long long* strides, int causal, void* stream) {
  if (B <= 0 || nq <= 0 || nkv <= 0 || nq % nkv != 0 || Sq <= 0 || Sk <= 0 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, nq, nkv, Sq, Sk, hd, st, causal, stream);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, nq, nkv, Sq, Sk, hd, st, causal, stream);
  return (int)cudaErrorInvalidValue;
}
