// Row-wise RMSNorm, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_kernel (Pallas body
// `_rmsnorm_kernel`). For every row of x [n, d]:
//   y = x * rsqrt(mean(x^2) + eps) * w
// reduced in float32, y in x's dtype. x is float32 or bfloat16; w [d] is
// float32 or x's dtype. The plain version with the same arithmetic is
// src/repro_torch/kernels/rmsnorm/ref.py::rmsnorm_ref.
//
// What bounds it on this card: bytes. A row of d elements is read once and
// written once for ~3 d operations, far below the ~20 float32 operations per
// byte at which the CUDA cores would become the limit; at qwen3-0.6b's
// [262,144, 1,024] bf16 the 1.07 GB that must move take 0.32 ms at 3.35 TB/s.
//
// What the design does about it: on the TPU a block of 256 rows sits in VMEM
// and the reduction runs across the lanes; here one warp owns one row, so
// the sum of squares is a register sum per lane plus five warp shuffles, and
// no shared memory or block barrier is needed. Each lane reads 16-byte
// vectors (4 floats or 8 bf16), neighbouring lanes on neighbouring vectors,
// and keeps up to CACHE of them in registers, so a row of up to 1,024 floats
// (2,048 bf16) is read from device memory exactly once; the rest of a wider
// row is read a second time. 256 threads = 8 rows per block; the row count
// need not be a multiple of anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr int CACHE = 8;  // 16-byte vectors a lane keeps in registers

template <typename T>
struct Vec;  // one 16-byte vector of T as floats

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(float (&d)[N], const float* p) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&s)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
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
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&s)[N]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// w as floats for the N elements of one x vector (w may be narrower or
// wider than x, so it is read element by element; it stays in L1/L2)
template <typename W, int N>
__device__ __forceinline__ void load_w(float (&d)[N], const W* p) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = to_float(p[i]);
}

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
               int64_t n_rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= n_rows) return;
  const T* xr = x + row * d;  // 64-bit offsets: n * d can exceed 2^31
  T* yr = y + row * d;
  const int nv = d / N;  // vectors in a row

  float c[CACHE][N];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int v = lane + 32 * i;
    if (v < nv) {
      Vec<T>::load(c[i], xr + (int64_t)v * N);
#pragma unroll
      for (int e = 0; e < N; ++e) ss += c[i][e] * c[i][e];
    }
  }
  for (int v = lane + 32 * CACHE; v < nv; v += 32) {
    float t[N];
    Vec<T>::load(t, xr + (int64_t)v * N);
#pragma unroll
    for (int e = 0; e < N; ++e) ss += t[e] * t[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  // mean, then rsqrt of (mean + eps), as the plain version orders them
  const float inv = rsqrtf(ss / (float)d + eps);

#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int v = lane + 32 * i;
    if (v < nv) {
      float wv[N], o[N];
      load_w<W, N>(wv, w + (int64_t)v * N);
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = c[i][e] * inv * wv[e];
      Vec<T>::store(yr + (int64_t)v * N, o);
    }
  }
  for (int v = lane + 32 * CACHE; v < nv; v += 32) {
    float t[N], wv[N], o[N];
    Vec<T>::load(t, xr + (int64_t)v * N);
    load_w<W, N>(wv, w + (int64_t)v * N);
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = t[e] * inv * wv[e];
    Vec<T>::store(yr + (int64_t)v * N, o);
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, long long n_rows, int d, float eps,
           void* stream) {
  if (n_rows <= 0 || d <= 0 || d % Vec<T>::N != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T, W><<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), n_rows, d,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// dtype codes: 0 = float32, 1 = bfloat16. x and y share x_dtype; w_dtype is
// 0 or x_dtype. d is a multiple of 16 bytes' worth of x (4 floats, 8 bf16);
// x, w and y are 16-byte aligned and contiguous.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, long long n_rows, int d,
                           float eps, int x_dtype, int w_dtype, void* stream) {
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, y, n_rows, d, eps, stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, n_rows, d, eps, stream);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, n_rows, d, eps, stream);
  return (int)cudaErrorInvalidValue;
}
