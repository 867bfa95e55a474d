// Causal or full GQA flash-attention forward on float32, on Hopper's tensor
// cores (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel (Pallas body `_attn_kernel`). For q [B, nq, Sq, hd]
// and k, v [B, nkv, Sk, hd] (q head h reads kv head h / (nq / nkv)):
//   o = softmax(scale * q k^T, masked) v
// (scale a runtime argument: the reference's 1 / sqrt(hd) by default; MLA
// passes 1 / sqrt(its q.k width) with q, k and v zero-padded to hd)
// with a float32 running max, sum and accumulator per q row (online
// softmax), the KV tiles wholly above the diagonal skipped, the diagonal tile
// masked per element with -1e30, and o = acc / max(l, 1e-30) at the end, cast
// to q's dtype; where the caller asks (training), also each row's
// log-sum-exp, which flash_attention_bwd.cu recomputes the probabilities
// from. Causal needs Sq == Sk (the wrapper raises otherwise). q, k, v
// and o are float32 or bfloat16, read and written through strides (the
// model's [B, S, n, hd] tensors arrive as transposed views, no copy), with
// 64-bit offsets (q of a 64-point qwen3 wave holds 537 M elements). The
// wrapper sends float32 here and bf16 to flash_attention_wgmma.cu; this
// kernel's bf16 instance runs the same body and is kept as the yardstick
// that kernel is measured against. The plain version is
// src/repro_torch/kernels/flash_attention/ref.py::attention_ref.
//
// What bounds it on this card: operations. One (b, head) of qwen3-0.6b
// (S = 2,048, hd = 128, causal) needs 2 * 2 * S(S+1)/2 * hd = 1.07 GFLOP
// for 4.2 MB of float32 q, k, v and o: ~250 operations per byte, far above
// the float32 ridge (~20). Both products run on the tensor cores as
// mma.sync m16n8k8 in TF32 with float32 sums, in 3xTF32: each operand is
// split as big = tf32(x), small = tf32(x - big), rounded as cvt.rna rounds
// (the split of ssd.cu), and a product is small*big + big*small + big*big,
// small terms first, which keeps float32 accuracy (the float32 bound,
// 2e-5, is below one TF32 pass's error) for three times the tensor-core
// work. At [2, 16, 8, 2048, 128] that is 0.208 ms at the 495 TFLOP/s TF32
// peak, where the float32 CUDA cores (67 TFLOP/s) would need 0.513 ms.
// bf16 values are exact in TF32, so a bf16 K or V has small parts of zero.
//
// What the design does about it: on the TPU the KV sweep is the innermost,
// sequential grid axis and VMEM scratch carries (m, l, acc) across it;
// Hopper runs blocks in no order, so one block of NW warps owns one (b, q
// head, 16 NW-row q tile) and loops over the KV tiles itself, m, l and acc
// in registers for the whole sweep. Each warp owns 16 q rows. Tiles are
// scheduled longest first (the last q tiles of causal attention sweep the
// most KV tiles).
// - q, pre-scaled by log2(e) * scale (so exp2 of a score difference is
//   exp of the scaled one), is split once a block: into shared memory,
//   [16 NW][hd + 4] big and small, or (QREG) straight into each warp's A
//   fragments in registers (128 registers at hd = 128).
// - Each KV tile is split once, when it lands: K big and small as
//   [BK][hd + 4]; V big and small transposed, [hd][BK + 4], its keys
//   permuted within each 8 (key 2t at column t, key 2t + 1 at t + 4). Every
//   fragment read from shared memory then comes from ldmatrix (four 8 x 4
//   float matrices as 8 x 8 b16 ones, rows 16 B apart mod 128: no bank
//   conflict), and the score accumulator of a 16 x 8 tile IS the A fragment
//   of P V as it lies in the registers (k = t <-> key 2t, k = t + 4 <->
//   key 2t + 1, the permutation V's columns carry): P never goes through
//   shared memory or shuffles.
// - The next KV tile lands by cp.async (16 B, .cg; zero-filled past Sk) in
//   a staging buffer while the warps multiply the current one, so its loads
//   overlap this tile's products (two buffers: the staging one and the
//   split one); the split pass moves it between two barriers.
// - q k^T sums its small and big terms apart and runs every n-tile of a
//   tile with no branch in its k loop; on the diagonal a warp whose rows all
//   lie above the tile skips it (its p would be 0, alpha 1), and P V skips
//   the 8-key groups above the warp's last row.
// - The online softmax stays float32 in the score accumulators: a row's
//   max over the quad of lanes that share it (two shuffles), its sum kept
//   per lane and reduced over the quad at the end.
// The tiling by head dim (Config below) is the fastest that
// scripts/flash_f32_sweep.py measured on an H100 (PERF.md): hd = 32 NW = 4,
// BK = 64, three blocks an SM (72,704 B of shared memory each, registers
// capped at 170 by the launch bounds); hd = 64 NW = 4, BK = 64 (139,264 B,
// one block); hd = 128 NW = 8, BK = 32, q in registers (104,448 B, one
// block: 255 registers, a few spilled). What holds it back (PERF.md): with
// split operands every mma triple needs two ldmatrix of B and, from shared
// memory, of A, so a 16-row warp is bound by shared-memory bandwidth near
// half the TF32 rate; the split pass and two barriers a tile are not
// overlapped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the Pallas kernel's mask value
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// The tiling of each head dim: NW warps of 16 q rows a block (BQ = 16 NW
// rows), KV tiles of BK keys, q's split in registers (QREG) or in shared
// memory, and the blocks an SM the launch bounds ask the compiler for.
template <int D>
struct Config;
template <>
struct Config<32> { static constexpr int NW = 4, BK = 64, MINB = 3; static constexpr bool QREG = false; };
template <>
struct Config<64> { static constexpr int NW = 4, BK = 64, MINB = 1; static constexpr bool QREG = false; };
template <>
struct Config<128> { static constexpr int NW = 8, BK = 32, MINB = 1; static constexpr bool QREG = true; };

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// two consecutive outputs in o's dtype
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x = big + small, both TF32, rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero), on the bit pattern (ssd.cu's split): big
// has half an ulp added and its low 13 bits cleared; small = x - big gets
// half an ulp added and keeps its low bits, which the tensor core does not
// read (a TF32 operand is the top 19 bits of its register).
__device__ __forceinline__ void split(float x, float& big, float& small) {
  const uint32_t b = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  big = __uint_as_float(b);
  small = __uint_as_float(__float_as_uint(x - big) + 0x1000u);
}

struct FragA {  // 16 x 8 (rows g, g + 8; k = t, t + 4)
  uint32_t big[4], small[4];
};
struct FragB {  // 8 x 8 (k = t, t + 4; column g)
  uint32_t big[2], small[2];
};

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

// Four 8 x 4 float matrices as ldmatrix's four 8 x 8 b16 ones: lane l gives
// the address of row l % 8 of matrix l / 8, and each lane (g, t) gets word t
// of row g of every matrix: the TF32 fragments' layout where the fragment's
// k runs along the row.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes from global to shared memory, bypassing L1; `bytes` = 0 fills
// zeros and reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// column of key offset j (0..7 within its 8) in the transposed V: key 2t at
// t, key 2t + 1 at t + 4
__device__ __forceinline__ int perm8(int j) { return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2); }

// element strides of the B, n and S dims of q, k, v and o (hd has stride 1)
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// row strides in shared memory, in elements
template <int D>
__host__ __device__ constexpr int qk_stride() { return D + 4; }  // q and K, split
template <int D>
__host__ __device__ constexpr int vt_stride() { return Config<D>::BK + 4; }  // V transposed
template <typename T, int D>
__host__ __device__ constexpr int stage_stride() { return D + 16 / (int)sizeof(T); }

// Dynamic shared memory of one block, in bytes: q's split (unless it is
// kept in registers), K's, V's (transposed), and the staging buffer of the
// next K and V tile (in T).
template <typename T, int D>
constexpr int smem_bytes() {
  using C = Config<D>;
  constexpr int q_floats = C::QREG ? 0 : 2 * 16 * C::NW * qk_stride<D>();
  return 4 * (q_floats + 2 * C::BK * qk_stride<D>() + 2 * D * vt_stride<D>()) +
         (int)sizeof(T) * 2 * C::BK * stage_stride<T, D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * Config<D>::NW, Config<D>::MINB)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       Strides st, int nq, int nkv, int Sq, int Sk, int n_qt, long long n_bh,
                       float q_scale, int causal) {
  using Cfg = Config<D>;
  constexpr int BK = Cfg::BK, BQ = 16 * Cfg::NW, THREADS = 32 * Cfg::NW;
  constexpr bool QREG = Cfg::QREG;
  constexpr int EV = Vec<T>::N;      // elements of one 16-byte vector
  constexpr int QS = qk_stride<D>();
  constexpr int VS = vt_stride<D>();
  constexpr int SS = stage_stride<T, D>();
  constexpr int NJ = BK / 8;         // 8-key groups of a tile: score n-tiles, P V k-steps
  constexpr int ND = D / 8;          // 8-column groups of hd: q k^T k-steps, P V n-tiles
  static_assert(NJ % 2 == 0 && ND % 2 == 0, "ldmatrix loads two n-tiles at a time");
  extern __shared__ float4 smem4[];
  float* Qb = reinterpret_cast<float*>(smem4);  // [BQ][QS] q * q_scale, big (!QREG)
  float* Qsm = Qb + (QREG ? 0 : BQ * QS);       // [BQ][QS] small
  float* Kb = Qsm + (QREG ? 0 : BQ * QS);       // [BK][QS] the tile's keys, big
  float* Ksm = Kb + BK * QS;                    // [BK][QS] small
  float* Vb = Ksm + BK * QS;                    // [D][VS] its values, transposed and permuted, big
  float* Vsm = Vb + D * VS;                     // [D][VS] small
  T* Kst = reinterpret_cast<T*>(Vsm + D * VS);  // [BK][SS] the next tile's keys, landing
  T* Vst = Kst + BK * SS;                       // [BK][SS] its values

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and lane in it
  const long long blk = blockIdx.x;
  const int qt = n_qt - 1 - (int)(blk / n_bh);  // the longest sweeps first
  const long long bh = blk % n_bh;              // b * nq + h
  const long long b = bh / nq, h = bh % nq, hkv = h / (nq / nkv);
  const T* qg = q + b * st.q[0] + h * st.q[1];  // 64-bit offsets throughout
  const T* kg = k + b * st.k[0] + hkv * st.k[1];
  const T* vg = v + b * st.v[0] + hkv * st.v[1];
  T* og = o + b * st.o[0] + h * st.o[1];
  const int q0 = qt * BQ;

  const int n_kt_all = (Sk + BK - 1) / BK;
  // causal (Sq == Sk): KV tiles wholly above the diagonal are never visited
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / BK + 1) : n_kt_all;

  // the K and V rows [k0, k0 + BK) into the staging buffer, zeros past Sk
  auto stage = [&](int k0) {
    for (int e = tid; e < BK * (D / EV); e += THREADS) {
      const int j = e / (D / EV), c = (e % (D / EV)) * EV;
      const bool in = k0 + j < Sk;
      const long long row = in ? k0 + j : 0;
      cp16(Kst + j * SS + c, kg + row * st.k[2] + c, in ? 16 : 0);
      cp16(Vst + j * SS + c, vg + row * st.v[2] + c, in ? 16 : 0);
    }
    cp_commit();
  };
  stage(0);

  // the warp's rows: ra = 16 warp + g and rb = ra + 8 of the block
  const int ra = 16 * warp + g, rb = ra + 8;

  // q once: scaled and split, into shared memory, or (QREG) straight from
  // device memory into the A fragments of the warp's rows; zeros past Sq
  FragA qf[QREG ? ND : 1];
  if constexpr (QREG) {
    const T* qa = q0 + ra < Sq ? qg + (long long)(q0 + ra) * st.q[2] : nullptr;
    const T* qb = q0 + rb < Sq ? qg + (long long)(q0 + rb) * st.q[2] : nullptr;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int c = 8 * kk + t;
      const float x[4] = {qa ? to_float(qa[c]) : 0.f, qb ? to_float(qb[c]) : 0.f,
                          qa ? to_float(qa[c + 4]) : 0.f, qb ? to_float(qb[c + 4]) : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float bg, sm;
        split(x[i] * q_scale, bg, sm);
        qf[kk].big[i] = __float_as_uint(bg);
        qf[kk].small[i] = __float_as_uint(sm);
      }
    }
  } else {
    for (int e = tid; e < BQ * (D / EV); e += THREADS) {
      const int r = e / (D / EV), c = (e % (D / EV)) * EV;
      float x[EV];
      if (q0 + r < Sq) {
        Vec<T>::load(x, qg + (long long)(q0 + r) * st.q[2] + c);
      } else {
#pragma unroll
        for (int i = 0; i < EV; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < EV; i += 4) {
        float bg[4], sm[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split(x[i + u] * q_scale, bg[u], sm[u]);
        *reinterpret_cast<float4*>(&Qb[r * QS + c + i]) = make_float4(bg[0], bg[1], bg[2], bg[3]);
        *reinterpret_cast<float4*>(&Qsm[r * QS + c + i]) = make_float4(sm[0], sm[1], sm[2], sm[3]);
      }
    }
  }

  // ldmatrix rows of lane l: q rows 16 warp + l % 16 (+4 columns for
  // l >= 16) give the A fragment; K rows (l % 8) + 8 (l / 16) (+4 columns for
  // l % 16 >= 8), and the transposed V's rows the same way, give the B
  // fragments of two n-tiles
  const int a_off = (16 * warp + (lane & 15)) * QS + (lane >> 4) * 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 4;
  const int k_off = b_row * QS + b_col;
  const int v_off = b_row * VS + b_col;

  float m[2] = {NEG_INF, NEG_INF};  // rows ra, rb: running max (log2 units)
  float l[2] = {0.f, 0.f};          // this lane's share of the running sum
  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_wait_all();
    __syncthreads();  // the tile has landed; the previous one's split buffers are read
    // the split pass: K as it is, V transposed and permuted
    for (int e = tid; e < BK * (D / EV); e += THREADS) {
      const int j = e / (D / EV), c = (e % (D / EV)) * EV;
      float x[EV];
      Vec<T>::load(x, Kst + j * SS + c);
#pragma unroll
      for (int i = 0; i < EV; i += 4) {
        float bg[4], sm[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split(x[i + u], bg[u], sm[u]);
        *reinterpret_cast<float4*>(&Kb[j * QS + c + i]) = make_float4(bg[0], bg[1], bg[2], bg[3]);
        *reinterpret_cast<float4*>(&Ksm[j * QS + c + i]) = make_float4(sm[0], sm[1], sm[2], sm[3]);
      }
    }
    for (int e = tid; e < BK * (D / EV); e += THREADS) {
      const int j = e % BK, c = (e / BK) * EV;  // consecutive threads: consecutive keys
      const int col = perm8(j);
      float x[EV];
      Vec<T>::load(x, Vst + j * SS + c);
#pragma unroll
      for (int i = 0; i < EV; ++i) {
        float bg, sm;
        split(x[i], bg, sm);
        Vb[(c + i) * VS + col] = bg;
        Vsm[(c + i) * VS + col] = sm;
      }
    }
    __syncthreads();  // the split tile is in place; the staging buffer is free
    if (kt + 1 < n_kt) stage(k0 + BK);  // lands while this tile is multiplied

    // a warp whose rows all lie above the tile (causal) has nothing to add:
    // its scores would all be masked, p = 0 and alpha = 1
    if (causal && k0 > q0 + 16 * warp + 15) continue;
    // on the diagonal tile, the 8-key groups at or below the warp's last row
    const bool diagonal = causal && k0 + BK - 1 > q0;
    const int nj = diagonal ? min(NJ, (q0 + 16 * warp + 15 - k0) / 8 + 1) : NJ;

    // scores of rows ra, rb against the tile's keys (log2 units): the small
    // terms and the big ones summed apart (two chains of dependent mma an
    // n-tile, not one of three); every n-tile, with no branch in the loop
    float lo[NJ][4], hi[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[j][e] = hi[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      FragA fa;
      if constexpr (QREG) {
        fa = qf[kk];
      } else {
        ldsm4(fa.big, Qb + a_off + kk * 8);
        ldsm4(fa.small, Qsm + a_off + kk * 8);
      }
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t rb4[4], rs4[4];
        ldsm4(rb4, Kb + k_off + j * 8 * QS + kk * 8);  // keys 8j .. 8j + 15
        ldsm4(rs4, Ksm + k_off + j * 8 * QS + kk * 8);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const FragB fb = {{rb4[2 * u], rb4[2 * u + 1]}, {rs4[2 * u], rs4[2 * u + 1]}};
          mma(lo[j + u], fa.small, fb.big);
          mma(lo[j + u], fa.big, fb.small);
          mma(hi[j + u], fa.big, fb.big);
        }
      }
    }
    // the sums hold (ra, 2t), (ra, 2t + 1), (rb, 2t), (rb, 2t + 1) of each 8
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = lo[j][e] + hi[j][e];
    if (diagonal || k0 + BK > Sk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + (e < 2 ? ra : rb), col = k0 + 8 * j + 2 * t + (e & 1);
          if ((causal && col > row) || col >= Sk) s[j][e] = NEG_INF;
        }
    }

    // online softmax: a row's scores sit in the quad of lanes that share g
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          sum += s[j][e];
        }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        acc[dn][2 * r] *= alpha;
        acc[dn][2 * r + 1] *= alpha;
      }
    }

    // acc += P V: the probabilities of 8 keys, as they lie in the
    // registers, are the A fragment with k = t <-> key 2t, k = t + 4 <->
    // key 2t + 1, which V's permuted columns match
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        FragA fa;
        float bg[4], sm[4];
        split(s[j][0], bg[0], sm[0]);  // (ra, 2t)
        split(s[j][2], bg[1], sm[1]);  // (rb, 2t)
        split(s[j][1], bg[2], sm[2]);  // (ra, 2t + 1)
        split(s[j][3], bg[3], sm[3]);  // (rb, 2t + 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fa.big[i] = __float_as_uint(bg[i]);
          fa.small[i] = __float_as_uint(sm[i]);
        }
#pragma unroll
        for (int dn = 0; dn < ND; dn += 2) {
          uint32_t rb4[4], rs4[4];
          ldsm4(rb4, Vb + v_off + dn * 8 * VS + j * 8);  // columns 8 dn .. 8 dn + 15
          ldsm4(rs4, Vsm + v_off + dn * 8 * VS + j * 8);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const FragB fb = {{rb4[2 * u], rb4[2 * u + 1]}, {rs4[2 * u], rs4[2 * u + 1]}};
            mma3(acc[dn + u], fa, fb);
          }
        }
      }
    }
  }

  // the row sums over the quad, then o = acc / max(l, 1e-30), and where
  // asked the row's log-sum-exp of the scaled scores, (m + log2 l) ln 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + (r == 0 ? ra : rb);
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t == 0) lse[bh * Sq + row] = (m[r] + log2f(denom)) * LN2;
    T* orow = og + (long long)row * st.o[2] + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      store2(orow + 8 * dn, acc[dn][2 * r] / denom, acc[dn][2 * r + 1] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int nq, int nkv,
           int Sq, int Sk, const Strides& st, int causal, double scale, float* lse,
           void* stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr int smem = smem_bytes<T, D>();
  constexpr int BQ = 16 * Config<D>::NW, THREADS = 32 * Config<D>::NW;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long n_bh = (long long)B * nq;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const long long blocks = n_bh * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float q_scale = (float)(1.4426950408889634 * scale);  // log2(e) * scale
  kernel<<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, st, nq, nkv, Sq, Sk, n_qt, n_bh, q_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int nq, int nkv,
              int Sq, int Sk, int hd, const Strides& st, int causal, double scale, float* lse,
              void* stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, nq, nkv, Sq, Sk, st, causal, scale, lse, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, nq, nkv, Sq, Sk, st, causal, scale, lse, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, nq, nkv, Sq, Sk, st, causal, scale, lse, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q, o [B, nq, Sq, hd]; k, v [B, nkv, Sk, hd]; all of one dtype (0 =
// float32, 1 = bfloat16); `strides` holds the element strides of the B, n
// and S dims of q, k, v and o in that order (12 values; hd has stride 1),
// each a multiple of 16 bytes, every base 16-byte aligned; hd in
// {32, 64, 128}; nq a multiple of nkv; causal (1) needs Sq == Sk; `scale`
// (> 0) multiplies q k^T (1 / sqrt(hd) for the reference's attention).
// `lse`, where not null, gets each row's log-sum-exp of the scaled (and
// masked) scores, float32 [B, nq, Sq] contiguous: what the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from. Null writes
// nothing, and o is the same bit for bit.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int nq, int nkv, int Sq, int Sk, int hd,
                                   int dtype, const long long* strides, int causal, double scale,
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
  }
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, nq, nkv, Sq, Sk, hd, st, causal, scale,
                            static_cast<float*>(lse), stream);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, nq, nkv, Sq, Sk, hd, st, causal, scale,
                                    static_cast<float*>(lse), stream);
  return (int)cudaErrorInvalidValue;
}
