// Causal or full GQA flash-attention forward for bf16 on Hopper's tensor
// cores (sm_90a): wgmma for both products, TMA for the tiles.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel (Pallas body `_attn_kernel`) for bf16 inputs. For
// q [B, nq, Sq, hd] and k, v [B, nkv, Sk, hd] (q head h reads kv head
// h / (nq / nkv)):
//   o = softmax(scale * q k^T, masked) v
// (scale a runtime argument: the reference's 1 / sqrt(hd) by default; MLA
// passes 1 / sqrt(its q.k width) with q, k and v zero-padded to hd)
// with a float32 running max, sum and accumulator per q row (online
// softmax), the KV tiles wholly above the diagonal skipped, the diagonal
// tile masked per element, and o = acc / max(l, 1e-30), cast to bf16. Causal
// needs Sq == Sk (the wrapper raises otherwise). float32 inputs go to
// flash_attention.cu (mma.sync in 3xTF32: the f32 bound, 2e-5, is below one
// TF32 pass's error). The plain version is
// src/repro_torch/kernels/flash_attention/ref.py::attention_ref.
//
// What bounds it on this card: operations. qwen3-0.6b's attention over a
// 64-point wave ([B = 128, 16 q heads, 8 kv heads, S = 2,048, hd = 128],
// causal) needs 2 * 2 * S(S+1)/2 * hd * B * nq = 2.2 TFLOP for 2.1 GB of q,
// k, v and o: ~1,000 operations per byte, above the bf16 ridge (~295). At
// the bf16 tensor-core peak (989 TFLOP/s) that is 2.24 ms; the bytes take
// 0.64 ms. Only wgmma reaches that peak.
//
// What the design does about it (FA3-like, warp-specialised):
// * One block of three warpgroups per (b, q head, 128-row q tile); the tiles
//   with the longest causal sweeps are issued first. Warpgroup 0 is the
//   producer: one thread issues every TMA load and the warpgroup gives its
//   registers to the consumers (setmaxnreg 24). Warpgroups 1 and 2 are the
//   consumers (setmaxnreg 240), 64 q rows each, the m64 of wgmma. Two
//   consumers rather than one: while one runs its softmax on the CUDA cores
//   the other's products keep the tensor cores busy.
// * Shared memory: the q tile, loaded once, and a ring of 2 stages of
//   BK = 128 keys of K and V, each stage with a full and an empty mbarrier
//   (TMA completes the full one with its byte count; each consumer warp
//   arrives on the empty one once its products have retired). At hd = 128:
//   q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB, one block per SM.
// * S = Q K^T: wgmma m64n128k16, both operands in shared memory, both
//   K-major (hd contiguous), hd / 16 k-steps.
// * Softmax in registers, in the accumulator's fragment: a thread holds 2
//   rows, and the 4 lanes that share a row reduce its max with two
//   shuffles; the row sum stays per thread until the epilogue. The scale is
//   folded into exp2 as log2(e) * scale. Elements are masked only on the
//   diagonal tile and on keys >= Sk.
// * O += P V: P is rounded to bf16 in registers. The m64nNk16 f32
//   accumulator layout, packed in pairs, is the register A operand of the
//   next wgmma, so P never goes to shared memory. V is the B operand with
//   hd contiguous: the MN-major ("transposed B") descriptor. O is rescaled
//   by alpha only after wgmma.wait_group has retired the products that
//   write it. Rounding P to bf16 is the one rounding flash_attention.cu
//   does not make; the JAX package's model path makes it too
//   (src/repro/models/attention.py: softmax(...).astype(v.dtype)).
// * Epilogue: O / l in bf16, stored with 4-byte stores straight into o's
//   strided layout; rows >= Sq are never written. Where the caller asks
//   (training), each row's log-sum-exp too, (m + log2 l) ln 2, which
//   flash_attention_bwd.cu recomputes the probabilities from.
// * Layout through strides: q, k and v are read through one 4-D tensor map
//   each over the strided [B, S, n, hd] view (hd and the other three dims in
//   order of their strides; strides in bytes from the tensor), so the
//   model's [B, S, n, hd] tensors need no transposing copy, and a ragged S
//   zero-fills at the sequence's end instead of reading the next
//   sequence's rows. The maps come from cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint (no -lcuda) and reach the kernel as
//   __grid_constant__ parameters.
// * Swizzle: a tile row of hd bf16 is 64 bytes at hd = 32 (SWIZZLE_64B) and
//   128 or 256 bytes otherwise (SWIZZLE_128B, whose box is at most 128 bytes
//   wide: at hd = 128 a tile is two 64-column boxes, one after the other).
//   The wgmma descriptors walk them: a k-step of Q K^T moves 32 bytes along
//   a row and, past a box, to the next box; the V descriptor's leading byte
//   offset is the distance between boxes (the next 64 columns of hd) and its
//   stride byte offset that between groups of 8 keys.
#include "wgmma_tma.cuh"

namespace {

constexpr int BQ = 128;          // q rows of a block: 64 per consumer warpgroup
constexpr int BK = 128;          // keys of a KV tile
constexpr int STAGES = 2;        // KV tiles in flight
constexpr int THREADS = 384;     // producer + 2 consumer warpgroups
constexpr float NEG_INF = -1e30f;  // the Pallas kernel's mask value
constexpr float LN2 = 0.6931471805599453f;

// ---- the kernel ----------------------------------------------------------------

// the box geometry (wgmma_tma.cuh) and this kernel's tiles of head dim D
template <int D>
struct Tile : Swizzle<D> {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // 1024 bytes to align the tiles to the swizzle's 1 KB pattern, the tiles,
  // and 2 * STAGES + 1 mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (2 * STAGES + 1);
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, long long o_sb, long long o_sn, long long o_ss, int nq, int nkv,
                             int Sq, int Sk, int n_qt, long long n_bh, float scale_log2,
                             int causal, int perm_q, int perm_k, int perm_v) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* KVs = Qs + T::Q_BYTES;  // stage s: K at s * 2 * KV_BYTES, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + STAGES * 2 * T::KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const long long blk = blockIdx.x;
  const int qt = n_qt - 1 - (int)(blk / n_bh);  // the longest sweeps first
  const long long bh = blk % n_bh;              // b * nq + h
  const int b = (int)(bh / nq), h = (int)(bh % nq), hkv = h / (nq / nkv);
  const int q0 = qt * BQ;
  const int n_kt_all = (Sk + BK - 1) / BK;
  // causal (Sq == Sk): KV tiles wholly above the diagonal are never loaded
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / BK + 1) : n_kt_all;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; TMA completes the bytes
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, T::Q_BYTES);
      load_tile<D>(Qs, &tq, perm_q, h, q0, b, BQ, qbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[stage], 2 * T::KV_BYTES);
        uint8_t* Ks = KVs + stage * 2 * T::KV_BYTES;
        load_tile<D>(Ks, &tk, perm_k, hkv, kt * BK, b, BK, &full[stage]);
        load_tile<D>(Ks + T::KV_BYTES, &tv, perm_v, hkv, kt * BK, b, BK, &full[stage]);
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

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's part of the sum

    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BK;
      mbar_wait(&full[stage], phase);
      const uint32_t k_addr = smem_addr(KVs + stage * 2 * T::KV_BYTES);
      const uint32_t v_addr = k_addr + T::KV_BYTES;

      // S = Q K^T: D / 16 k-steps of 32 bytes along the rows, box after box
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 16 / T::CPB, off = (kk * 16 % T::CPB) * 2;
        const uint64_t da = gmma_desc(q_addr + box * BQ * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
        const uint64_t db = gmma_desc(k_addr + box * BK * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
        wgmma_ss_n128(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scores in log2 units; mask on the diagonal tile and past Sk. Element
      // i of the fragment: row r_lo + 8 * ((i >> 1) & 1), key
      // k0 + (i >> 2) * 8 + col_base + (i & 1)
      const bool masked = (causal && k0 + BK - 1 > row_first) || k0 + BK > Sk;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * scale_log2;
        if (masked) {
          const int row = r_lo + ((i & 2) ? 8 : 0);
          const int col = k0 + (i >> 2) * 8 + col_base + (i & 1);
          if ((causal && col > row) || col >= Sk) x = NEG_INF;
        }
        s[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = ex2(s[i] - ((i & 2) ? mn1 : mn0));
        s[i] = p;
        if (i & 2) sum1 += p;
        else sum0 += p;
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      // the previous tile's P V has retired (wait_group 0 below)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

      // O += P V: P in bf16 from registers (the accumulator layout is the A
      // fragment), V MN-major: k-steps of 16 keys
      uint32_t p[BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        const uint64_t dv = gmma_desc(v_addr + kk * 16 * T::SW, BK * T::SW, 8 * T::SW, T::LAYOUT);
        wgmma_rs<D>(acc, a, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: the row sums over the 4 lanes of a row, o = acc / l in bf16
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
    if (lse != nullptr && lane % 4 == 0) {  // the rows' log-sum-exp, (m + log2 l) ln 2
      if (r_lo < Sq) lse[bh * Sq + r_lo] = (m0 + log2f(fmaxf(l0, 1e-30f))) * LN2;
      if (r_lo + 8 < Sq) lse[bh * Sq + r_lo + 8] = (m1 + log2f(fmaxf(l1, 1e-30f))) * LN2;
    }
    __nv_bfloat16* ob = o + (long long)b * o_sb + (long long)h * o_sn;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r_lo + 8 * half;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = ob + (long long)row * o_ss + col_base;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[i] * inv[half], acc[i + 1] * inv[half]);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int nq, int nkv, int Sq,
           int Sk, const long long* st, int causal, double scale, float* lse, void* stream) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv;
  int pq, pk, pv, err;
  if ((err = make_map<D>(&mq, q, B, nq, Sq, st, BQ, &pq))) return err;
  if ((err = make_map<D>(&mk, k, B, nkv, Sk, st + 3, BK, &pk))) return err;
  if ((err = make_map<D>(&mv, v, B, nkv, Sk, st + 6, BK, &pv))) return err;
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long n_bh = (long long)B * nq;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const long long blocks = n_bh * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 * scale);  // log2(e) * scale
  kernel<<<(unsigned int)blocks, THREADS, T::SMEM, (cudaStream_t)stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, st[9], st[10], st[11], nq, nkv, Sq, Sk, n_qt,
      n_bh, scale_log2, causal, pq, pk, pv);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns 0, a cudaError_t of the launch, or 10000 + the
// CUresult of a tensor map that could not be encoded. q, o [B, nq, Sq, hd];
// k, v [B, nkv, Sk, hd]; bf16; `strides` holds the element strides of the
// B, n and S dims of q, k, v and o in that order (12 values; hd has stride
// 1), each a multiple of 8 elements, every base 16-byte aligned; hd in
// {32, 64, 128}; nq a multiple of nkv; causal (1) needs Sq == Sk; `scale`
// (> 0) multiplies q k^T (1 / sqrt(hd) for the reference's attention).
// `lse`, where not null, gets each row's log-sum-exp of the scaled (and
// masked) scores, float32 [B, nq, Sq] contiguous: what the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from. Null writes
// nothing, and o is the same bit for bit.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int B, int nq, int nkv, int Sq, int Sk,
                                         int hd, const long long* strides, int causal,
                                         double scale, void* stream) {
  if (B <= 0 || nq <= 0 || nkv <= 0 || nq % nkv != 0 || Sq <= 0 || Sk <= 0 ||
      (causal && Sq != Sk) || !(scale > 0.0))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, nq, nkv, Sq, Sk, strides, causal, scale,
                        static_cast<float*>(lse), stream);
    case 64:
      return launch<64>(q, k, v, o, B, nq, nkv, Sq, Sk, strides, causal, scale,
                        static_cast<float*>(lse), stream);
    case 128:
      return launch<128>(q, k, v, o, B, nq, nkv, Sq, Sk, strides, causal, scale,
                        static_cast<float*>(lse), stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
