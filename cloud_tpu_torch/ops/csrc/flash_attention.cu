// FlashAttention-2 forward and backward for Hopper (sm_90a), with a plain C
// interface (bound from Python with ctypes: cloud_tpu_torch/ops/attention.py).
//
// Replaces the three Pallas TPU kernels of cloud_tpu/ops/attention.py:
//   _fwd_kernel   (:179)  online-softmax attention; writes out and lse
//   _dq_kernel    (:345)  dq from the saved lse and delta = rowsum(dO * O)
//   _dkdv_kernel  (:383)  dk, dv, summed over each GQA group of q heads
// with the whole `flash_attention` contract: causal or not, sm_scale, a
// per-example key mask [B, S], GQA (kv_group = H / H_kv), a sliding window
// (key col visible from row iff row - window < col <= row), a tanh logit
// softcap, and any S (ragged edges are bound-checked, nothing is padded).
//
// Layouts (the JAX boundary, [B, S, H, D], read with strides; no transpose):
//   q, out, dout, dq   [B, S, H, D]      bf16 or f32
//   k, v, dk, dv       [B, S, H_kv, D]   the same type
//   mask               [B, S] bytes (0 = masked key) or null
//   lse, delta         [B, H, S] f32
// D is 64 or 128. Accumulation is f32; outputs are in the input type.
//
// Design. The TPU kernels walk a sequential grid and carry acc/m/l (or the
// dq, dk, dv accumulators) in VMEM scratch between grid steps. Blocks on the
// card run in parallel and carry nothing, so each block owns one output tile
// and loops over the tiles it reduces over (`_tile_live`: causal and window
// tiles that cannot hold an allowed pair are skipped):
// - forward: one block per (q tile of 64 rows, head, example), a loop over
//   the live key tiles of 64;
// - dq: one block per (q tile, head, example), a loop over the live key
//   tiles of 64;
// - dk/dv: one block per (key tile, kv head, example), a loop over every q
//   head of its group and every live q tile, so the GQA sum lands in the
//   block's own accumulators: deterministic, no atomics.
//
// bf16 (the training path):
// - The backward (dq, dk/dv) is built for Hopper on the primitives of
//   sm90.cuh. A block is a producer warpgroup and two or three consumer
//   warpgroups. The producer's first warp stages the tiles (TMA, 128-byte
//   swizzled boxes of rows x 64 values, from a rank-4 map of each
//   [B, S, H, D] tensor, so a box past S is zero-filled within its own
//   example) into a ring of shared-memory stages with a full and an empty
//   mbarrier each, with lse, delta and the key flags beside them; its
//   warpgroup lowers its registers with setmaxnreg for the consumers,
//   which own 64 output rows each. Per tile a consumer runs S (S^T in
//   dk/dv) and dP with wgmma m64nNk16 from shared memory (both operands
//   K-major), the per-element step in registers, then the second products
//   with P and dS (P^T, dS^T) as register A operands, rounded to bf16
//   first, which is the cast the TPU kernels make (p.astype(do.dtype)
//   :407, ds.astype(k.dtype) :368, ds.astype(q.dtype) :417), against the
//   same Q, dO or K tile read MN-major (transposed B): nothing is
//   transposed in memory. A consumer releases a stage once the wgmmas
//   that read it have retired.
//     dq: 64 q rows per consumer (Q, dO resident): three consumers, 192
//       rows, at D 64 (registers 32 / 160), two at D 128 (40 / 232); key
//       tiles of 64 streamed through 4 stages (3 at D 128); S and dP
//       m64n64, dQ m64nD.
//     dk/dv: 128 keys per block (K, V resident), two consumers (40 / 232;
//       a third would leave each 160 registers, where dk/dv spills);
//       (Q, dO) tiles of 64 q rows (32 at D 128, where dK and dV hold
//       twice the registers) through 4 stages; S^T and dP^T m64n64
//       (m64n32), dV and dK m64nD.
//   Under causal masking a block's work grows with its distance from the
//   diagonal's start (the first key tile sees every q tile, the last one
//   q tile), so blockIdx maps heaviest first: dk/dv's key tiles ascending,
//   dq's q tiles descending; dq puts the q heads of a GQA group side by
//   side, so they read the K/V tiles they share from L2.
// - The forward is the earlier design, next to be redesigned: four warps,
//   mma.sync m16n8k16 fed by ldmatrix, Q fragments in registers, P fed
//   back as the A operand (p.astype(v.dtype) :216), the next key tile
//   copied with cp.async into a second shared-memory stage.
// f32 (the tests' oracle runs): four warps, 64 x 64 tiles (32 q rows per
// inner dk/dv tile at D 128), each product computed in f32 FMAs from shared
// memory in the mma fragment layout, P and dS passed through shared memory.
// Both types run one copy of the per-element steps (logit2, fwd_softmax,
// dq_ds, dkdv_pds: scale, softcap, masking, online softmax, dS; the last
// two over any number of n8 accumulator tiles) and of the epilogues, so
// the f32 check covers the arithmetic the bf16 kernels train with; the
// types differ only in operand movement and products.
//
// Masking: a masked probability is set to 0 explicitly (:213, :340), so a
// row with no allowed key ends with l == 0 and writes out 0 and
// lse = -1e30; its dq is 0 and it adds nothing to dk/dv. The softcap
// derivative 1 - tanh^2 uses the uncapped logit (:333-336). Rows and keys
// past S are masked explicitly too; the zeros TMA fills in are not relied
// on.
//
// Bound on this card: at GPT-2 training shapes (B 8, S 1024, H 12, D 64,
// bf16, causal) the forward does 12.9 GFLOP over 51 MB, about 250 flop per
// byte, just under the H100's ~295 flop/byte ridge: bytes and tensor-core
// operations bound it about equally (15 us either way). dq (three
// products) and dk/dv (four) read the same bytes and are operation-bound:
// at TinyLlama's shape (B 4, S 2048, H 32, H_kv 4, D 64) 103 and 137
// GFLOP, 0.104 and 0.139 ms at 989 TFLOP/s, against ~0.02 ms of bytes.
// Beside the products, each kernel spends an exp2, the dS arithmetic and
// bf16 packs on every live (q row, key) pair, which the consumer
// warpgroups overlap with each other's wgmmas; that step is specialised
// per tile (no mask tests on a tile every pair of which is allowed, no
// softcap test without a cap).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 64;  // q rows per block (forward, dq): 16 per warp
constexpr int kBlockN = 64;  // keys per tile (forward, dq) / per block (dkdv)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int batch, seq, heads, kv_heads;
  int causal, window;
  float sm_scale, softcap;
};

// c[0..3] += A (16 x 16) * B (16 x 8) for one warp, in f32 with FMAs, in
// the fragment layout of mma.sync m16n8k16: this lane's outputs are rows g
// and g + 8, columns t and t + 1 (g = lane / 4, t = 2 * (lane % 4)); c[0],
// c[1] on row g and c[2], c[3] on row g + 8. A is row-major [m][k] at `a`
// with row stride lda; B is stored [n][k] (kBT) or [k][n], at `b` with
// stride ldb. (f32 inputs are the tests' oracle runs, where speed does not
// matter; the k loop is kept rolled so that they compile quickly.)
template <bool kBT>
__device__ __forceinline__ void mma_16x8x16(float* c, const float* a,
                                            int lda, const float* b,
                                            int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = g + (i >> 1) * 8;
    const int n = t + (i & 1);
    float s = c[i];
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
      const float bv = kBT ? b[n * ldb + k] : b[k * ldb + n];
      s = fmaf(a[r * lda + k], bv, s);
    }
    c[i] = s;
  }
}

// Copies `rows` rows of D elements (global row stride `stride` elements)
// into shared memory (row stride ld), 16 bytes per thread and step; rows at
// or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          size_t stride, int rows,
                                          int valid) {
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    int4 x = make_int4(0, 0, 0, 0);
    if (r < valid) x = *reinterpret_cast<const int4*>(src + r * stride + c);
    *reinterpret_cast<int4*>(dst + r * ld + c) = x;
  }
}

// The causal/window part of the mask for one (row, col) pair.
__device__ __forceinline__ bool band_ok(const Params& p, int row, int col) {
  if (!p.causal) return true;
  if (col > row) return false;
  return p.window == 0 || col > row - p.window;
}

// `_tile_live`: can the tile of q rows [q0, q0 + nq) and keys [k0, k0 + nk)
// hold an allowed pair? Tiles that cannot are skipped.
__device__ __forceinline__ bool tile_live(const Params& p, int q0, int nq,
                                          int k0, int nk) {
  if (!p.causal) return true;
  if (k0 > q0 + nq - 1) return false;
  return p.window == 0 || k0 + nk - 1 > q0 - p.window;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Flags of keys k0 .. k0 + n - 1, written by the threads first, first +
// stride, ...: 1 when the key exists and the key mask keeps it.
__device__ __forceinline__ void load_key_flags(uint8_t* flags,
                                               const Params& p, int b,
                                               int k0, int n, int first,
                                               int stride) {
  for (int i = first; i < n; i += stride) {
    const int col = k0 + i;
    flags[i] = col < p.seq &&
               (p.mask == nullptr || p.mask[(size_t)b * p.seq + col] != 0);
  }
}
// The same, by every thread of a kThreads block.
__device__ __forceinline__ void load_key_flags(uint8_t* flags,
                                               const Params& p, int b,
                                               int k0, int n) {
  load_key_flags(flags, p, b, k0, n, threadIdx.x, kThreads);
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A tile every pair of which is allowed: no key mask, no ragged edge, and
// wholly inside the causal/window band. Its scores skip the mask tests.
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int nq,
                                          int k0, int nk) {
  if (p.mask != nullptr || k0 + nk > p.seq || q0 + nq > p.seq) return false;
  if (!p.causal) return true;
  if (k0 + nk - 1 > q0) return false;
  return p.window == 0 || k0 > q0 + nq - 1 - p.window;
}

// A raw score in log2 units: sm_scale, then the softcap (kCap, when
// p.softcap > 0); *dcap gets the softcap derivative (1 without a cap).
template <bool kCap>
__device__ __forceinline__ float logit2(const Params& p, float raw,
                                        float* dcap) {
  if (kCap) {
    const float th = tanhf(raw * p.sm_scale / p.softcap);
    *dcap = 1.f - th * th;
    return p.softcap * th * kLog2e;
  }
  *dcap = 1.f;
  return raw * (p.sm_scale * kLog2e);
}
// The same with the softcap tested per score (the forward).
__device__ __forceinline__ float logit2(const Params& p, float raw,
                                        float* dcap) {
  return p.softcap > 0.f ? logit2<true>(p, raw, dcap)
                         : logit2<false>(p, raw, dcap);
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0): the
// backward's probabilities, whose exponent is at most 0 up to rounding.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax update of one 16 x 64 score tile (this lane's rows row0,
// row0 + 8): s becomes P, m/l (log2 units) advance, acc is rescaled.
template <bool kFull, int NT, int DT>
__device__ __forceinline__ void fwd_softmax(const Params& p,
                                            float (&s)[NT][4], float* m,
                                            float* l, float (&acc)[DT][4],
                                            const uint8_t* fl, int row0,
                                            int k0, int t) {
  float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dcap;
      float x = logit2(p, s[n][i], &dcap);
      if (!kFull) {
        const int c = n * 8 + t + (i & 1);
        if (!(fl[c] && band_ok(p, row0 + (i >> 1) * 8, k0 + c)))
          x = kNegInf;
      }
      s[n][i] = x;
      mcur[i >> 1] = fmaxf(mcur[i >> 1], x);
    }
  }
  float alpha[2], mnext[2], lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mnext[j] = fmaxf(m[j], quad_max(mcur[j]));
    alpha[j] = exp2f(m[j] - mnext[j]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1;
      // Masked scores are exactly kNegInf; their P is an explicit 0.
      const float pv = (kFull || s[n][i] != kNegInf)
                           ? exp2f(s[n][i] - mnext[j]) : 0.f;
      lsum[j] += pv;
      s[n][i] = pv;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = alpha[j] * l[j] + quad_sum(lsum[j]);
    m[j] = mnext[j];
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    acc[d][0] *= alpha[0];
    acc[d][1] *= alpha[0];
    acc[d][2] *= alpha[1];
    acc[d][3] *= alpha[1];
  }
}

// dS for a 16-row block of (q row, key) pairs held as NT 16 x 8
// accumulator tiles (s: raw scores in, dS out; dp: dO V^T). This lane's
// rows are row0 and row0 + 8, its keys k0 + c0 + u * 8 + t + (i & 1);
// lse2 in log2 units.
template <bool kFull, bool kCap, int NT>
__device__ __forceinline__ void dq_ds(const Params& p, float (&s)[NT][4],
                                      const float (&dp)[NT][4],
                                      const uint8_t* fl, int row0, int k0,
                                      int c0, int t, const float* lse2,
                                      const float* delta) {
#pragma unroll
  for (int u = 0; u < NT; ++u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1;
      float dcap;
      const float x = logit2<kCap>(p, s[u][i], &dcap);
      bool allowed = true;
      if (!kFull) {
        const int c = c0 + u * 8 + t + (i & 1);
        allowed = fl[c] && band_ok(p, row0 + j * 8, k0 + c);
      }
      const float pv = allowed ? ex2(x - lse2[j]) : 0.f;
      s[u][i] = pv * (dp[u][i] - delta[j]) * p.sm_scale * dcap;
    }
  }
}

// P^T and dS^T for a (16 keys) x (NT * 8 q rows) block of dk/dv: s (raw
// scores) becomes P^T, dp (dP^T) becomes dS^T. Keys key0, key0 + 8 (fl
// holds the flags of keys k0, k0 + 1, ...); q rows q0 + r, r = r0 + u * 8
// + t + (i & 1); lse (log2 units) and delta per q row of the tile, 8-byte
// aligned (read in pairs).
template <bool kFull, bool kCap, int NT>
__device__ __forceinline__ void dkdv_pds(const Params& p, float (&s)[NT][4],
                                         float (&dp)[NT][4],
                                         const uint8_t* fl, int key0,
                                         int k0, int q0, int r0, int t,
                                         const float* lse2_s,
                                         const float* delta_s) {
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int r2 = r0 + u * 8 + t;
    const float2 lse2 = *reinterpret_cast<const float2*>(lse2_s + r2);
    const float2 delta = *reinterpret_cast<const float2*>(delta_s + r2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + (i >> 1) * 8;
      const int r = r2 + (i & 1);
      float dcap;
      const float x = logit2<kCap>(p, s[u][i], &dcap);
      bool allowed = true;
      if (!kFull) {
        const int row = q0 + r;
        allowed = row < p.seq && fl[key - k0] && band_ok(p, row, key);
      }
      const float pv = allowed ? ex2(x - ((i & 1) ? lse2.y : lse2.x)) : 0.f;
      dp[u][i] = pv * (dp[u][i] - ((i & 1) ? delta.y : delta.x)) *
                 p.sm_scale * dcap;
      s[u][i] = pv;
    }
  }
}

// dq_ds and dkdv_pds specialised per tile: on `full` (tile_full) and on
// the softcap, so that neither is tested per score.
template <int NT>
__device__ __forceinline__ void dq_ds_tile(const Params& p, bool full,
                                           float (&s)[NT][4],
                                           const float (&dp)[NT][4],
                                           const uint8_t* fl, int row0,
                                           int k0, int c0, int t,
                                           const float* lse2,
                                           const float* delta) {
  if (p.softcap > 0.f) {
    if (full)
      dq_ds<true, true>(p, s, dp, fl, row0, k0, c0, t, lse2, delta);
    else
      dq_ds<false, true>(p, s, dp, fl, row0, k0, c0, t, lse2, delta);
  } else if (full) {
    dq_ds<true, false>(p, s, dp, fl, row0, k0, c0, t, lse2, delta);
  } else {
    dq_ds<false, false>(p, s, dp, fl, row0, k0, c0, t, lse2, delta);
  }
}
template <int NT>
__device__ __forceinline__ void dkdv_pds_tile(const Params& p, bool full,
                                              float (&s)[NT][4],
                                              float (&dp)[NT][4],
                                              const uint8_t* fl, int key0,
                                              int k0, int q0, int r0, int t,
                                              const float* lse2_s,
                                              const float* delta_s) {
  if (p.softcap > 0.f) {
    if (full)
      dkdv_pds<true, true>(p, s, dp, fl, key0, k0, q0, r0, t, lse2_s, delta_s);
    else
      dkdv_pds<false, true>(p, s, dp, fl, key0, k0, q0, r0, t, lse2_s,
                            delta_s);
  } else if (full) {
    dkdv_pds<true, false>(p, s, dp, fl, key0, k0, q0, r0, t, lse2_s, delta_s);
  } else {
    dkdv_pds<false, false>(p, s, dp, fl, key0, k0, q0, r0, t, lse2_s, delta_s);
  }
}

// This lane's share of a 16-row output tile in the m16n8 accumulator
// layout: rows row0 and row0 + 8 of `base` (row stride `stride`; rows at
// or past `rows` are not written), columns d * 8 + t and + 1, row row0
// multiplied by mul0 and row row0 + 8 by mul1.
__device__ __forceinline__ void store2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}
__device__ __forceinline__ void store2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack2(lo, hi);
}
template <typename T, int DT>
__device__ __forceinline__ void store_rows(T* base, size_t stride, int row0,
                                           int rows, const float (&acc)[DT][4],
                                           int t, float mul0 = 1.f,
                                           float mul1 = 1.f) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + j * 8;
    if (row >= rows) continue;
    T* r = base + (size_t)row * stride;
    const float mul = j ? mul1 : mul0;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      store2(r + d * 8 + t, acc[d][j * 2] * mul, acc[d][j * 2 + 1] * mul);
  }
}

// The forward's epilogue: out = acc / l (0 where l == 0) and, from the
// quad's first lane, lse = m + log(l) (kNegInf where l == 0), m and l in
// log2 units.
template <typename T, int DT>
__device__ __forceinline__ void fwd_store(const Params& p, int b, int h,
                                          int row0, const float (&acc)[DT][4],
                                          const float* m, const float* l,
                                          int lane) {
  constexpr int D = DT * 8;
  const int S = p.seq;
  const size_t qs = (size_t)p.heads * D;
  store_rows<T, DT>(static_cast<T*>(p.out) + (size_t)b * S * qs + h * D, qs,
                    row0, S, acc, (lane & 3) * 2,
                    l[0] == 0.f ? 0.f : 1.f / l[0],
                    l[1] == 0.f ? 0.f : 1.f / l[1]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + j * 8;
    if (row < S && (lane & 3) == 0)
      p.lse_out[((size_t)b * p.heads + h) * S + row] =
          l[j] == 0.f ? kNegInf : (m[j] + log2f(l[j])) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// f32 kernels (the tests' oracle runs). The same tiles, loops and
// per-element steps (fwd_softmax, dq_ds, dkdv_pds) as the bf16 kernels
// below; only the products differ: f32 FMAs from shared memory in the mma
// fragment layout (mma_16x8x16), with P and dS passed through shared
// memory.
// ---------------------------------------------------------------------------

// f32 shared-memory rows are padded by 16 bytes.
constexpr int kPad = 4;

template <int D>
size_t fwd_smem() {
  constexpr int LD = D + kPad, LDP = kBlockN + kPad;
  return sizeof(float) * ((size_t)(kBlockM + 2 * kBlockN) * LD +
                          (size_t)kBlockM * LDP) +
         kBlockN;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = D + kPad, LDP = kBlockN + kPad;
  constexpr int NT = kBlockN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kBlockM][LD]
  float* k_s = q_s + kBlockM * LD;              // [kBlockN][LD]
  float* v_s = k_s + kBlockN * LD;              // [kBlockN][LD]
  float* p_s = v_s + kBlockN * LD;              // [kBlockM][LDP]
  uint8_t* flags = reinterpret_cast<uint8_t*>(p_s + kBlockM * LDP);

  const int S = p.seq;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const size_t qs = (size_t)p.heads * D, ks = (size_t)p.kv_heads * D;
  const float* kg = static_cast<const float*>(p.k) + (size_t)b * S * ks + hk * D;
  const float* vg = static_cast<const float*>(p.v) + (size_t)b * S * ks + hk * D;
  load_tile<D>(q_s, LD,
               static_cast<const float*>(p.q) + ((size_t)b * S + q0) * qs +
                   h * D,
               qs, kBlockM, S - q0);

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const float* qw = q_s + warp * 16 * LD;
  float* pw = p_s + warp * 16 * LDP;

  for (int k0 = 0; k0 < S; k0 += kBlockN) {
    if (!tile_live(p, q0, kBlockM, k0, kBlockN)) continue;
    __syncthreads();  // every read of the previous tile is done
    load_tile<D>(k_s, LD, kg + k0 * ks, ks, kBlockN, S - k0);
    load_tile<D>(v_s, LD, vg + k0 * ks, ks, kBlockN, S - k0);
    load_key_flags(flags, p, b, k0, kBlockN);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16)
        mma_16x8x16<true>(s[n], qw + kk, LD, k_s + n * 8 * LD + kk, LD);
    }
    if (tile_full(p, q0, kBlockM, k0, kBlockN))
      fwd_softmax<true>(p, s, m, l, acc, flags, row0, k0, t);
    else
      fwd_softmax<false>(p, s, m, l, acc, flags, row0, k0, t);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pw[(g + (i >> 1) * 8) * LDP + n * 8 + t + (i & 1)] = s[n][i];
    __syncwarp();  // each warp reads back only its own rows of P
#pragma unroll
    for (int d = 0; d < DT; ++d) {
#pragma unroll
      for (int kk = 0; kk < kBlockN; kk += 16)
        mma_16x8x16<false>(acc[d], pw + kk, LDP, v_s + kk * LD + d * 8, LD);
    }
  }
  fwd_store<float, DT>(p, b, h, row0, acc, m, l, lane);
}

template <int D>
size_t dq_smem() {
  constexpr int LD = D + kPad, LDP = kBlockN + kPad;
  return sizeof(float) * ((size_t)(2 * kBlockM + 2 * kBlockN) * LD +
                          (size_t)kBlockM * LDP) +
         kBlockN;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  constexpr int LD = D + kPad, LDP = kBlockN + kPad;
  constexpr int NT = kBlockN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kBlockM][LD]
  float* do_s = q_s + kBlockM * LD;             // [kBlockM][LD]
  float* k_s = do_s + kBlockM * LD;             // [kBlockN][LD]
  float* v_s = k_s + kBlockN * LD;              // [kBlockN][LD]
  float* ds_s = v_s + kBlockN * LD;             // [kBlockM][LDP]
  uint8_t* flags = reinterpret_cast<uint8_t*>(ds_s + kBlockM * LDP);

  const int S = p.seq;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const size_t qs = (size_t)p.heads * D, ks = (size_t)p.kv_heads * D;
  const size_t qoff = ((size_t)b * S + q0) * qs + h * D;
  const float* kg = static_cast<const float*>(p.k) + (size_t)b * S * ks + hk * D;
  const float* vg = static_cast<const float*>(p.v) + (size_t)b * S * ks + hk * D;
  load_tile<D>(q_s, LD, static_cast<const float*>(p.q) + qoff, qs, kBlockM,
               S - q0);
  load_tile<D>(do_s, LD, static_cast<const float*>(p.dout) + qoff, qs,
               kBlockM, S - q0);

  const int row0 = q0 + warp * 16 + g;
  float lse[2], delta[2];  // lse in log2 units
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + j * 8;
    const size_t idx = ((size_t)b * p.heads + h) * S + row;
    lse[j] = row < S ? p.lse_in[idx] * kLog2e : 0.f;
    delta[j] = row < S ? p.delta[idx] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  const float* qw = q_s + warp * 16 * LD;
  const float* dow = do_s + warp * 16 * LD;
  float* dsw = ds_s + warp * 16 * LDP;

  for (int k0 = 0; k0 < S; k0 += kBlockN) {
    if (!tile_live(p, q0, kBlockM, k0, kBlockN)) continue;
    __syncthreads();
    load_tile<D>(k_s, LD, kg + k0 * ks, ks, kBlockN, S - k0);
    load_tile<D>(v_s, LD, vg + k0 * ks, ks, kBlockN, S - k0);
    load_key_flags(flags, p, b, k0, kBlockN);
    __syncthreads();
    const bool full = tile_full(p, q0, kBlockM, k0, kBlockN);

    // 16 keys at a time: S and dP for them, then dS into shared memory.
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma_16x8x16<true>(s[u], qw + kk, LD, k_s + (n + u) * 8 * LD + kk, LD);
          mma_16x8x16<true>(dp[u], dow + kk, LD, v_s + (n + u) * 8 * LD + kk,
                            LD);
        }
      }
      dq_ds_tile(p, full, s, dp, flags, row0, k0, n * 8, t, lse, delta);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dsw[(g + (i >> 1) * 8) * LDP + (n + u) * 8 + t + (i & 1)] = s[u][i];
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DT; ++d) {
#pragma unroll
      for (int kk = 0; kk < kBlockN; kk += 16)
        mma_16x8x16<false>(acc[d], dsw + kk, LDP, k_s + kk * LD + d * 8, LD);
    }
  }
  store_rows<float, DT>(static_cast<float*>(p.dq) + (size_t)b * S * qs + h * D,
                        qs, row0, S, acc, t);
}

// q rows per inner tile of the f32 dk/dv: 64 at D 64, 32 at D 128
// (registers: its S^T and dP^T tiles and the dk, dv accumulators).
template <int D>
__host__ __device__ constexpr int dkdv_tile_q() {
  return D == 128 ? 32 : 64;
}

template <int D>
size_t dkdv_smem() {
  constexpr int TQ = dkdv_tile_q<D>();
  constexpr int LD = D + kPad, LDQ = TQ + kPad;
  return sizeof(float) * ((size_t)(2 * kBlockN + 2 * TQ) * LD +
                          (size_t)2 * kBlockN * LDQ) +
         sizeof(float) * 2 * TQ + kBlockN;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(Params p) {
  constexpr int TQ = dkdv_tile_q<D>();
  constexpr int LD = D + kPad, LDQ = TQ + kPad;
  constexpr int NQ = TQ / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [kBlockN][LD]
  float* v_s = k_s + kBlockN * LD;              // [kBlockN][LD]
  float* q_s = v_s + kBlockN * LD;              // [TQ][LD]
  float* do_s = q_s + TQ * LD;                  // [TQ][LD]
  float* pt_s = do_s + TQ * LD;                 // [kBlockN][LDQ]  P^T
  float* dst_s = pt_s + kBlockN * LDQ;          // [kBlockN][LDQ]  dS^T
  float* lse_s = dst_s + kBlockN * LDQ;         // [TQ], log2 units
  float* delta_s = lse_s + TQ;                  // [TQ]
  uint8_t* flags = reinterpret_cast<uint8_t*>(delta_s + TQ);  // [kBlockN]

  const int S = p.seq;
  const int k0 = blockIdx.x * kBlockN, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const size_t qs = (size_t)p.heads * D, ks = (size_t)p.kv_heads * D;
  const size_t koff = ((size_t)b * S + k0) * ks + hk * D;
  load_tile<D>(k_s, LD, static_cast<const float*>(p.k) + koff, ks, kBlockN,
               S - k0);
  load_tile<D>(v_s, LD, static_cast<const float*>(p.v) + koff, ks, kBlockN,
               S - k0);
  load_key_flags(flags, p, b, k0, kBlockN);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  const float* kw = k_s + warp * 16 * LD;
  const float* vw = v_s + warp * 16 * LD;
  float* ptw = pt_s + warp * 16 * LDQ;
  float* dstw = dst_s + warp * 16 * LDQ;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const float* qg = static_cast<const float*>(p.q) + (size_t)b * S * qs + h * D;
    const float* dog = static_cast<const float*>(p.dout) + (size_t)b * S * qs + h * D;
    const float* lseg = p.lse_in + ((size_t)b * p.heads + h) * S;
    const float* deltag = p.delta + ((size_t)b * p.heads + h) * S;
    for (int q0 = 0; q0 < S; q0 += TQ) {
      if (!tile_live(p, q0, TQ, k0, kBlockN)) continue;
      __syncthreads();  // every read of the previous q tile is done
      load_tile<D>(q_s, LD, qg + q0 * qs, qs, TQ, S - q0);
      load_tile<D>(do_s, LD, dog + q0 * qs, qs, TQ, S - q0);
      for (int i = threadIdx.x; i < TQ; i += kThreads) {
        lse_s[i] = q0 + i < S ? lseg[q0 + i] * kLog2e : 0.f;
        delta_s[i] = q0 + i < S ? deltag[q0 + i] : 0.f;
      }
      __syncthreads();
      const bool full = tile_full(p, q0, TQ, k0, kBlockN);

      // 16 q rows at a time: S^T = K Q^T and dP^T = V dO^T for this
      // warp's 16 keys, then P^T and dS^T into shared memory.
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_16x8x16<true>(s[u], kw + kk, LD, q_s + (n + u) * 8 * LD + kk,
                              LD);
            mma_16x8x16<true>(dp[u], vw + kk, LD,
                              do_s + (n + u) * 8 * LD + kk, LD);
          }
        }
        dkdv_pds_tile(p, full, s, dp, flags, key0, k0, q0, n * 8, t, lse_s,
                      delta_s);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int at = (g + (i >> 1) * 8) * LDQ + (n + u) * 8 + t + (i & 1);
            ptw[at] = s[u][i];
            dstw[at] = dp[u][i];
          }
        }
      }
      __syncwarp();
      // dV += P^T dO and dK += dS^T Q.
#pragma unroll
      for (int d = 0; d < DT; ++d) {
#pragma unroll
        for (int kk = 0; kk < TQ; kk += 16) {
          mma_16x8x16<false>(dv[d], ptw + kk, LDQ, do_s + kk * LD + d * 8,
                             LD);
          mma_16x8x16<false>(dk[d], dstw + kk, LDQ, q_s + kk * LD + d * 8,
                             LD);
        }
      }
    }
  }
  const size_t kvoff = (size_t)b * S * ks + hk * D;
  store_rows<float, DT>(static_cast<float*>(p.dk) + kvoff, ks, key0, S, dk, t);
  store_rows<float, DT>(static_cast<float*>(p.dv) + kvoff, ks, key0, S, dv, t);
}

// ---------------------------------------------------------------------------
// bf16: the training path's kernels. Same tiles and loops as above, with
// the operands moved as the tensor cores want them: fragments loaded with
// ldmatrix (the transposing form for operands stored [k][n]); Q and dO
// fragments held in registers where they are reused; P and dS kept in
// registers and fed back as the A operand of the second product (the
// m16n8 accumulator layout of two adjacent key tiles is the m16k16 A
// layout); the next key (or q) tile copied with cp.async while the
// current one is computed (two shared-memory stages).
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment (16 x 16, k = the 16 columns) made of the accumulators of
// two adjacent 16 x 8 tiles, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack2(c0[0], c0[1]);
  a[1] = pack2(c0[2], c0[3]);
  a[2] = pack2(c1[0], c1[1]);
  a[3] = pack2(c1[2], c1[3]);
}

// Row/column of this lane's ldmatrix address for the three operand forms
// (tile origin added by the caller; ld = row stride in elements):
// A stored [m][k], 16 x 16 at (m0, k0).
__device__ __forceinline__ int a_off(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
// B stored [n][k]: two n tiles (n0, n0 + 8) at k0 -> regs {b(n0), b(n0+8)}.
__device__ __forceinline__ int bt_off(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}
// B stored [k][n] (transposing load): two n tiles at (k0, n0).
__device__ __forceinline__ int bn_off(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// As load_tile, with cp.async (zero-fill past `valid`); no wait.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                size_t stride, int rows,
                                                int valid) {
  constexpr int LD = D + 8, kPerRow = D / 8;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    const bool ok = r < valid;
    cp_async_16(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
  }
}

// First live key tile of the q tile [q0, q0 + nq); S when there is none.
__device__ __forceinline__ int first_live_key(const Params& p, int q0,
                                              int nq) {
  int k0 = 0;
  while (k0 < p.seq && !tile_live(p, q0, nq, k0, kBlockN)) k0 += kBlockN;
  return k0;
}

template <int D>
size_t fwd_smem_bf16() {
  return sizeof(bf16) * (size_t)(kBlockM + 4 * kBlockN) * (D + 8) +
         2 * kBlockN;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  constexpr int LD = D + 8, NT = kBlockN / 8, DT = D / 8, KT = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBlockM][LD]
  bf16* kv_s = q_s + kBlockM * LD;  // [stage][K | V][kBlockN][LD]
  uint8_t* flags = reinterpret_cast<uint8_t*>(kv_s + 4 * kBlockN * LD);

  const int S = p.seq;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const size_t qs = (size_t)p.heads * D, ks = (size_t)p.kv_heads * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + (size_t)b * S * ks + hk * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + (size_t)b * S * ks + hk * D;

  load_tile_async<D>(q_s,
                     static_cast<const bf16*>(p.q) +
                         ((size_t)b * S + q0) * qs + h * D,
                     qs, kBlockM, S - q0);
  cp_async_commit();
  int k0 = first_live_key(p, q0, kBlockM);
  if (k0 < S) {
    load_tile_async<D>(kv_s, kg + k0 * ks, ks, kBlockN, S - k0);
    load_tile_async<D>(kv_s + kBlockN * LD, vg + k0 * ks, ks, kBlockN,
                       S - k0);
    load_key_flags(flags, p, b, k0, kBlockN);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldsm_x4(qf[kk], q_s + warp * 16 * LD + kk * 16 + a_off(LD));

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;

  for (int stage = 0; k0 < S && tile_live(p, q0, kBlockM, k0, kBlockN);
       k0 += kBlockN, stage ^= 1) {
    const int kn = k0 + kBlockN;
    if (kn < S && tile_live(p, q0, kBlockM, kn, kBlockN)) {
      bf16* nxt = kv_s + (stage ^ 1) * 2 * kBlockN * LD;
      load_tile_async<D>(nxt, kg + kn * ks, ks, kBlockN, S - kn);
      load_tile_async<D>(nxt + kBlockN * LD, vg + kn * ks, ks, kBlockN,
                         S - kn);
      load_key_flags(flags + (stage ^ 1) * kBlockN, p, b, kn, kBlockN);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's K, V and flags are visible
    const bf16* k_s = kv_s + stage * 2 * kBlockN * LD;
    const bf16* v_s = k_s + kBlockN * LD;
    const uint8_t* fl = flags + stage * kBlockN;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, k_s + n * 8 * LD + kk * 16 + bt_off(LD));
        mma_bf16(s[n], qf[kk], bb);
        mma_bf16(s[n + 1], qf[kk], bb + 2);
      }
    }
    if (tile_full(p, q0, kBlockM, k0, kBlockN))
      fwd_softmax<true>(p, s, m, l, acc, fl, row0, k0, t);
    else
      fwd_softmax<false>(p, s, m, l, acc, fl, row0, k0, t);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, v_s + kk * 16 * LD + d * 8 + bn_off(LD));
        mma_bf16(acc[d], a, bb);
        mma_bf16(acc[d + 1], a, bb + 2);
      }
    }
    __syncthreads();  // every read of this stage is done before its refill
  }
  cp_async_wait<0>();

  fwd_store<bf16, DT>(p, b, h, row0, acc, m, l, lane);
}

enum Which { kForward = 0, kDq = 1, kDkdv = 2 };

// ---------------------------------------------------------------------------
// bf16 backward (the training path): dq and dk/dv on wgmma, fed by TMA,
// warp-specialised. Warpgroup 0 produces (its first warp stages the
// tiles; registers lowered with setmaxnreg), and the next two or three
// consume (registers raised), each owning 64 rows of the block's output
// tile, the M of its wgmma products. Every operand
// tile is a TMA box of rows x 64 values, 128-byte swizzled, which wgmma
// reads K-major for S (and dP) and MN-major for the second product, so
// Q, dO and K are never transposed in memory.
// ---------------------------------------------------------------------------

constexpr int kWg = 128;           // threads per warpgroup
constexpr int kWgRows = 64;        // rows of a consumer's tile
constexpr uint32_t kBoxRow = 128;  // bytes of a box row: 64 bf16

// The warpgroups of a block: a producer and C consumers, with the
// registers setmaxnreg gives each (the 64K of the SM shared out).
template <int C>
struct Warpgroups {
  static constexpr int kConsumers = C;
  static constexpr int kThreads = (C + 1) * kWg;
  static constexpr int kProducerRegs = C == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = C == 3 ? 160 : 232;
};

// dq: one block per (kM q rows, head, example); Q and dO resident, K and
// V streamed in tiles of 64 keys through a ring of kStages. At D 64 a dq
// consumer fits in 160 registers, so three of them (192 rows) hide more
// of each other's latency than two; at D 128 two.
template <int D>
constexpr int dq_consumers() {
  return D == 64 ? 3 : 2;
}
template <int D>
struct DqTiles : Warpgroups<dq_consumers<D>()> {
  static constexpr int kBoxes = D / 64;
  static constexpr int kM = dq_consumers<D>() * kWgRows;
  static constexpr int kN = kBlockN;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr uint32_t kQ = kBoxes * kM * kBoxRow;    // Q or dO
  static constexpr uint32_t kKV = kBoxes * kN * kBoxRow;   // K or V, a stage
  // Q, dO, the ring, its key flags, the barriers (Q/dO, full, empty) and
  // slack to align to 1024 bytes.
  static constexpr size_t kSmem = 2 * kQ + kStages * (2 * kKV + kN) +
                                  (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

// dk/dv: one block per (128 keys, kv head, example); K and V resident,
// (Q, dO, lse, delta) streamed for every q head of the group and every
// live q tile of kTQ rows. kTQ is the N of S^T and dP^T: 64 at D 64, 32 at
// D 128, where dK and dV take twice the registers. Two consumers: a dk/dv
// consumer spills in the 160 registers three would leave it.
template <int D>
struct DkdvTiles : Warpgroups<2> {
  static constexpr int kBoxes = D / 64;
  static constexpr int kN = kConsumers * kWgRows;
  static constexpr int kTQ = D == 64 ? 64 : 32;
  static constexpr int kStages = 4;
  static constexpr uint32_t kKV = kBoxes * kN * kBoxRow;   // K or V
  static constexpr uint32_t kQ = kBoxes * kTQ * kBoxRow;   // Q or dO, a stage
  // K, V, the ring, its lse and delta rows, the key flags, the barriers
  // (K/V, full, empty) and slack to align to 1024 bytes.
  static constexpr size_t kSmem = 2 * kKV + kStages * 2 * kQ +
                                  kStages * 2 * kTQ * sizeof(float) + kN +
                                  (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase,
                                           int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// S = A . B^T and dP over D for one consumer: A (64 rows) and B (N rows)
// are tiles of kBoxes boxes `a_box` and `b_box` values apart.
template <int D, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4],
                                       float (&dp)[NT][4], const bf16* a,
                                       const bf16* b, const bf16* da,
                                       const bf16* db, int a_box,
                                       int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / 4, off = 2 * (kk % 4);
    sm90::wgmma_ss(s, sm90::desc_k128(a + x * a_box) + off,
                   sm90::desc_k128(b + x * b_box) + off, kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / 4, off = 2 * (kk % 4);
    sm90::wgmma_ss(dp, sm90::desc_k128(da + x * a_box) + off,
                   sm90::desc_k128(db + x * b_box) + off, kk > 0);
  }
  sm90::wgmma_commit();
  sm90::fence_operands(s);
  sm90::fence_operands(dp);
  sm90::wgmma_wait<0>();
  sm90::fence_operands(s);
  sm90::fence_operands(dp);
}

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
    flash_dq_bf16(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const Params p) {
  using T = DqTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [box][kM][64]
  bf16* do_s = reinterpret_cast<bf16*>(smem + T::kQ);
  unsigned char* ring = smem + 2 * T::kQ;  // [stage][K | V][box][kN][64]
  uint8_t* flags = ring + T::kStages * 2 * T::kKV;    // [stage][kN]
  uint64_t* qdo_full =
      reinterpret_cast<uint64_t*>(flags + T::kStages * T::kN);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + T::kStages;

  // Heaviest first: the q tile runs down as blockIdx.x runs up (under
  // causal masking the last q tile sees the most keys); the heads of one
  // GQA group are neighbours, so the K/V tiles they share stay in L2.
  const int S = p.seq;
  const int n_qt = (S + T::kM - 1) / T::kM;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (p.heads * p.batch));
  const int h = blockIdx.x % p.heads;
  const int b = (blockIdx.x / p.heads) % p.batch;
  const int hk = h / (p.heads / p.kv_heads);
  const int q0 = qt * T::kM;
  // The live key tiles form one run [k_lo, k_hi).
  const int k_lo = first_live_key(p, q0, T::kM);
  int k_hi = k_lo;
  while (k_hi < S && tile_live(p, q0, T::kM, k_hi, T::kN)) k_hi += T::kN;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qdo_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      sm90::mbar_init(&full[s], 32);             // the producer warp
      sm90::mbar_init(&empty[s], T::kConsumers * kWg / 32);  // their warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<T::kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(qdo_full, 2 * T::kQ);
        for (int x = 0; x < T::kBoxes; ++x) {
          sm90::tma_load_4d(q_s + x * T::kM * 64, &map_q, qdo_full, x * 64,
                            h, q0, b);
          sm90::tma_load_4d(do_s + x * T::kM * 64, &map_do, qdo_full,
                            x * 64, h, q0, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = k_lo; k0 < k_hi; k0 += T::kN) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        load_key_flags(flags + stage * T::kN, p, b, k0, T::kN, lane, 32);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[stage], 2 * T::kKV);
          bf16* k_s = reinterpret_cast<bf16*>(ring + stage * 2 * T::kKV);
          bf16* v_s = k_s + T::kKV / sizeof(bf16);
          for (int x = 0; x < T::kBoxes; ++x) {
            sm90::tma_load_4d(k_s + x * T::kN * 64, &map_k, &full[stage],
                              x * 64, hk, k0, b);
            sm90::tma_load_4d(v_s + x * T::kN * 64, &map_v, &full[stage],
                              x * 64, hk, k0, b);
          }
        } else {
          sm90::mbar_arrive(&full[stage]);
        }
        next_stage(stage, phase, T::kStages);
      }
    }
  } else {
    sm90::setmaxnreg_inc<T::kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = (lane & 3) * 2;
    const int qc = q0 + c * kWgRows;  // this consumer's 64 rows
    const int row0 = qc + warp * 16 + (lane >> 2);
    float lse[2], delta[2];  // lse in log2 units
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + j * 8;
      const size_t idx = ((size_t)b * p.heads + h) * S + row;
      lse[j] = row < S ? p.lse_in[idx] * kLog2e : 0.f;
      delta[j] = row < S ? p.delta[idx] : 0.f;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    const bf16* qw = q_s + c * kWgRows * 64;
    const bf16* dow = do_s + c * kWgRows * 64;
    sm90::mbar_wait(qdo_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = k_lo; k0 < k_hi; k0 += T::kN) {
      sm90::mbar_wait(&full[stage], phase);
      const bf16* k_s = reinterpret_cast<const bf16*>(ring +
                                                      stage * 2 * T::kKV);
      const bf16* v_s = k_s + T::kKV / sizeof(bf16);
      if (qc < S && tile_live(p, qc, kWgRows, k0, T::kN)) {
        // S = Q K^T and dP = dO V^T, then dS in registers.
        float s[T::kN / 8][4], dp[T::kN / 8][4];
        sm90::wgmma_fence();
        scores<D>(s, dp, qw, k_s, dow, v_s, T::kM * 64, T::kN * 64);
        const uint8_t* fl = flags + stage * T::kN;
        dq_ds_tile(p, tile_full(p, qc, kWgRows, k0, T::kN), s, dp, fl, row0,
                   k0, 0, t, lse, delta);
        // dQ += dS K: dS from registers, K read MN-major.
        uint32_t a[T::kN / 16][4];
#pragma unroll
        for (int kk = 0; kk < T::kN / 16; ++kk)
          acc_to_a(a[kk], s[2 * kk], s[2 * kk + 1]);
        sm90::fence_operands(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::kN / 16; ++kk)
          sm90::wgmma_rs_tb(acc, a[kk],
                            sm90::desc_mn128(k_s + kk * 16 * 64,
                                             T::kN * kBoxRow));
        sm90::wgmma_commit();
        sm90::fence_operands(acc);
        sm90::wgmma_wait<0>();  // the stage is read; release it below
        sm90::fence_operands(acc);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      next_stage(stage, phase, T::kStages);
    }
    const size_t qs = (size_t)p.heads * D;
    store_rows<bf16, D / 8>(
        static_cast<bf16*>(p.dq) + (size_t)b * S * qs + h * D, qs, row0, S,
        acc, t);
  }
}

template <int D>
__global__ void __launch_bounds__(DkdvTiles<D>::kThreads, 1)
    flash_dkdv_bf16(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const Params p) {
  using T = DkdvTiles<D>;
  constexpr int NQ = T::kTQ / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem);          // [box][kN][64]
  bf16* v_s = reinterpret_cast<bf16*>(smem + T::kKV);
  unsigned char* ring = smem + 2 * T::kKV;  // [stage][Q | dO][box][kTQ][64]
  // [stage][lse (log2 units) | delta][kTQ]
  float* rows_s = reinterpret_cast<float*>(ring + T::kStages * 2 * T::kQ);
  uint8_t* flags =
      reinterpret_cast<uint8_t*>(rows_s + T::kStages * 2 * T::kTQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(flags + T::kN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + T::kStages;

  // Heaviest first: key tile 0, which every q tile sees under causal
  // masking, comes first.
  const int S = p.seq;
  const int group = p.heads / p.kv_heads;
  const int kt = blockIdx.x / (p.kv_heads * p.batch);
  const int hk = blockIdx.x % p.kv_heads;
  const int b = (blockIdx.x / p.kv_heads) % p.batch;
  const int k0 = kt * T::kN;
  // The live q tiles form one run [q_lo, q_hi) (causal and window bands
  // are contiguous); every q head of the group walks the same run.
  int q_lo = 0;
  while (q_lo < S && !tile_live(p, q_lo, T::kTQ, k0, T::kN)) q_lo += T::kTQ;
  int q_hi = q_lo;
  while (q_hi < S && tile_live(p, q_hi, T::kTQ, k0, T::kN)) q_hi += T::kTQ;
  const int nq = (q_hi - q_lo) / T::kTQ;
  const int total = group * nq;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 32);  // the producer warp
    for (int s = 0; s < T::kStages; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], T::kConsumers * kWg / 32);  // their warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<T::kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      load_key_flags(flags, p, b, k0, T::kN, lane, 32);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 2 * T::kKV);
        for (int x = 0; x < T::kBoxes; ++x) {
          sm90::tma_load_4d(k_s + x * T::kN * 64, &map_k, kv_full, x * 64,
                            hk, k0, b);
          sm90::tma_load_4d(v_s + x * T::kN * 64, &map_v, kv_full, x * 64,
                            hk, k0, b);
        }
      } else {
        sm90::mbar_arrive(kv_full);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < total; ++it) {
        const int h = hk * group + it / nq;
        const int q0 = q_lo + (it % nq) * T::kTQ;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        float* rows = rows_s + stage * 2 * T::kTQ;
        const size_t r0 = ((size_t)b * p.heads + h) * S + q0;
        for (int i = lane; i < T::kTQ; i += 32) {
          const bool ok = q0 + i < S;
          rows[i] = ok ? p.lse_in[r0 + i] * kLog2e : 0.f;
          rows[T::kTQ + i] = ok ? p.delta[r0 + i] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[stage], 2 * T::kQ);
          bf16* q_s = reinterpret_cast<bf16*>(ring + stage * 2 * T::kQ);
          bf16* do_s = q_s + T::kQ / sizeof(bf16);
          for (int x = 0; x < T::kBoxes; ++x) {
            sm90::tma_load_4d(q_s + x * T::kTQ * 64, &map_q, &full[stage],
                              x * 64, h, q0, b);
            sm90::tma_load_4d(do_s + x * T::kTQ * 64, &map_do, &full[stage],
                              x * 64, h, q0, b);
          }
        } else {
          sm90::mbar_arrive(&full[stage]);
        }
        next_stage(stage, phase, T::kStages);
      }
    }
  } else {
    sm90::setmaxnreg_inc<T::kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = (lane & 3) * 2;
    const int kc = k0 + c * kWgRows;  // this consumer's 64 keys
    const int key0 = kc + warp * 16 + (lane >> 2);
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
      dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
    }
    const bf16* kw = k_s + c * kWgRows * 64;
    const bf16* vw = v_s + c * kWgRows * 64;
    sm90::mbar_wait(kv_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < total; ++it) {
      const int q0 = q_lo + (it % nq) * T::kTQ;
      sm90::mbar_wait(&full[stage], phase);
      const bf16* q_s = reinterpret_cast<const bf16*>(ring +
                                                      stage * 2 * T::kQ);
      const bf16* do_s = q_s + T::kQ / sizeof(bf16);
      if (kc < S && tile_live(p, q0, T::kTQ, kc, kWgRows)) {
        // S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in registers.
        float s[NQ][4], dp[NQ][4];
        sm90::wgmma_fence();
        scores<D>(s, dp, kw, q_s, vw, do_s, T::kN * 64, T::kTQ * 64);
        const float* lse_s = rows_s + stage * 2 * T::kTQ;
        dkdv_pds_tile(p, tile_full(p, q0, T::kTQ, kc, kWgRows), s, dp, flags,
                      key0, k0, q0, 0, t, lse_s, lse_s + T::kTQ);
        // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers,
        // dO and Q read MN-major.
        uint32_t pa[NQ / 2][4], dsa[NQ / 2][4];
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
          acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
          acc_to_a(dsa[kk], dp[2 * kk], dp[2 * kk + 1]);
        }
        sm90::fence_operands(dv);
        sm90::fence_operands(dk);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
          sm90::wgmma_rs_tb(dv, pa[kk],
                            sm90::desc_mn128(do_s + kk * 16 * 64,
                                             T::kTQ * kBoxRow));
          sm90::wgmma_rs_tb(dk, dsa[kk],
                            sm90::desc_mn128(q_s + kk * 16 * 64,
                                             T::kTQ * kBoxRow));
        }
        sm90::wgmma_commit();
        sm90::fence_operands(dv);
        sm90::fence_operands(dk);
        sm90::wgmma_wait<0>();  // the stage is read; release it below
        sm90::fence_operands(dv);
        sm90::fence_operands(dk);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      next_stage(stage, phase, T::kStages);
    }
    const size_t ks = (size_t)p.kv_heads * D;
    const size_t kvoff = (size_t)b * S * ks + hk * D;
    store_rows<bf16, D / 8>(static_cast<bf16*>(p.dk) + kvoff, ks, key0, S,
                            dk, t);
    store_rows<bf16, D / 8>(static_cast<bf16*>(p.dv) + kvoff, ks, key0, S,
                            dv, t);
  }
}

// The bf16 dq (which == kDq) or dk/dv kernel: tensor maps of q, k, v and
// dout, one block per output tile, heaviest first.
template <int D>
cudaError_t launch_bwd_bf16(int which, const Params& p,
                            cudaStream_t stream) {
  const bool dq = which == kDq;
  const uint32_t q_rows = dq ? DqTiles<D>::kM : DkdvTiles<D>::kTQ;
  const uint32_t k_rows = dq ? DqTiles<D>::kN : DkdvTiles<D>::kN;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!sm90::make_map_bf16_bshd(&map_q, p.q, p.batch, p.seq, p.heads, D,
                                q_rows) ||
      !sm90::make_map_bf16_bshd(&map_do, p.dout, p.batch, p.seq, p.heads, D,
                                q_rows) ||
      !sm90::make_map_bf16_bshd(&map_k, p.k, p.batch, p.seq, p.kv_heads, D,
                                k_rows) ||
      !sm90::make_map_bf16_bshd(&map_v, p.v, p.batch, p.seq, p.kv_heads, D,
                                k_rows))
    return cudaErrorInvalidValue;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                 Params) = dq ? flash_dq_bf16<D> : flash_dkdv_bf16<D>;
  const size_t smem = dq ? DqTiles<D>::kSmem : DkdvTiles<D>::kSmem;
  const long long tiles = (p.seq + (dq ? DqTiles<D>::kM : DkdvTiles<D>::kN) -
                           1) / (dq ? DqTiles<D>::kM : DkdvTiles<D>::kN);
  const long long blocks =
      tiles * (dq ? p.heads : p.kv_heads) * (long long)p.batch;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = dq ? DqTiles<D>::kThreads : DkdvTiles<D>::kThreads;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(map_q, map_k, map_v,
                                                      map_do, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// T = float takes the f32 kernels; bf16 the mma.sync forward and the
// warp-specialised wgmma backward.
template <typename T, int D>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  void (*kernel)(Params);
  size_t smem;
  dim3 grid;
  if (which == kForward) {
    kernel = kBf16 ? flash_fwd_bf16<D> : flash_fwd_kernel<D>;
    smem = kBf16 ? fwd_smem_bf16<D>() : fwd_smem<D>();
    grid = dim3((p.seq + kBlockM - 1) / kBlockM, p.heads, p.batch);
  } else if (kBf16) {
    return launch_bwd_bf16<D>(which, p, stream);
  } else if (which == kDq) {
    kernel = flash_dq_kernel<D>;
    smem = dq_smem<D>();
    grid = dim3((p.seq + kBlockM - 1) / kBlockM, p.heads, p.batch);
  } else {
    kernel = flash_dkdv_kernel<D>;
    smem = dkdv_smem<D>();
    grid = dim3((p.seq + kBlockN - 1) / kBlockN, p.kv_heads, p.batch);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(int which, int kind, int head_dim, const Params& p,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.batch <= 0 || p.seq <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads != 0)
    return cudaErrorInvalidValue;
  if (kind == 0 && head_dim == 64) return launch<float, 64>(which, p, s);
  if (kind == 0 && head_dim == 128) return launch<float, 128>(which, p, s);
  if (kind == 1 && head_dim == 64) return launch<bf16, 64>(which, p, s);
  if (kind == 1 && head_dim == 128) return launch<bf16, 128>(which, p, s);
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* mask, int batch, int seq, int heads,
                   int kv_heads, int causal, int window, float sm_scale,
                   float softcap) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.batch = batch;
  p.seq = seq;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.causal = causal;
  p.window = window;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  return p;
}

}  // namespace

// kind: 0 = f32, 1 = bf16; head_dim 64 or 128. mask may be null. Each
// function returns the launch's cudaError_t (0 = ok); an unknown kind or
// head_dim, or heads not a multiple of kv_heads, gives cudaErrorInvalidValue.
extern "C" int flash_attention_forward(
    int kind, const void* q, const void* k, const void* v, const void* mask,
    void* out, void* lse, int batch, int seq, int heads, int kv_heads,
    int head_dim, int causal, int window, float sm_scale, float softcap,
    void* stream) {
  Params p = make_params(q, k, v, mask, batch, seq, heads, kv_heads, causal,
                         window, sm_scale, softcap);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return dispatch(kForward, kind, head_dim, p, stream);
}

extern "C" int flash_attention_backward_dq(
    int kind, const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dq,
    int batch, int seq, int heads, int kv_heads, int head_dim, int causal,
    int window, float sm_scale, float softcap, void* stream) {
  Params p = make_params(q, k, v, mask, batch, seq, heads, kv_heads, causal,
                         window, sm_scale, softcap);
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return dispatch(kDq, kind, head_dim, p, stream);
}

extern "C" int flash_attention_backward_dkdv(
    int kind, const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int batch, int seq, int heads, int kv_heads, int head_dim, int causal,
    int window, float sm_scale, float softcap, void* stream) {
  Params p = make_params(q, k, v, mask, batch, seq, heads, kv_heads, causal,
                         window, sm_scale, softcap);
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return dispatch(kDkdv, kind, head_dim, p, stream);
}
