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
// and loops over the tiles it reduces over:
// - forward and dq: one block per (q tile of 64 rows, head, example), a
//   loop over the live key tiles of 64 (`_tile_live`: causal and window
//   tiles that cannot hold an allowed pair are skipped);
// - dk/dv: one block per (key tile of 64, kv head, example), a loop over
//   every q head of its group and every live q tile, so the GQA sum lands in
//   the block's own accumulators: deterministic, no atomics.
// Four warps per block; each warp owns 16 rows of the block's output tile
// (64 x 64 tiles).
// - bf16 (the training path): every product runs on the tensor cores with
//   mma.sync m16n8k16 (bf16 in, f32 accumulate). Operands are loaded from
//   shared memory with ldmatrix; Q (and dO in dq) fragments stay in
//   registers; P and dS stay in registers and feed the second product as
//   its A operand, rounded to bf16 first, which is the cast the TPU kernels
//   make (p.astype(v.dtype) :216, ds.astype(k.dtype) :368); the next key
//   (or q) tile is copied with cp.async into a second shared-memory stage
//   while the current one is computed.
// - f32 (the tests' oracle runs): the same tiles and loops, each product
//   computed in f32 FMAs from shared memory in the mma fragment layout, P
//   and dS passed through shared memory.
// Both types run one copy of the per-element steps (logit2, fwd_softmax,
// dq_ds, dkdv_pds: scale, softcap, masking, online softmax, dS) and of
// the epilogues, so the f32 check covers the arithmetic the bf16 kernels
// train with; the types differ only in operand movement and products.
//
// Masking: a masked probability is set to 0 explicitly (:213, :340), so a
// row with no allowed key ends with l == 0 and writes out 0 and
// lse = -1e30; its dq is 0 and it adds nothing to dk/dv. The softcap
// derivative 1 - tanh^2 uses the uncapped logit (:333-336).
//
// Bound on this card: at GPT-2 training shapes (B 8, S 1024, H 12, D 64,
// bf16, causal) the forward does 12.9 GFLOP over 51 MB, about 250 flop per
// byte, just under the H100's ~295 flop/byte ridge: bytes and tensor-core
// operations bound it about equally (15 us either way); dq and dk/dv do
// more products on the same bytes and are operation-bound. These kernels use
// mma.sync from shared memory; wgmma, TMA and warp specialisation are the
// levers left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Flags of the current key tile: 1 when the key exists and the key mask
// keeps it.
__device__ __forceinline__ void load_key_flags(uint8_t* flags,
                                               const Params& p, int b,
                                               int k0, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int col = k0 + i;
    flags[i] = col < p.seq &&
               (p.mask == nullptr || p.mask[(size_t)b * p.seq + col] != 0);
  }
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

// A raw score in log2 units: sm_scale, then the softcap; *dcap gets the
// softcap derivative (1 without a cap).
__device__ __forceinline__ float logit2(const Params& p, float raw,
                                        float* dcap) {
  if (p.softcap > 0.f) {
    const float th = tanhf(raw * p.sm_scale / p.softcap);
    *dcap = 1.f - th * th;
    return p.softcap * th * kLog2e;
  }
  *dcap = 1.f;
  return raw * (p.sm_scale * kLog2e);
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

// dS for a 16 x 16 block of (q row, key) pairs held as two 16 x 8
// accumulator tiles (s: raw scores in, dS out; dp: dO V^T). This lane's
// rows are row0 and row0 + 8, its keys k0 + c0 + u * 8 + t + (i & 1);
// lse2 in log2 units.
template <bool kFull>
__device__ __forceinline__ void dq_ds(const Params& p, float (&s)[2][4],
                                      const float (&dp)[2][4],
                                      const uint8_t* fl, int row0, int k0,
                                      int c0, int t, const float* lse2,
                                      const float* delta) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1;
      float dcap;
      const float x = logit2(p, s[u][i], &dcap);
      bool allowed = true;
      if (!kFull) {
        const int c = c0 + u * 8 + t + (i & 1);
        allowed = fl[c] && band_ok(p, row0 + j * 8, k0 + c);
      }
      const float pv = allowed ? exp2f(x - lse2[j]) : 0.f;
      s[u][i] = pv * (dp[u][i] - delta[j]) * p.sm_scale * dcap;
    }
  }
}

// P^T and dS^T for a (16 keys) x (16 q rows) block of dk/dv: s (raw
// scores) becomes P^T, dp (dP^T) becomes dS^T. Keys key0, key0 + 8; q rows
// q0 + r, r = r0 + u * 8 + t + (i & 1); lse and delta per q row of the
// tile, lse in log2 units.
template <bool kFull>
__device__ __forceinline__ void dkdv_pds(const Params& p, float (&s)[2][4],
                                         float (&dp)[2][4],
                                         const uint8_t* fl, int key0,
                                         int k0, int q0, int r0, int t,
                                         const float* lse2_s,
                                         const float* delta_s) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + (i >> 1) * 8;
      const int r = r0 + u * 8 + t + (i & 1);
      float dcap;
      const float x = logit2(p, s[u][i], &dcap);
      bool allowed = true;
      if (!kFull) {
        const int row = q0 + r;
        allowed = row < p.seq && fl[key - k0] && band_ok(p, row, key);
      }
      const float pv = allowed ? exp2f(x - lse2_s[r]) : 0.f;
      dp[u][i] = pv * (dp[u][i] - delta_s[r]) * p.sm_scale * dcap;
      s[u][i] = pv;
    }
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
      if (full)
        dq_ds<true>(p, s, dp, flags, row0, k0, n * 8, t, lse, delta);
      else
        dq_ds<false>(p, s, dp, flags, row0, k0, n * 8, t, lse, delta);
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
        if (full)
          dkdv_pds<true>(p, s, dp, flags, key0, k0, q0, n * 8, t, lse_s,
                         delta_s);
        else
          dkdv_pds<false>(p, s, dp, flags, key0, k0, q0, n * 8, t, lse_s,
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

constexpr int kTileQ = 64;  // q rows per inner tile of the bf16 dk/dv

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

template <int D>
size_t dq_smem_bf16() {
  return sizeof(bf16) * (size_t)(2 * kBlockM + 4 * kBlockN) * (D + 8) +
         2 * kBlockN;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_bf16(Params p) {
  constexpr int LD = D + 8, DT = D / 8, KT = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBlockM][LD]
  bf16* do_s = q_s + kBlockM * LD;            // [kBlockM][LD]
  bf16* kv_s = do_s + kBlockM * LD;  // [stage][K | V][kBlockN][LD]
  uint8_t* flags = reinterpret_cast<uint8_t*>(kv_s + 4 * kBlockN * LD);

  const int S = p.seq;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const size_t qs = (size_t)p.heads * D, ks = (size_t)p.kv_heads * D;
  const size_t qoff = ((size_t)b * S + q0) * qs + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + (size_t)b * S * ks + hk * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + (size_t)b * S * ks + hk * D;

  load_tile_async<D>(q_s, static_cast<const bf16*>(p.q) + qoff, qs, kBlockM,
                     S - q0);
  load_tile_async<D>(do_s, static_cast<const bf16*>(p.dout) + qoff, qs,
                     kBlockM, S - q0);
  cp_async_commit();
  int k0 = first_live_key(p, q0, kBlockM);
  if (k0 < S) {
    load_tile_async<D>(kv_s, kg + k0 * ks, ks, kBlockN, S - k0);
    load_tile_async<D>(kv_s + kBlockN * LD, vg + k0 * ks, ks, kBlockN,
                       S - k0);
    load_key_flags(flags, p, b, k0, kBlockN);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float lse[2], delta[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + j * 8;
    const size_t idx = ((size_t)b * p.heads + h) * S + row;
    lse[j] = row < S ? p.lse_in[idx] * kLog2e : 0.f;
    delta[j] = row < S ? p.delta[idx] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KT][4], dof[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    ldsm_x4(qf[kk], q_s + warp * 16 * LD + kk * 16 + a_off(LD));
    ldsm_x4(dof[kk], do_s + warp * 16 * LD + kk * 16 + a_off(LD));
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

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
    __syncthreads();
    const bf16* k_s = kv_s + stage * 2 * kBlockN * LD;
    const bf16* v_s = k_s + kBlockN * LD;
    const uint8_t* fl = flags + stage * kBlockN;
    const bool full = tile_full(p, q0, kBlockM, k0, kBlockN);

    // 16 keys at a time: S and dP for them, dS, then dQ += dS K.
#pragma unroll
    for (int n = 0; n < kBlockN / 8; n += 2) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t bb[4];
        ldsm_x4(bb, k_s + n * 8 * LD + kk * 16 + bt_off(LD));
        mma_bf16(s[0], qf[kk], bb);
        mma_bf16(s[1], qf[kk], bb + 2);
        ldsm_x4(bb, v_s + n * 8 * LD + kk * 16 + bt_off(LD));
        mma_bf16(dp[0], dof[kk], bb);
        mma_bf16(dp[1], dof[kk], bb + 2);
      }
      if (full)
        dq_ds<true>(p, s, dp, fl, row0, k0, n * 8, t, lse, delta);
      else
        dq_ds<false>(p, s, dp, fl, row0, k0, n * 8, t, lse, delta);
      uint32_t a[4];
      acc_to_a(a, s[0], s[1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, k_s + n * 8 * LD + d * 8 + bn_off(LD));
        mma_bf16(acc[d], a, bb);
        mma_bf16(acc[d + 1], a, bb + 2);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  store_rows<bf16, DT>(static_cast<bf16*>(p.dq) + (size_t)b * S * qs + h * D,
                       qs, row0, S, acc, t);
}

template <int D>
size_t dkdv_smem_bf16() {
  return sizeof(bf16) * (size_t)(2 * kBlockN + 4 * kTileQ) * (D + 8) +
         sizeof(float) * 4 * kTileQ + kBlockN;
}

// Loads the (q head, q tile) of linear index `it` into shared-memory stage
// `st`: Q and dO with cp.async, lse and delta with plain loads.
template <int D>
__device__ __forceinline__ void dkdv_load(const Params& p, int b, int hk,
                                          int it, int nq, int q_lo,
                                          bf16* qdo, float* rows) {
  constexpr int LD = D + 8;
  const int group = p.heads / p.kv_heads;
  const int h = hk * group + it / nq;
  const int q0 = q_lo + (it % nq) * kTileQ;
  const int S = p.seq;
  const size_t qs = (size_t)p.heads * D;
  const size_t off = ((size_t)b * S + q0) * qs + h * D;
  load_tile_async<D>(qdo, static_cast<const bf16*>(p.q) + off, qs, kTileQ,
                     S - q0);
  load_tile_async<D>(qdo + kTileQ * LD, static_cast<const bf16*>(p.dout) + off,
                     qs, kTileQ, S - q0);
  const size_t r0 = ((size_t)b * p.heads + h) * S + q0;
  for (int i = threadIdx.x; i < kTileQ; i += kThreads) {
    const bool ok = q0 + i < S;
    rows[i] = ok ? p.lse_in[r0 + i] * kLog2e : 0.f;
    rows[kTileQ + i] = ok ? p.delta[r0 + i] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkdv_bf16(Params p) {
  constexpr int LD = D + 8, DT = D / 8, KT = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kBlockN][LD]
  bf16* v_s = k_s + kBlockN * LD;             // [kBlockN][LD]
  bf16* qdo_s = v_s + kBlockN * LD;  // [stage][Q | dO][kTileQ][LD]
  float* rows_s = reinterpret_cast<float*>(qdo_s + 4 * kTileQ * LD);
  // rows_s: [stage][lse | delta][kTileQ]
  uint8_t* flags = reinterpret_cast<uint8_t*>(rows_s + 4 * kTileQ);

  const int S = p.seq;
  const int k0 = blockIdx.x * kBlockN, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const size_t ks = (size_t)p.kv_heads * D;
  const size_t koff = ((size_t)b * S + k0) * ks + hk * D;
  load_tile_async<D>(k_s, static_cast<const bf16*>(p.k) + koff, ks, kBlockN,
                     S - k0);
  load_tile_async<D>(v_s, static_cast<const bf16*>(p.v) + koff, ks, kBlockN,
                     S - k0);
  load_key_flags(flags, p, b, k0, kBlockN);

  // The live q tiles form one run [q_lo, q_hi) (causal and window bands
  // are contiguous); every q head of the group walks the same run.
  int q_lo = 0;
  while (q_lo < S && !tile_live(p, q_lo, kTileQ, k0, kBlockN))
    q_lo += kTileQ;
  int q_hi = q_lo;
  while (q_hi < S && tile_live(p, q_hi, kTileQ, k0, kBlockN)) q_hi += kTileQ;
  const int nq = (q_hi - q_lo) / kTileQ;
  const int total = group * nq;
  if (total > 0)
    dkdv_load<D>(p, b, hk, 0, nq, q_lo, qdo_s, rows_s);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  const bf16* kw = k_s + warp * 16 * LD + a_off(LD);
  const bf16* vw = v_s + warp * 16 * LD + a_off(LD);

  for (int it = 0, stage = 0; it < total; ++it, stage ^= 1) {
    if (it + 1 < total)
      dkdv_load<D>(p, b, hk, it + 1, nq, q_lo,
                   qdo_s + (stage ^ 1) * 2 * kTileQ * LD,
                   rows_s + (stage ^ 1) * 2 * kTileQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this q tile (and, first time, K and V) is visible
    const int q0 = q_lo + (it % nq) * kTileQ;
    const bf16* q_s = qdo_s + stage * 2 * kTileQ * LD;
    const bf16* do_s = q_s + kTileQ * LD;
    const float* lse_s = rows_s + stage * 2 * kTileQ;  // log2 units
    const float* delta_s = lse_s + kTileQ;
    const bool full = tile_full(p, q0, kTileQ, k0, kBlockN);

    // 16 q rows at a time: S^T = K Q^T and dP^T = V dO^T for this warp's
    // 16 keys, then dV += P^T dO and dK += dS^T Q.
#pragma unroll
    for (int n = 0; n < kTileQ / 8; n += 2) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t af[4], bb[4];
        ldsm_x4(af, kw + kk * 16);
        ldsm_x4(bb, q_s + n * 8 * LD + kk * 16 + bt_off(LD));
        mma_bf16(s[0], af, bb);
        mma_bf16(s[1], af, bb + 2);
        ldsm_x4(af, vw + kk * 16);
        ldsm_x4(bb, do_s + n * 8 * LD + kk * 16 + bt_off(LD));
        mma_bf16(dp[0], af, bb);
        mma_bf16(dp[1], af, bb + 2);
      }
      if (full)
        dkdv_pds<true>(p, s, dp, flags, key0, k0, q0, n * 8, t, lse_s,
                       delta_s);
      else
        dkdv_pds<false>(p, s, dp, flags, key0, k0, q0, n * 8, t, lse_s,
                        delta_s);
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, s[0], s[1]);
      acc_to_a(dsa, dp[0], dp[1]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, do_s + n * 8 * LD + d * 8 + bn_off(LD));
        mma_bf16(dv[d], pa, bb);
        mma_bf16(dv[d + 1], pa, bb + 2);
        ldsm_x4_t(bb, q_s + n * 8 * LD + d * 8 + bn_off(LD));
        mma_bf16(dk[d], dsa, bb);
        mma_bf16(dk[d + 1], dsa, bb + 2);
      }
    }
    __syncthreads();  // every read of this stage is done before its refill
  }
  cp_async_wait<0>();

  const size_t kvoff = (size_t)b * S * ks + hk * D;
  store_rows<bf16, DT>(static_cast<bf16*>(p.dk) + kvoff, ks, key0, S, dk, t);
  store_rows<bf16, DT>(static_cast<bf16*>(p.dv) + kvoff, ks, key0, S, dv, t);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

enum Which { kForward = 0, kDq = 1, kDkdv = 2 };

// T = float takes the f32 kernels, bf16 the register-fragment kernels.
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
  } else if (which == kDq) {
    kernel = kBf16 ? flash_dq_bf16<D> : flash_dq_kernel<D>;
    smem = kBf16 ? dq_smem_bf16<D>() : dq_smem<D>();
    grid = dim3((p.seq + kBlockM - 1) / kBlockM, p.heads, p.batch);
  } else {
    kernel = kBf16 ? flash_dkdv_bf16<D> : flash_dkdv_kernel<D>;
    smem = kBf16 ? dkdv_smem_bf16<D>() : dkdv_smem<D>();
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
