// The flash-attention kernels' shared part: Params, the causal/window and
// key-mask tests, the per-element steps (scale, softcap, masking, online
// softmax, dS) and the epilogues, and the plain C interface. Included by
// flash_attention.cu (the bf16 kernels) and flash_attention_f32.cu (the
// f32 kernels), which are built as two libraries in parallel; each defines
// dispatch() for its own type. See flash_attention.cu for the design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 64;  // q rows per block (forward, dq): 16 per warp
constexpr int kBlockN = 64;  // keys per tile (forward, dq) / per block (dkdv)
constexpr int kMaxHeadDim = 32767;  // the widest D Params.dim holds

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
  int window;
  int16_t causal;
  int16_t dim;  // head_dim D: the row length of each [., ., H, D]
  float sm_scale, softcap;
};
// Every kernel takes Params by value. At 136 bytes (one more int) all
// three bf16 kernels ran 5-17 % slower on the card than at 128 (chip_smoke
// --flash-times, in turns on one card), so `causal` and `dim` share a
// word.
static_assert(sizeof(Params) == 128, "Params must stay 128 bytes");

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
// 2^x in one MUFU instruction (results below 2^-126 flush to 0): the
// probabilities and the forward's rescale factors, whose exponent is at
// most 0 up to rounding.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax update of one 16-row score tile of NT x 8 keys (this
// lane's rows row0, row0 + 8): s becomes P, m/l (log2 units) advance, acc
// is rescaled. kFused (a full tile without a softcap, sm_scale > 0): the
// row max is taken over the raw scores and the scale is folded into the
// exponent's FMA, one instruction fewer per score.
template <bool kFull, bool kCap, bool kFused = false, int NT, int DT>
__device__ __forceinline__ void fwd_softmax(const Params& p,
                                            float (&s)[NT][4], float* m,
                                            float* l, float (&acc)[DT][4],
                                            const uint8_t* fl, int row0,
                                            int k0, int t) {
  const float c2 = p.sm_scale * kLog2e;
  float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kFused) {
        mcur[i >> 1] = fmaxf(mcur[i >> 1], s[n][i]);
        continue;
      }
      float dcap;
      float x = logit2<kCap>(p, s[n][i], &dcap);
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
    const float mq = quad_max(mcur[j]);
    mnext[j] = fmaxf(m[j], kFused ? mq * c2 : mq);
    alpha[j] = ex2(m[j] - mnext[j]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1;
      // Masked scores are exactly kNegInf; their P is an explicit 0.
      const float pv = kFused ? ex2(fmaf(s[n][i], c2, -mnext[j]))
                       : (kFull || s[n][i] != kNegInf)
                           ? ex2(s[n][i] - mnext[j]) : 0.f;
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
// scores) becomes P^T, dp (dP^T) becomes dS^T (P^T alone without kDs, and
// dp is not read). Keys key0, key0 + 8 (fl holds the flags of keys k0,
// k0 + 1, ...); q rows q0 + r, r = r0 + u * 8 + t + (i & 1); lse (log2
// units) and delta per q row of the tile, 8-byte aligned (read in pairs).
template <bool kFull, bool kCap, bool kDs, int NT>
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
      if (kDs)
        dp[u][i] = pv * (dp[u][i] - ((i & 1) ? delta.y : delta.x)) *
                   p.sm_scale * dcap;
      s[u][i] = pv;
    }
  }
}

// fwd_softmax, dq_ds and dkdv_pds specialised per tile: on `full`
// (tile_full) and on the softcap, so that neither is tested per score.
template <int NT, int DT>
__device__ __forceinline__ void fwd_softmax_tile(const Params& p, bool full,
                                                 float (&s)[NT][4], float* m,
                                                 float* l,
                                                 float (&acc)[DT][4],
                                                 const uint8_t* fl, int row0,
                                                 int k0, int t) {
  if (p.softcap > 0.f) {
    if (full)
      fwd_softmax<true, true>(p, s, m, l, acc, fl, row0, k0, t);
    else
      fwd_softmax<false, true>(p, s, m, l, acc, fl, row0, k0, t);
  } else if (full && p.sm_scale > 0.f) {
    fwd_softmax<true, false, true>(p, s, m, l, acc, fl, row0, k0, t);
  } else if (full) {
    fwd_softmax<true, false>(p, s, m, l, acc, fl, row0, k0, t);
  } else {
    fwd_softmax<false, false>(p, s, m, l, acc, fl, row0, k0, t);
  }
}
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
template <bool kDs = true, int NT>
__device__ __forceinline__ void dkdv_pds_tile(const Params& p, bool full,
                                              float (&s)[NT][4],
                                              float (&dp)[NT][4],
                                              const uint8_t* fl, int key0,
                                              int k0, int q0, int r0, int t,
                                              const float* lse2_s,
                                              const float* delta_s) {
  if (p.softcap > 0.f) {
    if (full)
      dkdv_pds<true, true, kDs>(p, s, dp, fl, key0, k0, q0, r0, t, lse2_s,
                                delta_s);
    else
      dkdv_pds<false, true, kDs>(p, s, dp, fl, key0, k0, q0, r0, t, lse2_s,
                                 delta_s);
  } else if (full) {
    dkdv_pds<true, false, kDs>(p, s, dp, fl, key0, k0, q0, r0, t, lse2_s,
                               delta_s);
  } else {
    dkdv_pds<false, false, kDs>(p, s, dp, fl, key0, k0, q0, r0, t, lse2_s,
                                delta_s);
  }
}

// This lane's share of a 16-row output tile in the m16n8 accumulator
// layout: rows row0 and row0 + 8 of `base` (row stride `stride`; rows
// below 0 or at or past `rows` are not written), columns d * 8 + t and
// + 1 below `cols` (the accumulators past head_dim hold the zeros of the
// operands' zero-filled columns and are not written; cols is a multiple
// of 8, so a pair is wholly in or out), row row0 multiplied by mul0 and
// row row0 + 8 by mul1.
__device__ __forceinline__ void store2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}
__device__ __forceinline__ void store2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack2(lo, hi);
}
template <typename T, int DT>
__device__ __forceinline__ void store_rows(T* base, size_t stride, int row0,
                                           int rows, int cols,
                                           const float (&acc)[DT][4], int t,
                                           float mul0 = 1.f,
                                           float mul1 = 1.f) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + j * 8;
    if (row < 0 || row >= rows) continue;
    T* r = base + (size_t)row * stride;
    const float mul = j ? mul1 : mul0;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      if (d * 8 + t < cols)
        store2(r + d * 8 + t, acc[d][j * 2] * mul, acc[d][j * 2 + 1] * mul);
  }
}

// The forward's epilogue: out = acc / l (0 where l == 0) into columns
// col0 .. col0 + 8 DT of the row (those below head_dim), and, from the
// quad's first lane, lse = m + log(l) (kNegInf where l == 0), m and l in
// log2 units.
template <typename T, int DT>
__device__ __forceinline__ void fwd_store(const Params& p, int b, int h,
                                          int row0, const float (&acc)[DT][4],
                                          const float* m, const float* l,
                                          int lane, int col0 = 0) {
  const int S = p.seq;
  const size_t qs = (size_t)p.heads * p.dim;
  store_rows<T, DT>(static_cast<T*>(p.out) + (size_t)b * S * qs +
                        (size_t)h * p.dim + col0,
                    qs, row0, S, p.dim - col0, acc, (lane & 3) * 2,
                    l[0] == 0.f ? 0.f : 1.f / l[0],
                    l[1] == 0.f ? 0.f : 1.f / l[1]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + j * 8;
    if (row >= 0 && row < S && (lane & 3) == 0)
      p.lse_out[((size_t)b * p.heads + h) * S + row] =
          l[j] == 0.f ? kNegInf : (m[j] + log2f(l[j])) * kLn2;
  }
}

// The template width a head_dim runs at: the next of 64, 128 and 256. A
// head_dim below it is read as zero-filled columns past D (TMA fills them
// in the bf16 kernels, load_tile in the f32 ones), which leave S = Q K^T
// and dP = dO V^T exact and give the outputs zero columns there, which
// are not written. D must be a multiple of 8 (the 16-byte rows TMA and
// the vector loads take); 0 for any other D.
inline int template_width(int head_dim) {
  if (head_dim <= 0 || head_dim % 8 != 0 || head_dim > 256) return 0;
  return head_dim <= 64 ? 64 : head_dim <= 128 ? 128 : 256;
}

enum Which { kForward = 0, kDq = 1, kDkdv = 2 };

// Raises `kernel`'s dynamic shared-memory limit to `bytes` once per device
// (the attribute holds for the process), so that later launches skip the
// call; `done` is the kernel's own record (bit d: set on device d).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done & bit) return cudaSuccess;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  done |= bit;
  return cudaSuccess;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* mask, int batch, int seq, int heads,
                   int kv_heads, int head_dim, int causal, int window,
                   float sm_scale, float softcap) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.batch = batch;
  p.seq = seq;
  p.heads = heads;
  p.kv_heads = kv_heads;
  // Out of range (every dispatch refuses -1) before it is narrowed; D up
  // to 256 runs the narrow kernels, above it flash_attention_wide.cu's.
  p.dim = static_cast<int16_t>(head_dim > 0 && head_dim <= kMaxHeadDim
                                   ? head_dim
                                   : -1);
  p.causal = static_cast<int16_t>(causal != 0);
  p.window = window;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  return p;
}

// The kernels of the including source: kind 0 (f32) or 1 (bf16), at the
// template width of p.dim.
cudaError_t dispatch(int which, int kind, const Params& p, void* stream);

}  // namespace


// kind: 0 = f32, 1 = bf16; head_dim a multiple of 8 (up to 256 run at the
// template width of template_width, above it by flash_attention_wide.cu). mask may be null. Each function
// returns the launch's cudaError_t (0 = ok); an unknown kind or head_dim,
// or heads not a multiple of kv_heads, gives cudaErrorInvalidValue.
extern "C" int flash_attention_forward(
    int kind, const void* q, const void* k, const void* v, const void* mask,
    void* out, void* lse, int batch, int seq, int heads, int kv_heads,
    int head_dim, int causal, int window, float sm_scale, float softcap,
    void* stream) {
  Params p = make_params(q, k, v, mask, batch, seq, heads, kv_heads,
                         head_dim, causal, window, sm_scale, softcap);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return dispatch(kForward, kind, p, stream);
}

extern "C" int flash_attention_backward_dq(
    int kind, const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dq,
    int batch, int seq, int heads, int kv_heads, int head_dim, int causal,
    int window, float sm_scale, float softcap, void* stream) {
  Params p = make_params(q, k, v, mask, batch, seq, heads, kv_heads,
                         head_dim, causal, window, sm_scale, softcap);
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return dispatch(kDq, kind, p, stream);
}

extern "C" int flash_attention_backward_dkdv(
    int kind, const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int batch, int seq, int heads, int kv_heads, int head_dim, int causal,
    int window, float sm_scale, float softcap, void* stream) {
  Params p = make_params(q, k, v, mask, batch, seq, heads, kv_heads,
                         head_dim, causal, window, sm_scale, softcap);
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return dispatch(kDkdv, kind, p, stream);
}
