// The decode block's small kernels for Hopper (sm_90a), with a plain C
// interface (bound from Python with ctypes: cloud_tpu_torch/ops/decode_block.py).
//
// None of them replaces a Pallas kernel: on the TPU, XLA fuses these steps of
// the decode forward (cloud_tpu/models/transformer.py: the LayerNorms at :307
// and :322 with the residual adds, the dense decode attention `_decode_attention`
// at :86, and the int8 page write of the paged decode). On the card each of
// them was a chain of small PyTorch launches, and the serving tick and the
// prefill windows are CUDA graphs of a few hundred such launches whose cost is
// per launch, not per byte.
//
// add_layer_norm: h = x + r (f32 residual stream x, r in the compute dtype or
//   f32, added in f32), y = LayerNorm(h) * w + b with f32 statistics, one cast
//   to the output dtype. One warp per row, four rows a block; the row stays
//   in the warp's registers: the add (and h's store) and the sum, the
//   squared deviations, then y.
// page_gather: a prefill's dense cache seeded from the pool (the prefix
//   hit's gather, JAX's `_gather_impl` in cloud_tpu/serving/engine.py:852):
//   the first plen positions from the pages of a page vector, int8 pages
//   dequantized by their per-page per-head scales, zeros past plen; one
//   pass, bit for bit the plain version's values.
// window_attention: the dense decode attention of a window of W queries of
//   one example over its cache of L positions: f32 logits of the compute-dtype
//   q and K (f32 accumulation), plus an additive mask (0 or -1e30), an f32
//   softmax, and its product with V (f32 accumulation), rounded to the
//   compute dtype. The weights stay in f32 (the plain version rounds them
//   to the compute dtype first). Split over the keys, flash-decoding style:
//   one block per (head, four query rows, 128 keys), each K and V row
//   loaded once for four queries; the last block of a (head, rows) merges
//   the splits' (max, sum, output).
// int8_page_write: one decode position of every slot written into int8 pages
//   with a per-page per-head scale: the scale grows to cover the token
//   (new = max(old, amax / 127)), the page's block of that head is rescaled by
//   old / new when the scale grew, and the token is quantized at new. One block
//   per (K or V, slot, head), one thread per feature. Every operation is the
//   plain version's f32 operation (round half to even, clamp to +-127), so the
//   pages and scales equal the plain version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements, loaded as 16 bytes (bf16) or 2 x 16 bytes (f32).
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  int4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<int4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A block-wide sum or max that every thread receives (blockDim.x a multiple
// of 32); `scratch` holds 32 floats of shared memory.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < warps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

// -- add_layer_norm ---------------------------------------------------------

constexpr int kNormRows = 4;  // one warp per row
constexpr int kNormThreads = kNormRows * 32;

// kChunks: 8-element chunks a lane holds (features <= kChunks * 256); the
// row stays in registers from the load to the store.
template <typename Tr, typename Ty, bool kRes, int kChunks>
__global__ void __launch_bounds__(kNormThreads)
    add_layer_norm_kernel(const float* __restrict__ x,
                          const Tr* __restrict__ r,
                          const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ h,
                          Ty* __restrict__ y, int rows, int features,
                          float eps) {
  const int row = blockIdx.x * kNormRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * features;
  // The row, its residual, the scale and the shift all loaded at once:
  // one round trip to memory.
  float v[kChunks][8], ww[kChunks][8], bb[kChunks][8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (j * 32 + lane) * 8;
    if (c < features) {
      load8(x + base + c, v[j]);
      load8(w + c, ww[j]);
      load8(b + c, bb[j]);
      if (kRes) {
        float a[8];
        load8(r + base + c, a);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[j][i] += a[i];
        store8(h + base + c, v[j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += v[j][i];
    }
  }
  const float mean = warp_sum(sum) / (float)features;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if ((j * 32 + lane) * 8 < features) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = v[j][i] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)features + eps);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (j * 32 + lane) * 8;
    if (c < features) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[j][i] = (v[j][i] - mean) * rstd * ww[j][i] + bb[j][i];
      store8(y + base + c, v[j]);
    }
  }
}

template <typename Tr, typename Ty, int kChunks>
cudaError_t launch_norm_c(const void* x, const void* r, const void* w,
                          const void* b, void* h, void* y, int rows,
                          int features, float eps, cudaStream_t s) {
  const dim3 grid((rows + kNormRows - 1) / kNormRows);
  if (r != nullptr)
    add_layer_norm_kernel<Tr, Ty, true, kChunks><<<grid, kNormThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const Tr*>(r),
        static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(h), static_cast<Ty*>(y), rows, features, eps);
  else
    add_layer_norm_kernel<Tr, Ty, false, kChunks><<<grid, kNormThreads, 0, s>>>(
        static_cast<const float*>(x), nullptr, static_cast<const float*>(w),
        static_cast<const float*>(b), nullptr, static_cast<Ty*>(y), rows,
        features, eps);
  return cudaGetLastError();
}

template <typename Tr, typename Ty>
cudaError_t launch_norm(const void* x, const void* r, const void* w,
                        const void* b, void* h, void* y, int rows,
                        int features, float eps, cudaStream_t s) {
  if (features <= 1024)
    return launch_norm_c<Tr, Ty, 4>(x, r, w, b, h, y, rows, features, eps, s);
  if (features <= 2048)
    return launch_norm_c<Tr, Ty, 8>(x, r, w, b, h, y, rows, features, eps, s);
  if (features <= 4096)
    return launch_norm_c<Tr, Ty, 16>(x, r, w, b, h, y, rows, features, eps,
                                     s);
  return cudaErrorInvalidValue;
}

// -- page_gather ------------------------------------------------------------

// A prefill's dense cache from the pool: out[lk, l, :] = page
// gvec[l / P] at offset l % P of layer-and-K/V lk, dequantized by its
// per-page per-head scale (int8 pages: q * scale in f32, then cast), for
// l < plen, and zeros past it. One thread per 8 features; a 16-byte (bf16)
// or 8-byte (int8) load and a 16-byte store.
template <typename Tp, typename To>
__global__ void page_gather_kernel(const Tp* __restrict__ pages,
                                   const float* __restrict__ scales,
                                   const int64_t* __restrict__ gvec,
                                   const int64_t* __restrict__ plen,
                                   To* __restrict__ out, long long chunks,
                                   int num_pages, int page_size, int length,
                                   int heads, int head_dim) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const int row8 = heads * head_dim / 8;            // chunks a position
  const int c = (int)(i % row8);
  const long long pos = i / row8;                   // lk * length + l
  const int l = (int)(pos % length);
  const long long lk = pos / length;
  float vals[8];
  if (l < *plen) {
    const long long page = gvec[l / page_size];
    const long long src =
        ((lk * num_pages + page) * page_size + l % page_size) *
            (long long)heads * head_dim + (long long)c * 8;
    if (scales != nullptr) {
      const int head = c * 8 / head_dim;
      const float sc = scales[(lk * num_pages + page) * heads + head];
      const int2 raw = *reinterpret_cast<const int2*>(
          reinterpret_cast<const int8_t*>(pages) + src);
      const int8_t* q8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) vals[k] = (float)q8[k] * sc;
    } else {
      load8(reinterpret_cast<const To*>(pages) + src, vals);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) vals[k] = 0.f;
  }
  store8(out + i * 8, vals);
}

// -- window_attention -------------------------------------------------------

constexpr int kAttnThreads = 128;  // one key a thread in a split
constexpr int kAttnRows = 4;       // query rows a block, sharing K / V loads
constexpr int kAttnSplit = 128;    // keys a block

// One block per (head, group of kAttnRows query rows, split of kAttnSplit
// keys), so that even a 4-token window spreads over L / 128 x heads blocks.
// Phase 1: a thread per key loads the key's row once (D / 8 16-byte loads,
// all in flight while the queries go to shared memory) and forms the logits
// of every row of the group; shuffles give each warp's max and sum, one
// exchange the split's max m and sum l of exp(s - m). Phase 2:
// D / 8 lanes cover a V row (one 16-byte load each), the key groups stride
// over the split, shuffles then shared memory sum them: the split's
// unnormalized output o. Each block writes (m, l, o) to `part`; the last
// block of a (head, group) to finish (a counter, reset by that block)
// merges the splits: out = sum_s o_s e^(m_s - M) / sum_s l_s e^(m_s - M).
template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
    window_attention_kernel(const T* __restrict__ q, long long q_row,
                            const T* __restrict__ k, const T* __restrict__ v,
                            long long kv_row, const float* __restrict__ bias,
                            T* __restrict__ out, float* __restrict__ part,
                            unsigned int* __restrict__ counters, int rows,
                            int length, int heads, int splits, float scale) {
  constexpr int R = kAttnRows;
  constexpr int kLanes = D / 8;                   // lanes over a V row
  constexpr int kGroups = kAttnThreads / kLanes;  // key groups, phase 2
  constexpr int kWarps = kAttnThreads / 32;
  constexpr int kPart = 2 + D;                    // m, l, o of a row
  __shared__ float qs[R * D];
  __shared__ float p[R * kAttnSplit];
  __shared__ float warp_ml[2 * kWarps * R];        // each warp's (m, l)
  __shared__ float acc_w[kWarps * R * D];
  __shared__ bool last;
  const int head = blockIdx.x, group = blockIdx.y, split = blockIdx.z;
  const int row0 = group * R, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nr = min(R, rows - row0);
  const int l0 = split * kAttnSplit;
  const int nl = min(kAttnSplit, length - l0);
  const bool has = tid < nl;
  // The key's row, in flight while the queries go to shared memory.
  float kf[D];
  if (has) {
    const T* kr = k + (l0 + tid) * kv_row + (long long)head * D;
#pragma unroll
    for (int c = 0; c < D; c += 8) load8(kr + c, kf + c);
  }
  for (int i = tid; i < R * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    qs[i] = r < nr ? to_f(q[(row0 + r) * q_row + (long long)head * D + d])
                   : 0.f;
  }
  __syncthreads();

  // Logits; each warp's max and sum of exp(s - max) by shuffles.
  float m[R], l[R], mw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = -INFINITY;
    if (has) {
      float part4[4] = {0.f, 0.f, 0.f, 0.f};  // four short chains
#pragma unroll
      for (int d = 0; d < D; ++d)
        part4[d & 3] = fmaf(qs[r * D + d], kf[d], part4[d & 3]);
      const float dot = (part4[0] + part4[1]) + (part4[2] + part4[3]);
      s = r < nr
              ? fmaf(dot, scale, bias[(size_t)(row0 + r) * length + l0 + tid])
              : 0.f;
    }
    mw[r] = warp_max(s);
    const float e = has ? expf(s - mw[r]) : 0.f;
    p[r * kAttnSplit + tid] = e;
    const float lw = warp_sum(e);
    if (lane == 0) {
      warp_ml[(warp * R + r) * 2] = mw[r];
      warp_ml[(warp * R + r) * 2 + 1] = lw;
    }
  }
  __syncthreads();
  // The split's max and sum; each thread rescales its own key's weights.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m[r] = fmaxf(m[r], warp_ml[(w * R + r) * 2]);
    l[r] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wm = warp_ml[(w * R + r) * 2];
      if (wm != -INFINITY)
        l[r] = fmaf(warp_ml[(w * R + r) * 2 + 1], expf(wm - m[r]), l[r]);
    }
    if (has) p[r * kAttnSplit + tid] *= expf(mw[r] - m[r]);
  }
  __syncthreads();

  const int chunk = tid % kLanes, kgroup = tid / kLanes;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  const T* vc = v + (long long)l0 * kv_row + (long long)head * D + chunk * 8;
#pragma unroll 4
  for (int j = kgroup; j < nl; j += kGroups) {
    float vf[8];
    load8(vc + j * kv_row, vf);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w = p[r * kAttnSplit + j];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(w, vf[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], o);
  if (lane < kLanes) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc_w[(warp * R + r) * D + chunk * 8 + i] = acc[r][i];
  }
  __syncthreads();
  // This split's (m, l, o) of each row: part[((head * groups + group) *
  // splits + split) * R + r][kPart].
  const size_t slot = ((size_t)head * gridDim.y + group) * splits;
  float* mine = part + (slot + split) * R * kPart;
  for (int i = tid; i < R * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += acc_w[(w * R + r) * D + d];
    mine[r * kPart + 2 + d] = o;
  }
  if (tid < R) {
    mine[tid * kPart] = m[tid];
    mine[tid * kPart + 1] = l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned int* counter = counters + (size_t)head * gridDim.y + group;
    last = atomicAdd(counter, 1u) == (unsigned int)splits - 1;
    if (last) *counter = 0u;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The merge: every split's (m, l) into shared memory at once (the
  // loads in flight together), each row's weights there, then the
  // outputs' sums over the splits.
  const float* all = part + slot * R * kPart;
  float* wts = p;  // [splits][R] weights, then [R] 1 / sums
  for (int i = tid; i < splits * R; i += kAttnThreads) {
    wts[i] = __ldcg(all + (size_t)i * kPart);
    acc_w[i] = __ldcg(all + (size_t)i * kPart + 1);
  }
  __syncthreads();
  if (tid < R) {
    float mx = -INFINITY;
    for (int t = 0; t < splits; ++t) mx = fmaxf(mx, wts[t * R + tid]);
    float den = 0.f;
    for (int t = 0; t < splits; ++t) {
      const float w = expf(wts[t * R + tid] - mx);
      wts[t * R + tid] = w;
      den = fmaf(acc_w[t * R + tid], w, den);
    }
    wts[splits * R + tid] = 1.f / den;
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    float num = 0.f;
#pragma unroll 8
    for (int t = 0; t < splits; ++t)
      num = fmaf(__ldcg(all + ((size_t)t * R + r) * kPart + 2 + d),
                 wts[t * R + r], num);
    out[((size_t)(row0 + r) * heads + head) * D + d] =
        from_f<T>(num * wts[splits * R + r]);
  }
}

template <typename T, int D>
cudaError_t launch_attn_d(const void* q, long long q_row, const void* k,
                          const void* v, long long kv_row, const void* bias,
                          void* out, void* part, void* counters, int rows,
                          int length, int heads, float scale,
                          cudaStream_t s) {
  const int splits = (length + kAttnSplit - 1) / kAttnSplit;
  // The merge keeps each split's weights in the block's shared memory.
  if ((splits + 1) * kAttnRows > kAttnRows * kAttnSplit ||
      splits > (kAttnThreads / 32) * D)
    return cudaErrorInvalidValue;
  const dim3 grid(heads, (rows + kAttnRows - 1) / kAttnRows, splits);
  window_attention_kernel<T, D><<<grid, kAttnThreads, 0, s>>>(
      static_cast<const T*>(q), q_row, static_cast<const T*>(k),
      static_cast<const T*>(v), kv_row, static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<unsigned int*>(counters), rows, length, heads, splits,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attn(const void* q, long long q_row, const void* k,
                        const void* v, long long kv_row, const void* bias,
                        void* out, void* part, void* counters, int rows,
                        int length, int heads, int head_dim, float scale,
                        cudaStream_t s) {
  if (head_dim == 16)
    return launch_attn_d<T, 16>(q, q_row, k, v, kv_row, bias, out, part,
                                counters, rows, length, heads, scale, s);
  if (head_dim == 32)
    return launch_attn_d<T, 32>(q, q_row, k, v, kv_row, bias, out, part,
                                counters, rows, length, heads, scale, s);
  if (head_dim == 64)
    return launch_attn_d<T, 64>(q, q_row, k, v, kv_row, bias, out, part,
                                counters, rows, length, heads, scale, s);
  if (head_dim == 128)
    return launch_attn_d<T, 128>(q, q_row, k, v, kv_row, bias, out, part,
                                 counters, rows, length, heads, scale, s);
  return cudaErrorInvalidValue;
}

// -- int8_page_write --------------------------------------------------------

template <typename T>
__global__ void int8_page_write_kernel(
    int8_t* __restrict__ pages, float* __restrict__ scales,
    const T* __restrict__ x, long long x_kv, long long x_slot,
    const int64_t* __restrict__ phys, const int64_t* __restrict__ off,
    long long index_stride, const uint8_t* __restrict__ valid,
    long long valid_stride, int num_pages, int page_size, int heads,
    int head_dim) {
  __shared__ float red[32];
  const int head = blockIdx.x, slot = blockIdx.y, kv = blockIdx.z;
  const int tid = threadIdx.x;
  const long long page = phys[slot * index_stride];
  const long long at = off[slot * index_stride];
  const bool live = valid == nullptr || valid[slot * valid_stride] != 0;
  const T* xr = x + kv * x_kv + slot * x_slot + (long long)head * head_dim;
  float amax = 0.f;
  for (int d = tid; d < head_dim; d += blockDim.x)
    amax = fmaxf(amax, live ? fabsf(to_f(xr[d])) : 0.f);
  amax = block_reduce<true>(amax, red);
  float* sp = scales + ((long long)kv * num_pages + page) * heads + head;
  const float old = *sp;
  const float grown = fmaxf(old, amax / 127.f);
  const float safe = grown > 0.f ? grown : 1.f;
  const float factor = old / safe;
  // The page's block of this head: [page_size, head_dim] at a row stride of
  // heads * head_dim.
  int8_t* blk = pages + (((long long)kv * num_pages + page) * page_size) *
                            heads * head_dim +
                (long long)head * head_dim;
  const long long stride = (long long)heads * head_dim;
  if (factor != 1.f) {
    for (int o = 0; o < page_size; ++o)
      for (int d = tid; d < head_dim; d += blockDim.x) {
        const float q = rintf((float)blk[o * stride + d] * factor);
        blk[o * stride + d] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
      }
  }
  for (int d = tid; d < head_dim; d += blockDim.x) {
    const float xv = live ? to_f(xr[d]) : 0.f;
    const float q = rintf(xv / safe);
    blk[at * stride + d] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
  __syncthreads();  // every thread has read `old`
  if (tid == 0) *sp = grown;
}

template <typename T>
cudaError_t launch_write(void* pages, void* scales, const void* x,
                         long long x_kv, long long x_slot, const void* phys,
                         const void* off, long long index_stride,
                         const void* valid, long long valid_stride, int slots,
                         int num_pages, int page_size, int heads,
                         int head_dim, cudaStream_t s) {
  const dim3 grid(heads, slots, 2);
  const int threads = head_dim >= 128 ? 128 : (head_dim + 31) / 32 * 32;
  int8_page_write_kernel<T><<<grid, threads, 0, s>>>(
      static_cast<int8_t*>(pages), static_cast<float*>(scales),
      static_cast<const T*>(x), x_kv, x_slot,
      static_cast<const int64_t*>(phys), static_cast<const int64_t*>(off),
      index_stride, static_cast<const uint8_t*>(valid), valid_stride,
      num_pages, page_size, heads, head_dim);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 = f32, 1 = bf16. Each entry point returns the launch's cudaError_t
// (0 = ok); operands the kernel does not take give cudaErrorInvalidValue.

// x, h: [rows, D] f32; r: [rows, D] (r_kind) or null (then h is not
// written); w, b: [D] f32; y: [rows, D] (y_kind). D % 8 == 0.
extern "C" int add_layer_norm(int r_kind, int y_kind, const void* x,
                              const void* r, const void* w, const void* b,
                              void* h, void* y, int rows, int features,
                              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || features <= 0 || features % 8 != 0)
    return cudaErrorInvalidValue;
  if (r != nullptr && h == nullptr) return cudaErrorInvalidValue;
  if (r_kind == 0 && y_kind == 0)
    return launch_norm<float, float>(x, r, w, b, h, y, rows, features, eps, s);
  if (r_kind == 0 && y_kind == 1)
    return launch_norm<float, bf16>(x, r, w, b, h, y, rows, features, eps, s);
  if (r_kind == 1 && y_kind == 0)
    return launch_norm<bf16, float>(x, r, w, b, h, y, rows, features, eps, s);
  if (r_kind == 1 && y_kind == 1)
    return launch_norm<bf16, bf16>(x, r, w, b, h, y, rows, features, eps, s);
  return cudaErrorInvalidValue;
}

// pages: [LK, num_pages, page_size, heads, D] (LK = layers x 2) in the
// output kind (page_kind 0 f32, 1 bf16) or int8 (page_kind 2, with scales
// [LK, num_pages, heads] f32); gvec: [length / page_size] int64 page ids;
// plen: a 0-d int64 on the device; out: [LK, length, heads, D] of out_kind.
// heads * D % 8 == 0; pages and out 16-byte aligned.
extern "C" int page_gather(int page_kind, int out_kind, const void* pages,
                           const void* scales, const void* gvec,
                           const void* plen, void* out, int lk, int num_pages,
                           int page_size, int length, int heads, int head_dim,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lk <= 0 || num_pages <= 0 || page_size <= 0 || length <= 0 ||
      heads <= 0 || head_dim <= 0 || (heads * head_dim) % 8 != 0 ||
      (page_kind == 2) != (scales != nullptr))
    return cudaErrorInvalidValue;
  const long long chunks = (long long)lk * length * heads * head_dim / 8;
  const dim3 grid((unsigned int)((chunks + 255) / 256));
  const int64_t* g = static_cast<const int64_t*>(gvec);
  const int64_t* n = static_cast<const int64_t*>(plen);
  const float* sc = static_cast<const float*>(scales);
#define GATHER(TP, TO)                                                      \
  page_gather_kernel<TP, TO><<<grid, 256, 0, s>>>(                          \
      static_cast<const TP*>(pages), sc, g, n, static_cast<TO*>(out),       \
      chunks, num_pages, page_size, length, heads, head_dim)
  if (page_kind == 0 && out_kind == 0) GATHER(float, float);
  else if (page_kind == 1 && out_kind == 1) GATHER(bf16, bf16);
  else if (page_kind == 2 && out_kind == 0) GATHER(int8_t, float);
  else if (page_kind == 2 && out_kind == 1) GATHER(int8_t, bf16);
  else return cudaErrorInvalidValue;
#undef GATHER
  return cudaGetLastError();
}

// q: row w, head h, feature d at q + w * q_row + h * D + d; k, v: position
// l at k + l * kv_row + h * D + d; bias: [rows, length] f32; out: [rows,
// heads, D] contiguous, all of one kind. D is 16, 32, 64 or 128; q, k and v
// 16-byte aligned (with q_row and kv_row multiples of 8). part: f32
// scratch of window_attention_part_floats(...); counters: u32, one per
// (head, group of 4 rows), zero before the first launch (each launch
// leaves them zero). Launches that share counters must not overlap.
extern "C" long long window_attention_part_floats(int rows, int length,
                                                  int heads, int head_dim) {
  const long long groups = (rows + kAttnRows - 1) / kAttnRows;
  const long long splits = (length + kAttnSplit - 1) / kAttnSplit;
  return (long long)heads * groups * splits * kAttnRows * (2 + head_dim);
}

extern "C" int window_attention(int kind, const void* q, long long q_row,
                                const void* k, const void* v,
                                long long kv_row, const void* bias, void* out,
                                void* part, void* counters, int rows,
                                int length, int heads, int head_dim,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || length <= 0 || heads <= 0 ||
      (head_dim != 16 && head_dim != 32 && head_dim != 64 &&
       head_dim != 128) || q_row % 8 != 0 || kv_row % 8 != 0)
    return cudaErrorInvalidValue;
  if (kind == 0)
    return launch_attn<float>(q, q_row, k, v, kv_row, bias, out, part,
                              counters, rows, length, heads, head_dim, scale,
                              s);
  if (kind == 1)
    return launch_attn<bf16>(q, q_row, k, v, kv_row, bias, out, part,
                             counters, rows, length, heads, head_dim, scale,
                             s);
  return cudaErrorInvalidValue;
}

// pages: [2, num_pages, page_size, heads, D] int8; scales: [2, num_pages,
// heads] f32; x: K/V of the position, [2, slots, heads, D] at strides
// (x_kv, x_slot, D, 1) of x_kind; phys, off: the slot's page and offset at
// index_stride int64 elements apart; valid: uint8 per slot at valid_stride
// (null = every slot live; a dead slot writes zeros and keeps the scale).
extern "C" int int8_page_write(int x_kind, void* pages, void* scales,
                               const void* x, long long x_kv, long long x_slot,
                               const void* phys, const void* off,
                               long long index_stride, const void* valid,
                               long long valid_stride, int slots,
                               int num_pages, int page_size, int heads,
                               int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots <= 0 || num_pages <= 0 || page_size <= 0 || heads <= 0 ||
      head_dim <= 0)
    return cudaErrorInvalidValue;
  if (x_kind == 0)
    return launch_write<float>(pages, scales, x, x_kv, x_slot, phys, off,
                               index_stride, valid, valid_stride, slots,
                               num_pages, page_size, heads, head_dim, s);
  if (x_kind == 1)
    return launch_write<bf16>(pages, scales, x, x_kv, x_slot, phys, off,
                              index_stride, valid, valid_stride, slots,
                              num_pages, page_size, heads, head_dim, s);
  return cudaErrorInvalidValue;
}
