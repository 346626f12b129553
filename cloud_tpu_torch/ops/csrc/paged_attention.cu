// Paged decode attention for Hopper (sm_90a), with a plain C interface
// (bound from Python with ctypes: cloud_tpu_torch/ops/paged_attention.py).
//
// Replaces the two Pallas TPU kernels of cloud_tpu/ops/paged_attention.py:
//   _paged_kernel       (:164)  bf16 / f32 pages
//   _paged_kernel_quant (:207)  int8 pages, one f32 scale per page per head
// Both variants are one templated body.
//
// Layouts (the JAX boundary, unchanged):
//   q          [slots, seq, H, D]      bf16 or f32
//   key/value  [num_pages, P, H, D]    the q type, or int8
//   page_table [slots, pages_per_slot] int32
//   allowed    [slots, seq, pages_per_slot * P] bool (1 byte)
//   scales     [num_pages, H]          f32 (int8 pages only)
//   out        [slots, seq, H, D]      the q type
// Rows of K/V (D elements of one head) must be a multiple of 16 bytes and
// the page arrays 16-byte aligned; the wrapper checks both.
//
// Design: one thread block per (head, slot). The TPU kernel walks a
// sequential grid over the slot's pages and carries the online-softmax
// state in VMEM scratch between grid steps; blocks on the card run in
// parallel and carry nothing between them, so the walk over pages is a
// loop inside the block, which reads page_table[slot, j] itself.
//
// - The block first copies the slot's `allowed` rows into shared memory
//   (coalesced) and lists the pages that have any allowed entry for any
//   query row. Only those are visited: a page with none is an exact
//   no-op of the online softmax (m unchanged, alpha = 1, p = 0), and
//   skipping it saves its bytes, which bound this kernel.
// - The live pages' K and V tiles for this head ([P, D] each) are
//   copied into shared memory with cp.async three pages ahead of the
//   one being computed (a ring of four buffers), so the loop does not
//   wait on device memory once per page.
// - Scores: eight lanes per (query row, key) pair, each summing D/8
//   products in f32, then a shuffle reduction. Softmax update: one warp
//   per query row. PV: one thread per (row, d).
// - Masked probabilities are set to 0 explicitly (p = mask ? exp(s - m) :
//   0, as :189-192), so a fully masked row (evicted slot, scratch page 0)
//   ends with l == 0 and is written as exact zeros.
// - bf16: P is rounded to bf16 before the PV product, as the TPU kernel
//   casts p to the page dtype (:194-196). int8: the per-page scale is a
//   scalar per page, folded into the scores (ks * sm_scale) and the PV sum
//   (vs), all in f32 (:231-246).
//
// Bound on this card: decode attention does 4 * seq * D flops per key
// against 2 * D * sizeof(page element) bytes of K and V, about 1 flop per
// byte at seq = 1, far below the H100's ~295 flop/byte ridge; the least
// time is the live K/V bytes over 3.35 TB/s. At the served shapes (GPT-2
// small: slots 8, H 12, D 64, P 16, bf16) a fully live 64-page table for
// every slot is 8 * 64 * 16 * 12 * 64 * 2 * 2 bytes = 25.2 MB, 7.5 us.
// One block per (head, slot) is 96 blocks on 132 SMs, each walking its
// slot's pages in order: the deepest slot sets the time. Splitting a
// slot's pages over blocks (flash-decoding), TMA and wgmma are left for
// later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerDot = 8;
constexpr int kStages = 4;  // pages in flight: one computed, three loading

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the PV product sees it: rounded to the page dtype for bf16 pages,
// kept in f32 for f32 and int8 pages (the int8 products run in f32).
template <typename KT>
__device__ __forceinline__ float round_like(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Shared memory, in this order (the tiles first, so they are 16-byte
// aligned): K and V tiles [kStages][P * D] of KT, q and acc [seq * D],
// scores [seq * P], m, l, alpha [seq], the live page list
// [pages_per_slot], and the slot's allowed rows [seq * pages_per_slot * P]
// (bytes).
template <typename KT>
size_t shared_bytes(int seq, int head_dim, int page_size, int pages_per_slot) {
  const size_t tiles =
      2 * kStages * (size_t)page_size * head_dim * sizeof(KT);
  const size_t floats = 2 * (size_t)seq * head_dim + (size_t)seq * page_size +
                        3 * (size_t)seq;
  return tiles + floats * sizeof(float) + (size_t)pages_per_slot * sizeof(int) +
         (size_t)seq * pages_per_slot * page_size;
}

template <typename KT>
__device__ __forceinline__ void load_tiles(
    KT* k_dst, KT* v_dst, const KT* __restrict__ key_pages,
    const KT* __restrict__ value_pages, int phys, int h, int heads, int D,
    int P) {
  constexpr int kPerChunk = 16 / sizeof(KT);
  const int chunks_per_row = D / kPerChunk;
  const int chunks = P * chunks_per_row;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int c = i / chunks_per_row;
    const int d = (i % chunks_per_row) * kPerChunk;
    const size_t off = (((size_t)phys * P + c) * heads + h) * D + d;
    cp_async_16(k_dst + c * D + d, key_pages + off);
    cp_async_16(v_dst + c * D + d, value_pages + off);
  }
}

template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ key_pages,
    const KT* __restrict__ value_pages, const int32_t* __restrict__ page_table,
    const uint8_t* __restrict__ allowed, const float* __restrict__ key_scales,
    const float* __restrict__ value_scales, QT* __restrict__ out, int seq,
    int heads, int head_dim, int page_size, int pages_per_slot, int num_pages,
    float sm_scale) {
  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = head_dim;
  const int P = page_size;
  const int L = pages_per_slot * P;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  KT* k_tile = reinterpret_cast<KT*>(smem_raw);  // [kStages][P * D]
  KT* v_tile = k_tile + kStages * P * D;         // [kStages][P * D]
  float* q_s = reinterpret_cast<float*>(v_tile + kStages * P * D);
  float* acc = q_s + seq * D;                    // [seq, D]
  float* p_s = acc + seq * D;                    // [seq, P]
  float* m_s = p_s + seq * P;                    // [seq]
  float* l_s = m_s + seq;                        // [seq]
  float* alpha_s = l_s + seq;                    // [seq]
  int* live = reinterpret_cast<int*>(alpha_s + seq);  // [pages_per_slot]
  uint8_t* allow = reinterpret_cast<uint8_t*>(live + pages_per_slot);
  __shared__ int n_live;

  const uint8_t* allow_g = allowed + (size_t)slot * seq * L;
  const int32_t* table = page_table + (size_t)slot * pages_per_slot;

  for (int j = tid; j < pages_per_slot; j += blockDim.x) live[j] = 0;
  for (int i = tid; i < seq * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    q_s[i] = to_f32(q[((size_t)(slot * seq + r) * heads + h) * D + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < seq; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < seq * L; i += blockDim.x) {
    const uint8_t a = allow_g[i] != 0;
    allow[i] = a;
    if (a) live[(i % L) / P] = 1;  // benign race: all write 1
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j < pages_per_slot; ++j) {
      const int phys = table[j];
      if (live[j] && phys >= 0 && phys < num_pages) live[n++] = j;
    }
    n_live = n;
  }
  __syncthreads();
  const int n = n_live;

  // One commit group per page (empty past the last), so that waiting for
  // all but the newest kStages - 1 groups waits for exactly this page.
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n) {
      load_tiles(k_tile + t * P * D, v_tile + t * P * D, key_pages,
                 value_pages, table[live[t]], h, heads, D, P);
    }
    cp_async_commit();
  }

  for (int t = 0; t < n; ++t) {
    const int j = live[t];
    const int phys = table[j];
    const int buf = t % kStages;
    const int ahead = t + kStages - 1;
    if (ahead < n) {
      const int next = ahead % kStages;
      load_tiles(k_tile + next * P * D, v_tile + next * P * D, key_pages,
                 value_pages, table[live[ahead]], h, heads, D, P);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this page's tiles have landed
    __syncthreads();
    const KT* k_s = k_tile + buf * P * D;
    const KT* v_s = v_tile + buf * P * D;
    float k_scale = 1.f, v_scale = 1.f;
    if (kQuant) {
      k_scale = key_scales[(size_t)phys * heads + h];
      v_scale = value_scales[(size_t)phys * heads + h];
    }
    const float s_scale = kQuant ? k_scale * sm_scale : sm_scale;

    // Scores: eight lanes per (row, key) pair.
    const int pairs = seq * P;
    const int sub = lane % kLanesPerDot;
    for (int base = 0; base < pairs; base += kThreads / kLanesPerDot) {
      const int pair = base + tid / kLanesPerDot;
      float dot = 0.f;
      if (pair < pairs) {
        const float* qr = q_s + (pair / P) * D;
        const KT* kc = k_s + (pair % P) * D;
        for (int d = sub; d < D; d += kLanesPerDot)
          dot = fmaf(qr[d], to_f32(kc[d]), dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      if (pair < pairs && sub == 0) {
        const int r = pair / P, c = pair % P;
        p_s[pair] = allow[(size_t)r * L + j * P + c] ? dot * s_scale
                                                     : kNegInf;
      }
    }
    __syncthreads();

    // Online-softmax update: one warp per query row.
    for (int r = warp; r < seq; r += kWarps) {
      float* row = p_s + r * P;
      const uint8_t* arow = allow + (size_t)r * L + j * P;
      float m_cur = kNegInf;
      for (int c = lane; c < P; c += 32) m_cur = fmaxf(m_cur, row[c]);
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, m_cur);
      float l_add = 0.f;
      for (int c = lane; c < P; c += 32) {
        const float p = arow[c] ? expf(row[c] - m_next) : 0.f;
        l_add += p;
        row[c] = kQuant ? p : round_like<KT>(p);
      }
      for (int o = 16; o > 0; o >>= 1)
        l_add += __shfl_xor_sync(0xffffffffu, l_add, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        l_s[r] = alpha * l_s[r] + l_add;
        m_s[r] = m_next;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one thread per (row, d).
    for (int i = tid; i < seq * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const float* prow = p_s + r * P;
      float pv = 0.f;
      for (int c = 0; c < P; ++c) pv = fmaf(prow[c], to_f32(v_s[c * D + d]), pv);
      if (kQuant) pv *= v_scale;
      acc[i] = acc[i] * alpha_s[r] + pv;
    }
    // Every read of this buffer ends before a later iteration's copy
    // into it is issued.
    __syncthreads();
  }
  cp_async_wait<0>();

  for (int i = tid; i < seq * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const float l = l_s[r];
    const float o = l == 0.f ? 0.f : acc[i] / l;
    out[((size_t)(slot * seq + r) * heads + h) * D + d] = from_f32<QT>(o);
  }
}

template <typename QT, typename KT, bool kQuant>
cudaError_t launch(const void* q, const void* key_pages,
                   const void* value_pages, const void* page_table,
                   const void* allowed, const void* key_scales,
                   const void* value_scales, void* out, int slots, int seq,
                   int heads, int head_dim, int page_size, int pages_per_slot,
                   int num_pages, float sm_scale, cudaStream_t stream) {
  if ((head_dim * sizeof(KT)) % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem =
      shared_bytes<KT>(seq, head_dim, page_size, pages_per_slot);
  auto kernel = paged_attention_kernel<QT, KT, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(heads, slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(key_pages),
      static_cast<const KT*>(value_pages),
      static_cast<const int32_t*>(page_table),
      static_cast<const uint8_t*>(allowed),
      static_cast<const float*>(key_scales),
      static_cast<const float*>(value_scales), static_cast<QT*>(out), seq,
      heads, head_dim, page_size, pages_per_slot, num_pages, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 = f32 pages, 1 = bf16 pages, 2 = int8 pages with f32 q,
// 3 = int8 pages with bf16 q. Returns the launch's cudaError_t (0 = ok);
// an unknown kind, or a K/V row that is not a multiple of 16 bytes,
// returns cudaErrorInvalidValue.
extern "C" int paged_attention_forward(
    int kind, const void* q, const void* key_pages, const void* value_pages,
    const void* page_table, const void* allowed, const void* key_scales,
    const void* value_scales, void* out, int slots, int seq, int heads,
    int head_dim, int page_size, int pages_per_slot, int num_pages,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<float, float, false>(
          q, key_pages, value_pages, page_table, allowed, key_scales,
          value_scales, out, slots, seq, heads, head_dim, page_size,
          pages_per_slot, num_pages, sm_scale, s);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(
          q, key_pages, value_pages, page_table, allowed, key_scales,
          value_scales, out, slots, seq, heads, head_dim, page_size,
          pages_per_slot, num_pages, sm_scale, s);
    case 2:
      return launch<float, int8_t, true>(
          q, key_pages, value_pages, page_table, allowed, key_scales,
          value_scales, out, slots, seq, heads, head_dim, page_size,
          pages_per_slot, num_pages, sm_scale, s);
    case 3:
      return launch<__nv_bfloat16, int8_t, true>(
          q, key_pages, value_pages, page_table, allowed, key_scales,
          value_scales, out, slots, seq, heads, head_dim, page_size,
          pages_per_slot, num_pages, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
