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
//   part       [slots, chunks, seq, H, D + 2] f32 scratch (acc, m, l)
// Rows of K/V (D elements of one head) must be a multiple of 16 bytes and
// every array 16-byte aligned; the wrapper sees to both.
//
// Design (flash-decoding). The TPU kernel walks a sequential grid over a
// slot's pages and carries the online-softmax state in VMEM scratch from
// one grid step to the next. On the card a walk over up to 64 pages in one
// block per (head, slot) is a serial chain that leaves most SMs idle, so
// the walk is split:
// - A block per (chunk, head group, slot). Every block of a slot reads the
//   slot's `allowed` rows into shared memory and lists the pages that have
//   an allowed entry for some query row and a valid physical page (a page
//   with none is an exact no-op of the online softmax, and skipping it
//   saves its bytes, which bound this kernel); chunk c takes the live
//   pages [c n / chunks, (c + 1) n / chunks) of that list. `chunks` comes
//   from the host (the live-page count is unknown there): about two
//   blocks per SM over the whole grid.
// - A block computes every head of its group (all H heads when a page of
//   K and V fits the stage budget) for each of its pages, which are read
//   whole: a page-head group is `P` rows of group x D contiguous values
//   (one bulk copy when the group is every head: [P, H, D] is contiguous).
//   The copies are 1-D bulk asynchronous copies (cp.async.bulk) into a ring
//   of two stages with an mbarrier each, issued one page ahead.
// - Per page: scores by eight lanes per (row, head, key) from 16-byte
//   vectors, the online-softmax step by half a warp per (row, head), and
//   acc = acc * alpha + P V by one thread per (row, head, d); products in
//   f32 on CUDA cores: at seq 1 to 4 there are too few rows for the tensor
//   cores to pay.
// - Each block writes its partial (acc, m, l) in f32 per (row, head); a
//   second kernel, one block per (slot, row, head), merges a slot's chunks:
//   out = sum_c acc_c e^(m_c - M) / sum_c l_c e^(m_c - M). A chunk with no allowed key has m = -1e30,
//   l = 0, acc = 0 and adds exactly nothing; a row with no allowed key in
//   any chunk has l = 0 and is written as exact zeros.
// - Masked probabilities are set to 0 explicitly (p = mask ? exp(s - m) :
//   0, as :189-192). bf16: P is rounded to bf16 before the PV product, as
//   the TPU kernel casts p to the page dtype (:194-196). int8: the
//   per-page scale is a scalar per page and head, folded into the scores
//   (ks * sm_scale) and the PV sum (vs), all in f32 (:231-246).
//
// Bound on this card: decode attention does 4 * seq * D flops per key
// against 2 * D * sizeof(page element) bytes of K and V, about 1 flop per
// byte at seq = 1, far below the H100's ~295 flop/byte ridge; the least
// time is the live K/V bytes over 3.35 TB/s. At the served shapes (GPT-2
// small: slots 8, H 12, D 64, P 16, bf16) a fully live 64-page table for
// every slot is 8 * 64 * 16 * 12 * 64 * 2 * 2 bytes = 25.2 MB, 7.5 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kLanesPerDot = 8;
constexpr int kRowLanes = 16;  // lanes per (row, head) in the softmax step
constexpr int kStages = 2;     // pages in flight: one computed, one loading

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

struct Args {
  const void* q;
  const void* key_pages;
  const void* value_pages;
  const int32_t* page_table;
  const uint8_t* allowed;
  const float* key_scales;
  const float* value_scales;
  float* part;
  void* out;
  int slots, seq, heads, head_dim, page_size, pages_per_slot, num_pages;
  int group;   // heads per block
  int chunks;  // blocks per (head group, slot)
  float sm_scale;
};

// Shared memory, in this order (the stages first, so that they are 16-byte
// aligned for the bulk copies): the K and V stages [kStages][2][P * group
// * D] of KT, their barriers [kStages], q and acc [seq * group * D], the
// scores [seq * group * P], m, l and alpha [seq * group] (f32), the slot's
// page table and its live page list [pages_per_slot] (int), and the slot's
// allowed rows [seq * pages_per_slot * P] (bytes).
template <typename KT>
__host__ __device__ size_t stage_bytes(int group, int head_dim,
                                       int page_size) {
  return (size_t)page_size * group * head_dim * sizeof(KT);
}
template <typename KT>
size_t shared_bytes(int seq, int group, int head_dim, int page_size,
                    int pages_per_slot) {
  const size_t rows = (size_t)seq * group;
  const size_t floats = 2 * rows * head_dim + rows * page_size + 3 * rows;
  return kStages * 2 * stage_bytes<KT>(group, head_dim, page_size) +
         kStages * sizeof(uint64_t) + floats * sizeof(float) +
         2 * (size_t)pages_per_slot * sizeof(int) +
         (size_t)seq * pages_per_slot * page_size;
}

// Issues the bulk copies of page `phys`'s K and V rows of heads [h0, h0 +
// group) into one stage (warp 0; lane 0 first announces the bytes).
template <typename KT>
__device__ __forceinline__ void load_page(const Args& a, KT* k_dst,
                                          KT* v_dst, uint64_t* bar, int phys,
                                          int h0, int lane) {
  const int D = a.head_dim, P = a.page_size, G = a.group;
  const uint32_t bytes = (uint32_t)stage_bytes<KT>(G, D, P);
  if (lane == 0) sm90::mbar_arrive_expect_tx(bar, 2 * bytes);
  __syncwarp();
  const KT* kp = static_cast<const KT*>(a.key_pages);
  const KT* vp = static_cast<const KT*>(a.value_pages);
  if (G == a.heads) {  // [P, H, D] is contiguous: one copy each
    if (lane == 0) {
      const size_t off = (size_t)phys * P * a.heads * D;
      sm90::bulk_load(k_dst, kp + off, bytes, bar);
      sm90::bulk_load(v_dst, vp + off, bytes, bar);
    }
    return;
  }
  const uint32_t row = (uint32_t)G * D * sizeof(KT);
  for (int c = lane; c < P; c += 32) {
    const size_t off = (((size_t)phys * P + c) * a.heads + h0) * D;
    sm90::bulk_load(k_dst + (size_t)c * G * D, kp + off, row, bar);
    sm90::bulk_load(v_dst + (size_t)c * G * D, vp + off, row, bar);
  }
}

// q . k over D in f32: this lane's 16-byte pieces sub, sub + 8, ... of the
// key row, against q in f32.
template <typename KT>
__device__ __forceinline__ float dot_part(const float* q, const KT* k, int D,
                                          int sub) {
  constexpr int kE = 16 / sizeof(KT);  // values per 16 bytes
  float dot = 0.f;
  for (int d = sub * kE; d < D; d += kLanesPerDot * kE) {
    union {
      uint4 v;
      KT e[kE];
    } u;
    u.v = *reinterpret_cast<const uint4*>(k + d);
#pragma unroll
    for (int e = 0; e < kE; ++e) dot = fmaf(q[d + e], to_f32(u.e[e]), dot);
  }
  return dot;
}

template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Args a) {
  const int chunk = blockIdx.x;
  const int h0 = blockIdx.y * a.group;
  const int slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = a.head_dim, P = a.page_size, G = a.group, seq = a.seq;
  const int L = a.pages_per_slot * P;
  const int R = seq * G;  // (row, head) pairs of this block

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const size_t sb = stage_bytes<KT>(G, D, P);
  unsigned char* stages = smem_raw;  // [kStages][K | V][P][G][D]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * 2 * sb);
  float* q_s = reinterpret_cast<float*>(full + kStages);  // [seq][G][D]
  float* acc = q_s + R * D;                               // [seq][G][D]
  float* p_s = acc + R * D;                               // [seq][G][P]
  float* m_s = p_s + R * P;                               // [seq][G]
  float* l_s = m_s + R;
  float* alpha_s = l_s + R;
  int* table = reinterpret_cast<int*>(alpha_s + R);  // [pages_per_slot]
  int* live = table + a.pages_per_slot;               // [pages_per_slot]
  uint8_t* allow = reinterpret_cast<uint8_t*>(live + a.pages_per_slot);
  __shared__ int n_live;

  const uint8_t* allow_g = a.allowed + (size_t)slot * seq * L;
  const int32_t* table_g = a.page_table + (size_t)slot * a.pages_per_slot;
  const QT* q = static_cast<const QT*>(a.q);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
  }
  for (int j = tid; j < a.pages_per_slot; j += kThreads) {
    live[j] = 0;
    table[j] = table_g[j];
  }
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / (G * D), hh = (i / D) % G, d = i % D;
    q_s[i] = to_f32(q[(((size_t)slot * seq + r) * a.heads + h0 + hh) * D + d]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < R; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < seq * L; i += kThreads) {
    const uint8_t ok = allow_g[i] != 0;
    allow[i] = ok;
    if (ok) live[(i % L) / P] = 1;  // benign race: all write 1
  }
  __syncthreads();
  // The live pages, in order, compacted in place by warp 0 (a page's index
  // is written at or before its own place, after its flag is read).
  if (warp == 0) {
    int n = 0;
    for (int j0 = 0; j0 < a.pages_per_slot; j0 += 32) {
      const int j = j0 + lane;
      bool ok = false;
      if (j < a.pages_per_slot) {
        const int phys = table[j];
        ok = live[j] && phys >= 0 && phys < a.num_pages;
      }
      __syncwarp();
      const unsigned ball = __ballot_sync(0xffffffffu, ok);
      if (ok) live[n + __popc(ball & ((1u << lane) - 1))] = j;
      n += __popc(ball);
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  const int lo = (int)((long long)chunk * n_live / a.chunks);
  const int hi = (int)((long long)(chunk + 1) * n_live / a.chunks);

  auto k_stage = [&](int s) {
    return reinterpret_cast<KT*>(stages + (size_t)s * 2 * sb);
  };
  if (warp == 0) {
    for (int t = lo; t < hi && t < lo + kStages; ++t) {
      const int s = (t - lo) % kStages;
      load_page<KT>(a, k_stage(s), k_stage(s) + sb / sizeof(KT), &full[s],
                    table[live[t]], h0, lane);
    }
  }

  for (int t = lo; t < hi; ++t) {
    const int s = (t - lo) % kStages;
    const int j = live[t];
    const int phys = table[j];
    sm90::mbar_wait(&full[s], ((t - lo) / kStages) & 1);
    const KT* k_s = k_stage(s);
    const KT* v_s = k_s + sb / sizeof(KT);

    // Scores: eight lanes per (row, head, key).
    const int pairs = R * P;
    const int sub = lane % kLanesPerDot;
    for (int base = 0; base < pairs; base += kThreads / kLanesPerDot) {
      const int pair = base + tid / kLanesPerDot;
      const int rh = pair / P, c = pair % P;  // (row, head), key
      float dot = 0.f;
      if (pair < pairs)
        dot = dot_part(q_s + rh * D, k_s + ((size_t)c * G + rh % G) * D, D,
                       sub);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      if (pair < pairs && sub == 0) {
        float scale = a.sm_scale;
        if (kQuant)
          scale *= a.key_scales[(size_t)phys * a.heads + h0 + rh % G];
        p_s[pair] = allow[(size_t)(rh / G) * L + j * P + c] ? dot * scale
                                                           : kNegInf;
      }
    }
    __syncthreads();

    // Online-softmax step: half a warp per (row, head).
    for (int rh0 = 0; rh0 < R; rh0 += kThreads / kRowLanes) {
      const int rh = rh0 + tid / kRowLanes;
      const int sl = tid % kRowLanes;
      float* row = p_s + (rh < R ? rh : 0) * P;
      const uint8_t* arow = allow + (size_t)(rh / G) * L + j * P;
      float m_cur = kNegInf;
      if (rh < R)
        for (int c = sl; c < P; c += kRowLanes) m_cur = fmaxf(m_cur, row[c]);
      for (int o = kRowLanes / 2; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = rh < R ? m_s[rh] : kNegInf;
      const float m_next = fmaxf(m_prev, m_cur);
      float l_add = 0.f;
      if (rh < R) {
        for (int c = sl; c < P; c += kRowLanes) {
          const float pv = arow[c] ? expf(row[c] - m_next) : 0.f;
          l_add += pv;
          row[c] = kQuant ? pv : round_like<KT>(pv);
        }
      }
      for (int o = kRowLanes / 2; o > 0; o >>= 1)
        l_add += __shfl_xor_sync(0xffffffffu, l_add, o);
      if (rh < R && sl == 0) {
        const float alpha = expf(m_prev - m_next);
        l_s[rh] = alpha * l_s[rh] + l_add;
        m_s[rh] = m_next;
        alpha_s[rh] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one thread per (row, head, d).
    for (int i = tid; i < R * D; i += kThreads) {
      const int rh = i / D, d = i % D;
      const float* prow = p_s + rh * P;
      const KT* vcol = v_s + (size_t)(rh % G) * D + d;
      float pv = 0.f;
      for (int c = 0; c < P; ++c)
        pv = fmaf(prow[c], to_f32(vcol[(size_t)c * G * D]), pv);
      if (kQuant) pv *= a.value_scales[(size_t)phys * a.heads + h0 + rh % G];
      acc[i] = acc[i] * alpha_s[rh] + pv;
    }
    // Every read of this stage ends before its refill is issued.
    __syncthreads();
    if (warp == 0 && t + kStages < hi)
      load_page<KT>(a, k_stage(s), k_stage(s) + sb / sizeof(KT), &full[s],
                    table[live[t + kStages]], h0, lane);
  }

  // The partial of this chunk: acc, m, l per (row, head).
  float* part = a.part + (((size_t)slot * a.chunks + chunk) * seq) *
                             a.heads * (D + 2);
  for (int i = tid; i < R * (D + 2); i += kThreads) {
    const int rh = i / (D + 2), e = i % (D + 2);
    const int r = rh / G, h = h0 + rh % G;
    const float v = e < D ? acc[rh * D + e] : e == D ? m_s[rh] : l_s[rh];
    part[((size_t)r * a.heads + h) * (D + 2) + e] = v;
  }
}

// out[slot, r, h, :] from the chunks' partials: one block per (slot, r, h).
// The chunks' weights e^(m_c - M) go to shared memory; then each thread
// sums one column d over a share of the chunks (kThreads / D shares, so
// that the chunks' loads are in flight together), and the shares add up.
template <typename QT>
__global__ void __launch_bounds__(kThreads) paged_attention_merge(Args a) {
  const int D = a.head_dim, C = a.chunks;
  extern __shared__ float w[];              // [C] weights, then [kThreads]
  float* sums = w + C;
  __shared__ float red[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rows = (size_t)a.seq * a.heads;
  const size_t rh = blockIdx.x % rows;
  const int slot = (int)(blockIdx.x / rows);
  const size_t cstride = rows * (D + 2);
  const float* part = a.part + (size_t)slot * C * cstride + rh * (D + 2);

  float m = kNegInf;
  for (int c = tid; c < C; c += kThreads) {
    w[c] = part[c * cstride + D];
    m = fmaxf(m, w[c]);
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, red[i]);
  __syncthreads();
  float l = 0.f;
  for (int c = tid; c < C; c += kThreads) {
    w[c] = expf(w[c] - m);  // 0 for a chunk with no allowed key
    l = fmaf(part[c * cstride + D + 1], w[c], l);
  }
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) l += red[i];

  const int shares = D < kThreads ? kThreads / D : 1;
  QT* out = static_cast<QT*>(a.out) + ((size_t)slot * rows + rh) * D;
  for (int d0 = 0; d0 < D; d0 += kThreads / shares) {
    const int g = tid / (kThreads / shares);
    const int d = d0 + tid % (kThreads / shares);
    float o = 0.f;
    if (d < D && g < shares) {
#pragma unroll 4
      for (int c = g; c < C; c += shares)
        o = fmaf(part[c * cstride + d], w[c], o);
    }
    sums[tid] = o;
    __syncthreads();
    if (g == 0 && d < D) {
      for (int i = 1; i < shares; ++i) o += sums[i * (kThreads / shares) +
                                                tid];
      out[d] = from_f32<QT>(l == 0.f ? 0.f : o / l);
    }
    __syncthreads();
  }
}

template <typename QT, typename KT, bool kQuant>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if ((a.head_dim * sizeof(KT)) % 16 != 0 || a.group <= 0 ||
      a.heads % a.group != 0 || a.chunks <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = shared_bytes<KT>(a.seq, a.group, a.head_dim,
                                       a.page_size, a.pages_per_slot);
  auto kernel = paged_attention_kernel<QT, KT, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.chunks, a.heads / a.group, a.slots);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t merge_smem = (a.chunks + kThreads) * sizeof(float);
  if (merge_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_merge<QT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)merge_smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_merge<QT>
      <<<(unsigned)((size_t)a.slots * a.seq * a.heads), kThreads, merge_smem,
         stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 = f32 pages, 1 = bf16 pages, 2 = int8 pages with f32 q,
// 3 = int8 pages with bf16 q. group: heads per block (a divisor of heads);
// chunks: blocks per (head group, slot); part: f32 scratch of
// slots * chunks * seq * heads * (head_dim + 2) values. Returns the
// launches' cudaError_t (0 = ok); an unknown kind, a K/V row that is not a
// multiple of 16 bytes, or a group that does not divide heads returns
// cudaErrorInvalidValue.
extern "C" int paged_attention_forward(
    int kind, const void* q, const void* key_pages, const void* value_pages,
    const void* page_table, const void* allowed, const void* key_scales,
    const void* value_scales, void* part, void* out, int slots, int seq,
    int heads, int head_dim, int page_size, int pages_per_slot,
    int num_pages, int group, int chunks, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = q;
  a.key_pages = key_pages;
  a.value_pages = value_pages;
  a.page_table = static_cast<const int32_t*>(page_table);
  a.allowed = static_cast<const uint8_t*>(allowed);
  a.key_scales = static_cast<const float*>(key_scales);
  a.value_scales = static_cast<const float*>(value_scales);
  a.part = static_cast<float*>(part);
  a.out = out;
  a.slots = slots;
  a.seq = seq;
  a.heads = heads;
  a.head_dim = head_dim;
  a.page_size = page_size;
  a.pages_per_slot = pages_per_slot;
  a.num_pages = num_pages;
  a.group = group;
  a.chunks = chunks;
  a.sm_scale = sm_scale;
  switch (kind) {
    case 0:
      return launch<float, float, false>(a, s);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(a, s);
    case 2:
      return launch<float, int8_t, true>(a, s);
    case 3:
      return launch<__nv_bfloat16, int8_t, true>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
