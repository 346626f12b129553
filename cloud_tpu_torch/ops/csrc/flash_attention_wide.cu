// Flash attention at head_dim above 256 (forward, dq, dk/dv), bf16 and
// f32, with the plain C interface of flash_common.cuh. The kernels for
// head_dim up to 256 are in flash_attention.cu (bf16) and
// flash_attention_f32.cu (f32) and are not touched by this route.
//
// Replaces, at D > 256, the Pallas TPU kernels of cloud_tpu/ops/attention.py
// _fwd_kernel (:179), _dq_kernel (:345) and _dkdv_kernel (:383), with the
// whole `flash_attention` contract: causal or not, sm_scale, a key mask
// [B, S], GQA, a sliding window, a tanh logit softcap, any S. The
// per-element steps (scale, softcap, masking, online softmax, dS) and the
// epilogue's rounding are flash_common.cuh's, shared with the narrow
// kernels.
//
// Design: one kernel family for every D, no per-width template. A wide
// output row does not fit a block's registers (the narrow kernels keep all
// D of an output row in registers, 128 values a thread at D 256), so the
// outputs are split into column chunks: one block owns one (row block,
// column chunk) of out, dq, or dk and dv. The scores S = Q K^T (and dP =
// dO V^T in the backward) need the whole D, so every chunk's block
// recomputes them, looping over D in slices of kDepth columns staged
// through shared memory by cp.async (columns past D and rows past S are
// zero-filled, so the products are exact); it then runs the per-element
// step and accumulates only its own chunk of the second products (P V;
// dS K; P^T dO and dS^T Q). That costs ceil(D / chunk) times the score
// products, the price of a simple kernel. P and dS go through shared
// memory, rounded to the input type first (the cast the TPU kernels make
// before the second product). lse is written by chunk 0's blocks.
// Products are warp-level mma.sync m16n8k16 in bf16 (f32 accumulation);
// the f32 kernels compute the same tiles with FMAs in the fragment layout.
// There is no producer/consumer pipeline: each step loads, waits and
// computes, and three to four resident blocks per SM overlap each other's
// loads.
//
// Bound on this card: the forward at DeepSeek-V4-Flash's attention (B 1,
// S 2048, 64 heads over 1 KV head, D 512, causal) does 275 GFLOP over
// 0.27 GB, operation-bound (0.28 ms at 989 TFLOP/s); the chunks add
// (ceil(D / 128) - 1) x the QK^T product (x 3 at D 512).

#include "flash_common.cuh"

namespace {

constexpr int kDepth = 64;   // columns of D per staged slice of Q, K, dO, V
constexpr int kChunk = 128;  // output columns per block
constexpr int kKeys = 64;    // keys per tile (forward, dq) and per dk/dv block
constexpr int kTq = 32;      // q rows per inner tile of dk/dv

// Shared-memory rows are padded by 16 bytes (no bank conflicts on the
// fragment reads).
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__device__ __forceinline__ T cvt(float x);
template <>
__device__ __forceinline__ float cvt<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: no bytes read, 16 zeros written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Issues the copy of ROWS x COLS values into shared memory (row stride ld)
// from rows 0.. of `src` (row stride `stride` values), columns c0 .. c0 +
// COLS; rows at or past `valid` and columns at or past `dim` are zeros.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_async(T* dst, int ld, const T* src,
                                           size_t stride, int valid, int c0,
                                           int dim) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool ok = r < valid && c0 + c < dim;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c0 + c : src, ok);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c[n] (the 16 x 8 accumulator tiles n = 0 .. NT - 1 of one warp, in the
// mma m16n8 layout: this lane's c[n][0], c[n][1] at row g, columns n * 8 +
// t, + 1; c[n][2], c[n][3] at row g + 8) += A B, with A 16 x KD row-major
// at `a` (row stride lda) and B KD x (8 NT), stored [n][k] (kBT) or [k][n]
// at `b` (row stride ldb). bf16: mma.sync m16n8k16, f32 accumulation.
template <bool kBT, int NT, int KD>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const bf16* a,
                                         int lda, const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    af[0] = ld32(a + g * lda + kk + t);
    af[1] = ld32(a + (g + 8) * lda + kk + t);
    af[2] = ld32(a + g * lda + kk + t + 8);
    af[3] = ld32(a + (g + 8) * lda + kk + t + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bf[2];
      if (kBT) {
        const bf16* bn = b + (n * 8 + g) * ldb + kk + t;
        bf[0] = ld32(bn);
        bf[1] = ld32(bn + 8);
      } else {
        const bf16* bk = b + (kk + t) * ldb + n * 8 + g;
        bf[0] = pack_bf16(bk[0], bk[ldb]);
        bf[1] = pack_bf16(bk[8 * ldb], bk[9 * ldb]);
      }
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
          : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(bf[0]),
            "r"(bf[1]));
    }
  }
}
// The same tiles in f32 FMAs (the tests' oracle runs; the k loop rolled so
// that they build quickly).
template <bool kBT, int NT, int KD>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const float* a,
                                         int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
#pragma unroll 1
  for (int kk = 0; kk < KD; ++kk) {
    const float a0 = a[g * lda + kk], a1 = a[(g + 8) * lda + kk];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int n0 = n * 8 + t;
      const float b0 = kBT ? b[n0 * ldb + kk] : b[kk * ldb + n0];
      const float b1 = kBT ? b[(n0 + 1) * ldb + kk] : b[kk * ldb + n0 + 1];
      c[n][0] = fmaf(a0, b0, c[n][0]);
      c[n][1] = fmaf(a0, b1, c[n][1]);
      c[n][2] = fmaf(a1, b0, c[n][2]);
      c[n][3] = fmaf(a1, b1, c[n][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// This warp's 16 rows of accumulator tiles into shared memory (row stride
// ld), rounded to T.
template <typename T, int NT>
__device__ __forceinline__ void tiles_to_smem(T* dst, int ld,
                                              const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[(g + (i >> 1) * 8) * ld + n * 8 + t + (i & 1)] = cvt<T>(c[n][i]);
}

__host__ __device__ inline int chunks(int dim) {
  return (dim + kChunk - 1) / kChunk;
}

// ---------------------------------------------------------------------------
// forward: one block per (64 q rows x kChunk output columns, head, example).
// Per live key tile: S over D slices (Q and K slices staged together), the
// online softmax, P to shared memory, then the tile's V columns of the
// chunk (staged over the Q/K slices' space) and O += P V.
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int fwd_ld() {
  return kDepth + pad<T>();
}
template <typename T>
size_t fwd_smem() {
  constexpr int LD = fwd_ld<T>(), LDV = kChunk + pad<T>();
  constexpr int LDP = kKeys + pad<T>();
  constexpr size_t stage = (size_t)(kBlockM + kKeys) * LD;
  constexpr size_t vtile = (size_t)kKeys * LDV;
  return sizeof(T) * ((stage > vtile ? stage : vtile) +
                      (size_t)kBlockM * LDP) +
         kKeys;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_fwd_kernel(Params p) {
  constexpr int LD = fwd_ld<T>(), LDV = kChunk + pad<T>();
  constexpr int LDP = kKeys + pad<T>();
  constexpr int NT = kKeys / 8, DT = kChunk / 8;
  constexpr size_t stage = (size_t)(kBlockM + kKeys) * LD;
  constexpr size_t vtile = (size_t)kKeys * LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [kBlockM][LD]
  T* k_s = q_s + kBlockM * LD;          // [kKeys][LD]
  T* v_s = q_s;                         // [kKeys][LDV], over Q and K
  T* p_s = q_s + (stage > vtile ? stage : vtile);  // [kBlockM][LDP]
  uint8_t* flags = reinterpret_cast<uint8_t*>(p_s + kBlockM * LDP);

  const int S = p.seq, dim = p.dim;
  const int nc = chunks(dim), tiles = (S + kBlockM - 1) / kBlockM;
  // Heaviest first under causal masking: the last q tiles see most keys.
  const int q0 = (tiles - 1 - static_cast<int>(blockIdx.x) / nc) * kBlockM;
  const int col0 = (static_cast<int>(blockIdx.x) % nc) * kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = (lane & 3) * 2;
  const size_t qs = (size_t)p.heads * dim, ks = (size_t)p.kv_heads * dim;
  const T* qg = static_cast<const T*>(p.q) + ((size_t)b * S + q0) * qs +
                (size_t)h * dim;
  const T* kg = static_cast<const T*>(p.k) + (size_t)b * S * ks +
                (size_t)hk * dim;
  const T* vg = static_cast<const T*>(p.v) + (size_t)b * S * ks +
                (size_t)hk * dim;

  float acc[DT][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  T* pw = p_s + warp * 16 * LDP;

  for (int k0 = 0; k0 < S; k0 += kKeys) {
    if (!tile_live(p, q0, kBlockM, k0, kKeys)) continue;
    float s[NT][4];
    zero(s);
    for (int d0 = 0; d0 < dim; d0 += kDepth) {
      __syncthreads();  // every read of the previous slice (or V) is done
      load_async<T, kBlockM, kDepth>(q_s, LD, qg, qs, S - q0, d0, dim);
      load_async<T, kKeys, kDepth>(k_s, LD, kg + (size_t)k0 * ks, ks,
                                   S - k0, d0, dim);
      if (d0 == 0) load_key_flags(flags, p, b, k0, kKeys);
      cp_async_wait_all();
      __syncthreads();
      warp_mma<true, NT, kDepth>(s, q_s + warp * 16 * LD, LD, k_s, LD);
    }
    fwd_softmax_tile(p, tile_full(p, q0, kBlockM, k0, kKeys), s, m, l, acc,
                     flags, row0, k0, t);
    tiles_to_smem<T>(pw, LDP, s);
    __syncthreads();  // Q and K slices read by every warp: V goes there
    load_async<T, kKeys, kChunk>(v_s, LDV, vg + (size_t)k0 * ks, ks, S - k0,
                                 col0, dim);
    cp_async_wait_all();
    __syncthreads();
    warp_mma<false, DT, kKeys>(acc, pw, LDP, v_s, LDV);
  }
  store_rows<T, DT>(static_cast<T*>(p.out) + (size_t)b * S * qs +
                        (size_t)h * dim + col0,
                    qs, row0, S, dim - col0, acc, t,
                    l[0] == 0.f ? 0.f : 1.f / l[0],
                    l[1] == 0.f ? 0.f : 1.f / l[1]);
  if (col0 == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + j * 8;
      if (row < S)
        p.lse_out[((size_t)b * p.heads + h) * S + row] =
            l[j] == 0.f ? kNegInf : (m[j] + log2f(l[j])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (64 q rows x kChunk columns of dq, head, example). Per
// live key tile: S and dP over D slices (Q, dO, K, V slices staged
// together), dS to shared memory, then the tile's K columns of the chunk
// (over the slices' space) and dQ += dS K.
// ---------------------------------------------------------------------------

template <typename T>
size_t dq_smem() {
  constexpr int LD = kDepth + pad<T>(), LDK = kChunk + pad<T>();
  constexpr int LDP = kKeys + pad<T>();
  constexpr size_t stage = (size_t)(2 * kBlockM + 2 * kKeys) * LD;
  constexpr size_t ktile = (size_t)kKeys * LDK;
  return sizeof(T) * ((stage > ktile ? stage : ktile) +
                      (size_t)kBlockM * LDP) +
         kKeys;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dq_kernel(Params p) {
  constexpr int LD = kDepth + pad<T>(), LDK = kChunk + pad<T>();
  constexpr int LDP = kKeys + pad<T>();
  constexpr int NT = kKeys / 8, DT = kChunk / 8;
  constexpr size_t stage = (size_t)(2 * kBlockM + 2 * kKeys) * LD;
  constexpr size_t ktile = (size_t)kKeys * LDK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [kBlockM][LD]
  T* do_s = q_s + kBlockM * LD;         // [kBlockM][LD]
  T* k_s = do_s + kBlockM * LD;         // [kKeys][LD]
  T* v_s = k_s + kKeys * LD;            // [kKeys][LD]
  T* kc_s = q_s;                        // [kKeys][LDK], over the slices
  T* ds_s = q_s + (stage > ktile ? stage : ktile);  // [kBlockM][LDP]
  uint8_t* flags = reinterpret_cast<uint8_t*>(ds_s + kBlockM * LDP);

  const int S = p.seq, dim = p.dim;
  const int nc = chunks(dim), tiles = (S + kBlockM - 1) / kBlockM;
  const int q0 = (tiles - 1 - static_cast<int>(blockIdx.x) / nc) * kBlockM;
  const int col0 = (static_cast<int>(blockIdx.x) % nc) * kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = (lane & 3) * 2;
  const size_t qs = (size_t)p.heads * dim, ks = (size_t)p.kv_heads * dim;
  const size_t qoff = ((size_t)b * S + q0) * qs + (size_t)h * dim;
  const T* qg = static_cast<const T*>(p.q) + qoff;
  const T* dog = static_cast<const T*>(p.dout) + qoff;
  const T* kg = static_cast<const T*>(p.k) + (size_t)b * S * ks +
                (size_t)hk * dim;
  const T* vg = static_cast<const T*>(p.v) + (size_t)b * S * ks +
                (size_t)hk * dim;

  const int row0 = q0 + warp * 16 + (lane >> 2);
  float lse[2], delta[2];  // lse in log2 units
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + j * 8;
    const size_t idx = ((size_t)b * p.heads + h) * S + row;
    lse[j] = row < S ? p.lse_in[idx] * kLog2e : 0.f;
    delta[j] = row < S ? p.delta[idx] : 0.f;
  }
  float acc[DT][4];
  zero(acc);
  T* dsw = ds_s + warp * 16 * LDP;

  for (int k0 = 0; k0 < S; k0 += kKeys) {
    if (!tile_live(p, q0, kBlockM, k0, kKeys)) continue;
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    for (int d0 = 0; d0 < dim; d0 += kDepth) {
      __syncthreads();
      load_async<T, kBlockM, kDepth>(q_s, LD, qg, qs, S - q0, d0, dim);
      load_async<T, kBlockM, kDepth>(do_s, LD, dog, qs, S - q0, d0, dim);
      load_async<T, kKeys, kDepth>(k_s, LD, kg + (size_t)k0 * ks, ks,
                                   S - k0, d0, dim);
      load_async<T, kKeys, kDepth>(v_s, LD, vg + (size_t)k0 * ks, ks,
                                   S - k0, d0, dim);
      if (d0 == 0) load_key_flags(flags, p, b, k0, kKeys);
      cp_async_wait_all();
      __syncthreads();
      warp_mma<true, NT, kDepth>(s, q_s + warp * 16 * LD, LD, k_s, LD);
      warp_mma<true, NT, kDepth>(dp, do_s + warp * 16 * LD, LD, v_s, LD);
    }
    dq_ds_tile(p, tile_full(p, q0, kBlockM, k0, kKeys), s, dp, flags, row0,
               k0, 0, t, lse, delta);
    tiles_to_smem<T>(dsw, LDP, s);
    __syncthreads();
    load_async<T, kKeys, kChunk>(kc_s, LDK, kg + (size_t)k0 * ks, ks, S - k0,
                                 col0, dim);
    cp_async_wait_all();
    __syncthreads();
    warp_mma<false, DT, kKeys>(acc, dsw, LDP, kc_s, LDK);
  }
  store_rows<T, DT>(static_cast<T*>(p.dq) + (size_t)b * S * qs +
                        (size_t)h * dim + col0,
                    qs, row0, S, dim - col0, acc, t);
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (kKeys keys x kChunk columns of dk and dv, kv head,
// example), looping over every q head of its GQA group and every live
// tile of kTq q rows (the group sum lands in the block's accumulators: no
// atomics). Per q tile: S^T = K Q^T and dP^T = V dO^T over D slices (K, V,
// Q, dO slices staged together), P^T and dS^T to shared memory, then the
// tile's dO and Q columns of the chunk (over the slices' space) and dV +=
// P^T dO, dK += dS^T Q.
// ---------------------------------------------------------------------------

template <typename T>
size_t dkdv_smem() {
  constexpr int LD = kDepth + pad<T>(), LDC = kChunk + pad<T>();
  constexpr int LDQ = kTq + pad<T>();
  constexpr size_t stage = (size_t)(2 * kKeys + 2 * kTq) * LD;
  constexpr size_t qtile = (size_t)2 * kTq * LDC;
  return sizeof(T) * ((stage > qtile ? stage : qtile) +
                      (size_t)2 * kKeys * LDQ) +
         sizeof(float) * 2 * kTq + kKeys;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dkdv_kernel(Params p) {
  constexpr int LD = kDepth + pad<T>(), LDC = kChunk + pad<T>();
  constexpr int LDQ = kTq + pad<T>();
  constexpr int NQ = kTq / 8, DT = kChunk / 8;
  constexpr size_t stage = (size_t)(2 * kKeys + 2 * kTq) * LD;
  constexpr size_t qtile = (size_t)2 * kTq * LDC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);  // [kKeys][LD]
  T* v_s = k_s + kKeys * LD;            // [kKeys][LD]
  T* q_s = v_s + kKeys * LD;            // [kTq][LD]
  T* do_s = q_s + kTq * LD;             // [kTq][LD]
  T* qc_s = k_s;                        // [kTq][LDC], over the slices
  T* doc_s = qc_s + kTq * LDC;          // [kTq][LDC]
  T* pt_s = k_s + (stage > qtile ? stage : qtile);  // [kKeys][LDQ] P^T
  T* dst_s = pt_s + kKeys * LDQ;                     // [kKeys][LDQ] dS^T
  float* lse_s = reinterpret_cast<float*>(dst_s + kKeys * LDQ);  // log2
  float* delta_s = lse_s + kTq;
  uint8_t* flags = reinterpret_cast<uint8_t*>(delta_s + kTq);

  const int S = p.seq, dim = p.dim;
  const int nc = chunks(dim);
  // Ascending key tiles: under causal masking the first see most q rows.
  const int k0 = (static_cast<int>(blockIdx.x) / nc) * kKeys;
  const int col0 = (static_cast<int>(blockIdx.x) % nc) * kChunk;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = (lane & 3) * 2;
  const size_t qs = (size_t)p.heads * dim, ks = (size_t)p.kv_heads * dim;
  const size_t koff = ((size_t)b * S + k0) * ks + (size_t)hk * dim;
  const T* kg = static_cast<const T*>(p.k) + koff;
  const T* vg = static_cast<const T*>(p.v) + koff;
  load_key_flags(flags, p, b, k0, kKeys);  // read after the first sync

  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);
  const int key0 = k0 + warp * 16 + (lane >> 2);  // keys key0, key0 + 8
  T* ptw = pt_s + warp * 16 * LDQ;
  T* dstw = dst_s + warp * 16 * LDQ;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const T* qg = static_cast<const T*>(p.q) + (size_t)b * S * qs +
                  (size_t)h * dim;
    const T* dog = static_cast<const T*>(p.dout) + (size_t)b * S * qs +
                   (size_t)h * dim;
    const float* lseg = p.lse_in + ((size_t)b * p.heads + h) * S;
    const float* deltag = p.delta + ((size_t)b * p.heads + h) * S;
    for (int q0 = 0; q0 < S; q0 += kTq) {
      if (!tile_live(p, q0, kTq, k0, kKeys)) continue;
      float s[NQ][4], dp[NQ][4];
      zero(s);
      zero(dp);
      for (int d0 = 0; d0 < dim; d0 += kDepth) {
        __syncthreads();
        load_async<T, kKeys, kDepth>(k_s, LD, kg, ks, S - k0, d0, dim);
        load_async<T, kKeys, kDepth>(v_s, LD, vg, ks, S - k0, d0, dim);
        load_async<T, kTq, kDepth>(q_s, LD, qg + (size_t)q0 * qs, qs,
                                   S - q0, d0, dim);
        load_async<T, kTq, kDepth>(do_s, LD, dog + (size_t)q0 * qs, qs,
                                   S - q0, d0, dim);
        if (d0 == 0) {
          for (int i = threadIdx.x; i < kTq; i += kThreads) {
            lse_s[i] = q0 + i < S ? lseg[q0 + i] * kLog2e : 0.f;
            delta_s[i] = q0 + i < S ? deltag[q0 + i] : 0.f;
          }
        }
        cp_async_wait_all();
        __syncthreads();
        warp_mma<true, NQ, kDepth>(s, k_s + warp * 16 * LD, LD, q_s, LD);
        warp_mma<true, NQ, kDepth>(dp, v_s + warp * 16 * LD, LD, do_s, LD);
      }
      dkdv_pds_tile(p, tile_full(p, q0, kTq, k0, kKeys), s, dp, flags, key0,
                    k0, q0, 0, t, lse_s, delta_s);
      tiles_to_smem<T>(ptw, LDQ, s);
      tiles_to_smem<T>(dstw, LDQ, dp);
      __syncthreads();  // the slices are read: dO and Q columns go there
      load_async<T, kTq, kChunk>(qc_s, LDC, qg + (size_t)q0 * qs, qs, S - q0,
                                 col0, dim);
      load_async<T, kTq, kChunk>(doc_s, LDC, dog + (size_t)q0 * qs, qs,
                                 S - q0, col0, dim);
      cp_async_wait_all();
      __syncthreads();
      warp_mma<false, DT, kTq>(dv, ptw, LDQ, doc_s, LDC);
      warp_mma<false, DT, kTq>(dk, dstw, LDQ, qc_s, LDC);
    }
  }
  const size_t kvoff = (size_t)b * S * ks + (size_t)hk * dim + col0;
  store_rows<T, DT>(static_cast<T*>(p.dk) + kvoff, ks, key0, S, dim - col0,
                    dk, t);
  store_rows<T, DT>(static_cast<T*>(p.dv) + kvoff, ks, key0, S, dim - col0,
                    dv, t);
}

template <typename T>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  static uint64_t done[3] = {0, 0, 0};  // forward, dq, dk/dv
  void (*kernel)(Params);
  size_t smem;
  dim3 grid;
  const int nc = chunks(p.dim);
  if (which == kForward) {
    kernel = wide_fwd_kernel<T>;
    smem = fwd_smem<T>();
    grid = dim3((p.seq + kBlockM - 1) / kBlockM * nc, p.heads, p.batch);
  } else if (which == kDq) {
    kernel = wide_dq_kernel<T>;
    smem = dq_smem<T>();
    grid = dim3((p.seq + kBlockM - 1) / kBlockM * nc, p.heads, p.batch);
  } else {
    kernel = wide_dkdv_kernel<T>;
    smem = dkdv_smem<T>();
    grid = dim3((p.seq + kKeys - 1) / kKeys * nc, p.kv_heads, p.batch);
  }
  const cudaError_t err = allow_smem(kernel, smem, done[which]);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(int which, int kind, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dim <= 256 || p.dim % 8 != 0 || p.batch <= 0 || p.seq <= 0 ||
      p.kv_heads <= 0 || p.heads % p.kv_heads != 0 ||
      p.heads / p.kv_heads > 65535 || p.heads > 65535 || p.batch > 65535)
    return cudaErrorInvalidValue;
  if (kind == 1) return launch<bf16>(which, p, s);
  if (kind == 0) return launch<float>(which, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace
