// The f32 flash-attention kernels (the tests' oracle runs), with the plain
// C interface of flash_common.cuh (kind 0); the bf16 kernels, and the
// design of both, are in flash_attention.cu. Replaces, in f32, the Pallas
// TPU kernels _fwd_kernel (cloud_tpu/ops/attention.py:179), _dq_kernel
// (:345) and _dkdv_kernel (:383). Four warps, 64 x 64 tiles (keys of 32
// in dq at D 256; 32 q rows per inner dk/dv tile at D 128 and 256; at D
// 256 two blocks per output tile, each summing half of its columns), each
// product computed in f32 FMAs from shared memory in the mma fragment
// layout, its k loop rolled (these kernels check, they are not timed, and
// the unrolled code took most of the build), P and dS passed through
// shared memory; the per-element steps are the bf16 kernels' own. A
// head_dim below the template width is read with zero columns past it
// (load_tile) and written only up to it (store_rows), as in the bf16
// kernels.

#include "flash_common.cuh"

namespace {

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
// or past `valid`, and columns at or past `cols` (head_dim, a multiple of
// 8, below the template width D), are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          size_t stride, int rows, int valid,
                                          int cols) {
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    int4 x = make_int4(0, 0, 0, 0);
    if (r < valid && c < cols)
      x = *reinterpret_cast<const int4*>(src + r * stride + c);
    *reinterpret_cast<int4*>(dst + r * ld + c) = x;
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

// Output columns a block sums: all D, and half at D 256, where two blocks
// share each output tile, each computing the scores over the whole D, so
// that its accumulators stay those of D 128 (registers, and build time).
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D == 256 ? 128 : D;
}

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
  constexpr int NT = kBlockN / 8, DT = out_cols<D>() / 8;
  constexpr int kSplits = D / out_cols<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kBlockM][LD]
  float* k_s = q_s + kBlockM * LD;              // [kBlockN][LD]
  float* v_s = k_s + kBlockN * LD;              // [kBlockN][LD]
  float* p_s = v_s + kBlockN * LD;              // [kBlockM][LDP]
  uint8_t* flags = reinterpret_cast<uint8_t*>(p_s + kBlockM * LDP);

  const int S = p.seq;
  const int q0 = (blockIdx.x / kSplits) * kBlockM, h = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = (blockIdx.x % kSplits) * out_cols<D>();
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int dim = p.dim;
  const size_t qs = (size_t)p.heads * dim, ks = (size_t)p.kv_heads * dim;
  const float* kg =
      static_cast<const float*>(p.k) + (size_t)b * S * ks + (size_t)hk * dim;
  const float* vg =
      static_cast<const float*>(p.v) + (size_t)b * S * ks + (size_t)hk * dim;
  load_tile<D>(q_s, LD,
               static_cast<const float*>(p.q) + ((size_t)b * S + q0) * qs +
                   (size_t)h * dim,
               qs, kBlockM, S - q0, dim);

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
    load_tile<D>(k_s, LD, kg + k0 * ks, ks, kBlockN, S - k0, dim);
    load_tile<D>(v_s, LD, vg + k0 * ks, ks, kBlockN, S - k0, dim);
    load_key_flags(flags, p, b, k0, kBlockN);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < D; kk += 16)
        mma_16x8x16<true>(s[n], qw + kk, LD, k_s + n * 8 * LD + kk, LD);
    }
    fwd_softmax_tile(p, tile_full(p, q0, kBlockM, k0, kBlockN), s, m, l, acc,
                     flags, row0, k0, t);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pw[(g + (i >> 1) * 8) * LDP + n * 8 + t + (i & 1)] = s[n][i];
    __syncwarp();  // each warp reads back only its own rows of P
#pragma unroll
    for (int d = 0; d < DT; ++d) {
#pragma unroll 1
      for (int kk = 0; kk < kBlockN; kk += 16)
        mma_16x8x16<false>(acc[d], pw + kk, LDP,
                           v_s + kk * LD + col0 + d * 8, LD);
    }
  }
  fwd_store<float, DT>(p, b, h, row0, acc, m, l, lane, col0);
}

// Keys per tile of the f32 dq: 64, and 32 at D 256 (shared memory).
template <int D>
__host__ __device__ constexpr int dq_tile_k() {
  return D == 256 ? 32 : kBlockN;
}

template <int D>
size_t dq_smem() {
  constexpr int BN = dq_tile_k<D>();
  constexpr int LD = D + kPad, LDP = BN + kPad;
  return sizeof(float) * ((size_t)(2 * kBlockM + 2 * BN) * LD +
                          (size_t)kBlockM * LDP) +
         BN;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  constexpr int BN = dq_tile_k<D>();
  constexpr int LD = D + kPad, LDP = BN + kPad;
  constexpr int NT = BN / 8, DT = out_cols<D>() / 8;
  constexpr int kSplits = D / out_cols<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kBlockM][LD]
  float* do_s = q_s + kBlockM * LD;             // [kBlockM][LD]
  float* k_s = do_s + kBlockM * LD;             // [BN][LD]
  float* v_s = k_s + BN * LD;                   // [BN][LD]
  float* ds_s = v_s + BN * LD;                  // [kBlockM][LDP]
  uint8_t* flags = reinterpret_cast<uint8_t*>(ds_s + kBlockM * LDP);

  const int S = p.seq;
  const int q0 = (blockIdx.x / kSplits) * kBlockM, h = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = (blockIdx.x % kSplits) * out_cols<D>();
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int dim = p.dim;
  const size_t qs = (size_t)p.heads * dim, ks = (size_t)p.kv_heads * dim;
  const size_t qoff = ((size_t)b * S + q0) * qs + (size_t)h * dim;
  const float* kg =
      static_cast<const float*>(p.k) + (size_t)b * S * ks + (size_t)hk * dim;
  const float* vg =
      static_cast<const float*>(p.v) + (size_t)b * S * ks + (size_t)hk * dim;
  load_tile<D>(q_s, LD, static_cast<const float*>(p.q) + qoff, qs, kBlockM,
               S - q0, dim);
  load_tile<D>(do_s, LD, static_cast<const float*>(p.dout) + qoff, qs,
               kBlockM, S - q0, dim);

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

  for (int k0 = 0; k0 < S; k0 += BN) {
    if (!tile_live(p, q0, kBlockM, k0, BN)) continue;
    __syncthreads();
    load_tile<D>(k_s, LD, kg + k0 * ks, ks, BN, S - k0, dim);
    load_tile<D>(v_s, LD, vg + k0 * ks, ks, BN, S - k0, dim);
    load_key_flags(flags, p, b, k0, BN);
    __syncthreads();
    const bool full = tile_full(p, q0, kBlockM, k0, BN);

    // 16 keys at a time: S and dP for them, then dS into shared memory.
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll 1
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
#pragma unroll 1
      for (int kk = 0; kk < BN; kk += 16)
        mma_16x8x16<false>(acc[d], dsw + kk, LDP,
                           k_s + kk * LD + col0 + d * 8, LD);
    }
  }
  store_rows<float, DT>(
      static_cast<float*>(p.dq) + (size_t)b * S * qs + (size_t)h * dim + col0,
      qs, row0, S, dim - col0, acc, t);
}

// q rows per inner tile of the f32 dk/dv: 64 at D 64, 32 at D 128 and 256
// (registers: its S^T and dP^T tiles and the dk, dv accumulators).
template <int D>
__host__ __device__ constexpr int dkdv_tile_q() {
  return D == 64 ? 64 : 32;
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
  constexpr int NQ = TQ / 8, DT = out_cols<D>() / 8;
  constexpr int kSplits = D / out_cols<D>();
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
  const int k0 = (blockIdx.x / kSplits) * kBlockN, hk = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = (blockIdx.x % kSplits) * out_cols<D>();
  const int group = p.heads / p.kv_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int dim = p.dim;
  const size_t qs = (size_t)p.heads * dim, ks = (size_t)p.kv_heads * dim;
  const size_t koff = ((size_t)b * S + k0) * ks + (size_t)hk * dim;
  load_tile<D>(k_s, LD, static_cast<const float*>(p.k) + koff, ks, kBlockN,
               S - k0, dim);
  load_tile<D>(v_s, LD, static_cast<const float*>(p.v) + koff, ks, kBlockN,
               S - k0, dim);
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
    const float* qg =
        static_cast<const float*>(p.q) + (size_t)b * S * qs + (size_t)h * dim;
    const float* dog = static_cast<const float*>(p.dout) + (size_t)b * S * qs +
                       (size_t)h * dim;
    const float* lseg = p.lse_in + ((size_t)b * p.heads + h) * S;
    const float* deltag = p.delta + ((size_t)b * p.heads + h) * S;
    for (int q0 = 0; q0 < S; q0 += TQ) {
      if (!tile_live(p, q0, TQ, k0, kBlockN)) continue;
      __syncthreads();  // every read of the previous q tile is done
      load_tile<D>(q_s, LD, qg + q0 * qs, qs, TQ, S - q0, dim);
      load_tile<D>(do_s, LD, dog + q0 * qs, qs, TQ, S - q0, dim);
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
#pragma unroll 1
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
#pragma unroll 1
        for (int kk = 0; kk < TQ; kk += 16) {
          mma_16x8x16<false>(dv[d], ptw + kk, LDQ,
                             do_s + kk * LD + col0 + d * 8, LD);
          mma_16x8x16<false>(dk[d], dstw + kk, LDQ,
                             q_s + kk * LD + col0 + d * 8, LD);
        }
      }
    }
  }
  const size_t kvoff = (size_t)b * S * ks + (size_t)hk * dim + col0;
  store_rows<float, DT>(static_cast<float*>(p.dk) + kvoff, ks, key0, S,
                        dim - col0, dk, t);
  store_rows<float, DT>(static_cast<float*>(p.dv) + kvoff, ks, key0, S,
                        dim - col0, dv, t);
}

template <int D>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  static uint64_t done[3] = {0, 0, 0};  // forward, dq, dk/dv
  void (*kernel)(Params);
  size_t smem;
  dim3 grid;
  if (which == kForward) {
    kernel = flash_fwd_kernel<D>;
    smem = fwd_smem<D>();
    grid = dim3((p.seq + kBlockM - 1) / kBlockM * (D / out_cols<D>()),
                p.heads, p.batch);
  } else if (which == kDq) {
    kernel = flash_dq_kernel<D>;
    smem = dq_smem<D>();
    grid = dim3((p.seq + kBlockM - 1) / kBlockM * (D / out_cols<D>()),
                p.heads, p.batch);
  } else {
    kernel = flash_dkdv_kernel<D>;
    smem = dkdv_smem<D>();
    grid = dim3((p.seq + kBlockN - 1) / kBlockN * (D / out_cols<D>()),
                p.kv_heads, p.batch);
  }
  const cudaError_t err = allow_smem(kernel, smem, done[which]);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(int which, int kind, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = template_width(p.dim);
  if (kind != 0 || width == 0 || p.batch <= 0 || p.seq <= 0 ||
      p.kv_heads <= 0 || p.heads % p.kv_heads != 0)
    return cudaErrorInvalidValue;
  if (width == 64) return launch<64>(which, p, s);
  if (width == 128) return launch<128>(which, p, s);
  return launch<256>(which, p, s);
}

}  // namespace
