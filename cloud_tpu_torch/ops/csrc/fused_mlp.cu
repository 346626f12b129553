// Fused gated MLP (SwiGLU / GeGLU) for Hopper (sm_90a), with a plain C
// interface (bound from Python with ctypes: cloud_tpu_torch/ops/fused_mlp.py).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of cloud_tpu/ops/fused_mlp.py
// (:96, called from `_swiglu_forward` :106 at :115):
//   y = (act(x Wg) * (x Wu)) Wd
// with act silu, gelu_tanh or gelu (erf).
//
// Layouts (the port's [out, in] weights, row-major):
//   x  [M, D]    Wg, Wu [F, D]    Wd [D_out, F]    a [M, F]    y [M, D_out]
// so both products are A . B^T with both operands contiguous along the
// reduced dimension ("TN"), which is wgmma's K-major layout for both bf16
// operands: nothing is transposed. bf16 or f32 (all one type); D, F and
// D_out multiples of 8; any M; every pointer 16-byte aligned (TMA's rule).
//
// Design. The TPU kernel keeps all three weights resident in VMEM and
// streams row blocks through them, so the [rows, F] intermediates never
// touch HBM. Hopper's 227 KB of shared memory cannot hold the weights
// (3 x 2048 x 5632 bf16 = 69 MB at TinyLlama's widths), nor a row block's
// [64, 5632] intermediate, so the work is two kernels:
//   (a) gate|up: a tile is 128 rows by the same 128 columns of g = x Wg^T
//       and u = x Wu^T, one x tile feeding both products; its epilogue
//       rounds g and u to the compute dtype, applies act, rounds,
//       multiplies and rounds (the rounding points of the plain version
//       `swiglu_reference`) and writes a = act(g) * u.
//   (b) down: y = a Wd^T, 128 x 256 tiles.
// The two kernels move a [M, F] intermediate through device memory (92 MB
// written and read again at M 8192, F 5632, bf16), which the TPU kernel
// avoids; at these shapes the products bound the work (5.67e11 flop, 0.573
// ms at 989 TFLOP/s against ~0.08 ms for all the bytes), so that traffic
// costs little and the tensor cores' rate is what counts.
//   - bf16 (the training path): one GEMM for both kernels, built for the
//     card (sm90.cuh holds its primitives). Only wgmma reaches the tensor
//     cores' full rate, so each tile is 128 rows x 256 weight rows (down:
//     256 columns of Wd; gate|up: 128 of Wg stacked on the same 128 of Wu,
//     so g and u of an element land in one thread of one m64n256
//     accumulator). TMA loads 64-deep k tiles (128 bytes, 128-byte
//     swizzled) into a 4-stage ring of 48 KB stages with a full and an
//     empty mbarrier each, zero-filling past M, N and K, so the mainloop
//     has no masks. Three warpgroups, one block per SM: a producer (one
//     thread issues the loads; its registers lowered to 40 with setmaxnreg)
//     and two consumers (raised to 232), each running m64n256k16 wgmma on
//     its 64 rows from shared memory, one group in flight, releasing a
//     stage when the wgmmas that read it have retired. The grid is
//     min(tiles, SMs) persistent blocks walking tiles in bands of 8 M tiles
//     swept along N (weight tiles reused from L2); the producer loads the
//     next tile while the consumers run the epilogue: stmatrix into two
//     swizzled 64 x 64 staging buffers per consumer, in turn, each sent
//     out by a TMA store, which clips at M and N.
//   - f32 (the tests' oracle runs): [128, 128] tiles, eight warps as 2 (M)
//     x 4 (N), each product computed in f32 FMAs from shared memory in the
//     mma.sync m16n8 accumulator layout (no TF32), with synchronous loads;
//     the same rounding points in the epilogue.
// Bound at the main shape (rows 8192, D 2048, F 5632): gate|up 0.382 ms,
// down 0.191 ms of products at 989 TFLOP/s (PERF.md has the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// f32 tiles.
constexpr int kThreads = 256;    // 8 warps: 2 along M x 4 along N
constexpr int kBM = 128;         // rows of x (or a) per block
constexpr int kBRows = 128;      // rows of weights per block, over all matrices
constexpr int kBKF = 16;         // k tile
constexpr int kLdf = kBKF + 4;   // shared row stride

enum Act { kSilu = 0, kGeluTanh = 1, kGelu = 2 };

template <int ACT>
__device__ __forceinline__ float activation(float x) {
  if constexpr (ACT == kSilu) return x / (1.f + expf(-x));
  if constexpr (ACT == kGeluTanh) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// x rounded to T's precision.
__device__ __forceinline__ float rnd(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rnd(float x, const float*) { return x; }

__device__ __forceinline__ void store2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

// One output element from its products: NMAT == 2, a = rnd(rnd(act(rnd(g)))
// * rnd(u)) (the plain version's rounding points; the store rounds the
// product); NMAT == 1, the product g itself. C is the output, for its type.
template <int NMAT, int ACT, typename T>
__device__ __forceinline__ float out_value(float g, float u, const T* C) {
  if constexpr (NMAT == 2)
    return rnd(activation<ACT>(rnd(g, C)), C) * rnd(u, C);
  return g;
}

// The f32 epilogue: this lane's accumulators of the warp's 64-row slice (4
// m16 tiles) and NT n8 tiles per matrix, in the m16n8 layout (c[0], c[1] on
// row g, columns t, t + 1; c[2], c[3] on row g + 8); g in acc[.][n] and u
// in acc[.][NT + n]. C is [M, N] row-major.
template <int NMAT, int NT, int ACT>
__device__ __forceinline__ void epilogue_f32(
    float* C, int M, int N, int row_base, int col_base,
    const float (&acc)[4][NMAT * NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_base + mi * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int col = col_base + ni * 8 + t;
        if (col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = out_value<NMAT, ACT>(
              acc[mi][ni][half * 2 + e],
              acc[mi][(NMAT - 1) * NT + ni][half * 2 + e], C);
        store2(C + (size_t)row * N + col, v[0], v[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: a persistent, warp-specialised wgmma GEMM fed by TMA.
// ---------------------------------------------------------------------------

constexpr int kWg = 128;             // threads per warpgroup
constexpr int kHThreads = 3 * kWg;   // producer + two consumers
constexpr int kHBM = 128;            // rows of x (or a) per tile
constexpr int kHBRows = 256;         // weight rows per tile, over all matrices
constexpr int kHBK = 64;             // k tile: 128 bytes, one swizzle span
constexpr int kHStages = 4;          // TMA ring
constexpr int kBand = 8;             // M tiles per band of the raster
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kStageA = kHBM * kHBK * sizeof(bf16);       // 16 KB
constexpr uint32_t kStageB = kHBRows * kHBK * sizeof(bf16);    // 32 KB
constexpr uint32_t kStageC = 64 * 64 * sizeof(bf16);           // 8 KB
// The ring, two output staging buffers per consumer, the ring's full and
// empty barriers, and slack to align it all to 1024 bytes.
constexpr size_t kHSmem = kHStages * (kStageA + kStageB) + 4 * kStageC +
                          2 * kHStages * sizeof(uint64_t) + 1024;

// Output tile t of a grid of m_tiles x n_tiles, in bands of kBand M tiles
// swept along N, so the blocks in flight share weight tiles in L2.
__device__ __forceinline__ void tile_at(int t, int m_tiles, int n_tiles,
                                        int& mt, int& nt) {
  const int per_band = kBand * n_tiles;
  const int band = t / per_band, first = band * kBand;
  const int height = min(m_tiles - first, kBand);
  const int r = t - band * per_band;
  mt = first + r % height;
  nt = r / height;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C[M, N] = epilogue(A[M, K] . Bj[N, K]^T for j < NMAT), bf16. Each tile
// is 128 rows by 256 weight rows: for NMAT == 1, 256 columns of B0; for
// NMAT == 2, the same 128 columns of B0 and of B1, stacked, so that one
// m64n256 accumulator holds g in its n8 tiles 0-15 and u in 16-31, each
// element's g and u in the same thread. Warpgroup 0 produces: one thread
// keeps the ring full with TMA loads. Warpgroups 1 and 2 consume: each
// multiplies its 64 rows of the tile with wgmma from the ring, releases a
// stage once the wgmmas that read it have retired, and stores its rows
// in the epilogue while the producer already loads the next tile.
template <int NMAT, int ACT>
__global__ void __launch_bounds__(kHThreads, 1)
    gemm_bf16(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b0,
              const __grid_constant__ CUtensorMap map_b1,
              const __grid_constant__ CUtensorMap map_c, int M, int N,
              int K) {
  constexpr int BN = kHBRows / NMAT;  // output columns per tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sa = reinterpret_cast<bf16*>(smem);  // [stage][kHBM][kHBK]
  bf16* sb = reinterpret_cast<bf16*>(smem + kHStages * kStageA);
  // [consumer][2][64][64], 128-byte swizzled
  bf16* sc = reinterpret_cast<bf16*>(smem + kHStages * (kStageA + kStageB));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kHStages * (kStageA + kStageB) + 4 * kStageC);
  uint64_t* empty = full + kHStages;

  const int m_tiles = (M + kHBM - 1) / kHBM;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int ktiles = (K + kHBK - 1) / kHBK;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * kWg / 32);  // every consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        tile_at(t, m_tiles, n_tiles, mt, nt);
        const int m0 = mt * kHBM, n0 = nt * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          sm90::mbar_arrive_expect_tx(&full[stage], kStageA + kStageB);
          const int k0 = kt * kHBK;
          bf16* b = sb + stage * kHBRows * kHBK;
          sm90::tma_load_2d(sa + stage * kHBM * kHBK, &map_a, &full[stage],
                            k0, m0);
          sm90::tma_load_2d(b, &map_b0, &full[stage], k0, n0);
          sm90::tma_load_2d(b + 128 * kHBK, NMAT == 2 ? &map_b1 : &map_b0,
                            &full[stage], k0, NMAT == 2 ? n0 : n0 + 128);
          if (++stage == kHStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int half_rows = (wg - 1) * 64;  // this warpgroup's rows of a tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool issuer = threadIdx.x % kWg == 0;  // issues the TMA stores
    float acc[128];
    int stage = 0, chunks = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      tile_at(t, m_tiles, n_tiles, mt, nt);
      int held = -1;  // the stage the wgmmas in flight read
      for (int kt = 0; kt < ktiles; ++kt) {
        sm90::mbar_wait(&full[stage], phase);
        const uint64_t da = sm90::desc_k128(sa + stage * kHBM * kHBK +
                                            half_rows * kHBK);
        const uint64_t db = sm90::desc_k128(sb + stage * kHBRows * kHBK);
#pragma unroll
        for (int i = 0; i < 128; ++i) sm90::fence_operand(acc[i]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHBK / 16; ++kk)
          sm90::wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk,
                                 kt > 0 || kk > 0);
        sm90::wgmma_commit();
#pragma unroll
        for (int i = 0; i < 128; ++i) sm90::fence_operand(acc[i]);
        sm90::wgmma_wait<1>();  // the previous k tile's group has retired
        if (held >= 0 && lane == 0) sm90::mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == kHStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) sm90::fence_operand(acc[i]);
      if (lane == 0) sm90::mbar_arrive(&empty[held]);

      // Epilogue: the tile's values rounded to bf16, 64 columns at a time,
      // through this warpgroup's two 64 x 64 staging buffers in turn
      // (stmatrix, 128-byte swizzled as the map of C reads them) into TMA
      // stores, which clip at M and N. For NMAT == 2 each value is
      // rnd(rnd(act(rnd(g))) * rnd(u)).
#pragma unroll
      for (int ch = 0; ch < BN / 64; ++ch, ++chunks) {
        bf16* buf = sc + ((wg - 1) * 2 + (chunks & 1)) * 64 * 64;
        if (issuer) sm90::bulk_wait_read<1>();  // its last store has read it
        sm90::named_barrier(wg, kWg);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // Matrix m of this stmatrix: n8 tile ch * 8 + 2 q + m / 2, rows
          // (m % 2) * 8 + 0..7 of this warp's 16.
          uint32_t r[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = (ch * 8 + 2 * q + m / 2) * 4 + (m % 2) * 2;
            const int iu = i + (NMAT - 1) * 64;
            const bf16* type = nullptr;
            r[m] = pack_bf16(out_value<NMAT, ACT>(acc[i], acc[iu], type),
                             out_value<NMAT, ACT>(acc[i + 1], acc[iu + 1],
                                                  type));
          }
          const int m = lane / 8;
          const int row = warp * 16 + (m % 2) * 8 + lane % 8;
          sm90::stmatrix_x4(buf + row * 64 + ((2 * q + m / 2) ^ (row % 8)) * 8,
                            r);
        }
        sm90::fence_proxy_async();
        sm90::named_barrier(wg, kWg);
        if (issuer) {
          sm90::tma_store_2d(&map_c, buf, nt * BN + ch * 64,
                             mt * kHBM + half_rows);
          sm90::bulk_commit();
        }
      }
    }
    if (issuer) sm90::bulk_wait<0>();
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int NMAT, int ACT>
cudaError_t launch_bf16(const void* A, const void* B0, const void* B1,
                        void* C, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap map_a, map_b0, map_b1, map_c;
  if (!sm90::make_map_bf16(&map_a, A, M, K, kHBM) ||
      !sm90::make_map_bf16(&map_b0, B0, N, K, 128) ||
      !sm90::make_map_bf16(&map_b1, B1, N, K, 128) ||
      !sm90::make_map_bf16(&map_c, C, M, N, 64))
    return cudaErrorInvalidValue;
  constexpr int BN = kHBRows / NMAT;
  const int tiles = ((M + kHBM - 1) / kHBM) * ((N + BN - 1) / BN);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const cudaError_t err =
      cudaFuncSetAttribute(gemm_bf16<NMAT, ACT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kHSmem);
  if (err != cudaSuccess) return err;
  gemm_bf16<NMAT, ACT><<<tiles < sms ? tiles : sms, kHThreads, kHSmem,
                         stream>>>(
      map_a, map_b0, map_b1, map_c, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 (the tests' oracle runs): products in f32 FMAs from shared memory in
// the mma.sync accumulator layout.
// ---------------------------------------------------------------------------

template <int NMAT, int ACT>
__global__ void __launch_bounds__(kThreads)
    gemm_f32(const float* __restrict__ A, const float* __restrict__ B0,
             const float* __restrict__ B1, float* __restrict__ C, int M, int N,
             int K) {
  constexpr int BN = kBRows / NMAT;
  constexpr int WN = BN / 4;
  constexpr int NT = WN / 8;
  __shared__ __align__(16) float sa[kBM * kLdf];
  __shared__ __align__(16) float sb[kBRows * kLdf];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = (lane & 3) * 2;

  float acc[4][NMAT * NT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int n = 0; n < NMAT * NT; ++n)
      acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;

  constexpr int kChunks = kBKF / 4;  // float4 chunks per row
  for (int k0 = 0; k0 < K; k0 += kBKF) {
    for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M && k0 + c < K)
        v = *reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<float4*>(sa + r * kLdf + c) = v;
    }
    for (int i = threadIdx.x; i < kBRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const int j = r / BN, n = n0 + r % BN;
      const float* B = j ? B1 : B0;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N && k0 + c < K)
        v = *reinterpret_cast<const float4*>(B + (size_t)n * K + k0 + c);
      *reinterpret_cast<float4*>(sb + r * kLdf + c) = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < kBKF; ++k) {
      float a[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        a[mi][0] = sa[(wm * 64 + mi * 16 + g) * kLdf + k];
        a[mi][1] = sa[(wm * 64 + mi * 16 + g + 8) * kLdf + k];
      }
#pragma unroll
      for (int j = 0; j < NMAT; ++j) {
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int n = j * BN + wn * WN + ni * 8 + t;
          const float b0 = sb[n * kLdf + k], b1 = sb[(n + 1) * kLdf + k];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            float* c = acc[mi][j * NT + ni];
            c[0] = fmaf(a[mi][0], b0, c[0]);
            c[1] = fmaf(a[mi][0], b1, c[1]);
            c[2] = fmaf(a[mi][1], b0, c[2]);
            c[3] = fmaf(a[mi][1], b1, c[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  epilogue_f32<NMAT, NT, ACT>(C, M, N, m0 + wm * 64, n0 + wn * WN, acc);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int NMAT, int ACT>
cudaError_t launch(int kind, const void* A, const void* B0, const void* B1,
                   void* C, int M, int N, int K, cudaStream_t stream) {
  if (kind == 1) return launch_bf16<NMAT, ACT>(A, B0, B1, C, M, N, K, stream);
  constexpr int BN = kBRows / NMAT;
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  gemm_f32<NMAT, ACT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(B0),
      static_cast<const float*>(B1), static_cast<float*>(C), M, N, K);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool shapes_ok(int kind, int M, int N, int K) {
  // The f32 grid.y counts column tiles of at least kBRows / 2 columns.
  return (kind == 0 || kind == 1) && M > 0 && N > 0 && K > 0 && N % 8 == 0 &&
         K % 8 == 0 && (N + kBRows / 2 - 1) / (kBRows / 2) <= 65535;
}

}  // namespace

// kind: 0 = f32, 1 = bf16 (every operand one type); act: 0 = silu,
// 1 = gelu_tanh, 2 = gelu (erf). Each returns the launch's cudaError_t
// (0 = ok); an unknown kind or activation, a width that is not a positive
// multiple of 8, rows <= 0, or a pointer that is not 16-byte aligned give
// cudaErrorInvalidValue.

// a [rows, d_ff] = rnd(act(rnd(x Wg^T))) * rnd(x Wu^T).
extern "C" int fused_mlp_gate_up(int kind, int act, const void* x,
                                 const void* w_gate, const void* w_up, void* a,
                                 int rows, int features, int d_ff,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(kind, rows, d_ff, features) || !aligned16(x) ||
      !aligned16(w_gate) || !aligned16(w_up) || !aligned16(a))
    return cudaErrorInvalidValue;
  if (act == kSilu)
    return launch<2, kSilu>(kind, x, w_gate, w_up, a, rows, d_ff, features, s);
  if (act == kGeluTanh)
    return launch<2, kGeluTanh>(kind, x, w_gate, w_up, a, rows, d_ff,
                                features, s);
  if (act == kGelu)
    return launch<2, kGelu>(kind, x, w_gate, w_up, a, rows, d_ff, features, s);
  return cudaErrorInvalidValue;
}

// y [rows, d_out] = a Wd^T.
extern "C" int fused_mlp_down(int kind, const void* a, const void* w_down,
                              void* y, int rows, int d_ff, int d_out,
                              void* stream) {
  if (!shapes_ok(kind, rows, d_out, d_ff) || !aligned16(a) ||
      !aligned16(w_down) || !aligned16(y))
    return cudaErrorInvalidValue;
  return launch<1, kSilu>(kind, a, w_down, w_down, y, rows, d_out, d_ff,
                          static_cast<cudaStream_t>(stream));
}
