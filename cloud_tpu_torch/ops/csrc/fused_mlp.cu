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
// reduced dimension, as mma.sync's row.col form wants them. bf16 or f32
// (all one type); D, F and D_out multiples of 8; any M (ragged tiles are
// bound-checked: loads past an edge are zero-filled, stores are skipped).
//
// Design. The TPU kernel keeps all three weights resident in VMEM and
// streams row blocks through them, so the [rows, F] intermediates never
// touch HBM. Hopper's 227 KB of shared memory cannot hold the weights
// (3 x 2048 x 5632 bf16 = 69 MB at TinyLlama's widths), nor a row block's
// [64, 5632] intermediate, so the work is two kernels:
//   (a) gate|up: each block computes the same [128, 64] tile of g = x Wg^T
//       and u = x Wu^T, loading each x tile once for both products into two
//       f32 accumulators; its epilogue rounds g and u to the compute dtype,
//       applies act, rounds, multiplies and rounds (the rounding points of
//       the plain version `swiglu_reference`) and writes a = act(g) * u.
//   (b) down: y = a Wd^T, [128, 128] tiles.
// The two kernels move a [M, F] intermediate through device memory (92 MB
// written and read again at M 8192, F 5632, bf16), which the TPU kernel
// avoids; at these shapes the products bound the work (5.67e11 flop, 0.573
// ms at 989 TFLOP/s against ~0.08 ms for all the bytes), so that traffic
// costs little.
//   - bf16 (the training path): mma.sync m16n8k16 (bf16 in, f32 accumulate),
//     operands loaded with ldmatrix from shared memory rows padded to 80
//     bytes (conflict-free), a three-stage cp.async ring of 32-wide k tiles,
//     eight warps as 2 (M) x 4 (N), each owning a 64-row slice of the tile.
//   - f32 (the tests' oracle runs): the same tiles and warp layout and the
//     same epilogue, each product computed in f32 FMAs from shared memory in
//     the mma accumulator layout (no TF32), with synchronous loads.
// wgmma, TMA and a persistent schedule are the levers left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;    // 8 warps: 2 along M x 4 along N
constexpr int kBM = 128;         // rows of x (or a) per block
constexpr int kBRows = 128;      // rows of weights per block, over all matrices
constexpr int kBK = 32;          // bf16 k tile
constexpr int kStages = 3;       // bf16 cp.async ring
constexpr int kLds = kBK + 8;    // bf16 shared row stride: 80 bytes
constexpr int kBKF = 16;         // f32 k tile
constexpr int kLdf = kBKF + 4;   // f32 shared row stride

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

__device__ __forceinline__ void store2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void store2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

// The epilogue, shared by both types: this lane's accumulators of the warp's
// 64-row slice (4 m16 tiles) and NT n8 tiles per matrix, in the m16n8
// layout (c[0], c[1] on row g, columns t, t + 1; c[2], c[3] on row g + 8).
// NMAT == 2: a = rnd(rnd(act(rnd(g))) * rnd(u)) with g in acc[.][n] and u
// in acc[.][NT + n]; NMAT == 1: the product itself. C is [M, N] row-major.
template <typename T, int NMAT, int NT, int ACT>
__device__ __forceinline__ void epilogue(T* C, int M, int N, int row_base,
                                         int col_base,
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
        for (int e = 0; e < 2; ++e) {
          const float x = acc[mi][ni][half * 2 + e];
          if constexpr (NMAT == 2) {
            const float u = rnd(acc[mi][NT + ni][half * 2 + e], C);
            v[e] = rnd(activation<ACT>(rnd(x, C)), C) * u;
          } else {
            v[e] = x;
          }
        }
        store2(C + (size_t)row * N + col, v[0], v[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync from ldmatrix fragments, cp.async ring.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// This lane's ldmatrix row address within a 16 x 16 tile: A stored [m][k]
// (regs: the m16k16 A fragment); B stored [n][k], two n8 tiles (regs
// {b(n0), b(n0 + 8)}).
__device__ __forceinline__ int a_off(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int bt_off(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
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

// One k tile of A (kBM rows of x / a) and of the weights (kBRows rows: the
// first BN of B0, then BN of B1) into one ring stage; zero-fill past M, N, K.
template <int NMAT>
__device__ __forceinline__ void load_stage(bf16* sa, bf16* sb, const bf16* A,
                                           const bf16* B0, const bf16* B1,
                                           int M, int N, int K, int m0, int n0,
                                           int k0) {
  constexpr int BN = kBRows / NMAT;
  constexpr int kChunks = kBK / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    cp_async_16(sa + r * kLds + c, ok ? A + (size_t)(m0 + r) * K + k0 + c : A,
                ok);
  }
  for (int i = threadIdx.x; i < kBRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int j = r / BN, n = n0 + r % BN;
    const bf16* B = j ? B1 : B0;
    const bool ok = n < N && k0 + c < K;
    cp_async_16(sb + r * kLds + c, ok ? B + (size_t)n * K + k0 + c : B, ok);
  }
}

template <int NMAT>
constexpr size_t smem_bf16() {
  return sizeof(bf16) * (size_t)kStages * (kBM + kBRows) * kLds;
}

// C[M, N] = epilogue(A[M, K] . Bj[N, K]^T for j < NMAT).
template <int NMAT, int ACT>
__global__ void __launch_bounds__(kThreads)
    gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B0,
              const bf16* __restrict__ B1, bf16* __restrict__ C, int M, int N,
              int K) {
  constexpr int BN = kBRows / NMAT;  // output columns per matrix per block
  constexpr int WN = BN / 4;         // per warp per matrix
  constexpr int NT = WN / 8;         // n8 tiles per warp per matrix
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);  // [stage][kBM][kLds]
  bf16* sb = sa + kStages * kBM * kLds;      // [stage][kBRows][kLds]

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int ktiles = (K + kBK - 1) / kBK;

  float acc[4][NMAT * NT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int n = 0; n < NMAT * NT; ++n)
      acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_stage<NMAT>(sa + s * kBM * kLds, sb + s * kBRows * kLds, A, B0, B1,
                       M, N, K, m0, n0, s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is visible; every read of tile kt - 1 is done
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      const int s = nk % kStages;
      load_stage<NMAT>(sa + s * kBM * kLds, sb + s * kBRows * kLds, A, B0, B1,
                       M, N, K, m0, n0, nk * kBK);
    }
    cp_async_commit();
    const int st = kt % kStages;
    const bf16* as = sa + st * kBM * kLds + wm * 64 * kLds;
    const bf16* bs = sb + st * kBRows * kLds + wn * WN * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + mi * 16 * kLds + kk + a_off(kLds));
#pragma unroll
      for (int j = 0; j < NMAT; ++j) {
#pragma unroll
        for (int ni = 0; ni < NT; ni += 2) {
          uint32_t bb[4];
          ldsm_x4(bb, bs + (j * BN + ni * 8) * kLds + kk + bt_off(kLds));
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(acc[mi][j * NT + ni], af[mi], bb);
            mma_bf16(acc[mi][j * NT + ni + 1], af[mi], bb + 2);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  epilogue<bf16, NMAT, NT, ACT>(C, M, N, m0 + wm * 64, n0 + wn * WN, acc);
}

// ---------------------------------------------------------------------------
// f32 (the tests' oracle runs): the same tiles, warp layout and epilogue;
// products in f32 FMAs from shared memory in the accumulator layout.
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

  epilogue<float, NMAT, NT, ACT>(C, M, N, m0 + wm * 64, n0 + wn * WN, acc);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int NMAT, int ACT>
cudaError_t launch(int kind, const void* A, const void* B0, const void* B1,
                   void* C, int M, int N, int K, cudaStream_t stream) {
  constexpr int BN = kBRows / NMAT;
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  if (kind == 1) {
    constexpr size_t smem = smem_bf16<NMAT>();
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16<NMAT, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    gemm_bf16<NMAT, ACT><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(B0),
        static_cast<const bf16*>(B1), static_cast<bf16*>(C), M, N, K);
  } else {
    gemm_f32<NMAT, ACT><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(B0),
        static_cast<const float*>(B1), static_cast<float*>(C), M, N, K);
  }
  return cudaGetLastError();
}

bool shapes_ok(int kind, int M, int N, int K) {
  // grid.y counts column tiles of at least kBRows / 2 columns.
  return (kind == 0 || kind == 1) && M > 0 && N > 0 && K > 0 && N % 8 == 0 &&
         K % 8 == 0 && (N + kBRows / 2 - 1) / (kBRows / 2) <= 65535;
}

}  // namespace

// kind: 0 = f32, 1 = bf16 (every operand one type); act: 0 = silu,
// 1 = gelu_tanh, 2 = gelu (erf). Each returns the launch's cudaError_t
// (0 = ok); an unknown kind or activation, a width that is not a positive
// multiple of 8, or rows <= 0 give cudaErrorInvalidValue.

// a [rows, d_ff] = rnd(act(rnd(x Wg^T))) * rnd(x Wu^T).
extern "C" int fused_mlp_gate_up(int kind, int act, const void* x,
                                 const void* w_gate, const void* w_up, void* a,
                                 int rows, int features, int d_ff,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(kind, rows, d_ff, features)) return cudaErrorInvalidValue;
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
  if (!shapes_ok(kind, rows, d_out, d_ff)) return cudaErrorInvalidValue;
  return launch<1, kSilu>(kind, a, w_down, w_down, y, rows, d_out, d_ff,
                          static_cast<cudaStream_t>(stream));
}
