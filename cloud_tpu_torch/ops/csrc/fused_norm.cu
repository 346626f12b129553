// Fused residual-add + RMSNorm for Hopper (sm_90a), with a plain C interface
// (bound from Python with ctypes: cloud_tpu_torch/ops/fused_norm.py).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of cloud_tpu/ops/fused_norm.py
// (:70, called from `_norm_forward` :83 without a residual at :97 and with
// one at :107):
//   h      = x + residual, rounded to x's dtype (x itself without residual)
//   normed = h * (rsqrt(mean(h^2) + eps) * scale), the statistics in f32 on
//            the rounded h, one cast to the output dtype at the end.
//
// Layouts: x, residual, h [rows, D] row-major in one dtype (f32 or bf16);
// scale [D] f32; normed [rows, D] f32 or bf16. D % 8 == 0 (8 elements are
// 16 bytes of bf16); any row count (rows past the end are never touched).
//
// Design. The work is bound by bytes: at the Llama training shape (rows
// 8192, D 2048, bf16) the residual variant moves 134 MB (x and residual in,
// h and normed out) for 67 MFLOP, 0.040 ms at 3.35 TB/s. The TPU kernel
// streams a block of rows through VMEM; here one warp owns one row and four
// rows share a block. Pass 1 reads x (and the residual) 8 elements per lane
// and step (16-byte loads of bf16), forms h in the input dtype, stores it,
// and sums the squares of its f32 values; a warp shuffle reduces the sum.
// Pass 2 reads the row of h back (it was written by this warp a moment
// before, so it comes from L1 or L2, not device memory), scales it and
// writes normed. Nothing is padded; no shared memory is used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowsPerBlock = 4;  // one warp per row
constexpr int kThreads = kRowsPerBlock * 32;

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
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<int4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// x rounded to T's precision (the dtype h is kept in).
__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Tin: x / residual / h; Tout: normed. kResidual: h = x + residual is
// formed and stored; otherwise h is x.
template <typename Tin, typename Tout, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const Tin* __restrict__ x, const Tin* __restrict__ res,
                   const float* __restrict__ scale, Tout* __restrict__ out,
                   Tin* __restrict__ h, int rows, int features, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * features;
  const Tin* xr = x + base;
  const Tin* hr = kResidual ? h + base : xr;  // the row of h read in pass 2

  // Pass 1: h in the input dtype, stored; sum of squares of its f32 value.
  float sumsq = 0.f;
  for (int c = lane * 8; c < features; c += 32 * 8) {
    float v[8];
    load8(xr + c, v);
    if (kResidual) {
      float r[8];
      load8(res + base + c, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = round_to(v[i] + r[i], x);
      store8(h + base + c, v);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sumsq = fmaf(v[i], v[i], sumsq);
  }
  sumsq = warp_sum(sumsq);
  // h's stores are visible to the warp's own loads of pass 2.
  if (kResidual) __syncwarp();
  const float rstd = rsqrtf(sumsq / (float)features + eps);

  // Pass 2: normed = h * (rstd * scale), one cast.
  for (int c = lane * 8; c < features; c += 32 * 8) {
    float v[8], w[8];
    load8(hr + c, v);
    load8(scale + c, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * (rstd * w[i]);
    store8(out + base + c, v);
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_typed(const void* x, const void* res, const void* scale,
                         void* out, void* h, int rows, int features, float eps,
                         cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (res != nullptr)
    rmsnorm_kernel<Tin, Tout, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const Tin*>(x), static_cast<const Tin*>(res),
        static_cast<const float*>(scale), static_cast<Tout*>(out),
        static_cast<Tin*>(h), rows, features, eps);
  else
    rmsnorm_kernel<Tin, Tout, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const Tin*>(x), nullptr,
        static_cast<const float*>(scale), static_cast<Tout*>(out), nullptr,
        rows, features, eps);
  return cudaGetLastError();
}

cudaError_t dispatch(int in_kind, int out_kind, const void* x, const void* res,
                     const void* scale, void* out, void* h, int rows,
                     int features, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || features <= 0 || features % 8 != 0)
    return cudaErrorInvalidValue;
  if (in_kind == 0 && out_kind == 0)
    return launch_typed<float, float>(x, res, scale, out, h, rows, features,
                                      eps, s);
  if (in_kind == 0 && out_kind == 1)
    return launch_typed<float, bf16>(x, res, scale, out, h, rows, features,
                                     eps, s);
  if (in_kind == 1 && out_kind == 0)
    return launch_typed<bf16, float>(x, res, scale, out, h, rows, features,
                                     eps, s);
  if (in_kind == 1 && out_kind == 1)
    return launch_typed<bf16, bf16>(x, res, scale, out, h, rows, features,
                                    eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 = f32, 1 = bf16 (in_kind for x, residual and h; out_kind for
// normed). Each returns the launch's cudaError_t (0 = ok); rows <= 0, a
// feature count that is not a positive multiple of 8, or an unknown kind
// give cudaErrorInvalidValue.
extern "C" int fused_rmsnorm_residual(int in_kind, int out_kind,
                                      const void* x, const void* residual,
                                      const void* scale, void* normed, void* h,
                                      int rows, int features, float eps,
                                      void* stream) {
  if (residual == nullptr || h == nullptr) return cudaErrorInvalidValue;
  return dispatch(in_kind, out_kind, x, residual, scale, normed, h, rows,
                  features, eps, stream);
}

extern "C" int fused_rmsnorm_noresidual(int in_kind, int out_kind,
                                        const void* x, const void* scale,
                                        void* normed, int rows, int features,
                                        float eps, void* stream) {
  return dispatch(in_kind, out_kind, x, nullptr, scale, normed, nullptr, rows,
                  features, eps, stream);
}
