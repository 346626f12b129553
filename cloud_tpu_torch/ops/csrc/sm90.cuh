// Hopper (sm_90a) primitives shared by the port's kernels, in inline PTX:
// TMA tensor maps, loads and stores, 1-D bulk copies, mbarriers, stmatrix,
// wgmma descriptors (K-major and MN-major), the bf16 products m64n256k16
// and m64n{32,64,128}k16 with both operands in shared memory,
// m64n{64,128,256}k16 with A in registers and B transposed, and
// setmaxnreg.
//
// Host side: the tensor maps of a row-major bf16 matrix and of a
// [B, S, H, D] bf16 tensor, encoded per call by the driver's
// cuTensorMapEncodeTiled, reached through the runtime's entry-point
// query so the library needs no -lcuda.
//
// Device side: the layout that ties TMA to wgmma here is bf16 tiles whose
// rows are 64 values (128 bytes) long, written by TMA with the 128-byte
// swizzle, so that 8 rows make one 1024-byte swizzle atom. Every tile
// starts on a 1024-byte boundary. Read along the rows' 64 values, such a
// tile is a K-major operand (desc_k128); read across its rows, it is an
// MN-major one (desc_mn128), which is how one tile in shared memory
// feeds both a product and its transpose.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------------------
// Host: tensor maps.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once (nullptr if the driver lacks it).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major bf16 matrix [rows, cols] (row stride cols values)
// cut into boxes of box_rows x 64 values, 128-byte swizzled; a box that
// reaches past an edge is filled with zeros there. TMA takes a 16-byte
// aligned base and a row stride that is a multiple of 16 bytes (cols % 8
// == 0); anything else returns an error here.
inline bool make_map_bf16(CUtensorMap* map, const void* base, uint64_t rows,
                          uint64_t cols, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a bf16 tensor [B, S, H, D] (D contiguous; D a multiple of 8,
// so that rows are 16 bytes apart) as rank 4 {D, H, S, B}, cut into boxes
// of 64 values x 1 head x box_rows positions x 1 example: a box lands as
// box_rows rows of 128 bytes, 128-byte swizzled; columns past D are filled
// with zeros (a box may be wider than D), and rows past S too, within the
// box's own example (a rank-2 map over [B * S, H * D] would read the next
// example's rows there).
inline bool make_map_bf16_bshd(CUtensorMap* map, const void* base,
                               uint64_t batch, uint64_t seq, uint64_t heads,
                               uint64_t dim, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {dim, heads, seq, batch};
  const cuuint64_t strides[3] = {dim * 2, heads * dim * 2,
                                 seq * heads * dim * 2};
  const cuuint32_t box[4] = {64, 1, box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Device: mbarriers and TMA.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to TMA and the other threads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase awaits.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so a wait on parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of `map` at (c0 along the contiguous dimension, c1 along rows)
// into shared memory at dst; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One box of a rank-4 `map` at (c0, c1, c2, c3), innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global memory at src into shared memory
// at dst, both 16-byte aligned, as one bulk copy (no tensor map);
// completion counts its bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One box of shared memory at src into `map` at (c0, c1), clipped to the
// matrix's bounds, in this thread's current bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Four 8 x 8 bf16 matrices into shared memory: r[i] holds this lane's two
// values of matrix i (row lane / 4, columns 2 (lane % 4) and + 1, the
// mma accumulator layout); lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(void* row, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_u32(row)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma.
// ---------------------------------------------------------------------------

// Descriptor of a K-major bf16 tile in the layout above: rows 128 bytes
// apart, 8-row atoms 1024 bytes apart (stride byte offset), 128-byte
// swizzle (layout type 1). The k16 slice kk of the tile is the descriptor
// plus 2 * kk (its start address moves by 32 bytes).
__device__ __forceinline__ uint64_t desc_k128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Descriptor of an MN-major bf16 operand in the same tiles: the k
// dimension runs across the rows (128 bytes apart, 8-row atoms 1024 bytes
// apart: the stride byte offset), M or N along each row's 64 values, and
// the next 64 values of M or N lie `chunk_bytes` further on (the leading
// byte offset: the next tile). The k16 slice kk is the descriptor plus
// 128 * kk (its start moves by 16 rows, 2048 bytes).
__device__ __forceinline__ uint64_t desc_mn128(const void* tile,
                                               uint32_t chunk_bytes) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(chunk_bytes >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warp are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of r across an asynchronous
// wgmma that reads or writes it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

#define SM90_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_F16(i) SM90_F4(i), SM90_F4(i + 4), SM90_F4(i + 8), SM90_F4(i + 12)

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, bf16 in, f32 accumulate,
// both operands K-major in shared memory; scale_d 0 overwrites d. d is
// this thread's part of the m64n256 accumulator: d[4 j + e] is row
// 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2, w the
// warp of the warpgroup (the m16n8 layout of each warp, repeated over n8).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_F16(0), SM90_F16(16), SM90_F16(32), SM90_F16(48), SM90_F16(64),
        SM90_F16(80), SM90_F16(96), SM90_F16(112)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef SM90_F16
#undef SM90_F4

// The same products at n 32 to 256 on accumulators held as [N / 8][4]
// (d[j][e] is the m64n256 layout's d[4 j + e]: each warp's m16n8 tiles).
template <int NT>
__device__ __forceinline__ void fence_operands(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(d[j][e]);
}

#define SM90_T4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, both operands K-major in shared
// memory (desc_k128); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_T4(0), SM90_T4(1), SM90_T4(2), SM90_T4(3)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_T4(0), SM90_T4(1), SM90_T4(2), SM90_T4(3), SM90_T4(4),
        SM90_T4(5), SM90_T4(6), SM90_T4(7)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_T4(0), SM90_T4(1), SM90_T4(2), SM90_T4(3), SM90_T4(4),
        SM90_T4(5), SM90_T4(6), SM90_T4(7), SM90_T4(8), SM90_T4(9),
        SM90_T4(10), SM90_T4(11), SM90_T4(12), SM90_T4(13), SM90_T4(14),
        SM90_T4(15)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x N] += A[64 x 16] . B[16 x N], A in registers and B MN-major in
// shared memory (desc_mn128; the transpose-B immediate set). Warp w of
// the warpgroup holds rows 16 w .. 16 w + 15 of A as the m16n8k16 A
// fragment: a[0] row lane / 4, columns 2 (lane % 4) and + 1; a[1] the
// same 8 rows down; a[2], a[3] the same 8 columns on. That is the
// accumulator layout of two adjacent n8 tiles, rounded to bf16 in pairs.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_T4(0), SM90_T4(1), SM90_T4(2), SM90_T4(3), SM90_T4(4),
        SM90_T4(5), SM90_T4(6), SM90_T4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SM90_T4(0), SM90_T4(1), SM90_T4(2), SM90_T4(3), SM90_T4(4),
        SM90_T4(5), SM90_T4(6), SM90_T4(7), SM90_T4(8), SM90_T4(9),
        SM90_T4(10), SM90_T4(11), SM90_T4(12), SM90_T4(13), SM90_T4(14),
        SM90_T4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32][4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "
      "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : SM90_T4(0), SM90_T4(1), SM90_T4(2), SM90_T4(3), SM90_T4(4),
        SM90_T4(5), SM90_T4(6), SM90_T4(7), SM90_T4(8), SM90_T4(9),
        SM90_T4(10), SM90_T4(11), SM90_T4(12), SM90_T4(13), SM90_T4(14),
        SM90_T4(15), SM90_T4(16), SM90_T4(17), SM90_T4(18), SM90_T4(19),
        SM90_T4(20), SM90_T4(21), SM90_T4(22), SM90_T4(23), SM90_T4(24),
        SM90_T4(25), SM90_T4(26), SM90_T4(27), SM90_T4(28), SM90_T4(29),
        SM90_T4(30), SM90_T4(31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef SM90_T4

// ---------------------------------------------------------------------------
// Device: register reallocation between warpgroups (all four warps of a
// warpgroup execute it together; counts are multiples of 8 in [24, 256]).
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace sm90
