// FlashAttention-2 forward and backward for Hopper (sm_90a), with a plain C
// interface (bound from Python with ctypes: cloud_tpu_torch/ops/attention.py).
// This source holds the bf16 kernels; the f32 ones are in
// flash_attention_f32.cu and what both share in flash_common.cuh, so that
// the two libraries build in parallel.
//
// Replaces the three Pallas TPU kernels of cloud_tpu/ops/attention.py:
//   _fwd_kernel   (:179)  online-softmax attention; writes out and lse
//   _dq_kernel    (:345)  dq from the saved lse and delta = rowsum(dO * O)
//   _dkdv_kernel  (:383)  dk, dv, summed over each GQA group of q heads
// with the whole `flash_attention` contract: causal or not, sm_scale, a
// per-example key mask [B, S], GQA (kv_group = H / H_kv), a sliding window
// (key col visible from row iff row - window < col <= row), a tanh logit
// softcap, and any S (ragged edges are bound-checked, nothing is padded).
//
// Layouts (the JAX boundary, [B, S, H, D], read with strides; no transpose):
//   q, out, dout, dq   [B, S, H, D]      bf16 or f32
//   k, v, dk, dv       [B, S, H_kv, D]   the same type
//   mask               [B, S] bytes (0 = masked key) or null
//   lse, delta         [B, H, S] f32
// D is any multiple of 8 up to 256, run at the next template width of 64,
// 128 and 256 (`template_width`): the tensor maps span the true D, TMA
// zero-fills each box's columns past it (a box wholly past it is not
// loaded and stays zero), so S and dP are exact, and the epilogues write
// only the first D columns of out, dq, dk and dv. Accumulation is f32;
// outputs are in the input type.
//
// Design. The TPU kernels walk a sequential grid and carry acc/m/l (or the
// dq, dk, dv accumulators) in VMEM scratch between grid steps. Blocks on the
// card run in parallel and carry nothing, so each block owns one output tile
// and loops over the tiles it reduces over (`_tile_live`: causal and window
// tiles that cannot hold an allowed pair are skipped):
// - forward: one block per (q tile, head, example), a loop over the live
//   key tiles;
// - dq: one block per (q tile, head, example), a loop over the live key
//   tiles;
// - dk/dv: one block per (key tile, kv head, example), a loop over every q
//   head of its group and every live q tile, so the GQA sum lands in the
//   block's own accumulators: deterministic, no atomics.
//
// bf16 (the training path): all three kernels are built for Hopper on the
// primitives of sm90.cuh. A block is a producer warpgroup and two or three
// consumer warpgroups. The producer's first warp stages the tiles (TMA,
// 128-byte swizzled boxes of rows x 64 values, from a rank-4 map of each
// [B, S, H, D] tensor, so a box past S is zero-filled within its own
// example) into a ring of shared-memory stages with a full and an empty
// mbarrier each, with the key flags (and lse, delta) beside them; its
// warpgroup lowers its registers with setmaxnreg for the consumers, which
// own 64 output rows each. Per tile a consumer runs S (S^T in dk/dv, and
// dP in the backward) with wgmma m64nNk16 from shared memory (both
// operands K-major), the per-element step in registers, then the second
// products with P (and dS; P^T, dS^T) as register A operands, rounded to
// bf16 first, which is the cast the TPU kernels make (p.astype(v.dtype)
// :216, p.astype(do.dtype) :407, ds.astype(k.dtype) :368, ds.astype(q.dtype)
// :417), against the V, K, dO or Q tile read MN-major (transposed B):
// nothing is transposed in memory. A consumer releases a stage once the
// wgmmas that read it have retired.
//   forward: 64 q rows per consumer (Q resident): three consumers (192
//     rows) at D 64 (registers 32 / 160), two at D 128 and 256 (40 / 232);
//     key tiles of 128 (64 at D 256) through 4, 3 and 2 stages; S m64nN,
//     O m64nD.
//   dq: 64 q rows per consumer (Q, dO resident): three consumers at D 64,
//     two at D 128 and 256; key tiles of 64 (32 at D 256, where dQ takes
//     128 registers) through 4 stages (3 at D 128 and 256); S and dP
//     m64nN, dQ m64nD.
//   dk/dv: K and V resident, (Q, dO) tiles of 64 q rows (32 at D 128 and
//     256) through 4 stages. At D 64 and 128: 128 keys per block, two
//     consumers of 64 keys each summing dV and dK (a third would leave each
//     160 registers, where dk/dv spills). At D 256, where dK and dV of 64
//     keys alone take 256 registers, 64 keys per block and the sums split:
//     one consumer sums dV, the other dK, each computing S^T itself.
//   Under causal masking a block's work grows with its distance from the
//   diagonal's start, so blockIdx maps heaviest first: dk/dv's key tiles
//   ascending, the forward's and dq's q tiles descending; the forward and
//   dq put the q heads of a GQA group side by side, so they read the K/V
//   tiles they share from L2.
// f32 (the tests' oracle runs, flash_attention_f32.cu): four warps, 64 x 64
// tiles, each product computed in f32 FMAs from shared memory.
// Both types run one copy of the per-element steps (logit2, fwd_softmax,
// dq_ds, dkdv_pds: scale, softcap, masking, online softmax, dS; over any
// number of n8 accumulator tiles, specialised per tile) and of the
// epilogues, so the f32 check covers the arithmetic the bf16 kernels train
// with; the types differ only in operand movement and products.
//
// Masking: a masked probability is set to 0 explicitly (:213, :340), so a
// row with no allowed key ends with l == 0 and writes out 0 and
// lse = -1e30; its dq is 0 and it adds nothing to dk/dv. The softcap
// derivative 1 - tanh^2 uses the uncapped logit (:333-336). Rows and keys
// past S are masked explicitly too; the zeros TMA fills in are not relied
// on.
//
// Bound on this card: at GPT-2 training shapes (B 8, S 1024, H 12, D 64,
// bf16, causal) the forward does 12.9 GFLOP over 51 MB, about 250 flop per
// byte, just under the H100's ~295 flop/byte ridge: bytes and tensor-core
// operations bound it about equally (15 us either way). dq (three
// products) and dk/dv (four) read the same bytes and are operation-bound:
// at TinyLlama's shape (B 4, S 2048, H 32, H_kv 4, D 64) 103 and 137
// GFLOP, 0.104 and 0.139 ms at 989 TFLOP/s, against ~0.02 ms of bytes.
// Beside the products, each kernel spends an exp2, the dS arithmetic and
// bf16 packs on every live (q row, key) pair, which the consumer
// warpgroups overlap with each other's wgmmas; that step is specialised
// per tile (no mask tests on a tile every pair of which is allowed, no
// softcap test without a cap). Ping-pong scheduling of the consumers and
// overlap of one tile's softmax with the next tile's S inside a consumer
// are not done.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: the training path's kernels, on wgmma, fed by TMA and
// warp-specialised. Warpgroup 0 produces (its first warp stages the tiles;
// registers lowered with setmaxnreg), and the next two or three consume
// (registers raised), each owning 64 rows of the block's output tile, the
// M of its wgmma products. Every operand tile is a TMA box of rows x 64
// values, 128-byte swizzled, which wgmma reads K-major for S (and dP) and
// MN-major for the second product, so Q, dO, K and V are never transposed
// in memory.
// ---------------------------------------------------------------------------

// The A fragment (16 x 16, k = the 16 columns) made of the accumulators of
// two adjacent 16 x 8 tiles, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack2(c0[0], c0[1]);
  a[1] = pack2(c0[2], c0[3]);
  a[2] = pack2(c1[0], c1[1]);
  a[3] = pack2(c1[2], c1[3]);
}

// First live key tile (tiles of nk keys) of the q tile [q0, q0 + nq); S
// when there is none.
__device__ __forceinline__ int first_live_key(const Params& p, int q0,
                                              int nq, int nk) {
  int k0 = 0;
  while (k0 < p.seq && !tile_live(p, q0, nq, k0, nk)) k0 += nk;
  return k0;
}


constexpr int kWg = 128;           // threads per warpgroup
constexpr int kWgRows = 64;        // rows of a consumer's tile
constexpr uint32_t kBoxRow = 128;  // bytes of a box row: 64 bf16

// The warpgroups of a block: a producer and C consumers, with the
// registers setmaxnreg gives each (the 64K of the SM shared out).
template <int C>
struct Warpgroups {
  static constexpr int kConsumers = C;
  static constexpr int kThreads = (C + 1) * kWg;
  static constexpr int kProducerRegs = C == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = C == 3 ? 160 : 232;
};

// forward: one block per (kM q rows, head, example); Q resident, K and V
// streamed in tiles of kN keys through a ring of kStages. A consumer holds
// O (D / 2 registers a thread), S and P (kN / 2 and kN / 4): three fit in
// 160 registers at D 64, two at D 128 and 256 (232); kN is 128 at D 64
// and 128 and 64 at D 256, where O alone takes 128 registers. Shared
// memory: Q, then stages of K | V as many as fit (D 64: 24 KB + 4 x 32 KB;
// D 128: 32 KB + 3 x 64 KB; D 256: 64 KB + 2 x 64 KB).
template <int D>
constexpr int fwd_consumers() {
  return D == 64 ? 3 : 2;
}
template <int D>
struct FwdTiles : Warpgroups<fwd_consumers<D>()> {
  static constexpr int kBoxes = D / 64;
  static constexpr int kM = fwd_consumers<D>() * kWgRows;
  static constexpr int kN = D == 256 ? 64 : 128;
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr uint32_t kQ = kBoxes * kM * kBoxRow;    // Q
  static constexpr uint32_t kKV = kBoxes * kN * kBoxRow;   // K or V, a stage
  // Q, the ring, its key flags, the barriers (Q, full, empty) and slack to
  // align to 1024 bytes.
  static constexpr size_t kSmem = kQ + kStages * (2 * kKV + kN) +
                                  (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

// dq: one block per (kM q rows, head, example); Q and dO resident, K and
// V streamed in tiles of kN keys through a ring of kStages. At D 64 a dq
// consumer fits in 160 registers, so three of them (192 rows) hide more
// of each other's latency than two; at D 128 and 256 two. kN is 64, and
// 32 at D 256, where dQ alone takes 128 registers a thread (S and dP then
// 16 each) and Q and dO 128 KB of shared memory.
template <int D>
constexpr int dq_consumers() {
  return D == 64 ? 3 : 2;
}
template <int D>
struct DqTiles : Warpgroups<dq_consumers<D>()> {
  static constexpr int kBoxes = D / 64;
  static constexpr int kM = dq_consumers<D>() * kWgRows;
  static constexpr int kN = D == 256 ? 32 : kBlockN;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr uint32_t kQ = kBoxes * kM * kBoxRow;    // Q or dO
  static constexpr uint32_t kKV = kBoxes * kN * kBoxRow;   // K or V, a stage
  // Q, dO, the ring, its key flags, the barriers (Q/dO, full, empty) and
  // slack to align to 1024 bytes.
  static constexpr size_t kSmem = 2 * kQ + kStages * (2 * kKV + kN) +
                                  (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

// dk/dv: one block per (kN keys, kv head, example); K and V resident,
// (Q, dO, lse, delta) streamed for every q head of the group and every
// live q tile of kTQ rows. kTQ is the N of S^T and dP^T: 64 at D 64, 32 at
// D 128 and 256, where dK and dV take twice the registers and more. Two
// consumers: a dk/dv consumer spills in the 160 registers three would
// leave it. At D 64 and 128 each owns 64 of the block's 128 keys and sums
// both dK and dV. At D 256 dK and dV of 64 keys would take 256 registers
// a thread, so the block has 64 keys (kSplit) and its consumers split the
// sums: the first sums dV = P^T dO, the second dK = dS^T Q; each computes
// S^T itself (a fifth product, against passing P^T through shared memory,
// which would tie the two together per tile), and only the second dP^T.
template <int D>
struct DkdvTiles : Warpgroups<2> {
  static constexpr bool kSplit = D == 256;
  static constexpr int kBoxes = D / 64;
  static constexpr int kN = kSplit ? kWgRows : kConsumers * kWgRows;
  static constexpr int kTQ = D == 64 ? 64 : 32;
  static constexpr int kStages = 4;
  static constexpr uint32_t kKV = kBoxes * kN * kBoxRow;   // K or V
  static constexpr uint32_t kQ = kBoxes * kTQ * kBoxRow;   // Q or dO, a stage
  // K, V, the ring, its lse and delta rows, the key flags, the barriers
  // (K/V, full, empty) and slack to align to 1024 bytes.
  static constexpr size_t kSmem = 2 * kKV + kStages * 2 * kQ +
                                  kStages * 2 * kTQ * sizeof(float) + kN +
                                  (2 * kStages + 1) * sizeof(uint64_t) + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase,
                                           int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// Boxes of 64 columns that hold any of head_dim's columns; TMA loads only
// these. Only the D 256 template can have a box wholly past head_dim (for
// head_dim <= 192; the 128 template runs head_dim 72..128, two live
// boxes): such a box is never loaded, and `zero_dead_boxes` zeroes it
// once, before the first TMA.
template <int D>
__device__ __forceinline__ int live_boxes(const Params& p) {
  return D == 256 ? (p.dim + 63) / 64 : D / 64;
}

// Zeroes boxes [live, boxes) of `n` tiles laid out `tile` bytes apart from
// `base` (boxes of `box` bytes), by every thread of the block, and makes
// the zeros visible to the async proxy that wgmma reads shared memory
// through. The caller's __syncthreads follows.
__device__ __forceinline__ void zero_dead_boxes(unsigned char* base, int n,
                                                uint32_t tile, uint32_t box,
                                                int live, int boxes) {
  if (live >= boxes) return;
  for (int i = 0; i < n; ++i)
    for (int x = live; x < boxes; ++x) {
      uint4* dst = reinterpret_cast<uint4*>(base + i * tile + x * box);
      for (uint32_t j = threadIdx.x; j < box / 16; j += blockDim.x)
        dst[j] = make_uint4(0u, 0u, 0u, 0u);
    }
  sm90::fence_proxy_async();
}

// Issues s = A . B^T over D for one consumer (no commit): A (64 rows) and
// B (N rows) are tiles of D / 64 boxes `a_box` and `b_box` values apart.
template <int D, int NT>
__device__ __forceinline__ void product_ss(float (&s)[NT][4], const bf16* a,
                                           const bf16* b, int a_box,
                                           int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / 4, off = 2 * (kk % 4);
    sm90::wgmma_ss(s, sm90::desc_k128(a + x * a_box) + off,
                   sm90::desc_k128(b + x * b_box) + off, kk > 0);
  }
}

// S = A . B^T alone, and with dP = dA . dB^T, waited for.
template <int D, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const bf16* a,
                                       const bf16* b, int a_box,
                                       int b_box) {
  product_ss<D>(s, a, b, a_box, b_box);
  sm90::wgmma_commit();
  sm90::fence_operands(s);
  sm90::wgmma_wait<0>();
  sm90::fence_operands(s);
}
template <int D, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4],
                                       float (&dp)[NT][4], const bf16* a,
                                       const bf16* b, const bf16* da,
                                       const bf16* db, int a_box,
                                       int b_box) {
  product_ss<D>(s, a, b, a_box, b_box);
  product_ss<D>(dp, da, db, a_box, b_box);
  sm90::wgmma_commit();
  sm90::fence_operands(s);
  sm90::fence_operands(dp);
  sm90::wgmma_wait<0>();
  sm90::fence_operands(s);
  sm90::fence_operands(dp);
}

// The forward. The producer's first warp loads Q once and then the live
// key tiles' K, V and key flags into the ring; each consumer, per tile,
// runs S = Q K^T (wgmma from shared memory, both K-major), the online
// softmax in registers (fwd_softmax), P rounded to bf16 as the register A
// operand (p.astype(v.dtype), :216), and O += P V with V read MN-major,
// then releases the stage. Under causal masking the last q tile sees the
// most keys, so q tiles run down as blockIdx.x runs up; the q heads of a
// GQA group are neighbours, so they read the K/V tiles they share from L2.
template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const Params p) {
  using T = FwdTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);         // [box][kM][64]
  unsigned char* ring = smem + T::kQ;   // [stage][K | V][box][kN][64]
  uint8_t* flags = ring + T::kStages * 2 * T::kKV;   // [stage][kN]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(flags + T::kStages * T::kN);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + T::kStages;

  // The q tiles end at S, so that a partial tile is the first, which under
  // causal masking sees the fewest keys: tile 0 may start below row 0,
  // where TMA fills Q with zeros, and rows below 0 are neither computed
  // (their consumer idles) nor written.
  const int S = p.seq;
  const int n_qt = (S + T::kM - 1) / T::kM;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (p.heads * p.batch));
  const int h = blockIdx.x % p.heads;
  const int b = (blockIdx.x / p.heads) % p.batch;
  const int hk = h / (p.heads / p.kv_heads);
  const int q0 = S - (n_qt - qt) * T::kM;
  // The live key tiles form one run [k_lo, k_hi).
  const int k_lo = first_live_key(p, q0, T::kM, T::kN);
  int k_hi = k_lo;
  while (k_hi < S && tile_live(p, q0, T::kM, k_hi, T::kN)) k_hi += T::kN;
  const int wg = threadIdx.x / kWg;
  const int live = live_boxes<D>(p);
  zero_dead_boxes(smem, 1, T::kQ, T::kM * kBoxRow, live, T::kBoxes);
  zero_dead_boxes(ring, 2 * T::kStages, T::kKV, T::kN * kBoxRow, live,
                  T::kBoxes);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      sm90::mbar_init(&full[s], 32);             // the producer warp
      sm90::mbar_init(&empty[s], T::kConsumers * kWg / 32);  // their warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<T::kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(q_full, live * T::kM * kBoxRow);
        for (int x = 0; x < live; ++x)
          sm90::tma_load_4d(q_s + x * T::kM * 64, &map_q, q_full, x * 64, h,
                            q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = k_lo; k0 < k_hi; k0 += T::kN) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        load_key_flags(flags + stage * T::kN, p, b, k0, T::kN, lane, 32);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[stage],
                                      2 * live * T::kN * kBoxRow);
          bf16* k_s = reinterpret_cast<bf16*>(ring + stage * 2 * T::kKV);
          bf16* v_s = k_s + T::kKV / sizeof(bf16);
          for (int x = 0; x < live; ++x) {
            sm90::tma_load_4d(k_s + x * T::kN * 64, &map_k, &full[stage],
                              x * 64, hk, k0, b);
            sm90::tma_load_4d(v_s + x * T::kN * 64, &map_v, &full[stage],
                              x * 64, hk, k0, b);
          }
        } else {
          sm90::mbar_arrive(&full[stage]);
        }
        next_stage(stage, phase, T::kStages);
      }
    }
  } else {
    sm90::setmaxnreg_inc<T::kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = (lane & 3) * 2;
    const int qc = q0 + c * kWgRows;  // this consumer's 64 rows
    const int row0 = qc + warp * 16 + (lane >> 2);
    float o[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const bf16* qw = q_s + c * kWgRows * 64;
    sm90::mbar_wait(q_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = k_lo; k0 < k_hi; k0 += T::kN) {
      sm90::mbar_wait(&full[stage], phase);
      const bf16* k_s = reinterpret_cast<const bf16*>(ring +
                                                      stage * 2 * T::kKV);
      const bf16* v_s = k_s + T::kKV / sizeof(bf16);
      if (qc + kWgRows > 0 && tile_live(p, qc, kWgRows, k0, T::kN)) {
        float s[T::kN / 8][4];
        sm90::wgmma_fence();
        scores<D>(s, qw, k_s, T::kM * 64, T::kN * 64);
        fwd_softmax_tile(p, tile_full(p, qc, kWgRows, k0, T::kN), s, m, l, o,
                         flags + stage * T::kN, row0, k0, t);
        // O += P V: P from registers, V read MN-major.
        uint32_t a[T::kN / 16][4];
#pragma unroll
        for (int kk = 0; kk < T::kN / 16; ++kk)
          acc_to_a(a[kk], s[2 * kk], s[2 * kk + 1]);
        sm90::fence_operands(o);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::kN / 16; ++kk)
          sm90::wgmma_rs_tb(o, a[kk],
                            sm90::desc_mn128(v_s + kk * 16 * 64,
                                             T::kN * kBoxRow));
        sm90::wgmma_commit();
        sm90::fence_operands(o);
        sm90::wgmma_wait<0>();  // the stage is read; release it below
        sm90::fence_operands(o);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      next_stage(stage, phase, T::kStages);
    }
    fwd_store<bf16, D / 8>(p, b, h, row0, o, m, l, lane);
  }
}

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
    flash_dq_bf16(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const Params p) {
  using T = DqTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [box][kM][64]
  bf16* do_s = reinterpret_cast<bf16*>(smem + T::kQ);
  unsigned char* ring = smem + 2 * T::kQ;  // [stage][K | V][box][kN][64]
  uint8_t* flags = ring + T::kStages * 2 * T::kKV;    // [stage][kN]
  uint64_t* qdo_full =
      reinterpret_cast<uint64_t*>(flags + T::kStages * T::kN);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + T::kStages;

  // Heaviest first: the q tile runs down as blockIdx.x runs up (under
  // causal masking the last q tile sees the most keys); the heads of one
  // GQA group are neighbours, so the K/V tiles they share stay in L2.
  const int S = p.seq;
  const int n_qt = (S + T::kM - 1) / T::kM;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (p.heads * p.batch));
  const int h = blockIdx.x % p.heads;
  const int b = (blockIdx.x / p.heads) % p.batch;
  const int hk = h / (p.heads / p.kv_heads);
  const int q0 = qt * T::kM;
  // The live key tiles form one run [k_lo, k_hi).
  const int k_lo = first_live_key(p, q0, T::kM, T::kN);
  int k_hi = k_lo;
  while (k_hi < S && tile_live(p, q0, T::kM, k_hi, T::kN)) k_hi += T::kN;
  const int wg = threadIdx.x / kWg;
  const int live = live_boxes<D>(p);
  zero_dead_boxes(smem, 2, T::kQ, T::kM * kBoxRow, live, T::kBoxes);
  zero_dead_boxes(ring, 2 * T::kStages, T::kKV, T::kN * kBoxRow, live,
                  T::kBoxes);

  if (threadIdx.x == 0) {
    sm90::mbar_init(qdo_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      sm90::mbar_init(&full[s], 32);             // the producer warp
      sm90::mbar_init(&empty[s], T::kConsumers * kWg / 32);  // their warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<T::kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(qdo_full, 2 * live * T::kM * kBoxRow);
        for (int x = 0; x < live; ++x) {
          sm90::tma_load_4d(q_s + x * T::kM * 64, &map_q, qdo_full, x * 64,
                            h, q0, b);
          sm90::tma_load_4d(do_s + x * T::kM * 64, &map_do, qdo_full,
                            x * 64, h, q0, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = k_lo; k0 < k_hi; k0 += T::kN) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        load_key_flags(flags + stage * T::kN, p, b, k0, T::kN, lane, 32);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[stage],
                                      2 * live * T::kN * kBoxRow);
          bf16* k_s = reinterpret_cast<bf16*>(ring + stage * 2 * T::kKV);
          bf16* v_s = k_s + T::kKV / sizeof(bf16);
          for (int x = 0; x < live; ++x) {
            sm90::tma_load_4d(k_s + x * T::kN * 64, &map_k, &full[stage],
                              x * 64, hk, k0, b);
            sm90::tma_load_4d(v_s + x * T::kN * 64, &map_v, &full[stage],
                              x * 64, hk, k0, b);
          }
        } else {
          sm90::mbar_arrive(&full[stage]);
        }
        next_stage(stage, phase, T::kStages);
      }
    }
  } else {
    sm90::setmaxnreg_inc<T::kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = (lane & 3) * 2;
    const int qc = q0 + c * kWgRows;  // this consumer's 64 rows
    const int row0 = qc + warp * 16 + (lane >> 2);
    float lse[2], delta[2];  // lse in log2 units
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + j * 8;
      const size_t idx = ((size_t)b * p.heads + h) * S + row;
      lse[j] = row < S ? p.lse_in[idx] * kLog2e : 0.f;
      delta[j] = row < S ? p.delta[idx] : 0.f;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    const bf16* qw = q_s + c * kWgRows * 64;
    const bf16* dow = do_s + c * kWgRows * 64;
    sm90::mbar_wait(qdo_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = k_lo; k0 < k_hi; k0 += T::kN) {
      sm90::mbar_wait(&full[stage], phase);
      const bf16* k_s = reinterpret_cast<const bf16*>(ring +
                                                      stage * 2 * T::kKV);
      const bf16* v_s = k_s + T::kKV / sizeof(bf16);
      if (qc < S && tile_live(p, qc, kWgRows, k0, T::kN)) {
        // S = Q K^T and dP = dO V^T, then dS in registers.
        float s[T::kN / 8][4], dp[T::kN / 8][4];
        sm90::wgmma_fence();
        scores<D>(s, dp, qw, k_s, dow, v_s, T::kM * 64, T::kN * 64);
        const uint8_t* fl = flags + stage * T::kN;
        dq_ds_tile(p, tile_full(p, qc, kWgRows, k0, T::kN), s, dp, fl, row0,
                   k0, 0, t, lse, delta);
        // dQ += dS K: dS from registers, K read MN-major.
        uint32_t a[T::kN / 16][4];
#pragma unroll
        for (int kk = 0; kk < T::kN / 16; ++kk)
          acc_to_a(a[kk], s[2 * kk], s[2 * kk + 1]);
        sm90::fence_operands(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::kN / 16; ++kk)
          sm90::wgmma_rs_tb(acc, a[kk],
                            sm90::desc_mn128(k_s + kk * 16 * 64,
                                             T::kN * kBoxRow));
        sm90::wgmma_commit();
        sm90::fence_operands(acc);
        sm90::wgmma_wait<0>();  // the stage is read; release it below
        sm90::fence_operands(acc);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      next_stage(stage, phase, T::kStages);
    }
    const size_t qs = (size_t)p.heads * p.dim;
    store_rows<bf16, D / 8>(
        static_cast<bf16*>(p.dq) + (size_t)b * S * qs + (size_t)h * p.dim, qs,
        row0, S, p.dim, acc, t);
  }
}

template <int D>
__global__ void __launch_bounds__(DkdvTiles<D>::kThreads, 1)
    flash_dkdv_bf16(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const Params p) {
  using T = DkdvTiles<D>;
  constexpr int NQ = T::kTQ / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem);          // [box][kN][64]
  bf16* v_s = reinterpret_cast<bf16*>(smem + T::kKV);
  unsigned char* ring = smem + 2 * T::kKV;  // [stage][Q | dO][box][kTQ][64]
  // [stage][lse (log2 units) | delta][kTQ]
  float* rows_s = reinterpret_cast<float*>(ring + T::kStages * 2 * T::kQ);
  uint8_t* flags =
      reinterpret_cast<uint8_t*>(rows_s + T::kStages * 2 * T::kTQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(flags + T::kN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + T::kStages;

  // Heaviest first: key tile 0, which every q tile sees under causal
  // masking, comes first.
  const int S = p.seq;
  const int group = p.heads / p.kv_heads;
  const int kt = blockIdx.x / (p.kv_heads * p.batch);
  const int hk = blockIdx.x % p.kv_heads;
  const int b = (blockIdx.x / p.kv_heads) % p.batch;
  const int k0 = kt * T::kN;
  // The live q tiles form one run [q_lo, q_hi) (causal and window bands
  // are contiguous); every q head of the group walks the same run.
  int q_lo = 0;
  while (q_lo < S && !tile_live(p, q_lo, T::kTQ, k0, T::kN)) q_lo += T::kTQ;
  int q_hi = q_lo;
  while (q_hi < S && tile_live(p, q_hi, T::kTQ, k0, T::kN)) q_hi += T::kTQ;
  const int nq = (q_hi - q_lo) / T::kTQ;
  const int total = group * nq;
  const int wg = threadIdx.x / kWg;
  const int live = live_boxes<D>(p);
  zero_dead_boxes(smem, 2, T::kKV, T::kN * kBoxRow, live, T::kBoxes);
  zero_dead_boxes(ring, 2 * T::kStages, T::kQ, T::kTQ * kBoxRow, live,
                  T::kBoxes);

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 32);  // the producer warp
    for (int s = 0; s < T::kStages; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], T::kConsumers * kWg / 32);  // their warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<T::kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      load_key_flags(flags, p, b, k0, T::kN, lane, 32);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 2 * live * T::kN * kBoxRow);
        for (int x = 0; x < live; ++x) {
          sm90::tma_load_4d(k_s + x * T::kN * 64, &map_k, kv_full, x * 64,
                            hk, k0, b);
          sm90::tma_load_4d(v_s + x * T::kN * 64, &map_v, kv_full, x * 64,
                            hk, k0, b);
        }
      } else {
        sm90::mbar_arrive(kv_full);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < total; ++it) {
        const int h = hk * group + it / nq;
        const int q0 = q_lo + (it % nq) * T::kTQ;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        float* rows = rows_s + stage * 2 * T::kTQ;
        const size_t r0 = ((size_t)b * p.heads + h) * S + q0;
        for (int i = lane; i < T::kTQ; i += 32) {
          const bool ok = q0 + i < S;
          rows[i] = ok ? p.lse_in[r0 + i] * kLog2e : 0.f;
          rows[T::kTQ + i] = ok ? p.delta[r0 + i] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[stage],
                                      2 * live * T::kTQ * kBoxRow);
          bf16* q_s = reinterpret_cast<bf16*>(ring + stage * 2 * T::kQ);
          bf16* do_s = q_s + T::kQ / sizeof(bf16);
          for (int x = 0; x < live; ++x) {
            sm90::tma_load_4d(q_s + x * T::kTQ * 64, &map_q, &full[stage],
                              x * 64, h, q0, b);
            sm90::tma_load_4d(do_s + x * T::kTQ * 64, &map_do, &full[stage],
                              x * 64, h, q0, b);
          }
        } else {
          sm90::mbar_arrive(&full[stage]);
        }
        next_stage(stage, phase, T::kStages);
      }
    }
  } else if constexpr (T::kSplit) {
    sm90::setmaxnreg_inc<T::kConsumerRegs>();
    // The first consumer sums dV = P^T dO, the second dK = dS^T Q, over the
    // block's 64 keys.
    const bool dk_side = wg == 2;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = (lane & 3) * 2;
    const int key0 = k0 + warp * 16 + (lane >> 2);
    float acc[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    sm90::mbar_wait(kv_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < total; ++it) {
      const int q0 = q_lo + (it % nq) * T::kTQ;
      sm90::mbar_wait(&full[stage], phase);
      const bf16* q_s = reinterpret_cast<const bf16*>(ring +
                                                      stage * 2 * T::kQ);
      const bf16* do_s = q_s + T::kQ / sizeof(bf16);
      if (tile_live(p, q0, T::kTQ, k0, T::kN)) {
        // S^T = K Q^T (and dP^T = V dO^T), then P^T (and dS^T).
        float s[NQ][4], dp[NQ][4];
        const float* lse_s = rows_s + stage * 2 * T::kTQ;
        const bool full_tile = tile_full(p, q0, T::kTQ, k0, T::kN);
        uint32_t a[NQ / 2][4];
        sm90::wgmma_fence();
        if (dk_side) {
          scores<D>(s, dp, k_s, q_s, v_s, do_s, T::kN * 64, T::kTQ * 64);
          dkdv_pds_tile<true>(p, full_tile, s, dp, flags, key0, k0, q0, 0, t,
                              lse_s, lse_s + T::kTQ);
#pragma unroll
          for (int kk = 0; kk < NQ / 2; ++kk)
            acc_to_a(a[kk], dp[2 * kk], dp[2 * kk + 1]);
        } else {
          scores<D>(s, k_s, q_s, T::kN * 64, T::kTQ * 64);
          dkdv_pds_tile<false>(p, full_tile, s, dp, flags, key0, k0, q0, 0,
                               t, lse_s, lse_s + T::kTQ);
#pragma unroll
          for (int kk = 0; kk < NQ / 2; ++kk)
            acc_to_a(a[kk], s[2 * kk], s[2 * kk + 1]);
        }
        // dK += dS^T Q or dV += P^T dO, Q or dO read MN-major.
        const bf16* b_s = dk_side ? q_s : do_s;
        sm90::fence_operands(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk)
          sm90::wgmma_rs_tb(acc, a[kk],
                            sm90::desc_mn128(b_s + kk * 16 * 64,
                                             T::kTQ * kBoxRow));
        sm90::wgmma_commit();
        sm90::fence_operands(acc);
        sm90::wgmma_wait<0>();  // the stage is read; release it below
        sm90::fence_operands(acc);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      next_stage(stage, phase, T::kStages);
    }
    const size_t ks = (size_t)p.kv_heads * p.dim;
    store_rows<bf16, D / 8>(
        static_cast<bf16*>(dk_side ? p.dk : p.dv) + (size_t)b * S * ks +
            (size_t)hk * p.dim,
        ks, key0, S, p.dim, acc, t);
  } else {
    sm90::setmaxnreg_inc<T::kConsumerRegs>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = (lane & 3) * 2;
    const int kc = k0 + c * kWgRows;  // this consumer's 64 keys
    const int key0 = kc + warp * 16 + (lane >> 2);
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
      dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
    }
    const bf16* kw = k_s + c * kWgRows * 64;
    const bf16* vw = v_s + c * kWgRows * 64;
    sm90::mbar_wait(kv_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < total; ++it) {
      const int q0 = q_lo + (it % nq) * T::kTQ;
      sm90::mbar_wait(&full[stage], phase);
      const bf16* q_s = reinterpret_cast<const bf16*>(ring +
                                                      stage * 2 * T::kQ);
      const bf16* do_s = q_s + T::kQ / sizeof(bf16);
      if (kc < S && tile_live(p, q0, T::kTQ, kc, kWgRows)) {
        // S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in registers.
        float s[NQ][4], dp[NQ][4];
        sm90::wgmma_fence();
        scores<D>(s, dp, kw, q_s, vw, do_s, T::kN * 64, T::kTQ * 64);
        const float* lse_s = rows_s + stage * 2 * T::kTQ;
        dkdv_pds_tile(p, tile_full(p, q0, T::kTQ, kc, kWgRows), s, dp, flags,
                      key0, k0, q0, 0, t, lse_s, lse_s + T::kTQ);
        // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers,
        // dO and Q read MN-major.
        uint32_t pa[NQ / 2][4], dsa[NQ / 2][4];
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
          acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
          acc_to_a(dsa[kk], dp[2 * kk], dp[2 * kk + 1]);
        }
        sm90::fence_operands(dv);
        sm90::fence_operands(dk);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
          sm90::wgmma_rs_tb(dv, pa[kk],
                            sm90::desc_mn128(do_s + kk * 16 * 64,
                                             T::kTQ * kBoxRow));
          sm90::wgmma_rs_tb(dk, dsa[kk],
                            sm90::desc_mn128(q_s + kk * 16 * 64,
                                             T::kTQ * kBoxRow));
        }
        sm90::wgmma_commit();
        sm90::fence_operands(dv);
        sm90::fence_operands(dk);
        sm90::wgmma_wait<0>();  // the stage is read; release it below
        sm90::fence_operands(dv);
        sm90::fence_operands(dk);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      next_stage(stage, phase, T::kStages);
    }
    const size_t ks = (size_t)p.kv_heads * p.dim;
    const size_t kvoff = (size_t)b * S * ks + (size_t)hk * p.dim;
    store_rows<bf16, D / 8>(static_cast<bf16*>(p.dk) + kvoff, ks, key0, S,
                            p.dim, dk, t);
    store_rows<bf16, D / 8>(static_cast<bf16*>(p.dv) + kvoff, ks, key0, S,
                            p.dim, dv, t);
  }
}

// The bf16 forward: tensor maps of q, k and v, one block per (q tile,
// head, example), heaviest first.
template <int D>
cudaError_t launch_fwd_bf16(const Params& p, cudaStream_t stream) {
  using T = FwdTiles<D>;
  CUtensorMap map_q, map_k, map_v;
  if (!sm90::make_map_bf16_bshd(&map_q, p.q, p.batch, p.seq, p.heads, p.dim,
                                T::kM) ||
      !sm90::make_map_bf16_bshd(&map_k, p.k, p.batch, p.seq, p.kv_heads,
                                p.dim, T::kN) ||
      !sm90::make_map_bf16_bshd(&map_v, p.v, p.batch, p.seq, p.kv_heads,
                                p.dim, T::kN))
    return cudaErrorInvalidValue;
  const long long blocks =
      (long long)((p.seq + T::kM - 1) / T::kM) * p.heads * p.batch;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  static uint64_t done = 0;
  const cudaError_t err = allow_smem(flash_fwd_bf16<D>, T::kSmem, done);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16<D><<<(unsigned)blocks, T::kThreads, T::kSmem, stream>>>(
      map_q, map_k, map_v, p);
  return cudaGetLastError();
}

// The bf16 dq (which == kDq) or dk/dv kernel: tensor maps of q, k, v and
// dout, one block per output tile, heaviest first.
template <int D>
cudaError_t launch_bwd_bf16(int which, const Params& p,
                            cudaStream_t stream) {
  const bool dq = which == kDq;
  const uint32_t q_rows = dq ? DqTiles<D>::kM : DkdvTiles<D>::kTQ;
  const uint32_t k_rows = dq ? DqTiles<D>::kN : DkdvTiles<D>::kN;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!sm90::make_map_bf16_bshd(&map_q, p.q, p.batch, p.seq, p.heads, p.dim,
                                q_rows) ||
      !sm90::make_map_bf16_bshd(&map_do, p.dout, p.batch, p.seq, p.heads,
                                p.dim, q_rows) ||
      !sm90::make_map_bf16_bshd(&map_k, p.k, p.batch, p.seq, p.kv_heads,
                                p.dim, k_rows) ||
      !sm90::make_map_bf16_bshd(&map_v, p.v, p.batch, p.seq, p.kv_heads,
                                p.dim, k_rows))
    return cudaErrorInvalidValue;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                 Params) = dq ? flash_dq_bf16<D> : flash_dkdv_bf16<D>;
  const size_t smem = dq ? DqTiles<D>::kSmem : DkdvTiles<D>::kSmem;
  const long long tiles = (p.seq + (dq ? DqTiles<D>::kM : DkdvTiles<D>::kN) -
                           1) / (dq ? DqTiles<D>::kM : DkdvTiles<D>::kN);
  const long long blocks =
      tiles * (dq ? p.heads : p.kv_heads) * (long long)p.batch;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  static uint64_t done_dq = 0, done_dkdv = 0;
  const cudaError_t err = allow_smem(kernel, smem, dq ? done_dq : done_dkdv);
  if (err != cudaSuccess) return err;
  const int threads = dq ? DqTiles<D>::kThreads : DkdvTiles<D>::kThreads;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(map_q, map_k, map_v,
                                                      map_do, p);
  return cudaGetLastError();
}

cudaError_t dispatch(int which, int kind, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = template_width(p.dim);
  if (kind != 1 || width == 0 || p.batch <= 0 || p.seq <= 0 ||
      p.kv_heads <= 0 || p.heads % p.kv_heads != 0)
    return cudaErrorInvalidValue;
  const bool fwd = which == kForward;
  if (width == 64)
    return fwd ? launch_fwd_bf16<64>(p, s) : launch_bwd_bf16<64>(which, p, s);
  if (width == 128)
    return fwd ? launch_fwd_bf16<128>(p, s)
               : launch_bwd_bf16<128>(which, p, s);
  return fwd ? launch_fwd_bf16<256>(p, s) : launch_bwd_bf16<256>(which, p, s);
}

}  // namespace
