// flash_bwd.cu - attention backward (flash-2) for Hopper, sm_90a: two kernels.
//
// K2, dQ and delta. Replaces: ray_tpu/ops/attention.py::_dq_kernel
// (launched by _flash_backward). Per (batch*head) and row tile, sweeping
// the K tiles: P = exp(scale * Q K^T [masked] - lse), dP = dO V^T,
// dS = P * (dP - delta) * scale, dQ = sum_k dS K. It also computes
// delta = rowsum(dO * O) for its rows (the JAX package leaves that to
// XLA) and writes it out for K3.
//
// K3, dK and dV. Replaces: ray_tpu/ops/attention.py::_dkv_kernel (launched
// by _flash_backward). Per (batch*head) and 128-key tile (64 at head_dim
// 128), sweeping the Q tiles: P^T = exp(scale * K Q^T [masked] - lse), dV = sum_q P^T dO,
// dP^T = V dO^T, dS^T = P^T * (dP^T - delta) * scale, dK = sum_q dS^T Q.
//
// Both take lse (m + log l, f32 [BH, S], written by flash_fwd.cu); K3
// takes the delta (f32 [BH, S]) that K2 wrote, so K2 runs first. Both
// apply the causal mask as the TPU kernels do: DEFAULT_MASK_VALUE
// (-0.7 * FLT_MAX) after scaling, then exp(s - lse) with no log2 prescale,
// so a masked entry gives exactly 0 and never inf or NaN. P and dS are
// rounded to the input dtype before their products, as the TPU kernels
// round them (p.astype, ds.astype); every sum is kept in f32. No atomics:
// each block owns its output rows (K2 a Q tile's dQ and delta, K3 a K
// tile's dK and dV), so the gradients are bit-identical from run to run.
//
// What bounds them on an H100: at the GPT-2 shape (head_dim 64, S = 1024,
// causal) K2 does 3 matrix products over the causal pairs and moves 6
// tensors (q, k, v, dO and O read, dq written), about 253 flops per byte,
// under the card's ~295 flops/byte ridge: bound by bytes. K3 does 4
// products over the same 6 tensors, about 338 flops per byte: bound by
// operations, by a small margin. At head_dim 128 and S = 2048 both are
// bound by operations.
//
// K2, bf16 (K3's mirror image: it holds Q and dO and streams K and V):
// one block of one consumer warpgroup (64 query rows) and a producer warp
// per (bh, row tile); row tiles are issued last-first, so the long causal
// rows start early.
//   * The producer warp loads Q and dO once by TMA (cp.async.bulk.tensor)
//     and then keeps the 64-key K and V tiles of the sweep (which stops
//     at the diagonal when causal) in flight by TMA in a ring of kDqStages
//     stages, each guarded by a full/empty mbarrier pair. No __syncthreads
//     brackets a copy.
//   * Delta: while those loads are in flight, each consumer thread reads
//     its two rows' lse and, from global memory, a quarter of each row of
//     dO and O (the four threads of a row's quad split the columns, then
//     add their sums by shuffles), so delta lands in the accumulator's row
//     layout with no swizzled shared-memory read. It stays in registers
//     for the sweep and is written out once.
//   * All three products run on wgmma.mma_async: S = Q K^T and dP = dO V^T
//     with both operands from shared memory, K-major as stored; dQ += dS K
//     with dS from registers (it comes out of the first two products in
//     the A-fragment layout) and the K tile read MN-major through the
//     descriptor. Nothing is staged transposed. The mask runs only on
//     tiles that cross the diagonal or S.
//   * Registers: a consumer thread holds dQ (D/2 f32), S and dP of a
//     64-key tile (64) and dS packed (16). A block is 160 threads, so an
//     SM holds three blocks below head_dim 128 (at most 136 registers a
//     thread; ptxas uses 107-122) and two at 128 (ptxas uses 157), and
//     the blocks' warpgroups overlap one another's products and softmax. A
//     block of two warpgroups (128 rows, one block an SM, K and V loaded
//     once for twice the rows) measured about 10% slower on an H100 at
//     head_dim 64 and no faster at 128 (PERF.md).
//   * Ragged S: TMA fills Q and dO rows >= S and K and V rows >= S with
//     zeros (3-D maps end at each head's S); keys >= S get the mask value,
//     rows >= S get zero lse and delta, and neither their dQ nor their
//     delta is stored.
//
// K3, bf16 (the FlashAttention-3 backward layout without dQ): one block of
// consumer warpgroups, 64 keys each, and a producer warp per (bh, key
// tile), sweeping the 64-row Q tiles from the diagonal when causal.
//   * The producer warp loads K and V once by TMA (cp.async.bulk.tensor)
//     and then keeps the Q and dO tiles of the sweep in flight by TMA in a
//     ring of kDkvStages stages, each guarded by a full/empty mbarrier
//     pair. No __syncthreads brackets a copy. Its lanes also copy the 64
//     lse and delta values of each tile into the stage with plain loads:
//     TMA needs a 16-byte-aligned start, which a row of a [BH, S] f32
//     array has only when S is a multiple of 4.
//   * All four products run on wgmma.mma_async: S^T = K Q^T and dP^T = V dO^T with both operands
//     from shared memory, K-major as stored; dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T from registers (they come out of the
//     first two products in the A-fragment layout) and dO and Q read
//     MN-major through the descriptor. Nothing is staged transposed.
//   * Registers: a consumer thread holds dK and dV (D f32 together), S^T
//     and dP^T of a 64-query tile (64), and never the K and V fragments,
//     which wgmma reads from shared memory. Below head_dim 128 that fits
//     the 168 registers a thread of two consumer warpgroups can have
//     (hopper.cuh), so a block owns 128 keys. At 128 it does not (ptxas
//     spilled 240 bytes at 168, and setmaxnreg did not lift the limit), so
//     a block owns 64 keys with one consumer warpgroup, whose threads may
//     hold 255; the tile is worked in two 32-query halves there, so S^T
//     and dP^T take 32. No instantiation spills (chip_smoke.py prints
//     ptxas's report).
//   * Ragged S: TMA fills Q and dO rows >= S with zeros (3-D maps end at
//     each head's S) and the producer stores zero lse and delta for
//     queries >= S. Those queries get the mask value, so they add exactly
//     0; keys >= S are not stored.
//   * Tiles of both kernels are swizzled by row width (32B at head_dim 16,
//     64B at 32, 128B at 64; two 64-column boxes a tile at 128): see
//     hopper.cuh.
//
// The f32 instantiations of both: grid (ceil(S/64), B*H), one block of 4
// warps, SIMT FMAs (no TF32), two threads per row; they check the
// algorithm on the card apart from bf16. K2's f32 kernel computes and
// writes delta as the bf16 one does, so both dtypes keep one C contract.
//
// C interface (loaded with ctypes): ray_tpu_torch_flash_bwd_dq(...) and
// ray_tpu_torch_flash_bwd_dkv(...) return cudaGetLastError() after the
// launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;  // Q rows per tile (f32 kernels)
constexpr int kBlockK = 64;  // K rows per tile (== kBlockQ: causal tile skips)
constexpr int kThreads = 128;
constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// ---------------------------------------------------------------------------
// K2 bf16: warp-specialised, TMA ring, wgmma. One block per (bh, 64-row
// Q tile): one consumer warpgroup, then the producer warp.
// ---------------------------------------------------------------------------
constexpr int kDqRows = 64;   // query rows per block: one consumer warpgroup
constexpr int kDqKeys = 64;   // keys per K/V tile (== kDqRows: causal tile skips)
constexpr int kDqStages = 2;  // K/V ring depth
using DqRoles = hopper::WarpRoles<1>;

template <int D>
struct DqSmem {
  using Tile = hopper::Tile<D, 64>;  // a Q, dO, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + Tile::kBytes;
  static constexpr int kK = kDO + Tile::kBytes;               // [kDqStages]
  static constexpr int kV = kK + kDqStages * Tile::kBytes;    // [kDqStages]
  static constexpr int kBar = kV + kDqStages * Tile::kBytes;  // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kDqStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  // Blocks an SM the registers allow (see the note at the top).
  static constexpr int kBlocksPerSM = D == 128 ? 2 : 3;
};

// rowsum(dO * O) of row `row` of a [seq, D] head in f32: each thread of the
// row's quad (t = 0..3) sums D/4 columns with 8- or 16-byte loads, then the
// quad adds its four sums. A row >= seq gives 0. Every lane calls it (the
// shuffles).
template <int D>
__device__ __forceinline__ float row_delta(const bf16* dout, const bf16* o, int row,
                                           int seq, int t) {
  constexpr int kCols = D / 4;                 // columns per thread
  constexpr int kVec = kCols < 8 ? kCols : 8;  // bf16 per load
  using Vec = typename std::conditional<kVec == 8, uint4, uint2>::type;
  float s = 0.f;
  if (row < seq) {
    const size_t off = (size_t)row * D + t * kCols;
#pragma unroll
    for (int c = 0; c < kCols; c += kVec) {
      const Vec xv = *reinterpret_cast<const Vec*>(dout + off + c);
      const Vec yv = *reinterpret_cast<const Vec*>(o + off + c);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
      for (int i = 0; i < kVec / 2; ++i) {
        const float2 x = __bfloat1622float2(x2[i]), y = __bfloat1622float2(y2[i]);
        s = fmaf(x.x, y.x, s);  // a bf16 product is exact in f32
        s = fmaf(x.y, y.y, s);
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

template <int D>
__global__ void __launch_bounds__(DqRoles::kThreads, DqSmem<D>::kBlocksPerSM)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const bf16* __restrict__ o, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         bf16* __restrict__ dq, int seq, float scale, int causal) {
  using L = DqSmem<D>;
  using Tile = typename L::Tile;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_bar = base + L::kBar;
  auto full_bar = [&](int s) { return q_bar + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return q_bar + 8u * (1 + kDqStages + s); };

  const int qtile = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int q0 = qtile * kDqRows;
  const int bh = blockIdx.y;
  const int all_tiles = (seq + kDqKeys - 1) / kDqKeys;
  const int n_tiles = causal ? min(all_tiles, qtile + 1) : all_tiles;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), DqRoles::kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= DqRoles::kConsumerThreads) {
    // Producer warp: one thread loads Q and dO, then keeps the ring full.
    if (threadIdx.x == DqRoles::kConsumerThreads) {
      hopper::mbar_expect_tx(q_bar, 2 * Tile::kBytes);
      Tile::load(&qmap, base + L::kQ, q_bar, q0, bh);
      Tile::load(&domap, base + L::kDO, q_bar, q0, bh);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kDqStages;
        hopper::mbar_wait(empty_bar(s), ((kt / kDqStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full_bar(s), 2 * Tile::kBytes);
        Tile::load(&kmap, base + L::kK + s * Tile::kBytes, full_bar(s), kt * kDqKeys, bh);
        Tile::load(&vmap, base + L::kV + s * Tile::kBytes, full_bar(s), kt * kDqKeys, bh);
      }
    }
  } else {
    // The consumer warpgroup: 64 query rows, dQ in registers.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + warp * 16 + g;
    const int row1 = row0 + 8;
    const size_t rows = (size_t)bh * seq;  // this head's first row
    const size_t hbase = rows * D;

    // lse and delta of this thread's two rows, while the producer's loads
    // are in flight; rows >= seq get 0 and are not stored.
    const float lse0 = row0 < seq ? lse[rows + row0] : 0.f;
    const float lse1 = row1 < seq ? lse[rows + row1] : 0.f;
    const float dl0 = row_delta<D>(dout + hbase, o + hbase, row0, seq, t);
    const float dl1 = row_delta<D>(dout + hbase, o + hbase, row1, seq, t);
    if (t == 0) {
      if (row0 < seq) delta[rows + row0] = dl0;
      if (row1 < seq) delta[rows + row1] = dl1;
    }

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

    hopper::mbar_wait(q_bar, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kDqStages;
      const int k0 = kt * kDqKeys;
      hopper::mbar_wait(full_bar(s), (kt / kDqStages) & 1);
      const uint32_t kb = base + L::kK + s * Tile::kBytes;
      const uint32_t vb = base + L::kV + s * Tile::kBytes;

      // S = Q K^T and dP = dO V^T, 64 rows x 64 keys each.
      float sc[kDqKeys / 2], dp[kDqKeys / 2];
#pragma unroll
      for (int j = 0; j < kDqKeys / 2; ++j) sc[j] = dp[j] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<kDqKeys>(sc, Tile::kmajor(base + L::kQ, 0, kk),
                                  Tile::kmajor(kb, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<kDqKeys>(dp, Tile::kmajor(base + L::kDO, 0, kk),
                                  Tile::kmajor(vb, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // dS = P * (dP - delta) * scale, the mask only where the tile crosses
      // S or the diagonal. A key >= seq is masked (P = 0) and has zero V.
      const bool edge = k0 + kDqKeys > seq || (causal && kt == qtile);
#pragma unroll
      for (int j = 0; j < kDqKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale;
          if (edge) {
            const int key = k0 + j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (key >= seq || (causal && key > row)) x = kMaskValue;
          }
          const float p = __expf(x - (e < 2 ? lse0 : lse1));
          dp[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1)) * scale;
        }
      }
      uint32_t da[kDqKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }

      // dQ += dS K, the key axis as depth: K read MN-major from the stage,
      // no transposed copy.
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk)
        hopper::wgmma_rs<D>(dqa, da[kk], Tile::mnmajor(kb, kk), 1);
      hopper::wgmma_commit();
      hopper::fence_regs(dqa);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dqa);
      if (lane == 0) hopper::mbar_arrive(empty_bar(s));  // the stage is free
    }

#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (row0 < seq)
        *reinterpret_cast<uint32_t*>(dq + hbase + (size_t)row0 * D + c) =
            pack_bf16(dqa[4 * j + 0], dqa[4 * j + 1]);
      if (row1 < seq)
        *reinterpret_cast<uint32_t*>(dq + hbase + (size_t)row1 * D + c) =
            pack_bf16(dqa[4 * j + 2], dqa[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3 bf16: warp-specialised, TMA ring, wgmma (the FlashAttention-3 backward
// layout without dQ). One block per (bh, key tile): consumer warpgroups of
// 64 keys each, then the producer warp.
// ---------------------------------------------------------------------------
constexpr int kDkvQueries = 64;   // queries per Q/dO tile
constexpr int kDkvStages = 2;     // Q/dO/lse/delta ring depth

template <int D>
struct DkvSmem {
  // 64 keys per consumer warpgroup: two below head_dim 128; one at 128,
  // where dK, dV, S^T and dP^T need more than the 168 registers a thread
  // of a two-warpgroup block can have.
  static constexpr int kConsumers = D == 128 ? 1 : 2;
  static constexpr int kKeys = 64 * kConsumers;
  using Roles = hopper::WarpRoles<kConsumers>;
  using KTile = hopper::Tile<D, kKeys>;
  using QTile = hopper::Tile<D, kDkvQueries>;
  static constexpr int kRowBytes = kDkvQueries * 4;  // one f32 row of lse or delta
  static constexpr int kK = 0;
  static constexpr int kV = kK + KTile::kBytes;
  static constexpr int kQ = kV + KTile::kBytes;                  // [kDkvStages]
  static constexpr int kDO = kQ + kDkvStages * QTile::kBytes;    // [kDkvStages]
  static constexpr int kLse = kDO + kDkvStages * QTile::kBytes;  // [kDkvStages]
  static constexpr int kDelta = kLse + kDkvStages * kRowBytes;   // [kDkvStages]
  static constexpr int kBar = kDelta + kDkvStages * kRowBytes;   // kv, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kDkvStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static constexpr uint32_t kStageTx = 2 * QTile::kBytes;  // Q and dO
};

template <int D>
__global__ void __launch_bounds__(DkvSmem<D>::Roles::kThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int seq,
                          float scale, int causal) {
  using L = DkvSmem<D>;
  using KTile = typename L::KTile;
  using QTile = typename L::QTile;
  using Roles = typename L::Roles;
  constexpr int kChunk = D == 128 ? 32 : kDkvQueries;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = hopper::smem_addr(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = wg_smem + (base - raw);  // generic pointer to `base`
  const uint32_t kv_bar = base + L::kBar;
  auto full_bar = [&](int s) { return kv_bar + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return kv_bar + 8u * (1 + kDkvStages + s); };

  const int k0 = blockIdx.x * L::kKeys;
  const int bh = blockIdx.y;
  const int n_qt = (seq + kDkvQueries - 1) / kDkvQueries;
  const int qt0 = causal ? k0 / kDkvQueries : 0;  // sweep from the diagonal

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      // full: the TMA arrival with its bytes, and one per producer lane
      // once its lse and delta values are stored.
      hopper::mbar_init(full_bar(s), 1 + 32);
      hopper::mbar_init(empty_bar(s), Roles::kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= Roles::kConsumerThreads) {
    // Producer warp: K and V once, then Q, dO, lse and delta per query tile.
    const int lane = threadIdx.x - Roles::kConsumerThreads;
    const size_t rows = (size_t)bh * seq;
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_bar, 2 * KTile::kBytes);
      KTile::load(&kmap, base + L::kK, kv_bar, k0, bh);
      KTile::load(&vmap, base + L::kV, kv_bar, k0, bh);
    }
    for (int i = 0; qt0 + i < n_qt; ++i) {
      const int s = i % kDkvStages;
      const int q0 = (qt0 + i) * kDkvQueries;
      hopper::mbar_wait(empty_bar(s), ((i / kDkvStages) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(full_bar(s), L::kStageTx);
        QTile::load(&qmap, base + L::kQ + s * QTile::kBytes, full_bar(s), q0, bh);
        QTile::load(&domap, base + L::kDO + s * QTile::kBytes, full_bar(s), q0, bh);
      }
      // lse and delta by plain loads (see the note at the top); queries
      // >= seq get zero.
      float* ls = reinterpret_cast<float*>(smem + L::kLse + s * L::kRowBytes);
      float* dls = reinterpret_cast<float*>(smem + L::kDelta + s * L::kRowBytes);
      for (int r = lane; r < kDkvQueries; r += 32) {
        const bool in = q0 + r < seq;
        ls[r] = in ? lse[rows + q0 + r] : 0.f;
        dls[r] = in ? delta[rows + q0 + r] : 0.f;
      }
      hopper::mbar_arrive(full_bar(s));
    }
  } else {
    // Consumers: 64 keys per warpgroup, dK and dV in registers.
    const int r0 = (threadIdx.x / 128) * 64;  // this warpgroup's keys in the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = k0 + r0 + warp * 16 + g;
    const int key1 = key0 + 8;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    hopper::mbar_wait(kv_bar, 0);
    for (int i = 0; qt0 + i < n_qt; ++i) {
      const int s = i % kDkvStages;
      const int q0 = (qt0 + i) * kDkvQueries;
      hopper::mbar_wait(full_bar(s), (i / kDkvStages) & 1);
      if (causal && q0 + kDkvQueries <= k0 + r0) {
        // Every query of the tile precedes every key here: P = 0.
        if (lane == 0) hopper::mbar_arrive(empty_bar(s));
        continue;
      }
      const uint32_t qb = base + L::kQ + s * QTile::kBytes;
      const uint32_t dob = base + L::kDO + s * QTile::kBytes;
      const float* ls = reinterpret_cast<const float*>(smem + L::kLse + s * L::kRowBytes);
      const float* dls = reinterpret_cast<const float*>(smem + L::kDelta + s * L::kRowBytes);

      // The tile is worked kChunk queries at a time (all 64 below head_dim
      // 128; two halves at 128, so S^T and dP^T fit beside dK and dV).
      const bool edge = q0 + kDkvQueries > seq || (causal && k0 + r0 + 63 > q0);
#pragma unroll
      for (int h = 0; h < kDkvQueries / kChunk; ++h) {
        // S^T = K Q^T and dP^T = V dO^T, 64 keys x kChunk queries each.
        float st[kChunk / 2], dpt[kChunk / 2];
#pragma unroll
        for (int j = 0; j < kChunk / 2; ++j) st[j] = dpt[j] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<kChunk>(st, KTile::kmajor(base + L::kK, r0, kk),
                                   QTile::kmajor(qb, h * kChunk, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<kChunk>(dpt, KTile::kmajor(base + L::kV, r0, kk),
                                   QTile::kmajor(dob, h * kChunk, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);

        // P^T and dS^T = P^T * (dP^T - delta) * scale. A query >= seq is
        // masked (P = 0) and has zero dO, lse and delta, so it adds 0.
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = h * kChunk + j * 8 + 2 * t + (e & 1);
            const int query = q0 + qi;
            float x = st[4 * j + e] * scale;
            if (edge) {
              const int key = e < 2 ? key0 : key1;
              if (query >= seq || (causal && key > query)) x = kMaskValue;
            }
            const float p = __expf(x - ls[qi]);
            st[4 * j + e] = p;
            dpt[4 * j + e] = p * (dpt[4 * j + e] - dls[qi]) * scale;
          }
        }
        uint32_t pa[kChunk / 16][4], da[kChunk / 16][4];
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
          }
        }

        // dV += P^T dO and dK += dS^T Q, the query axis as depth: dO and Q
        // read MN-major from the stage, no transposed copy.
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          const int depth = h * (kChunk / 16) + kk;
          hopper::wgmma_rs<D>(dva, pa[kk], QTile::mnmajor(dob, depth), 1);
          hopper::wgmma_rs<D>(dka, da[kk], QTile::mnmajor(qb, depth), 1);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(dva);
        hopper::fence_regs(dka);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dva);
        hopper::fence_regs(dka);
      }
      if (lane == 0) hopper::mbar_arrive(empty_bar(s));  // the stage is free
    }

    const size_t obase = (size_t)bh * seq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (key0 < seq) {
        const size_t off = obase + (size_t)key0 * D + c;
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dka[4 * j + 0], dka[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[4 * j + 0], dva[4 * j + 1]);
      }
      if (key1 < seq) {
        const size_t off = obase + (size_t)key1 * D + c;
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dka[4 * j + 2], dka[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT FMAs, no TF32. Two threads per row (a Q row in K2, a K row in
// K3): thread h (0/1) scores the columns 2i+h of each tile and accumulates
// output columns [h*D/2, (h+1)*D/2); the pair swaps dS (and P) with one
// shuffle per column pair. Shared rows are padded to D + 1 floats, so
// column reads are free of bank conflicts.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t f32_smem() {  // four [64][D + 1] tiles, two [64] rows
  return sizeof(float) * (4 * (size_t)64 * (D + 1) + 2 * 64);
}

// Stages rows [r0, r0 + 64) of two row-major [seq, D] f32 matrices into
// [64][D + 1] tiles; rows >= seq are zero.
template <int D>
__device__ __forceinline__ void stage_f32(const float* a, const float* b, int r0,
                                          int seq, float* as, float* bs) {
  constexpr int kS = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = r0 + r < seq;
    const size_t off = (size_t)(r0 + r) * D + c;
    as[r * kS + c] = in ? a[off] : 0.f;
    bs[r * kS + c] = in ? b[off] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int seq,
                        float scale, int causal) {
  constexpr int kS = D + 1;
  constexpr int kHalf = D / 2;
  constexpr int kCols = kBlockK / 2;  // keys scored per thread per tile
  extern __shared__ float smem[];
  float* qs = smem;                  // [row][d]
  float* dos = qs + kBlockQ * kS;    // [row][d]
  float* ks = dos + kBlockQ * kS;    // [key][d]
  float* vs = ks + kBlockK * kS;     // [key][d]

  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int q0 = qtile * kBlockQ;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int r = threadIdx.x / 2, h = threadIdx.x % 2;
  const int row = q0 + r;

  stage_f32<D>(q + base, dout + base, q0, seq, qs, dos);
  const float lse_r = row < seq ? lse[rbase + row] : 0.f;
  // delta = rowsum(dO * O): each thread of the row's pair sums its half of
  // the columns from global memory, the pair adds the two.
  float dl_r = 0.f;
  if (row < seq) {
    const size_t off = base + (size_t)row * D + h * kHalf;
#pragma unroll 8
    for (int c = 0; c < kHalf; ++c) dl_r = fmaf(dout[off + c], o[off + c], dl_r);
  }
  dl_r += __shfl_xor_sync(0xffffffffu, dl_r, 1);
  if (h == 0 && row < seq) delta[rbase + row] = dl_r;

  float acc[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) acc[c] = 0.f;

  const int all_tiles = (seq + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(all_tiles, qtile + 1) : all_tiles;
  for (int kti = 0; kti < n_tiles; ++kti) {
    const int k0 = kti * kBlockK;
    __syncthreads();
    stage_f32<D>(k + base, v + base, k0, seq, ks, vs);
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * kS + d], dd = dos[r * kS + d];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        s[i] = fmaf(qd, ks[(2 * i + h) * kS + d], s[i]);
        dp[i] = fmaf(dd, vs[(2 * i + h) * kS + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int key = k0 + 2 * i + h;
      float x = s[i] * scale;
      if (key >= seq || (causal && key > row)) x = kMaskValue;
      s[i] = expf(x - lse_r) * (dp[i] - dl_r) * scale;  // dS
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const float other = __shfl_xor_sync(0xffffffffu, s[i], 1);
      const float ds_even = h ? other : s[i];
      const float ds_odd = h ? s[i] : other;
      const float* k_even = ks + (2 * i) * kS + h * kHalf;
      const float* k_odd = k_even + kS;
#pragma unroll
      for (int c = 0; c < kHalf; ++c)
        acc[c] = fmaf(ds_odd, k_odd[c], fmaf(ds_even, k_even[c], acc[c]));
    }
  }

  if (row < seq) {
    float* out = dq + base + (size_t)row * D + h * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) out[c] = acc[c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int seq, float scale, int causal) {
  constexpr int kS = D + 1;
  constexpr int kHalf = D / 2;
  constexpr int kCols = kBlockQ / 2;  // queries scored per thread per tile
  extern __shared__ float smem[];
  float* ks = smem;                  // [key][d]
  float* vs = ks + kBlockK * kS;     // [key][d]
  float* qs = vs + kBlockK * kS;     // [query][d]
  float* dos = qs + kBlockQ * kS;    // [query][d]
  float* ls = dos + kBlockQ * kS;    // [query] lse
  float* dls = ls + kBlockQ;         // [query] delta

  const int ktile = blockIdx.x;
  const int k0 = ktile * kBlockK;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int r = threadIdx.x / 2, h = threadIdx.x % 2;
  const int key = k0 + r;

  stage_f32<D>(k + base, v + base, k0, seq, ks, vs);

  float dka[kHalf], dva[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) dka[c] = dva[c] = 0.f;

  const int n_tiles = (seq + kBlockQ - 1) / kBlockQ;
  for (int qti = causal ? ktile : 0; qti < n_tiles; ++qti) {
    const int q0 = qti * kBlockQ;
    __syncthreads();
    stage_f32<D>(q + base, dout + base, q0, seq, qs, dos);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      const bool in = q0 + i < seq;  // rows >= seq: lse = delta = 0
      ls[i] = in ? lse[rbase + q0 + i] : 0.f;
      dls[i] = in ? delta[rbase + q0 + i] : 0.f;
    }
    __syncthreads();

    float st[kCols], dpt[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = ks[r * kS + d], vd = vs[r * kS + d];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        st[i] = fmaf(kd, qs[(2 * i + h) * kS + d], st[i]);
        dpt[i] = fmaf(vd, dos[(2 * i + h) * kS + d], dpt[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int qi = 2 * i + h;
      const int query = q0 + qi;
      float x = st[i] * scale;
      if (query >= seq || (causal && key > query)) x = kMaskValue;
      st[i] = expf(x - ls[qi]);                          // P^T
      dpt[i] = st[i] * (dpt[i] - dls[qi]) * scale;       // dS^T
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const float p_other = __shfl_xor_sync(0xffffffffu, st[i], 1);
      const float ds_other = __shfl_xor_sync(0xffffffffu, dpt[i], 1);
      const float p_even = h ? p_other : st[i], p_odd = h ? st[i] : p_other;
      const float ds_even = h ? ds_other : dpt[i], ds_odd = h ? dpt[i] : ds_other;
      const float* q_even = qs + (2 * i) * kS + h * kHalf;
      const float* d_even = dos + (2 * i) * kS + h * kHalf;
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        dva[c] = fmaf(p_odd, d_even[c + kS], fmaf(p_even, d_even[c], dva[c]));
        dka[c] = fmaf(ds_odd, q_even[c + kS], fmaf(ds_even, q_even[c], dka[c]));
      }
    }
  }

  if (key < seq) {
    const size_t off = base + (size_t)key * D + h * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      dk[off + c] = dka[c];
      dv[off + c] = dva[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch: every kernel takes dynamic shared memory (above 48 KB at
// head_dim 128, and for every f32 instantiation), so each launch raises
// its limit first.
// ---------------------------------------------------------------------------
struct BwdArgs {
  const void *q, *k, *v, *o, *dout;  // o: K2 only
  const float* lse;
  float* delta;  // written by K2, read by K3
  void *dq, *dk, *dv;
  int bh, seq, causal;
  float scale;
  cudaStream_t stream;
};

// Both dtypes of K2 take a grid of 64-row Q tiles; bf16 also takes
// tensor maps.
template <int D>
cudaError_t launch_dq(const BwdArgs& a, int dtype) {
  cudaError_t err;
  const dim3 grid((a.seq + kDqRows - 1) / kDqRows, a.bh);
  if (dtype == 1) {
    CUtensorMap qmap, kmap, vmap, domap;
    err = hopper::map_rows(&qmap, a.q, a.bh, a.seq, D, kDqRows);
    if (err == cudaSuccess) err = hopper::map_rows(&domap, a.dout, a.bh, a.seq, D, kDqRows);
    if (err == cudaSuccess) err = hopper::map_rows(&kmap, a.k, a.bh, a.seq, D, kDqKeys);
    if (err == cudaSuccess) err = hopper::map_rows(&vmap, a.v, a.bh, a.seq, D, kDqKeys);
    if (err != cudaSuccess) return err;
    constexpr int smem = DqSmem<D>::kAlloc;
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<D><<<grid, DqRoles::kThreads, smem, a.stream>>>(
        qmap, kmap, vmap, domap, static_cast<const bf16*>(a.o),
        static_cast<const bf16*>(a.dout), a.lse, a.delta, static_cast<bf16*>(a.dq), a.seq,
        a.scale, a.causal);
  } else {
    constexpr size_t smem = f32_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.o),
        static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dq), a.seq,
        a.scale, a.causal);
  }
  return cudaGetLastError();
}

// K3 bf16 takes its own grid of key tiles and tensor maps; f32 keeps the
// 64-row grid of the SIMT kernels.
template <int D>
cudaError_t launch_dkv(const BwdArgs& a, int dtype) {
  cudaError_t err;
  if (dtype == 1) {
    CUtensorMap qmap, kmap, vmap, domap;
    err = hopper::map_rows(&qmap, a.q, a.bh, a.seq, D, kDkvQueries);
    if (err == cudaSuccess) err = hopper::map_rows(&domap, a.dout, a.bh, a.seq, D, kDkvQueries);
    if (err == cudaSuccess) err = hopper::map_rows(&kmap, a.k, a.bh, a.seq, D, DkvSmem<D>::kKeys);
    if (err == cudaSuccess) err = hopper::map_rows(&vmap, a.v, a.bh, a.seq, D, DkvSmem<D>::kKeys);
    if (err != cudaSuccess) return err;
    constexpr int smem = DkvSmem<D>::kAlloc;
    err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.seq + DkvSmem<D>::kKeys - 1) / DkvSmem<D>::kKeys, a.bh);
    flash_bwd_dkv_bf16_kernel<D><<<grid, DkvSmem<D>::Roles::kThreads, smem, a.stream>>>(
        qmap, kmap, vmap, domap, a.lse, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.seq, a.scale, a.causal);
  } else {
    constexpr size_t smem = f32_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.seq + kBlockK - 1) / kBlockK, a.bh);
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
        a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.seq, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

template <cudaError_t (*F16)(const BwdArgs&, int), cudaError_t (*F32)(const BwdArgs&, int),
          cudaError_t (*F64)(const BwdArgs&, int), cudaError_t (*F128)(const BwdArgs&, int)>
cudaError_t dispatch(const BwdArgs& a, int head_dim, int dtype) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return F16(a, dtype);
    case 32: return F32(a, dtype);
    case 64: return F64(a, dtype);
    case 128: return F128(a, dtype);
  }
  return cudaErrorInvalidValue;
}

cudaError_t prepare(BwdArgs& a, int bh, int seq, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh <= 0 || bh > 65535 || seq <= 0) return cudaErrorInvalidValue;
  a.bh = bh;
  a.seq = seq;
  a.stream = static_cast<cudaStream_t>(stream);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout, dq: contiguous
// [bh, seq, head_dim] of that dtype; lse (read) and delta (written:
// rowsum(dout * o)): f32 [bh, seq]. Returns a cudaError_t (0 = launched).
extern "C" int ray_tpu_torch_flash_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, int bh, int seq,
                                          int head_dim, int dtype, int causal,
                                          float scale, int device, void* stream) {
  BwdArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.causal = causal;
  a.scale = scale;
  cudaError_t err = prepare(a, bh, seq, device, stream);
  if (err != cudaSuccess) return err;
  return dispatch<launch_dq<16>, launch_dq<32>, launch_dq<64>, launch_dq<128>>(
      a, head_dim, dtype);
}

// q, k, v, dout and lse as above, delta as K2 wrote it; writes dk and dv,
// contiguous [bh, seq, head_dim] of the dtype.
extern "C" int ray_tpu_torch_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int bh,
                                           int seq, int head_dim, int dtype, int causal,
                                           float scale, int device, void* stream) {
  BwdArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(const_cast<void*>(delta));  // read only
  a.dk = dk;
  a.dv = dv;
  a.causal = causal;
  a.scale = scale;
  cudaError_t err = prepare(a, bh, seq, device, stream);
  if (err != cudaSuccess) return err;
  return dispatch<launch_dkv<16>, launch_dkv<32>, launch_dkv<64>, launch_dkv<128>>(
      a, head_dim, dtype);
}
