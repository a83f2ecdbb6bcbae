// flash_bwd.cu - attention backward (flash-2) for Hopper, sm_90a: two kernels.
//
// K2, dQ. Replaces: ray_tpu/ops/attention.py::_dq_kernel (launched by
// _flash_backward). Per (batch*head) and 64-row Q tile, sweeping the K
// tiles: P = exp(scale * Q K^T [masked] - lse), dP = dO V^T,
// dS = P * (dP - delta) * scale, dQ = sum_k dS K.
//
// K3, dK and dV. Replaces: ray_tpu/ops/attention.py::_dkv_kernel (launched
// by _flash_backward). Per (batch*head) and 128-key tile (64 at head_dim
// 128), sweeping the Q tiles: P^T = exp(scale * K Q^T [masked] - lse), dV = sum_q P^T dO,
// dP^T = V dO^T, dS^T = P^T * (dP^T - delta) * scale, dK = sum_q dS^T Q.
//
// Both take lse (m + log l, f32 [BH, S], written by flash_fwd.cu) and
// delta = rowsum(dO * O) (f32 [BH, S], computed by the caller), and apply
// the causal mask as the TPU kernels do: DEFAULT_MASK_VALUE
// (-0.7 * FLT_MAX) after scaling, then exp(s - lse) with no log2 prescale,
// so a masked entry gives exactly 0 and never inf or NaN. P and dS are
// rounded to the input dtype before their products, as the TPU kernels
// round them (p.astype, ds.astype); every sum is kept in f32. No atomics:
// each block owns its output rows (K2 a Q tile's dQ, K3 a K tile's dK and
// dV), so the gradients are bit-identical from run to run.
//
// What bounds them on an H100: at the GPT-2 shape (head_dim 64, S = 1024,
// causal) K2 does 3 and K3 4 matrix products over the causal pairs, about
// 304 (K2) and 338 (K3) flops per byte they must move, just above the
// card's ~295 flops/byte ridge: at the data-sheet peaks both are bound by
// operations, by a small margin.
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
//   * Tiles are swizzled by row width (32B at head_dim 16, 64B at 32, 128B
//     at 64; two 64-column boxes a tile at 128): see hopper.cuh.
//
// K2 (bf16, unchanged) and the f32 instantiations of both: grid
// (ceil(S/64), B*H), one block of 4 warps, 16 rows per warp. K2 keeps its
// rows' Q and dO fragments, lse and delta in registers for the whole K
// sweep (which stops at the diagonal when causal) and issues Q tiles
// last-first. It issues mma.sync and stages K and V per 64-row tile in
// shared memory, row-major for S and dP and transposed for dQ += dS K
// (rows padded by 8 elements against bank conflicts); dS never leaves
// registers. The f32 kernels use SIMT FMAs (no TF32), two threads per
// row; they check the algorithm on the card apart from bf16.
//
// C interface (loaded with ctypes): ray_tpu_torch_flash_bwd_dq(...) and
// ray_tpu_torch_flash_bwd_dkv(...) return cudaGetLastError() after the
// launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;  // Q rows per tile
constexpr int kBlockK = 64;  // K rows per tile (== kBlockQ: causal tile skips)
constexpr int kThreads = 128;
constexpr int kPad = 8;      // bf16 elements of row padding in shared memory
constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// d += a * b for one 16x8x16 tile: a is 16x16 row-major, b 16x8 col-major.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Loads the A fragments of 16 rows (row0 and row0 + 8 per lane) of a
// row-major [seq, D] matrix; rows >= seq read as zero.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const bf16* m, int row0, int seq,
                                            int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bf16* p0 = m + (size_t)row0 * D + c;
    const bf16* p1 = m + (size_t)row1 * D + c;
    f[kk][0] = row0 < seq ? ld32(p0) : 0u;
    f[kk][1] = row1 < seq ? ld32(p1) : 0u;
    f[kk][2] = row0 < seq ? ld32(p0 + 8) : 0u;
    f[kk][3] = row1 < seq ? ld32(p1 + 8) : 0u;
  }
}

// Stages 64 rows [r0, r0 + 64) of two row-major [seq, D] matrices into
// shared memory, each both row-major (stride D + kPad) and, where the
// transposed pointer is given, transposed (stride 64 + kPad). Rows >= seq
// are zero.
template <int D>
__device__ __forceinline__ void stage_tile(const bf16* a, const bf16* b,
                                           int r0, int seq, bf16* a_rows,
                                           bf16* b_rows, bf16* a_t,
                                           bf16* b_t) {
  constexpr int kRow = D + kPad, kCol = 64 + kPad, kVec = D / 8;
  for (int i = threadIdx.x; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 av = make_uint4(0u, 0u, 0u, 0u), bv = av;
    if (r0 + r < seq) {
      const size_t off = (size_t)(r0 + r) * D + c;
      av = *reinterpret_cast<const uint4*>(a + off);
      bv = *reinterpret_cast<const uint4*>(b + off);
    }
    if (a_rows != nullptr) *reinterpret_cast<uint4*>(&a_rows[r * kRow + c]) = av;
    if (b_rows != nullptr) *reinterpret_cast<uint4*>(&b_rows[r * kRow + c]) = bv;
    const bf16* ae = reinterpret_cast<const bf16*>(&av);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (a_t != nullptr) a_t[(c + e) * kCol + r] = ae[e];
      if (b_t != nullptr) b_t[(c + e) * kCol + r] = be[e];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A a0:(g, 2t..2t+1) a1:(g+8, 2t..) a2:(g, 2t+8..) a3:(g+8, 2t+8..)
//   B b0:(k 2t..2t+1, n g) b1:(k 2t+8.., n g)
//   C c0,c1:(g, 2t, 2t+1) c2,c3:(g+8, 2t, 2t+1)
// Two C tiles of 8 columns each (columns 16kk..16kk+15) pack into one A
// fragment of depth 16: a0 = c[0][0..1], a1 = c[0][2..3], a2 = c[1][0..1],
// a3 = c[1][2..3].
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_bf16_smem() {  // ks, vs [64][D + kPad]; kt [D][64 + kPad]
  return sizeof(bf16) * (2 * (size_t)kBlockK * (D + kPad) + (size_t)D * (kBlockK + kPad));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq,
                         int seq, float scale, int causal) {
  constexpr int kRow = D + kPad, kCol = kBlockK + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [key][d]
  bf16* vs = ks + kBlockK * kRow;                // [key][d]
  bf16* kt = vs + kBlockK * kRow;                // [d][key]

  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int q0 = qtile * kBlockQ;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_rows<D>(qf, q + base, row0, seq, t);
  load_a_rows<D>(df, dout + base, row0, seq, t);
  const float lse0 = row0 < seq ? lse[rbase + row0] : 0.f;
  const float lse1 = row1 < seq ? lse[rbase + row1] : 0.f;
  const float dl0 = row0 < seq ? delta[rbase + row0] : 0.f;
  const float dl1 = row1 < seq ? delta[rbase + row1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int all_tiles = (seq + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(all_tiles, qtile + 1) : all_tiles;
  for (int kti = 0; kti < n_tiles; ++kti) {
    const int k0 = kti * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    stage_tile<D>(k + base, v + base, k0, seq, ks, vs, kt, nullptr);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {  // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          const bf16* kr = &ks[(j * 8 + g) * kRow + dd * 16 + 2 * t];
          mma_bf16(s[jj], qf[dd], ld32(kr), ld32(kr + 8));
          const bf16* vr = &vs[(j * 8 + g) * kRow + dd * 16 + 2 * t];
          mma_bf16(dp[jj], df[dd], ld32(vr), ld32(vr + 8));
        }
      }
      // dS = P * (dP - delta) * scale, with P from the saved lse.
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + (2 * kk + jj) * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          float x = s[jj][e] * scale;
          if (key >= seq || (causal && key > row)) x = kMaskValue;
          const float p = __expf(x - (e < 2 ? lse0 : lse1));
          s[jj][e] = p * (dp[jj][e] - (e < 2 ? dl0 : dl1)) * scale;
        }
      }
      const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      // dQ += dS K: K with the key axis as depth, from the transposed copy.
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const bf16* kr = &kt[(j * 8 + g) * kCol + kk * 16 + 2 * t];
        mma_bf16(acc[j], a, ld32(kr), ld32(kr + 8));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < seq)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)row0 * D + c) =
          pack_bf16(acc[j][0], acc[j][1]);
    if (row1 < seq)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)row1 * D + c) =
          pack_bf16(acc[j][2], acc[j][3]);
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
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int seq, float scale, int causal) {
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
  const float dl_r = row < seq ? delta[rbase + row] : 0.f;

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
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, seq, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int dtype) {
  cudaError_t err;
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.bh);
  if (dtype == 1) {
    constexpr size_t smem = dq_bf16_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
        a.delta, static_cast<bf16*>(a.dq), a.seq, a.scale, a.causal);
  } else {
    constexpr size_t smem = f32_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
        a.delta, static_cast<float*>(a.dq), a.seq, a.scale, a.causal);
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

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq: contiguous
// [bh, seq, head_dim] of that dtype; lse, delta: f32 [bh, seq]. Returns a
// cudaError_t (0 = launched).
extern "C" int ray_tpu_torch_flash_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int bh, int seq,
                                          int head_dim, int dtype, int causal,
                                          float scale, int device, void* stream) {
  BwdArgs a = {q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, 0, 0, causal, scale,
               nullptr};
  cudaError_t err = prepare(a, bh, seq, device, stream);
  if (err != cudaSuccess) return err;
  return dispatch<launch_dq<16>, launch_dq<32>, launch_dq<64>, launch_dq<128>>(
      a, head_dim, dtype);
}

// As above; writes dk and dv, contiguous [bh, seq, head_dim] of the dtype.
extern "C" int ray_tpu_torch_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int bh,
                                           int seq, int head_dim, int dtype, int causal,
                                           float scale, int device, void* stream) {
  BwdArgs a = {q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, 0, 0, causal, scale,
               nullptr};
  cudaError_t err = prepare(a, bh, seq, device, stream);
  if (err != cudaSuccess) return err;
  return dispatch<launch_dkv<16>, launch_dkv<32>, launch_dkv<64>, launch_dkv<128>>(
      a, head_dim, dtype);
}
