// flash_fwd.cu - attention forward (flash, online softmax) for Hopper, sm_90a.
//
// Replaces: ray_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel
// launched by _flash_forward). Same function: O = softmax(scale * Q K^T
// [+ causal mask]) V per (batch*head), with the causal mask value
// DEFAULT_MASK_VALUE = -0.7 * FLT_MAX applied after scaling (not -inf, so a
// fully masked row behaves as in the TPU kernel), exp(s - m) with no log2
// prescale, f32 running max / sum / accumulator, P rounded to the input
// dtype before the PV product, the l == 0 -> 1 guard, and optionally
// lse = m + log(l) per row as f32 [BH, S] (the TPU kernel's 128-lane copy
// is a TPU tile rule and is dropped here).
//
// What bounds it on an H100: at the GPT-2 shape (head_dim 64, S = 1024,
// causal) one call does about S/4 = 256 flops per byte it must move, under
// the card's ~295 flops/byte ridge, so the floor is the bytes of q, k, v
// and o; at head_dim 128 and S = 2048 it is the tensor cores' rate.
//
// Design (bf16): one block of two consumer warpgroups and a producer warp
// per (bh, 128-row Q tile), Q tiles issued last-first so the long causal
// rows start early.
//   * The producer warp holds no accumulators; one of its threads issues
//     TMA loads (cp.async.bulk.tensor, 3-D maps over [bh, S, D]): Q once,
//     then the 128-key K and V tiles into a ring of kStages shared-memory
//     stages, each guarded by a full/empty mbarrier pair, so the next tiles
//     are in flight while the consumers compute. No thread copies through
//     registers and no __syncthreads brackets a copy.
//   * Warpgroups 0 and 1 are the consumers, 64 query rows each, with up
//     to 168 registers a thread (hopper.cuh says why, and why not
//     setmaxnreg); ptxas fits every head dim in that without a spill.
//     S = Q K^T runs on wgmma.mma_async with Q and K both read from shared memory, K-major
//     as stored. O += P V runs on wgmma with P from registers and V read
//     MN-major through the descriptor: no transposed copy of V, no 2-byte
//     stores, no 32-bit fragment reads.
//   * The wgmma accumulator gives each warp 16 rows in the m16n8 C
//     fragment layout, so the online softmax works in registers: the quad
//     shuffles for the max, the sum reduced once at the end, and S packed into the
//     A fragments of the PV product without leaving registers.
//   * TMA fills rows >= S with zeros (a 3-D map ends at each head's S);
//     keys >= S still get the mask value, rows >= S are not stored, so any
//     S is taken. K tiles wholly right of the diagonal are never loaded;
//     per-element masks run only on tiles that cross the diagonal or S.
//   * Tiles are swizzled by row width (32B at head_dim 16, 64B at 32, 128B
//     at 64; two 64-column boxes a tile at 128): see hopper.cuh.
//   * An f32 instantiation uses SIMT FMAs (no TF32) with 64-row tiles and
//     the same online softmax; it checks the algorithm on the card.
//
// C interface (loaded with ctypes): ray_tpu_torch_flash_fwd(...) returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised, TMA ring, wgmma.
// ---------------------------------------------------------------------------
constexpr int kWgBlockQ = 128;  // query rows per block, 64 per consumer
constexpr int kWgBlockK = 128;  // keys per K/V tile
constexpr int kStages = 2;      // K/V ring depth
using Roles = hopper::WarpRoles<2>;  // 2 consumer warpgroups + a producer warp

template <int D>
struct FwdSmem {
  using QTile = hopper::Tile<D, kWgBlockQ>;
  using KTile = hopper::Tile<D, kWgBlockK>;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + QTile::kBytes;               // [kStages]
  static constexpr int kV = kK + kStages * KTile::kBytes;     // [kStages]
  static constexpr int kBar = kV + kStages * KTile::kBytes;   // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(Roles::kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                      float* __restrict__ lse, int seq, float scale, int causal) {
  using L = FwdSmem<D>;
  using QTile = typename L::QTile;
  using KTile = typename L::KTile;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_bar = base + L::kBar;
  auto full_bar = [&](int s) { return q_bar + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return q_bar + 8u * (1 + kStages + s); };

  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int q0 = qtile * kWgBlockQ;
  const int bh = blockIdx.y;
  const int all_tiles = (seq + kWgBlockK - 1) / kWgBlockK;
  const int n_tiles =
      causal ? min(all_tiles, (q0 + kWgBlockQ + kWgBlockK - 1) / kWgBlockK) : all_tiles;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), Roles::kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= Roles::kConsumerThreads) {
    // Producer warp: one thread keeps the ring full.
    if (threadIdx.x == Roles::kConsumerThreads) {
      hopper::mbar_expect_tx(q_bar, QTile::kBytes);
      QTile::load(&qmap, base + L::kQ, q_bar, q0, bh);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        hopper::mbar_wait(empty_bar(s), ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full_bar(s), 2 * KTile::kBytes);
        KTile::load(&kmap, base + L::kK + s * KTile::kBytes, full_bar(s), kt * kWgBlockK, bh);
        KTile::load(&vmap, base + L::kV + s * KTile::kBytes, full_bar(s), kt * kWgBlockK, bh);
      }
    }
  } else {
    // Consumers: 64 query rows per warpgroup.
    const int r0 = (threadIdx.x / 128) * 64;  // this warpgroup's rows in the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + r0 + warp * 16 + g;
    const int row1 = row0 + 8;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    hopper::mbar_wait(q_bar, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kStages;
      const int k0 = kt * kWgBlockK;
      const uint32_t kb = base + L::kK + s * KTile::kBytes;
      const uint32_t vb = base + L::kV + s * KTile::kBytes;
      hopper::mbar_wait(full_bar(s), (kt / kStages) & 1);

      // S = Q K^T for this warpgroup's 64 rows x 128 keys.
      float sc[kWgBlockK / 2];
#pragma unroll
      for (int i = 0; i < kWgBlockK / 2; ++i) sc[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<kWgBlockK>(sc, QTile::kmajor(base + L::kQ, r0, kk),
                                    KTile::kmajor(kb, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::fence_regs(sc);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // Scale, mask (only where the tile crosses S or the diagonal), and
      // the running max.
      const bool edge = k0 + kWgBlockK > seq || (causal && k0 + kWgBlockK - 1 > q0 + r0);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kWgBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale;
          if (edge) {
            const int key = k0 + j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (key >= seq || (causal && key > row)) x = kMaskValue;
          }
          sc[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P = exp(S - m): f32 for the sum, bf16 A fragments for the PV product.
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < kWgBlockK / 8; ++j) {
        sc[4 * j + 0] = __expf(sc[4 * j + 0] - mn0);
        sc[4 * j + 1] = __expf(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = __expf(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = __expf(sc[4 * j + 3] - mn1);
        ls0 += sc[4 * j + 0] + sc[4 * j + 1];
        ls1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = alpha0 * l0 + ls0;  // this lane's share; the quad sums at the end
      l1 = alpha1 * l1 + ls1;
      uint32_t pf[kWgBlockK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgBlockK / 16; ++kk) {
        pf[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O = alpha * O + P V, V read MN-major from the stage.
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBlockK / 16; ++kk)
        hopper::wgmma_rs<D>(acc, pf[kk], KTile::mnmajor(vb, kk), 1);
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(empty_bar(s));  // the stage is free
    }

    // Epilogue: O / l with the l == 0 guard; lse = m + log(l).
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
    const size_t obase = (size_t)bh * seq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (row0 < seq)
        *reinterpret_cast<uint32_t*>(o + obase + (size_t)row0 * D + c) =
            pack_bf16(acc[4 * j + 0] / d0, acc[4 * j + 1] / d0);
      if (row1 < seq)
        *reinterpret_cast<uint32_t*>(o + obase + (size_t)row1 * D + c) =
            pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
    if (lse != nullptr && t == 0) {
      float* lrow = lse + (size_t)bh * seq;
      if (row0 < seq) lrow[row0] = m0 + logf(d0);
      if (row1 < seq) lrow[row1] = m1 + logf(d1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT FMAs, no TF32. Two threads per Q row: thread h (0/1) scores the
// keys 2i+h of each tile and accumulates output columns [h*D/2, (h+1)*D/2);
// the pair swaps probabilities with one shuffle per key pair.
// ---------------------------------------------------------------------------
constexpr int kBlockQ = 64;  // Q rows per block
constexpr int kBlockK = 64;  // K/V rows per shared-memory tile
constexpr int kThreads = 128;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)(kBlockQ + kBlockK) * (D + 1) + (size_t)kBlockK * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale, int causal) {
  constexpr int kS = D + 1;  // padded stride: conflict-free column reads
  constexpr int kHalf = D / 2;
  constexpr int kKeys = kBlockK / 2;  // keys scored per thread per tile
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBlockQ][kS]
  float* ks = qs + kBlockQ * kS;    // [kBlockK][kS]
  float* vs = ks + kBlockK * kS;    // [kBlockK][D]

  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int q0 = qtile * kBlockQ;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const int r = threadIdx.x / 2, h = threadIdx.x % 2;
  const int row = q0 + r;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    qs[rr * kS + c] = q0 + rr < seq ? q[base + (size_t)(q0 + rr) * D + c] : 0.f;
  }

  float acc[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int all_tiles = (seq + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(all_tiles, qtile + 1) : all_tiles;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int rr = i / D, c = i % D;
      const bool in = k0 + rr < seq;
      const size_t off = base + (size_t)(k0 + rr) * D + c;
      ks[rr * kS + c] = in ? k[off] : 0.f;
      vs[rr * D + c] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * kS + d];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) s[i] = fmaf(qd, ks[(2 * i + h) * kS + d], s[i]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int key = k0 + 2 * i + h;
      float x = s[i] * scale;
      if (key >= seq || (causal && key > row)) x = kMaskValue;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      s[i] = expf(s[i] - mn);
      ls += s[i];
    }
    l = alpha * l + ls;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) acc[c] *= alpha;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const float other = __shfl_xor_sync(0xffffffffu, s[i], 1);
      const float p_even = h ? other : s[i];
      const float p_odd = h ? s[i] : other;
      const float* v_even = vs + (2 * i) * D + h * kHalf;
      const float* v_odd = v_even + D;
#pragma unroll
      for (int c = 0; c < kHalf; ++c)
        acc[c] = fmaf(p_odd, v_odd[c], fmaf(p_even, v_even[c], acc[c]));
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const float den = l == 0.f ? 1.f : l;
  if (row < seq) {
    float* orow = o + base + (size_t)row * D + h * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) orow[c] = acc[c] / den;
    if (lse != nullptr && h == 0) lse[(size_t)blockIdx.y * seq + row] = m + logf(den);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int seq, float scale, int causal,
                        cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = hopper::map_rows(&qmap, q, bh, seq, D, kWgBlockQ);
  if (err == cudaSuccess) err = hopper::map_rows(&kmap, k, bh, seq, D, kWgBlockK);
  if (err == cudaSuccess) err = hopper::map_rows(&vmap, v, bh, seq, D, kWgBlockK);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdSmem<D>::kAlloc;
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kWgBlockQ - 1) / kWgBlockQ, bh);
  flash_fwd_bf16_kernel<D><<<grid, Roles::kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), lse, seq, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous [bh, seq, head_dim];
// lse: f32 [bh, seq] or null. Returns a cudaError_t (0 = launched).
extern "C" int ray_tpu_torch_flash_fwd(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int bh, int seq,
                                       int head_dim, int dtype, int causal,
                                       float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh <= 0 || bh > 65535 || seq <= 0) return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (head_dim) {
      case 16: return launch_bf16<16>(q, k, v, o, l, bh, seq, scale, causal, st);
      case 32: return launch_bf16<32>(q, k, v, o, l, bh, seq, scale, causal, st);
      case 64: return launch_bf16<64>(q, k, v, o, l, bh, seq, scale, causal, st);
      case 128: return launch_bf16<128>(q, k, v, o, l, bh, seq, scale, causal, st);
    }
  } else if (dtype == 0) {
    switch (head_dim) {
      case 16: return launch_f32<16>(q, k, v, o, l, bh, seq, scale, causal, st);
      case 32: return launch_f32<32>(q, k, v, o, l, bh, seq, scale, causal, st);
      case 64: return launch_f32<64>(q, k, v, o, l, bh, seq, scale, causal, st);
      case 128: return launch_f32<128>(q, k, v, o, l, bh, seq, scale, causal, st);
    }
  }
  return cudaErrorInvalidValue;
}
