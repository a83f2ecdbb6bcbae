// flash_fwd.cu - attention forward (flash, online softmax) for Hopper, sm_90a.
//
// Replaces: ray_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel
// launched by _flash_forward). Same function: O = softmax(scale * Q K^T
// [+ causal mask]) V per (batch*head), with the causal mask value
// DEFAULT_MASK_VALUE = -0.7 * FLT_MAX (not -inf, so a fully masked row
// behaves as in the TPU kernel), f32 running max / sum / accumulator,
// P rounded to the input dtype before the PV product, the l == 0 -> 1
// guard, and optionally lse = m + log(l) per row as f32 [BH, S] (the
// TPU kernel's 128-lane copy is a TPU tile rule and is dropped here).
//
// What bounds it on an H100: at the model's shape (head_dim 64, S = 1024,
// causal) one call does about S/4 = 256 flops per byte it must move,
// under the card's ~295 flops/byte ridge, so the floor is set by the
// bytes of q, k, v and o. This first kernel is far from that floor: it
// issues mma.sync (Ampere-style warp MMAs, a fraction of the wgmma rate),
// does not overlap the K/V tile loads with the MMAs, and re-reads each
// K/V tile once per 64-row Q tile (from L2 for the most part).
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
//   * grid (ceil(S/64), B*H); one block of 4 warps per (bh, 64-row Q
//     tile); each warp owns 16 Q rows, whose Q fragments stay in
//     registers for the whole sweep. Q tiles are issued last-first, so
//     the long causal rows start early.
//   * K/V are swept in 64-row tiles staged in shared memory (K row-major,
//     V transposed, so both MMA B-fragments are 32-bit reads; rows padded
//     by 8 elements so those reads are free of bank conflicts).
//   * S = Q K^T and O += P V run on the tensor cores
//     (mma.sync.m16n8k16, bf16 in, f32 accumulate). The S accumulator's
//     register layout is the A-fragment layout of the PV product, so P
//     never leaves registers.
//   * The online max and sum live in registers; a row's four owning lanes
//     reduce the max with two shuffles each tile and the sum once at the
//     end.
//   * K tiles wholly right of the diagonal are never visited; a ragged S
//     is masked at the edge (keys >= S get the mask value, rows >= S are
//     not stored), so any S is taken, not only multiples of 128.
//   * An f32 instantiation uses SIMT FMAs (no TF32) with the same tiles
//     and online softmax; it checks the algorithm on the card.
//
// C interface (loaded with ctypes): ray_tpu_torch_flash_fwd(...) returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // Q rows per block (16 per warp)
constexpr int kBlockK = 64;  // K/V rows per shared-memory tile
constexpr int kThreads = 128;
constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A a0:(g, 2t..2t+1) a1:(g+8, 2t..) a2:(g, 2t+8..) a3:(g+8, 2t+8..)
//   B b0:(k 2t..2t+1, n g) b1:(k 2t+8.., n g)
//   C c0,c1:(g, 2t, 2t+1) c2,c3:(g+8, 2t, 2t+1)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int seq, float scale, int causal) {
  constexpr int kPad = 8;
  constexpr int kKStride = D + kPad;        // ks[key][d]
  constexpr int kVStride = kBlockK + kPad;  // vt[d][key]
  constexpr int kVec = D / 8;               // 16-byte vectors per row
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt[D * kVStride];

  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int q0 = qtile * kBlockQ;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const __nv_bfloat16* q0p = q + base + (size_t)row0 * D + c;
    const __nv_bfloat16* q1p = q + base + (size_t)row1 * D + c;
    qf[kk][0] = row0 < seq ? ld32(q0p) : 0u;
    qf[kk][1] = row1 < seq ? ld32(q1p) : 0u;
    qf[kk][2] = row0 < seq ? ld32(q0p + 8) : 0u;
    qf[kk][3] = row1 < seq ? ld32(q1p + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int all_tiles = (seq + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(all_tiles, qtile + 1) : all_tiles;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBlockK * kVec; i += kThreads) {
      const int r = i / kVec, c = (i % kVec) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < seq) {
        const size_t off = base + (size_t)(k0 + r) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r * kKStride + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c + e) * kVStride + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[(j * 8 + g) * kKStride + kk * 16 + 2 * t];
        mma_bf16(s[j], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale, mask, and the running max.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[j][e] * scale;
        if (key >= seq || (causal && key > row)) x = kMaskValue;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(S - m): f32 for the sum, bf16 A-fragments for the PV product.
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l0 = alpha0 * l0 + ls0;  // this lane's share; the quad sums at the end
    l1 = alpha1 * l1 + ls1;
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // O = alpha * O + P V.
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const __nv_bfloat16* vr = &vt[(j * 8 + g) * kVStride + kk * 16 + 2 * t];
        mma_bf16(acc[j], pf[kk], ld32(vr), ld32(vr + 8));
      }
    }
  }

  // Epilogue: O / l with the l == 0 guard; lse = m + log(l).
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < seq)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row0 * D + c) =
          pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
    if (row1 < seq)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row1 * D + c) =
          pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + (size_t)blockIdx.y * seq;
    if (row0 < seq) lrow[row0] = m0 + logf(d0);
    if (row1 < seq) lrow[row1] = m1 + logf(d1);
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT FMAs, no TF32. Two threads per Q row: thread h (0/1) scores the
// keys 2i+h of each tile and accumulates output columns [h*D/2, (h+1)*D/2);
// the pair swaps probabilities with one shuffle per key pair.
// ---------------------------------------------------------------------------
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
                        float* lse, dim3 grid, int seq, float scale,
                        int causal, cudaStream_t stream) {
  flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      seq, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, dim3 grid, int seq, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
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
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, bh);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (head_dim) {
      case 16: return launch_bf16<16>(q, k, v, o, l, grid, seq, scale, causal, st);
      case 32: return launch_bf16<32>(q, k, v, o, l, grid, seq, scale, causal, st);
      case 64: return launch_bf16<64>(q, k, v, o, l, grid, seq, scale, causal, st);
      case 128: return launch_bf16<128>(q, k, v, o, l, grid, seq, scale, causal, st);
    }
  } else if (dtype == 0) {
    switch (head_dim) {
      case 16: return launch_f32<16>(q, k, v, o, l, grid, seq, scale, causal, st);
      case 32: return launch_f32<32>(q, k, v, o, l, grid, seq, scale, causal, st);
      case 64: return launch_f32<64>(q, k, v, o, l, grid, seq, scale, causal, st);
      case 128: return launch_f32<128>(q, k, v, o, l, grid, seq, scale, causal, st);
    }
  }
  return cudaErrorInvalidValue;
}
