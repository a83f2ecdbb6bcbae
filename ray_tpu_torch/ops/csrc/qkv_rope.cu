// qkv_rope.cu - GPT's qkv product split into heads, with rotary position
// embedding on q and k, forward and backward, for Hopper, sm_90a.
//
// Replaces: none. The JAX package's blocks (ray_tpu/models/gpt.py,
// moe.py) split the qkv product, reshape it into heads and apply
// ray_tpu/ops/layers.py::rope as plain jnp, which XLA fuses; there is no
// Pallas kernel to port. The port's plain chain (split, reshape,
// transpose, ray_tpu_torch/ops/layers.py::_rope on q and k, .contiguous()
// on v) rebuilds the rope tables on every call, copies q and k to f32,
// runs six f32 elementwise ops, a cat and a cast back, and under autograd
// repeats that chain backward and concatenates the three gradients: about
// 50 bytes moved per element where 4 will do.
//
// Same function as that chain: from qkv [B, S, 3 h D] (columns
// [q | k | v], each h heads of D) write q, k, v as contiguous [B, h, S, D];
// q and k rotated with split halves (x1 the first D/2 of a head row, x2
// the second) at positions 0..S-1:
//   y1 = x1 cos - x2 sin,  y2 = x2 cos + x1 sin.
// The backward writes d(qkv) [B, S, 3 h D] from dq, dk, dv [B, h, S, D],
// q and k by the inverse rotation:
//   g1' = g1 cos + g2 sin,  g2' = g2 cos - g1 sin.
//
// Rounding: each value is computed in f32 in _rope's own order, every
// product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// which nvcc may not contract into an FMA), and rounded once to the
// storage dtype. cos and sin are not computed here: they are f32 [S, D/2]
// tables made by _rope's own torch ops (ops/layers.py::_rope_tables) and
// read from L2. The backward's order is autograd's through that chain: the
// two products of g1 summed, g2 cos plus the negated g1 sin. So q, k, v
// and d(qkv) are the plain chain's bits: the model's outputs, its
// gradients and the tokens it serves do not move.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (bf16: 4 bytes an element each way), with at most 6 flops: the
// floor is 2 * 3 B S h D * sizeof(T) / 3.35 TB/s a call, forward or
// backward.
//
// Design: a thread moves one 16-byte vector of a head row's first half
// and the matching vector of its second half (lanes = D / 2 / E threads a
// row, E = 8 bf16 or 4 f32 elements a vector), so the rotation needs no
// exchange between threads. A 256-thread block covers 256 / lanes
// consecutive tokens of one (batch, segment, head): blockIdx.x is that
// triple, blockIdx.y the token tile (tiles beyond gridDim.y's 65,535 are
// walked in a loop). At D = 64 in bf16 a warp reads 8 whole 128-byte head
// rows of qkv and writes 1 KB contiguous of [B, h, S, D] (the backward
// the other way round): every 32-byte sector is used whole on both sides.
// No shared memory, no tensor cores. The segment is uniform over a block,
// so v's blocks only move bytes. The wrapper (ops/_kernels.py) checks
// D % 16 == 0, D <= 256, contiguity, 16-byte alignment and the dtypes.
//
// C interface (loaded with ctypes): ray_tpu_torch_qkv_rope_fwd(...) and
// ray_tpu_torch_qkv_rope_bwd(...) each return cudaGetLastError() after the
// launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kMaxHeadDim = 256;

// Elements in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int E = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void to_float(const uint4& v, float* f);

template <>
__device__ __forceinline__ void to_float<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void to_float<bf16>(const uint4& v, float* f) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&words[i]);
    float2 p = __bfloat1622float2(h);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 from_float(const float* f);

template <>
__device__ __forceinline__ uint4 from_float<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

template <>
__device__ __forceinline__ uint4 from_float<bf16>(const float* f) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    words[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// E f32 values of a table from a 16-byte aligned address.
template <int E>
__device__ __forceinline__ void load_table(const float* __restrict__ t,
                                           float* out) {
  const float4* p = reinterpret_cast<const float4*>(t);
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    float4 q = __ldg(p + j);
    out[4 * j] = q.x;
    out[4 * j + 1] = q.y;
    out[4 * j + 2] = q.z;
    out[4 * j + 3] = q.w;
  }
}

// The rows of one (batch, segment, head) that this thread's block covers:
// the forward reads them from qkv and writes them to q, k or v; the
// backward (kGrad) reads them from dq, dk or dv and writes them to d(qkv).
template <typename T, bool kGrad>
__device__ __forceinline__ void move_rows(const T* __restrict__ src0,
                                          const T* __restrict__ src1,
                                          const T* __restrict__ src2,
                                          const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t,
                                          T* __restrict__ dst0,
                                          T* __restrict__ dst1,
                                          T* __restrict__ dst2, int heads,
                                          int seq, int d) {
  constexpr int E = Vec<T>::E;
  const int half = d / 2, lanes = half / E, rows = kThreads / lanes;
  const int lane = threadIdx.x % lanes, row = threadIdx.x / lanes;
  if (row >= rows) return;
  const int head = blockIdx.x % heads;
  const int seg = (blockIdx.x / heads) % 3;
  const long long b = blockIdx.x / (3 * heads);
  const long long width = 3LL * heads * d;
  // Element offsets of this thread's first vector at token 0: in the
  // fused [B, S, 3 h D] layout, and in the [B, h, S, D] layout of a head.
  const long long fused = b * seq * width + (long long)(seg * heads + head) * d
                          + lane * E;
  const long long split = (b * heads + head) * seq * d + lane * E;
  const T* src;
  T* dst;
  long long src_step, dst_step;
  if (kGrad) {
    src = (seg == 0 ? src0 : seg == 1 ? src1 : src2) + split;
    dst = dst0 + fused;
    src_step = d;
    dst_step = width;
  } else {
    src = src0 + fused;
    dst = (seg == 0 ? dst0 : seg == 1 ? dst1 : dst2) + split;
    src_step = width;
    dst_step = d;
  }
  for (int t = blockIdx.y * rows + row; t < seq; t += gridDim.y * rows) {
    const T* x = src + t * src_step;
    T* y = dst + t * dst_step;
    uint4 lo = *reinterpret_cast<const uint4*>(x);
    uint4 hi = *reinterpret_cast<const uint4*>(x + half);
    if (seg < 2) {
      float x1[E], x2[E], c[E], s[E], y1[E], y2[E];
      to_float<T>(lo, x1);
      to_float<T>(hi, x2);
      const long long at = (long long)t * half + lane * E;
      load_table<E>(cos_t + at, c);
      load_table<E>(sin_t + at, s);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        if (kGrad) {
          y1[i] = __fadd_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
          y2[i] = __fsub_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], s[i]));
        } else {
          y1[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
          y2[i] = __fadd_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], s[i]));
        }
      }
      lo = from_float<T>(y1);
      hi = from_float<T>(y2);
    }
    *reinterpret_cast<uint4*>(y) = lo;
    *reinterpret_cast<uint4*>(y + half) = hi;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    qkv_rope_fwd_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, T* __restrict__ q,
                        T* __restrict__ k, T* __restrict__ v, int heads,
                        int seq, int d) {
  move_rows<T, false>(qkv, nullptr, nullptr, cos_t, sin_t, q, k, v, heads,
                      seq, d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    qkv_rope_bwd_kernel(const T* __restrict__ dq, const T* __restrict__ dk,
                        const T* __restrict__ dv,
                        const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t,
                        T* __restrict__ dqkv, int heads, int seq, int d) {
  move_rows<T, true>(dq, dk, dv, cos_t, sin_t, dqkv, nullptr, nullptr, heads,
                     seq, d);
}

bool valid(int batch, int heads, int seq, int d) {
  return batch > 0 && heads > 0 && seq > 0 && d > 0 && d % 16 == 0 &&
         d <= kMaxHeadDim && 3LL * batch * heads <= 0x7fffffffLL;
}

template <typename T>
dim3 grid(int batch, int heads, int seq, int d) {
  const int rows = kThreads / (d / 2 / Vec<T>::E);
  const int tiles = (seq + rows - 1) / rows;
  return dim3((unsigned)(3 * batch * heads),
              (unsigned)(tiles < kMaxGridY ? tiles : kMaxGridY));
}

template <typename T>
cudaError_t fwd(const void* qkv, const void* cos_t, const void* sin_t,
                void* q, void* k, void* v, int batch, int heads, int seq,
                int d, cudaStream_t st) {
  qkv_rope_fwd_kernel<T><<<grid<T>(batch, heads, seq, d), kThreads, 0, st>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(q),
      static_cast<T*>(k), static_cast<T*>(v), heads, seq, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* dq, const void* dk, const void* dv,
                const void* cos_t, const void* sin_t, void* dqkv, int batch,
                int heads, int seq, int d, cudaStream_t st) {
  qkv_rope_bwd_kernel<T><<<grid<T>(batch, heads, seq, d), kThreads, 0, st>>>(
      static_cast<const T*>(dq), static_cast<const T*>(dk),
      static_cast<const T*>(dv), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(dqkv), heads, seq, d);
  return cudaGetLastError();
}

}  // namespace

// qkv [batch, seq, 3 heads d] contiguous; cos, sin f32 [seq, d / 2]; q, k,
// v [batch, heads, seq, d] contiguous; dtype 0 = f32, 1 = bf16.
extern "C" int ray_tpu_torch_qkv_rope_fwd(const void* qkv, const void* cos_t,
                                          const void* sin_t, void* q, void* k,
                                          void* v, int batch, int heads,
                                          int seq, int d, int dtype,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid(batch, heads, seq, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd<bf16>(qkv, cos_t, sin_t, q, k, v, batch, heads, seq, d, st);
  if (dtype == 0)
    return fwd<float>(qkv, cos_t, sin_t, q, k, v, batch, heads, seq, d, st);
  return cudaErrorInvalidValue;
}

// dq, dk, dv [batch, heads, seq, d] contiguous; cos, sin as in the
// forward; dqkv [batch, seq, 3 heads d] contiguous.
extern "C" int ray_tpu_torch_qkv_rope_bwd(const void* dq, const void* dk,
                                          const void* dv, const void* cos_t,
                                          const void* sin_t, void* dqkv,
                                          int batch, int heads, int seq, int d,
                                          int dtype, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid(batch, heads, seq, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd<bf16>(dq, dk, dv, cos_t, sin_t, dqkv, batch, heads, seq, d, st);
  if (dtype == 0)
    return bwd<float>(dq, dk, dv, cos_t, sin_t, dqkv, batch, heads, seq, d,
                      st);
  return cudaErrorInvalidValue;
}
