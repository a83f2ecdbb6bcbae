// rms_norm.cu - RMSNorm forward and backward for Hopper, sm_90a.
//
// Replaces: none. ray_tpu/ops/layers.py::rms_norm is plain jnp that the
// JAX package leaves to XLA, which fuses it into its neighbours; there is
// no Pallas kernel to port. The port's plain version
// (ray_tpu_torch/ops/layers.py::_rms_norm) runs as nine f32 torch ops
// forward and about a dozen backward, and autograd keeps f32 copies of
// the activations: about 140 bytes moved per element where 10 will do.
// Same function as that plain version: y = cast(x_f32 * rsqrt(mean(x_f32^2)
// + eps) * w_f32) in x's dtype, the mean in f32.
//
// What bounds it on an H100: bytes. A row of D elements needs about 1.5 D
// operations per element pass and moves 2 (bf16) bytes per element and
// pass, far under the card's ~295 flops per byte. The floor is reading x
// and writing y forward (4 bytes an element in bf16) and reading x and
// dy and writing dx backward (6 bytes): 10 bytes an element.
//
// Design:
//   * rms_norm_fwd_kernel: a team of warps per row (one warp for every D
//     up to 1,024 in bf16), several rows per 256-thread block. Each thread
//     loads its share of the row as 16-byte vectors (V per thread, lanes
//     on neighbouring vectors) and keeps them in registers; the sum of
//     squares is taken in f32 by warp shuffles (and across the team's
//     warps through shared memory), then y is written from the registers
//     with no second read of x. It also writes rstd, f32 [rows], for the
//     backward. Nothing else is written: autograd keeps x (the residual
//     stream, alive anyway) and rstd, no f32 copy.
//   * rms_norm_bwd_kernel: a persistent grid of a few blocks per SM walks
//     the rows with the forward's layout. A row's x and dy are read once
//     into registers, n = x rstd is recomputed, the row's mean(dy w n) is
//     reduced as in the forward, and dx = rstd (dy w - n mean(dy w n)) is
//     written. Each thread keeps the dw column partials (sum of dy n) of
//     its columns in f32 registers across all the rows it visits; at the
//     end a block sums its row slots' partials in shared memory in slot
//     order and writes one f32 row of a [blocks, D] scratch.
//   * rms_norm_dw_kernel sums that scratch's rows in a fixed order (per
//     column: 16 strided partial sums, then those 16 in order): dw is the
//     same bits on every run, with no atomics.
//   * Rows may be strided (a row stride in elements, e.g. the CLS rows
//     x[:, 0] of [B, S, D]); the columns are contiguous. y and dx are
//     written contiguous [rows, D].
// Vectors per thread (V) and warps per row (team) come from D and the
// dtype alone: V is the smallest power of two that lets one warp hold the
// row in at most 32 values a thread; past that, the team grows to 8 warps
// (D up to 8,192). The wrapper (ops/_kernels.py) checks D % 8 == 0,
// D <= 8192, 16-byte alignment of every row and of w, and the dtypes.
//
// C interface (loaded with ctypes): ray_tpu_torch_rms_norm_fwd(...),
// ray_tpu_torch_rms_norm_bwd(...), ray_tpu_torch_rms_norm_dw(...) each
// return cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxValues = 32;  // f32 values of a row a thread holds
constexpr int kMaxTeam = 8;     // warps a row at most
constexpr int kDwRows = 16;     // partial sums a column in rms_norm_dw

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The sum over a row's team of warps. Every thread of the block calls it
// the same number of times (team is uniform over the block); part holds a
// float per warp.
__device__ __forceinline__ float team_sum(float x, int team, float* part) {
  x = warp_sum(x);
  if (team == 1) return x;
  const int warp = threadIdx.x >> 5, first = warp - warp % team;
  if ((threadIdx.x & 31) == 0) part[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int t = 0; t < team; ++t) s += part[first + t];
  __syncthreads();  // part is free for the next row
  return s;
}

// The w values of this thread's vector i (0 where the vector is past D).
template <typename T>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int v,
                                       int nvec, float* out) {
  constexpr int E = Vec<T>::E;
  if (v < nvec) {
    const float4* p = reinterpret_cast<const float4*>(w + v * E);
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      float4 q = __ldg(p + j);
      out[4 * j] = q.x;
      out[4 * j + 1] = q.y;
      out[4 * j + 2] = q.z;
      out[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = 0.f;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rms_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ rstd, int rows,
                        int d, long long stride, int team, float eps) {
  constexpr int E = Vec<T>::E;
  __shared__ float part[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / team, member = warp % team;
  const long long row = (long long)blockIdx.x * (kWarps / team) + slot;
  const bool live = row < rows;
  const int nvec = d / E;
  const T* xr = x + (live ? row : 0) * stride;

  uint4 raw[V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int v = (member * V + i) * 32 + lane;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (live && v < nvec) {
      raw[i] = __ldg(reinterpret_cast<const uint4*>(xr) + v);
      float f[E];
      to_float<T>(raw[i], f);
#pragma unroll
      for (int e = 0; e < E; ++e) ss += f[e] * f[e];
    }
  }
  ss = team_sum(ss, team, part);
  if (!live) return;
  const float r = rsqrtf(ss * (1.f / d) + eps);
  if (member == 0 && lane == 0) rstd[row] = r;
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int v = (member * V + i) * 32 + lane;
    if (v < nvec) {
      float f[E], wf[E];
      to_float<T>(raw[i], f);
      load_w<T>(w, v, nvec, wf);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = (f[e] * r) * wf[e];
      yr[v] = from_float<T>(f);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ w,
                        const float* __restrict__ rstd, T* __restrict__ dx,
                        float* __restrict__ partial, int rows, int d,
                        long long stride, int team) {
  constexpr int E = Vec<T>::E;
  __shared__ float part[kWarps];
  extern __shared__ float red[];  // d floats
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / team, member = warp % team;
  const int per_block = kWarps / team;
  const int nvec = d / E;

  float wf[V][E], acc[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    load_w<T>(w, (member * V + i) * 32 + lane, nvec, wf[i]);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  // The loop's bounds are the block's, so every thread runs the same
  // iterations and meets team_sum's barriers together.
  for (long long base = (long long)blockIdx.x * per_block; base < rows;
       base += (long long)gridDim.x * per_block) {
    const long long row = base + slot;
    const bool live = row < rows;
    const T* xr = x + (live ? row : 0) * stride;
    const T* gr = g + (live ? row : 0) * d;
    const float r = live ? rstd[row] : 0.f;
    uint4 xv[V], gv[V];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int v = (member * V + i) * 32 + lane;
      xv[i] = gv[i] = make_uint4(0, 0, 0, 0);
      if (live && v < nvec) {
        xv[i] = __ldg(reinterpret_cast<const uint4*>(xr) + v);
        gv[i] = __ldg(reinterpret_cast<const uint4*>(gr) + v);
        float xf[E], gf[E];
        to_float<T>(xv[i], xf);
        to_float<T>(gv[i], gf);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float n = xf[e] * r;
          dot += gf[e] * wf[i][e] * n;
          acc[i][e] += gf[e] * n;
        }
      }
    }
    const float mean = team_sum(dot, team, part) * (1.f / d);
    if (!live) continue;
    uint4* dr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int v = (member * V + i) * 32 + lane;
      if (v < nvec) {
        float xf[E], gf[E];
        to_float<T>(xv[i], xf);
        to_float<T>(gv[i], gf);
#pragma unroll
        for (int e = 0; e < E; ++e)
          xf[e] = r * (gf[e] * wf[i][e] - (xf[e] * r) * mean);
        dr[v] = from_float<T>(xf);
      }
    }
  }

  // The block's dw partials: its row slots added in slot order, then one
  // row of the scratch. Slot 0's team covers every column.
  for (int s = 0; s < per_block; ++s) {
    if (slot == s) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int v = (member * V + i) * 32 + lane;
        if (v < nvec) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            red[v * E + e] = s == 0 ? acc[i][e] : red[v * E + e] + acc[i][e];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += kThreads) out[c] = red[c];
}

// dw[c] = the sum over the scratch's blocks rows of partial[., c], in a
// fixed order: thread (ty, tx) sums rows ty, ty + kDwRows, ... of column
// blockIdx.x * 32 + tx, then ty == 0 adds the kDwRows sums in order.
__global__ void __launch_bounds__(32 * kDwRows)
    rms_norm_dw_kernel(const float* __restrict__ partial,
                       float* __restrict__ dw, int blocks, int d) {
  __shared__ float sums[kDwRows][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < d)
    for (int b = ty; b < blocks; b += kDwRows) s += partial[(long long)b * d + c];
  sums[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kDwRows; ++k) t += sums[k][tx];
    dw[c] = t;
  }
}

// Vectors per thread and warps per row for D columns of T.
struct Layout {
  int v, team;
};

template <typename T>
Layout layout(int d) {
  constexpr int E = Vec<T>::E;
  constexpr int vmax = kMaxValues / E;
  const int nvec = d / E;
  const int per_lane = (nvec + 31) / 32;
  if (per_lane <= vmax) {
    int v = 1;
    while (v < per_lane) v *= 2;
    return {v, 1};
  }
  const int warps = (nvec + 32 * vmax - 1) / (32 * vmax);
  int team = 1;
  while (team < warps) team *= 2;
  return {vmax, team};
}

template <typename T, int V>
cudaError_t fwd_v(const void* x, const void* w, void* y, void* rstd, int rows,
                  int d, long long stride, int team, float eps,
                  cudaStream_t st) {
  const int per_block = kWarps / team;
  const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
  rms_norm_fwd_kernel<T, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), static_cast<float*>(rstd), rows, d, stride, team,
      eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t bwd_v(const void* x, const void* g, const void* w,
                  const void* rstd, void* dx, void* partial, int rows, int d,
                  long long stride, int team, int blocks, cudaStream_t st) {
  const size_t smem = (size_t)d * sizeof(float);
  rms_norm_bwd_kernel<T, V><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(w), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d, stride,
      team);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, void* y, void* rstd, int rows,
                int d, long long stride, float eps, cudaStream_t st) {
  const Layout l = layout<T>(d);
  switch (l.v) {
    case 1: return fwd_v<T, 1>(x, w, y, rstd, rows, d, stride, l.team, eps, st);
    case 2: return fwd_v<T, 2>(x, w, y, rstd, rows, d, stride, l.team, eps, st);
    case 4: return fwd_v<T, 4>(x, w, y, rstd, rows, d, stride, l.team, eps, st);
  }
  if constexpr (Vec<T>::E == 4) {
    if (l.v == 8) return fwd_v<T, 8>(x, w, y, rstd, rows, d, stride, l.team, eps, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd(const void* x, const void* g, const void* w, const void* rstd,
                void* dx, void* partial, int rows, int d, long long stride,
                int blocks, cudaStream_t st) {
  const Layout l = layout<T>(d);
  switch (l.v) {
    case 1: return bwd_v<T, 1>(x, g, w, rstd, dx, partial, rows, d, stride, l.team, blocks, st);
    case 2: return bwd_v<T, 2>(x, g, w, rstd, dx, partial, rows, d, stride, l.team, blocks, st);
    case 4: return bwd_v<T, 4>(x, g, w, rstd, dx, partial, rows, d, stride, l.team, blocks, st);
  }
  if constexpr (Vec<T>::E == 4) {
    if (l.v == 8) return bwd_v<T, 8>(x, g, w, rstd, dx, partial, rows, d, stride, l.team, blocks, st);
  }
  return cudaErrorInvalidValue;
}

bool valid(int rows, int d) {
  return rows > 0 && d > 0 && d % 8 == 0 && d <= 1024 * kMaxTeam;
}

}  // namespace

// x [rows, d] with row stride `stride` (elements), w f32 [d], y [rows, d]
// contiguous, rstd f32 [rows]; dtype 0 = f32, 1 = bf16.
extern "C" int ray_tpu_torch_rms_norm_fwd(const void* x, const void* w, void* y,
                                          void* rstd, int rows, int d,
                                          long long stride, int dtype, float eps,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid(rows, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return fwd<bf16>(x, w, y, rstd, rows, d, stride, eps, st);
  if (dtype == 0) return fwd<float>(x, w, y, rstd, rows, d, stride, eps, st);
  return cudaErrorInvalidValue;
}

// x as in the forward, g (dy) [rows, d] contiguous, rstd from the forward;
// dx [rows, d] contiguous; partial f32 [blocks, d], rms_norm_dw's input.
extern "C" int ray_tpu_torch_rms_norm_bwd(const void* x, const void* g,
                                          const void* w, const void* rstd,
                                          void* dx, void* partial, int rows,
                                          int d, long long stride, int dtype,
                                          int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid(rows, d) || blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd<bf16>(x, g, w, rstd, dx, partial, rows, d, stride, blocks, st);
  if (dtype == 0)
    return bwd<float>(x, g, w, rstd, dx, partial, rows, d, stride, blocks, st);
  return cudaErrorInvalidValue;
}

// dw f32 [d] = the column sums of partial f32 [blocks, d].
extern "C" int ray_tpu_torch_rms_norm_dw(const void* partial, void* dw,
                                         int blocks, int d, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid(1, d) || blocks <= 0) return cudaErrorInvalidValue;
  rms_norm_dw_kernel<<<(d + 31) / 32, 32 * kDwRows, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), blocks, d);
  return cudaGetLastError();
}
