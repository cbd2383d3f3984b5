// The paper's benchmark-suite kernels for Hopper (sm_90a): Sum3D, Stencil3D,
// TinyMatrixSum (static and dynamic inner extents) and MatVec (layout_right
// and layout_left), with a plain C interface loaded through ctypes
// (repro_torch/kernels/{sum3d,stencil3d,tinymatsum,matvec}.py hold the
// wrappers and the plain PyTorch versions they are held against).
//
// What they replace (the JAX reference package's Pallas TPU kernels):
//   sum3d_partials_kernel + sum_partials_kernel <- src/repro/kernels/sum3d.py::sum3d_pallas
//   stencil3d_kernel                 <- src/repro/kernels/stencil3d.py::stencil3d_pallas
//   tinymatsum_static_kernel<T,J,K>  <- src/repro/kernels/tinymatsum.py::tinymatsum_static
//   tinymatsum_dynamic_kernel<T>     <- src/repro/kernels/tinymatsum.py::tinymatsum_dynamic
//   matvec_kernel<T, Right>          <- src/repro/kernels/matvec.py::matvec_right
//   matvec_kernel<T, Left>           <- src/repro/kernels/matvec.py::matvec_left
//
// These are the paper's own C++ experiments, so the C++ says what the paper
// says. Each computes the reference function, not the Pallas BlockSpecs:
//
//   Sum3D       a grid-stride reduction over the physical buffer, f32
//               accumulators (four per thread, independent loads), one
//               partial per block, then a one-block second pass over the
//               partials in a fixed order. No float atomics: the grid depends
//               on the size only, so repeated runs are bit-identical.
//   Stencil3D   one thread per output element reading its 27 neighbours,
//               summed in f32 in the plain version's order (di, dj, dk);
//               interior only, the boundary (and I, J or K < 3) gives 0.
//   TinyMatSum  one thread per (J, K) matrix. The static kernel takes J and K
//               as TEMPLATE parameters (the card's extents<3, 3>): both loops
//               unroll and every offset folds to a constant. The dynamic
//               kernel takes them as runtime ints over the same unpadded
//               (N, J, K) buffers, with runtime loops and index math (the
//               reference pads to (jmax, kmax) only for TPU sublane
//               alignment). Paper Fig. 5 is the gap between the two.
//   MatVec      one kernel body templated on a layout policy (Right / Left,
//               each an offset(i, j) functor, as mdspan's layout_right /
//               layout_left), one thread per output row, f32 accumulation.
//               With layout_left neighbouring threads read neighbouring
//               addresses; with layout_right each reads its own row, a
//               stride of J apart: paper Fig. 6 predicts the gap inverts on a
//               GPU relative to a CPU.
//
// What bounds them on an H100: all four are bytes-bound (at most 27 adds, or
// 2 flops, per element read); the bound is the bytes each must move (inputs
// read once, outputs written once) over the device memory rate. Offsets are
// int64: the phase sizes pass 2^27 elements.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiny = 8;  // static TinyMatSum instantiates J, K in 1..8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum of v over the block, in a fixed order (warp shuffles, then warp 0 over
// the per-warp sums); the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// ---- Sum3D ------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum3d_partials_kernel(const T* __restrict__ x, int64_t n, float* __restrict__ partials) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (; e + 3 * stride < n; e += 4 * stride) {
    a0 += to_f32(x[e]);
    a1 += to_f32(x[e + stride]);
    a2 += to_f32(x[e + 2 * stride]);
    a3 += to_f32(x[e + 3 * stride]);
  }
  for (; e < n; e += stride) a0 += to_f32(x[e]);
  const float total = block_sum((a0 + a1) + (a2 + a3));
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int nparts, float* __restrict__ out) {
  float acc = 0.f;
  for (int p = threadIdx.x; p < nparts; p += kThreads) acc += partials[p];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = total;
}

// ---- Stencil3D --------------------------------------------------------------
// Block: 32 consecutive k by 8 consecutive j of one i-plane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil3d_kernel(const T* __restrict__ x, T* __restrict__ out, int I, int J, int K) {
  const int k = blockIdx.x * 32 + (threadIdx.x & 31);
  const int j = blockIdx.y * 8 + (threadIdx.x >> 5);
  const int i = blockIdx.z;
  if (j >= J || k >= K) return;
  const int64_t jk = static_cast<int64_t>(J) * K;
  const int64_t o = i * jk + static_cast<int64_t>(j) * K + k;
  float acc = 0.f;
  if (i > 0 && i < I - 1 && j > 0 && j < J - 1 && k > 0 && k < K - 1) {
#pragma unroll
    for (int di = -1; di <= 1; ++di)
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj)
#pragma unroll
        for (int dk = -1; dk <= 1; ++dk) acc += to_f32(x[o + di * jk + dj * K + dk]);
  }
  out[o] = from_f32<T>(acc);
}

// ---- TinyMatrixSum ----------------------------------------------------------
template <typename T, int J, int K>
__global__ void __launch_bounds__(kThreads)
tinymatsum_static_kernel(const T* __restrict__ o, const T* __restrict__ s, T* __restrict__ out,
                         int64_t n) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= n) return;
  const int64_t base = m * (J * K);
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t e = base + j * K + k;
      out[e] = from_f32<T>(to_f32(o[e]) + to_f32(s[e]));
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tinymatsum_dynamic_kernel(const T* __restrict__ o, const T* __restrict__ s, T* __restrict__ out,
                          int64_t n, int J, int K) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= n) return;
  const int64_t base = m * (static_cast<int64_t>(J) * K);
  for (int j = 0; j < J; ++j)
    for (int k = 0; k < K; ++k) {
      const int64_t e = base + static_cast<int64_t>(j) * K + k;
      out[e] = from_f32<T>(to_f32(o[e]) + to_f32(s[e]));
    }
}

// ---- MatVec -----------------------------------------------------------------
// Layout policies: the offset of A(i, j) in the stored buffer, as mdspan's
// layout_right (row-major, buffer (I, J)) and layout_left (column-major,
// buffer (J, I)).
struct Right {
  int64_t I, J;
  __device__ __forceinline__ int64_t offset(int64_t i, int64_t j) const { return i * J + j; }
};
struct Left {
  int64_t I, J;
  __device__ __forceinline__ int64_t offset(int64_t i, int64_t j) const { return j * I + i; }
};

template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ y, Layout map) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= map.I) return;
  float acc = 0.f;
  for (int64_t j = 0; j < map.J; ++j) acc = fmaf(to_f32(a[map.offset(i, j)]), to_f32(x[j]), acc);
  y[i] = from_f32<T>(acc);
}

// ---- launchers ----------------------------------------------------------------
unsigned int grid_for(int64_t n) { return static_cast<unsigned int>((n + kThreads - 1) / kThreads); }

template <typename T>
cudaError_t launch_sum3d(const void* x, int64_t n, void* partials, int max_blocks, void* out,
                         cudaStream_t st) {
  int64_t want = (n + kThreads * 8 - 1) / (kThreads * 8);
  const int nblocks = static_cast<int>(want < max_blocks ? (want < 1 ? 1 : want) : max_blocks);
  sum3d_partials_kernel<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), n, static_cast<float*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_partials_kernel<<<1, kThreads, 0, st>>>(static_cast<const float*>(partials), nblocks,
                                              static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stencil3d(const void* x, void* out, int I, int J, int K, cudaStream_t st) {
  const dim3 grid((K + 31) / 32, (J + 7) / 8, I);
  stencil3d_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                 I, J, K);
  return cudaGetLastError();
}

template <typename T, int J, int K>
cudaError_t launch_static(const void* o, const void* s, void* out, int64_t n, cudaStream_t st) {
  tinymatsum_static_kernel<T, J, K><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(s), static_cast<T*>(out), n);
  return cudaGetLastError();
}

// Runtime (J, K) -> the instantiation with those template arguments.
template <typename T, int J>
cudaError_t static_for_k(int K, const void* o, const void* s, void* out, int64_t n,
                         cudaStream_t st) {
  switch (K) {
    case 1: return launch_static<T, J, 1>(o, s, out, n, st);
    case 2: return launch_static<T, J, 2>(o, s, out, n, st);
    case 3: return launch_static<T, J, 3>(o, s, out, n, st);
    case 4: return launch_static<T, J, 4>(o, s, out, n, st);
    case 5: return launch_static<T, J, 5>(o, s, out, n, st);
    case 6: return launch_static<T, J, 6>(o, s, out, n, st);
    case 7: return launch_static<T, J, 7>(o, s, out, n, st);
    case 8: return launch_static<T, J, 8>(o, s, out, n, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_tiny_static(int J, int K, const void* o, const void* s, void* out, int64_t n,
                               cudaStream_t st) {
  switch (J) {
    case 1: return static_for_k<T, 1>(K, o, s, out, n, st);
    case 2: return static_for_k<T, 2>(K, o, s, out, n, st);
    case 3: return static_for_k<T, 3>(K, o, s, out, n, st);
    case 4: return static_for_k<T, 4>(K, o, s, out, n, st);
    case 5: return static_for_k<T, 5>(K, o, s, out, n, st);
    case 6: return static_for_k<T, 6>(K, o, s, out, n, st);
    case 7: return static_for_k<T, 7>(K, o, s, out, n, st);
    case 8: return static_for_k<T, 8>(K, o, s, out, n, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_tiny_dynamic(int J, int K, const void* o, const void* s, void* out, int64_t n,
                                cudaStream_t st) {
  tinymatsum_dynamic_kernel<T><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(s), static_cast<T*>(out), n, J, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_matvec(int layout, const void* a, const void* x, void* y, int I, int J,
                          cudaStream_t st) {
  const T* ap = static_cast<const T*>(a);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (layout == 0) {
    matvec_kernel<T, Right><<<grid_for(I), kThreads, 0, st>>>(ap, xp, yp, Right{I, J});
  } else {
    matvec_kernel<T, Left><<<grid_for(I), kThreads, 0, st>>>(ap, xp, yp, Left{I, J});
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point: dtype 0 = float32, 1 = bfloat16 (all operands share it);
// returns the cudaError_t of the launch (0 on success); nothing here
// synchronizes or allocates.

// Sum of the n elements of x into out[0] (f32); partials: max_blocks f32 of
// scratch.
int repro_sum3d(int dtype, const void* x, int64_t n, void* partials, int max_blocks, void* out,
                void* stream) {
  if ((dtype != 0 && dtype != 1) || n < 0 || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0
      ? launch_sum3d<float>(x, n, partials, max_blocks, out, s)
      : launch_sum3d<__nv_bfloat16>(x, n, partials, max_blocks, out, s);
  return static_cast<int>(e);
}

// out (I, J, K) = the 27-point box sum of x on the interior, 0 elsewhere.
int repro_stencil3d(int dtype, const void* x, void* out, int I, int J, int K, void* stream) {
  if ((dtype != 0 && dtype != 1) || I < 1 || J < 1 || K < 1 || I > 65535 || J > 8 * 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch_stencil3d<float>(x, out, I, J, K, s)
                                   : launch_stencil3d<__nv_bfloat16>(x, out, I, J, K, s);
  return static_cast<int>(e);
}

// out = o + s over n (J, K) matrices; is_static picks the kernel with J and K
// as template arguments (1..8 each) or as runtime ints.
int repro_tinymatsum(int dtype, int is_static, const void* o, const void* s, void* out, int64_t n,
                     int J, int K, void* stream) {
  if ((dtype != 0 && dtype != 1) || n < 1 || J < 1 || K < 1 ||
      (is_static && (J > kMaxTiny || K > kMaxTiny))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_static) {
    e = dtype == 0 ? launch_tiny_static<float>(J, K, o, s, out, n, st)
                   : launch_tiny_static<__nv_bfloat16>(J, K, o, s, out, n, st);
  } else {
    e = dtype == 0 ? launch_tiny_dynamic<float>(J, K, o, s, out, n, st)
                   : launch_tiny_dynamic<__nv_bfloat16>(J, K, o, s, out, n, st);
  }
  return static_cast<int>(e);
}

// y (I) = A x, A stored as layout 0 = right (buffer (I, J)) or 1 = left
// (buffer (J, I)).
int repro_matvec(int dtype, int layout, const void* a, const void* x, void* y, int I, int J,
                 void* stream) {
  if ((dtype != 0 && dtype != 1) || (layout != 0 && layout != 1) || I < 1 || J < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch_matvec<float>(layout, a, x, y, I, J, s)
                                   : launch_matvec<__nv_bfloat16>(layout, a, x, y, I, J, s);
  return static_cast<int>(e);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
