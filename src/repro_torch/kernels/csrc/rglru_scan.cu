// RG-LRU gated linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// over the time axis of (B, T, W), with a plain C interface loaded through
// ctypes (repro_torch/kernels/rglru_scan.py holds the wrapper and the plain
// PyTorch version it is held against).
//
// What it replaces: src/repro/kernels/rglru_scan.py::rglru_scan (Pallas TPU).
// Same function: a and b are the precomputed decay and input terms (the gates
// stay outside, as there), the state is f32 from an optional f32 h0, y is
// written in a's type, and the f32 final state comes back. Any T: the TPU
// kernel's T % chunk == 0 does not apply.
//
// Layout: a, b, y (B, T, W) in one element type (float or __nv_bfloat16),
// contiguous; h0 and the final state (B, W) f32.
//
// What bounds it on an H100: bytes. Each step is one multiply-add per column
// on 2 loads and 1 store, so the card's rate is far away and the memory
// system decides: the least time is (read a and b, write y) / the copy rate.
// The recurrence is sequential in t and independent across (b, w).
//
// What this simple design does about it: one thread owns one (b, w) column
// and keeps h in a register; a warp's 32 threads read 32 neighbouring columns
// of one time step, so every load and store is coalesced. The time loop is
// unrolled by kUnroll and all of a chunk's a_t, b_t loads are issued before
// the multiply-adds that consume them (they do not depend on h), so each
// thread has 2 * kUnroll loads in flight. The TPU kernel's sequential grid
// over time chunks is not copied: nothing carries between CUDA blocks, and
// here nothing has to. Not done yet: at B 2 x W 2560 this is 5120 threads,
// under one wave on 132 SMs, so the kernel is latency-bound and grid-starved;
// a chunked two-pass scan (chunk-local scans in parallel, then a pass that
// carries the chunk states) would fill the card.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;  // B 2 x W 2560: 80 blocks on 80 SMs (128 a block: 40)
constexpr int kUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ hf, int batch, int t_len, int width) {
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= static_cast<long long>(batch) * width) return;
  const long long bb = col / width, w = col - bb * width;
  const T* ap = a + bb * t_len * width + w;
  const T* bp = b + bb * t_len * width + w;
  T* yp = y + bb * t_len * width + w;
  float h = h0 != nullptr ? h0[col] : 0.f;
  int t = 0;
  for (; t + kUnroll <= t_len; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = static_cast<long long>(t + u) * width;
      av[u] = to_f32(ap[i]);
      bv[u] = to_f32(bp[i]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, bv[u]);
      yp[static_cast<long long>(t + u) * width] = from_f32<T>(h);
    }
  }
  for (; t < t_len; ++t) {
    const long long i = static_cast<long long>(t) * width;
    h = fmaf(to_f32(ap[i]), h, to_f32(bp[i]));
    yp[i] = from_f32<T>(h);
  }
  hf[col] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* y, void* hf, int batch,
                   int t_len, int width, cudaStream_t stream) {
  const long long cols = static_cast<long long>(batch) * width;
  const int blocks = static_cast<int>((cols + kThreads - 1) / kThreads);
  rglru_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hf), batch, t_len, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and y share it); h0 may be null (a
// zero initial state); hf receives the f32 final state. Returns the
// cudaError_t of the launch (0 on success); nothing here synchronizes.
int repro_rglru_scan(int dtype, const void* a, const void* b, const void* h0, void* y, void* hf,
                     int batch, int t_len, int width, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || t_len <= 0 || width <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0
      ? launch<float>(a, b, h0, y, hf, batch, t_len, width, s)
      : launch<__nv_bfloat16>(a, b, h0, y, hf, batch, t_len, width, s);
  return static_cast<int>(e);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
