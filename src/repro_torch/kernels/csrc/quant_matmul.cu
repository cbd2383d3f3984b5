// Quantized matmul for Hopper (sm_90a): y = x @ dequant(W)^T, with a plain C
// interface loaded through ctypes (repro_torch/kernels/quant_matmul.py holds
// the wrapper and the plain PyTorch version it is held against).
//
// What it replaces (the JAX reference package's Pallas TPU kernel):
//   quant_matmul_kernel  <- src/repro/kernels/quant_matmul.py::quant_matmul
//
// Operands: x (M, K) float or __nv_bfloat16; W stored output-major as q (N, K)
// int8, or (N, K/2) int4 in ADJACENT nibbles (byte j holds value 2j in the lo
// nibble and 2j + 1 in the hi, each sign-extended); scale (N, K / qblock) f32,
// one per (row, K-block). Output (M, N) in x's type; every product and sum is
// f32. As in the TPU kernel, the K-step is the quantization block, so one
// scale covers one staged tile: the block dequantizes W as float(q) * scale
// (the reference's arithmetic) while staging it.
//
// What bounds it on an H100: at the serving shapes (M = 8 decode rows or one
// 128-token chunk, K x N = 896 x 4864 or 4864 x 896) the int8 weight bytes
// dominate (4.4 MB a call) and the flops are 2 * M * N * K (0.07 to 1.1
// GFLOP), so the bound is bytes for M = 8 and still within a few x of it for
// M = 128 on the tensor cores.
//
// What this simple design does about it: each block computes a BM x 64 tile
// of y (BM = 16 for M <= 16, else 64) with 256 threads, each owning TM x 4
// outputs in registers. Per K-block it stages x's BM x qblock slice and W's
// 64 x qblock slice, dequantized, in shared memory as f32 (rows padded by one
// against bank conflicts), then takes the f32 products on CUDA cores. Each
// weight byte is read from device memory by the ceil(M / BM) blocks of its
// column tile only. What it does not do yet: vectorized or asynchronous
// (cp.async / TMA) loads, double buffering, or tensor cores (int8 or bf16
// wgmma), which the M = 128 chunk shape needs to approach its bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 16 x 16 threads
constexpr int kBN = 64;                 // output columns per block (4 per thread)
constexpr int kMaxQBlock = 256;         // the K-step; the wrapper refuses larger blocks
constexpr size_t kMaxSmem = 232448;     // opt-in shared memory per block on sm_90
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float signed_nibble(int b) {
  const int n = b & 0xF;
  return static_cast<float>(n >= 8 ? n - 16 : n);
}

// One block: rows m0 .. m0 + 16 * TM - 1, columns n0 .. n0 + 63 of y.
template <typename T, int BITS, int TM>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, T* __restrict__ y,
                    int M, int N, int K, int qblock) {
  constexpr int BM = 16 * TM;
  const int BK = qblock, LD = qblock + 1;
  const int nblocks = K / qblock;
  const int kq_row = BITS == 8 ? K : K / 2;  // bytes per row of q
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* x_s = smem;             // BM * LD
  float* w_s = x_s + BM * LD;    // kBN * LD

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < nblocks; ++kb) {
    const int k0 = kb * BK;
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i - r * BK;
      const int m = m0 + r;
      x_s[r * LD + c] = m < M ? to_f32(x[static_cast<size_t>(m) * K + k0 + c]) : 0.f;
    }
    if (BITS == 8) {
      for (int i = threadIdx.x; i < kBN * BK; i += kThreads) {
        const int r = i / BK, c = i - r * BK;
        const int n = n0 + r;
        float w = 0.f;
        if (n < N) {
          w = static_cast<float>(q[static_cast<size_t>(n) * kq_row + k0 + c]) *
              scale[static_cast<size_t>(n) * nblocks + kb];
        }
        w_s[r * LD + c] = w;
      }
    } else {
      const int BKB = BK / 2;  // bytes per row of the staged tile
      for (int i = threadIdx.x; i < kBN * BKB; i += kThreads) {
        const int r = i / BKB, c = i - r * BKB;
        const int n = n0 + r;
        float lo = 0.f, hi = 0.f;
        if (n < N) {
          const int b = q[static_cast<size_t>(n) * kq_row + k0 / 2 + c];
          const float s = scale[static_cast<size_t>(n) * nblocks + kb];
          lo = signed_nibble(b) * s;
          hi = signed_nibble(b >> 4) * s;
        }
        w_s[r * LD + 2 * c] = lo;
        w_s[r * LD + 2 * c + 1] = hi;
      }
    }
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float a[TM], w[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = x_s[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = w_s[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kern, size_t smem, size_t* opted) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) opted[dev] = smem;
  return e;
}

template <typename T, int BITS, int TM>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y, int M, int N,
                   int K, int qblock, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const size_t smem = sizeof(float) * static_cast<size_t>(BM + kBN) * (qblock + 1);
  auto kern = quant_matmul_kernel<T, BITS, TM>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<T*>(y), M, N, K, qblock);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_rows(const void* x, const void* q, const void* scale, void* y, int M, int N,
                        int K, int qblock, cudaStream_t stream) {
  return M <= 16 ? launch<T, BITS, 1>(x, q, scale, y, M, N, K, qblock, stream)
                 : launch<T, BITS, 4>(x, q, scale, y, M, N, K, qblock, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y share it); bits: 8 or 4. K must be
// a multiple of qblock, qblock even and <= 256. Returns the cudaError_t of the
// launch (0 on success); nothing here synchronizes.
int repro_quant_matmul(int dtype, int bits, const void* x, const void* q, const void* scale,
                       void* y, int M, int N, int K, int qblock, void* stream) {
  if ((dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) || M <= 0 || N <= 0 || K <= 0 ||
      qblock <= 0 || qblock > kMaxQBlock || qblock % 2 != 0 || K % qblock != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = bits == 8 ? launch_rows<float, 8>(x, q, scale, y, M, N, K, qblock, s)
                  : launch_rows<float, 4>(x, q, scale, y, M, N, K, qblock, s);
  } else {
    e = bits == 8 ? launch_rows<__nv_bfloat16, 8>(x, q, scale, y, M, N, K, qblock, s)
                  : launch_rows<__nv_bfloat16, 4>(x, q, scale, y, M, N, K, qblock, s);
  }
  return static_cast<int>(e);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
