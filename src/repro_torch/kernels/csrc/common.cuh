// Helpers the port's attention and scan kernels share (included by
// paged_attention.cu, flash_attention.cu and ssd_scan.cu; kernels/_build.py
// hashes every header under csrc/ into each library's name, so an edit here
// rebuilds them all): f32 conversions, warp reductions, the f32 K/V tile
// stage and the online-softmax tile update, the log-sum-exp combine of
// split-K partials, and the dynamic shared-memory opt-in.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;     // opt-in shared memory per block on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage NT token slots of K and V in shared memory as f32. ``src(t)`` gives
// the row index (in units of one head vector) of slot t in the source arrays,
// or -1 for a slot that holds nothing (it is zero-filled and masked dead by
// the caller).
template <typename T, int D, typename Src>
__device__ inline void load_kv_tile(const T* __restrict__ k, const T* __restrict__ v,
                                    float* k_s, float* v_s, int NT, Src src) {
  for (int i = threadIdx.x; i < NT * D; i += blockDim.x) {
    const int t = i / D, d = i - t * D;
    const long long row = src(t);
    float kv = 0.f, vv = 0.f;
    if (row >= 0) {
      kv = to_f32(k[row * D + d]);
      vv = to_f32(v[row * D + d]);
    }
    k_s[t * (D + 1) + d] = kv;
    v_s[t * D + d] = vv;
  }
}

// One online-softmax accumulation over a staged (NT, D) K/V tile for R query
// rows (the reference's _flash_update). Dead (row, slot) pairs are masked by
// liveness, never by the exponent alone: exp(NEG_INF - NEG_INF) == 1 on an
// all-dead tile. Ends with a barrier, so the caller may restage the tile.
template <int D, typename Live>
__device__ inline void flash_tile(const float* q_s, const float* k_s, const float* v_s,
                                  float* s_s, float* m_s, float* l_s, float* alpha_s,
                                  float* acc_s, int R, int NT, float scale, Live live) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int idx = tid; idx < R * NT; idx += nthr) {
    const int r = idx / NT, t = idx - r * NT;
    float s = kNegInf;
    if (live(r, t)) {
      const float* qr = q_s + r * D;
      const float* kt = k_s + t * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kt[d], dot);
      s = dot * scale;
    }
    s_s[idx] = s;
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  for (int r = warp; r < R; r += nwarps) {
    float* sr = s_s + r * NT;
    float mx = kNegInf;
    for (int t = lane; t < NT; t += 32) mx = fmaxf(mx, sr[t]);
    mx = warp_max(mx);
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < NT; t += 32) {
      const float p = live(r, t) ? expf(sr[t] - m_new) : 0.f;
      sr[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      alpha_s[r] = alpha;
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += nthr) {
    const int r = idx / D, d = idx - r * D;
    const float* pr = s_s + r * NT;
    float a = acc_s[idx] * alpha_s[r];
    for (int t = 0; t < NT; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
    acc_s[idx] = a;
  }
  __syncthreads();
}

// Split-K combine. A decode split over keys leaves, for each of ``rows``
// query rows and each of ``splits`` splits, its running max m, sum l and
// unnormalized f32 accumulator acc[D]; ws holds m (rows, splits), then l
// (rows, splits), then acc (rows, splits, D). The combine is the log-sum-exp
// merge: m* = max of m_s over live splits (l_s > 0), l* = sum l_s e^(m_s - m*),
// out = sum acc_s e^(m_s - m*) / l*, and 0 when l* is 0 (a row with no live
// key). A dead split (l_s == 0) is never used past its l, so its m and acc may
// be anything (its acc is read and dropped by a select, never summed).
//
// A block per (32 features, row), kCombineWarps warps: warp 0 takes the row's
// splits 32 at a time on its lanes (m*, then each split's weight e^(m_s - m*)
// into shared memory, and l*), then warp w sums splits w, w + kCombineWarps,
// ... of its lane's feature, and the warps' sums meet in shared memory in warp
// order. The splits are read in parallel, not one after another: a row of 64
// splits (the ring decode's) costs a few load latencies. Fixed order: the same
// bits every run. Dynamic shared memory: ``splits`` floats.
constexpr int kCombineWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
combine_splits_kernel(const float* __restrict__ ws, T* __restrict__ out, int rows, int splits,
                      int D) {
  extern __shared__ float w_s[];  // splits: the weight of each split, 0 for a dead one
  __shared__ float part[kCombineWarps][32];
  __shared__ float l_star;
  const int r = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* m = ws + static_cast<size_t>(r) * splits;
  const float* l = ws + static_cast<size_t>(rows) * splits + static_cast<size_t>(r) * splits;
  const float* acc = ws + 2 * static_cast<size_t>(rows) * splits +
                     static_cast<size_t>(r) * splits * D;
  if (warp == 0) {
    float mx = -CUDART_INF_F;
    for (int s = lane; s < splits; s += 32) mx = l[s] > 0.f ? fmaxf(mx, m[s]) : mx;
    mx = warp_max(mx);
    float ls = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float lv = l[s];
      const float w = lv > 0.f ? expf(m[s] - mx) : 0.f;
      w_s[s] = w;
      ls = fmaf(w, lv, ls);
    }
    ls = warp_sum(ls);
    if (lane == 0) l_star = ls;
  }
  __syncthreads();
  const int d = blockIdx.x * 32 + lane;
  float o = 0.f;
  if (d < D) {
#pragma unroll 4
    for (int s = warp; s < splits; s += kCombineWarps) {
      const float w = w_s[s], a = acc[static_cast<size_t>(s) * D + d];
      o = w > 0.f ? fmaf(w, a, o) : o;
    }
  }
  part[warp][lane] = o;
  __syncthreads();
  if (warp == 0 && d < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kCombineWarps; ++w) t += part[w][lane];
    out[static_cast<size_t>(r) * D + d] = from_f32<T>(l_star > 0.f ? t / l_star : 0.f);
  }
}

template <typename T>
cudaError_t combine_splits(const float* ws, T* out, int rows, int splits, int D,
                           cudaStream_t stream) {
  if (rows > 65535 || static_cast<size_t>(splits) * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
  combine_splits_kernel<T><<<dim3((D + 31) / 32, rows), kCombineWarps * 32,
                             static_cast<size_t>(splits) * sizeof(float), stream>>>(
      ws, out, rows, splits, D);
  return cudaGetLastError();
}

// Opt ``kern`` in to ``smem`` bytes of dynamic shared memory. The attribute
// is raised once per (kernel instantiation, device) and only when a launch
// needs more than before: ``opted`` remembers the level already set, so the
// steady serving loop makes no driver call here.
constexpr int kMaxDevices = 64;

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

}  // namespace
