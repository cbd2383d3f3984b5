// The backward pass of dense GQA flash attention for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (repro_torch/kernels/flash_vjp.py
// holds the wrapper, FlashAttentionFn, and the plain PyTorch backward these
// kernels are held against).
//
// What it replaces: the hand-written custom_vjp backward of the JAX reference
// package, src/repro/kernels/flash_vjp.py::_bwd (a jnp scan, no pallas_call:
// the reference's training path runs attention through it). Same math:
//
//   P    = exp(q . k * scale - lse)      recomputed, zero on dead pairs
//   dV   = P^T . dO
//   dP   = dO . V^T
//   delta = rowsum(dO o O)
//   dS   = P o (dP - delta) * scale
//   dQ   = dS . K ;  dK = dS^T . Q
//
// with the GQA group's Hq / Hkv query heads folded back onto their KV head.
// Query row t sits at absolute position q_offset + t (q_offset read on the
// device when the caller passes a pointer); key j is live when j < Tk,
// j <= q_pos (causal) and j > q_pos - window (window set). Dead pairs get
// P = 0 by liveness, never through the exponent, so a fully masked row (its
// lse is -1e30 from the forward) has zero gradients, not NaN.
//
// Layout: q, out, dO, dq (B, Hq, Tq, D); k, v, dk, dv (B, Hkv, Tk, D); lse
// and the delta scratch (B, Hq, Tq) f32; all contiguous, one element type T
// (float or __nv_bfloat16) for q, k, v, out, dO and the gradients; every
// product and sum in f32 on the CUDA cores, the gradients rounded to T once.
//
// Three kernels, launched in order on one stream:
//   delta_kernel   rowsum(dO o O), one warp a row;
//   dkdv_kernel    one block per (key tile of NK keys, b, kv head): its K/V
//                  tile stays in shared memory while the block walks the
//                  group's query heads and the query tiles of BQ rows that can
//                  see the tile (the causal start and the window's end cut the
//                  walk); dK and dV accumulate in registers and are written
//                  once, so the result is the same from run to run (no
//                  atomics);
//   dq_kernel      one block per (query tile of BQ rows, b, q head), walking
//                  the key tiles its rows can see; dQ in registers.
// Both recompute S and dP = dO . V^T from the staged tiles. 256 threads a
// block as a 16 x 16 grid: each thread holds a (BQ / 16) x (NK / 16) patch of
// S and dP and a (NK / 16) x (D / 16) patch of dK and dV (dkdv) or a
// (BQ / 16) x (D / 16) patch of dQ (dq). Tiles are 64 x 64 up to D 128 and
// 32 x 32 at D 256, where 64-row tiles would not fit shared memory with
// their accumulators in registers (at D 256 the tiles take 143,872 bytes).
// A design that is simple and right; the tensor cores are a later step.

#include "common.cuh"

namespace {

constexpr int kBwdThreads = 256;

template <int D> __host__ __device__ constexpr int bwd_rows() { return D > 128 ? 32 : 64; }
template <int D> __host__ __device__ constexpr int bwd_keys() { return D > 128 ? 32 : 64; }

// the planner's constants (kernels/flash_vjp.py::GEOMETRY), in its order
constexpr int kGeometry[] = {kBwdThreads, bwd_rows<64>(), bwd_keys<64>(), bwd_rows<256>(),
                             bwd_keys<256>()};

template <int D> struct BwdSmem {
  static constexpr int BQ = bwd_rows<D>(), NK = bwd_keys<D>();
  static constexpr int LK = D + 1;    // K / V row stride: S reads 16 rows at one column
  static constexpr int PS = NK + 16;  // P / dS row stride: two rows a warp on other banks
  static constexpr size_t floats =
      2 * static_cast<size_t>(NK) * LK + 2 * static_cast<size_t>(BQ) * D +
      2 * static_cast<size_t>(BQ) * PS + 2 * BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

struct Mask {
  int tq, tk, q_off, causal, has_window, window;
  __device__ bool operator()(int t, int j) const {
    if (t >= tq || j >= tk) return false;
    const int qp = q_off + t;
    if (causal && j > qp) return false;
    if (has_window && j <= qp - window) return false;
    return true;
  }
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
             long long rows, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * (kBwdThreads / 32) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(o[d]), to_f32(g[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// Rows [row0, row0 + n) of a (rows, D) matrix of T into shared memory as f32
// (stride D); rows past ``limit`` are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, float* dst, int row0,
                                           int n, int limit, int stride) {
  for (int i = threadIdx.x; i < n * D; i += kBwdThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * stride + d] = row0 + r < limit ? to_f32(src[static_cast<size_t>(row0 + r) * D + d])
                                           : 0.f;
  }
}

// S = Q . K^T and dP = dO . V^T over the staged tiles for this thread's patch
// (rows ty + 16 a, keys tx + 16 b), then P and dS by the mask:
// p_s / ds_s[i * PS + j] (p_s may be null: the dq kernel needs dS alone).
template <int D>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s, const float* k_s,
                                       const float* v_s, const float* lse_s, const float* dl_s,
                                       float* p_s, float* ds_s, int t0, int j0, float scale,
                                       const Mask& mask) {
  using S = BwdSmem<D>;
  constexpr int TI = S::BQ / 16, TJ = S::NK / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[TI][TJ], dp[TI][TJ];
#pragma unroll
  for (int a = 0; a < TI; ++a)
#pragma unroll
    for (int b = 0; b < TJ; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[TI], oa[TI], kb[TJ], vb[TJ];
#pragma unroll
    for (int a = 0; a < TI; ++a) {
      qa[a] = q_s[(ty + 16 * a) * D + d];
      oa[a] = do_s[(ty + 16 * a) * D + d];
    }
#pragma unroll
    for (int b = 0; b < TJ; ++b) {
      kb[b] = k_s[(tx + 16 * b) * S::LK + d];
      vb[b] = v_s[(tx + 16 * b) * S::LK + d];
    }
#pragma unroll
    for (int a = 0; a < TI; ++a)
#pragma unroll
      for (int b = 0; b < TJ; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < TI; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < TJ; ++b) {
      const int j = tx + 16 * b;
      const float p = mask(t0 + i, j0 + j) ? expf(s[a][b] * scale - lse_s[i]) : 0.f;
      if (p_s != nullptr) p_s[i * S::PS + j] = p;
      ds_s[i * S::PS + j] = p * (dp[a][b] - dl_s[i]) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            const int* __restrict__ q_off_ptr, int q_off_val, int hkv, int group, int tq,
            int tk, int causal, int has_window, int window, float scale) {
  using S = BwdSmem<D>;
  constexpr int BQ = S::BQ, NK = S::NK, TJ = NK / 16, TD = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + NK * S::LK;
  float* q_s = v_s + NK * S::LK;
  float* do_s = q_s + BQ * D;
  float* p_s = do_s + BQ * D;
  float* ds_s = p_s + BQ * S::PS;
  float* lse_s = ds_s + BQ * S::PS;
  float* dl_s = lse_s + BQ;

  const int j0 = blockIdx.x * NK, h = blockIdx.y, b = blockIdx.z;
  const int G = group, hq = hkv * G;
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Mask mask{tq, tk, q_off, causal, has_window, window};
  const size_t kv_row0 = (static_cast<size_t>(b) * hkv + h) * tk;
  stage_rows<T, D>(k + kv_row0 * D, k_s, j0, NK, tk, S::LK);
  stage_rows<T, D>(v + kv_row0 * D, v_s, j0, NK, tk, S::LK);

  float dk_acc[TJ][TD], dv_acc[TJ][TD];
#pragma unroll
  for (int a = 0; a < TJ; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // the query rows that can see keys [j0, j_last]: t in [t_lo, t_hi)
  const int j_last = min(j0 + NK, tk) - 1;
  const int t_lo = causal ? max(0, j0 - q_off) : 0;
  const int t_hi = has_window ? min(tq, j_last + window - q_off) : tq;
  for (int g = 0; g < G; ++g) {
    const size_t q_row0 = (static_cast<size_t>(b) * hq + h * G + g) * tq;
    for (int t0 = t_lo; t0 < t_hi; t0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      stage_rows<T, D>(q + q_row0 * D, q_s, t0, BQ, tq, D);
      stage_rows<T, D>(dout + q_row0 * D, do_s, t0, BQ, tq, D);
      for (int i = threadIdx.x; i < BQ; i += kBwdThreads) {
        const bool in = t0 + i < tq;
        lse_s[i] = in ? lse[q_row0 + t0 + i] : 0.f;
        dl_s[i] = in ? delta[q_row0 + t0 + i] : 0.f;
      }
      __syncthreads();
      scores<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, t0, j0, scale, mask);
      __syncthreads();
      // dV += P^T . dO, dK += dS^T . Q over this thread's keys ty + 16 a and
      // columns tx + 16 c
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pj[TJ], sj[TJ], od[TD], qd[TD];
#pragma unroll
        for (int a = 0; a < TJ; ++a) {
          pj[a] = p_s[i * S::PS + ty + 16 * a];
          sj[a] = ds_s[i * S::PS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          od[c] = do_s[i * D + tx + 16 * c];
          qd[c] = q_s[i * D + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < TJ; ++a)
#pragma unroll
          for (int c = 0; c < TD; ++c) {
            dv_acc[a][c] = fmaf(pj[a], od[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sj[a], qd[c], dk_acc[a][c]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TJ; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= tk) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const size_t off = (kv_row0 + j) * D + tx + 16 * c;
      dk[off] = from_f32<T>(dk_acc[a][c]);
      dv[off] = from_f32<T>(dv_acc[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq,
          const int* __restrict__ q_off_ptr, int q_off_val, int hkv, int group, int tq, int tk,
          int causal, int has_window, int window, float scale) {
  using S = BwdSmem<D>;
  constexpr int BQ = S::BQ, NK = S::NK, TI = BQ / 16, TD = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + NK * S::LK;
  float* q_s = v_s + NK * S::LK;
  float* do_s = q_s + BQ * D;
  float* ds_s = do_s + BQ * D + BQ * S::PS;  // the P slot of the layout stays unused
  float* lse_s = ds_s + BQ * S::PS;
  float* dl_s = lse_s + BQ;

  const int t0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int G = group;
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Mask mask{tq, tk, q_off, causal, has_window, window};
  const size_t q_row0 = (static_cast<size_t>(b) * hkv * G + hh) * tq;
  const size_t kv_row0 = (static_cast<size_t>(b) * hkv + hh / G) * tk;
  stage_rows<T, D>(q + q_row0 * D, q_s, t0, BQ, tq, D);
  stage_rows<T, D>(dout + q_row0 * D, do_s, t0, BQ, tq, D);
  for (int i = threadIdx.x; i < BQ; i += kBwdThreads) {
    const bool in = t0 + i < tq;
    lse_s[i] = in ? lse[q_row0 + t0 + i] : 0.f;
    dl_s[i] = in ? delta[q_row0 + t0 + i] : 0.f;
  }

  float dq_acc[TI][TD];
#pragma unroll
  for (int a = 0; a < TI; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) dq_acc[a][c] = 0.f;

  // the keys these rows can see: [j_lo, j_hi)
  const int t_last = min(t0 + BQ, tq) - 1;
  const int j_lo = has_window ? max(0, q_off + t0 - window + 1) : 0;
  const int j_hi = causal ? min(tk, q_off + t_last + 1) : tk;
  for (int j0 = j_lo; j0 < j_hi; j0 += NK) {
    __syncthreads();  // the previous tile's readers are done (and Q, dO staged)
    stage_rows<T, D>(k + kv_row0 * D, k_s, j0, NK, tk, S::LK);
    stage_rows<T, D>(v + kv_row0 * D, v_s, j0, NK, tk, S::LK);
    __syncthreads();
    scores<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s, t0, j0, scale, mask);
    __syncthreads();
    // dQ += dS . K over this thread's rows ty + 16 a and columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < NK; ++j) {
      float si[TI], kd[TD];
#pragma unroll
      for (int a = 0; a < TI; ++a) si[a] = ds_s[(ty + 16 * a) * S::PS + j];
#pragma unroll
      for (int c = 0; c < TD; ++c) kd[c] = k_s[j * S::LK + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TI; ++a)
#pragma unroll
        for (int c = 0; c < TD; ++c) dq_acc[a][c] = fmaf(si[a], kd[c], dq_acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < TI; ++a) {
    const int t = t0 + ty + 16 * a;
    if (t >= tq) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      dq[(q_row0 + t) * D + tx + 16 * c] = from_f32<T>(dq_acc[a][c]);
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, const void* q_off_ptr, int q_off, int batch, int hq, int hkv,
                       int tq, int tk, int causal, int has_window, int window, float scale,
                       cudaStream_t stream) {
  using S = BwdSmem<D>;
  const int G = hq / hkv;
  const long long rows = static_cast<long long>(batch) * hq * tq;
  const long long dblocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  if (dblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_kernel<T><<<static_cast<unsigned>(dblocks), kBwdThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static size_t opted_kv[kMaxDevices] = {}, opted_q[kMaxDevices] = {};
  auto kv_kern = dkdv_kernel<T, D>;
  e = set_smem(kv_kern, S::bytes, opted_kv);
  if (e != cudaSuccess) return e;
  kv_kern<<<dim3((tk + S::NK - 1) / S::NK, hkv, batch), kBwdThreads, S::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const int*>(q_off_ptr), q_off, hkv, G, tq, tk, causal, has_window, window,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto q_kern = dq_kernel<T, D>;
  e = set_smem(q_kern, S::bytes, opted_q);
  if (e != cudaSuccess) return e;
  q_kern<<<dim3((tq + S::BQ - 1) / S::BQ, hq, batch), kBwdThreads, S::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      static_cast<const int*>(q_off_ptr), q_off, hkv, G, tq, tk, causal, has_window, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout and the gradients
// share it). lse is the forward's (B, Hq, Tq) f32 log-sum-exp of the scaled
// scores (-1e30 on a row with no live key); delta is (B, Hq, Tq) f32
// scratch. q_offset_ptr points at one int32 on the device, or is null and
// q_offset is used. Returns the cudaError_t of the launches (0 on success);
// nothing here synchronizes.
int repro_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                              const void* out, const void* dout, const float* lse,
                              float* delta, void* dq, void* dk, void* dv,
                              const void* q_offset_ptr, int q_offset, int batch, int hq,
                              int hkv, int tq, int tk, int head_dim, int causal, int has_window,
                              int window, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || batch > 65535 || hkv <= 0 ||
      hq % hkv != 0 || hq > 65535 || tq <= 0 || tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only these launches' errors to them
  const auto st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(DIM)                                                                       \
  case DIM:                                                                                  \
    return static_cast<int>(                                                                 \
        dtype == 0                                                                           \
            ? launch_bwd<float, DIM>(q, k, v, out, dout, lse, delta, dq, dk, dv,             \
                                     q_offset_ptr, q_offset, batch, hq, hkv, tq, tk, causal, \
                                     has_window, window, scale, st)                          \
            : launch_bwd<__nv_bfloat16, DIM>(q, k, v, out, dout, lse, delta, dq, dk, dv,     \
                                             q_offset_ptr, q_offset, batch, hq, hkv, tq, tk, \
                                             causal, has_window, window, scale, st));
  switch (head_dim) {
    REPRO_BWD(16)
    REPRO_BWD(32)
    REPRO_BWD(64)
    REPRO_BWD(112)
    REPRO_BWD(128)
    REPRO_BWD(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD
}

// Copies up to ``n`` values of kGeometry into ``out``; returns how many it has.
int repro_geometry(int* out, int n) {
  constexpr int count = static_cast<int>(sizeof(kGeometry) / sizeof(kGeometry[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = kGeometry[i];
  return count;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
