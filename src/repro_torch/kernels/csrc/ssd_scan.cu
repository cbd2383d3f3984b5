// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a), ngroups
// 1, with a plain C interface loaded through ctypes
// (repro_torch/kernels/ssd_scan.py holds the wrapper and the plain PyTorch
// version it is held against).
//
// What it replaces: src/repro/kernels/ssd_scan.py::ssd_scan (Pallas TPU).
// Same math, per head h with a_t = exp(dt_t * A_h) and s_t the running sum of
// dt * A inside a chunk:
//   y_t     = exp(s_t) (C_t . S_0) + sum_{u <= t} exp(min(s_t - s_u, 0)) dt_u (C_t . B_u) x_u
//   S_chunk = exp(s_Q) S_0 + sum_u exp(s_Q - s_u) dt_u x_u B_u^T
// with the reference's exp(min(seg, 0)) guard kept. Every sum is in f32; y is
// written in x's type, the final state in f32.
//
// Layout: x (b, t, h, p) and B / C (b, t, n) in T (float or __nv_bfloat16);
// dt (b, t, h), A (h,), the initial and final states (b, h, p, n) in f32.
//
// State placement: the TPU kernel keeps the whole (H, P, N) state in VMEM
// across a sequential chunk grid; at mamba2-780m's width (H 48, P 64, N 128)
// that is 1.5 MB a sequence, more than an SM holds. With ngroups 1 the heads
// share B and C and never meet, so here one block owns one (sequence, head,
// 32-column slice of P) and carries its 32 x N f32 state in shared memory
// across the chunks, in order, inside the block.
//
// Chunk length: the block walks the sequence in its own chunks of kQ = 64
// steps whatever chunk the caller's plain version uses (the recurrence is
// exact at any chunk length; the two differ in rounding only), so the Q x Q
// intra-chunk product is one fixed 64 x 64 tile even where the model sets
// chunk = t for a prompt that is no multiple of 128. A ragged tail is masked
// as dt = 0, x = 0, B = C = 0, which is exact: those steps decay nothing and
// add nothing, and their y is never written.
//
// What bounds it on an H100: operations, and in this first version shared
// memory: per chunk and block it does ~0.8M f32 multiply-adds (C . B, the
// masked product with x, C . S and the state update) on operands staged in
// shared memory, one or two shared loads per multiply-add. Not done yet:
// tensor cores for the four products, or computing C . B once per (sequence,
// chunk) for all heads (it is recomputed by each of the h * p / 32 blocks).

#include "common.cuh"

namespace {

constexpr int kQ = 64;        // time steps per chunk
constexpr int kPS = 32;       // columns of the head dim per block
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ sf, int t_len, int heads, int hdim, int N) {
  const int p0 = blockIdx.x * kPS, hh = blockIdx.y, b = blockIdx.z;
  const int ps = min(kPS, hdim - p0);
  const int NP = N + 1;                 // padded row stride against bank conflicts
  extern __shared__ float smem[];
  float* S = smem;                      // kPS * NP   state rows p, columns n
  float* Bs = S + kPS * NP;             // kQ * NP
  float* Cs = Bs + kQ * NP;             // kQ * N     (read as broadcasts)
  float* xs = Cs + kQ * N;              // kQ * kPS
  float* Ms = xs + kQ * kPS;            // kQ * kQ    masked decay x (C . B) x dt
  float* dts = Ms + kQ * kQ;            // kQ
  float* ss = dts + kQ;                 // kQ         running sum s_t
  float* ws = ss + kQ;                  // kQ         exp(s_Q - s_u) dt_u
  float* es = ws + kQ;                  // kQ         exp(s_t)
  const int tid = threadIdx.x;
  const float a = A[hh];

  for (int i = tid; i < kPS * N; i += blockDim.x) {
    const int pp = i / N, n = i - pp * N;
    float v = 0.f;
    if (s0 != nullptr && pp < ps)
      v = s0[((static_cast<size_t>(b) * heads + hh) * hdim + p0 + pp) * N + n];
    S[pp * NP + n] = v;
  }
  for (int c0 = 0; c0 < t_len; c0 += kQ) {
    // stage the chunk; steps past t_len are dt = x = B = C = 0
    for (int i = tid; i < kQ * kPS; i += blockDim.x) {
      const int u = i / kPS, pp = i - u * kPS, t = c0 + u;
      xs[i] = (t < t_len && pp < ps)
          ? to_f32(x[((static_cast<size_t>(b) * t_len + t) * heads + hh) * hdim + p0 + pp])
          : 0.f;
    }
    for (int i = tid; i < kQ * N; i += blockDim.x) {
      const int u = i / N, n = i - u * N, t = c0 + u;
      float bv = 0.f, cv = 0.f;
      if (t < t_len) {
        const size_t off = (static_cast<size_t>(b) * t_len + t) * N + n;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      Bs[u * NP + n] = bv;
      Cs[i] = cv;
    }
    for (int u = tid; u < kQ; u += blockDim.x) {
      const int t = c0 + u;
      dts[u] = t < t_len ? dt[(static_cast<size_t>(b) * t_len + t) * heads + hh] : 0.f;
    }
    __syncthreads();
    // running sums of dt * A over the chunk: one warp, two steps a lane
    if (tid < 32) {
      const float l0 = dts[2 * tid] * a, l1 = dts[2 * tid + 1] * a;
      float incl = l0 + l1;
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      const float excl = incl - (l0 + l1);
      ss[2 * tid] = excl + l0;
      ss[2 * tid + 1] = incl;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
      for (int u = tid; u < kQ; u += 32) {
        ws[u] = expf(last - ss[u]) * dts[u];
        es[u] = expf(ss[u]);
      }
    }
    __syncthreads();
    // M[t, u] = (C_t . B_u) exp(min(s_t - s_u, 0)) dt_u for u <= t, else 0
    for (int i = tid; i < kQ * kQ; i += blockDim.x) {
      const int t = i / kQ, u = i - t * kQ;
      float m = 0.f;
      if (u <= t) {
        const float* ct = Cs + t * N;
        const float* bu = Bs + u * NP;
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(ct[n], bu[n], cb);
        m = cb * expf(fminf(ss[t] - ss[u], 0.f)) * dts[u];
      }
      Ms[i] = m;
    }
    __syncthreads();
    // y[t, p] = exp(s_t) (C_t . S_p) + sum_{u <= t} M[t, u] x[u, p]
    for (int i = tid; i < kQ * kPS; i += blockDim.x) {
      const int t = i / kPS, pp = i - t * kPS;
      if (c0 + t >= t_len || pp >= ps) continue;
      const float* ct = Cs + t * N;
      const float* sp = S + pp * NP;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ct[n], sp[n], inter);
      const float* mt = Ms + t * kQ;
      float intra = 0.f;
      for (int u = 0; u <= t; ++u) intra = fmaf(mt[u], xs[u * kPS + pp], intra);
      y[((static_cast<size_t>(b) * t_len + c0 + t) * heads + hh) * hdim + p0 + pp] =
          from_f32<T>(es[t] * inter + intra);
    }
    __syncthreads();
    // S[p, n] = exp(s_Q) S[p, n] + sum_u w_u x[u, p] B[u, n]
    const float decay = es[kQ - 1];
    for (int i = tid; i < kPS * N; i += blockDim.x) {
      const int pp = i / N, n = i - pp * N;
      float upd = 0.f;
      for (int u = 0; u < kQ; ++u) upd = fmaf(ws[u] * xs[u * kPS + pp], Bs[u * NP + n], upd);
      S[pp * NP + n] = S[pp * NP + n] * decay + upd;
    }
    __syncthreads();
  }
  for (int i = tid; i < ps * N; i += blockDim.x) {
    const int pp = i / N, n = i - pp * N;
    sf[((static_cast<size_t>(b) * heads + hh) * hdim + p0 + pp) * N + n] = S[pp * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   const void* s0, void* y, void* sf, int batch, int t_len, int heads, int hdim,
                   int N, cudaStream_t stream) {
  const size_t NP = N + 1;
  const size_t smem = sizeof(float) *
      (kPS * NP + kQ * NP + static_cast<size_t>(kQ) * N + kQ * kPS + kQ * kQ + 4 * kQ);
  auto kern = ssd_kernel<T>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  kern<<<dim3((hdim + kPS - 1) / kPS, heads, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sf), t_len, heads, hdim, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it); s0 may be null
// (a zero initial state). Returns the cudaError_t of the launch (0 on
// success); nothing here synchronizes.
int repro_ssd_scan(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* s0, void* y, void* sf, int batch, int t_len,
                   int heads, int head_dim, int n_state, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || t_len <= 0 || heads <= 0 || head_dim <= 0 ||
      n_state <= 0 || n_state > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0
      ? launch<float>(x, dt, A, Bm, Cm, s0, y, sf, batch, t_len, heads, head_dim, n_state, s)
      : launch<__nv_bfloat16>(x, dt, A, Bm, Cm, s0, y, sf, batch, t_len, heads, head_dim,
                              n_state, s);
  return static_cast<int>(e);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
