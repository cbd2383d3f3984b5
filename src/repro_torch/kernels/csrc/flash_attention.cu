// Dense-cache GQA flash attention for Hopper (sm_90a): the prefill kernel
// (a block of query rows against contiguous K/V) and one-token decode against
// a contiguous cache, with a plain C interface loaded through ctypes
// (repro_torch/kernels/flash_attention.py holds the wrappers and the plain
// PyTorch versions these kernels are held against).
//
// What they replace (the JAX reference package's Pallas TPU kernels):
//   repro_flash_attention  <- src/repro/kernels/flash_attention.py::flash_attention
//   repro_flash_decode     <- src/repro/kernels/flash_attention.py::flash_decode
// Same math as the reference's _flash_kernel / _decode_kernel: scores
// (q . k) * scale, an online softmax with f32 (m, l, acc) per query row, and
// fully masked rows output 0. Query row t sits at absolute position
// q_offset + t; key j is live when j < Tk, j <= q_pos (causal) and
// j > q_pos - window (window set). q_offset (the decode position) is read on
// the device from an int32 scalar when the caller passes a tensor, so a step
// never waits on the host.
//
// Layout: q / out (B, Hq, Tq, D), k / v (B, Hkv, Tk, D), all contiguous, one
// element type T (float or __nv_bfloat16); sums in f32, out in T.
//
// What bounds them on an H100: prefill is operations-heavy (4 * Tq * Tk * D
// per head, halved by the causal band), decode is bytes: it reads each live
// cache slot once (~0.6 MB per layer at B 8, S 288, bf16), microseconds at
// the card's rate. Both run the f32 CUDA-core products of common.cuh's
// flash_tile, so prefill sits far from the tensor-core rate and decode is
// latency-bound at B * Hkv blocks.
//
// What this simple design does about it: one block takes the G = Hq / Hkv
// query heads of one KV head together (rows ordered t-major: row = t * G + g),
// so every staged K/V tile serves all G heads of its group (GQA reuse, as the
// TPU kernel's (G, D) decode block); prefill takes 64 such rows a block, decode
// the G rows of its one token. K/V tiles of 64 keys (32 for D 128 and 256)
// are staged as f32 through shared memory. At D 256 (recurrentgemma) a
// prefill block stages 4 * (64 * 256 * 2 + 32 * 513 + 64 * 32 + 192) =
// 205,696 bytes, under the 232,448 a block may opt in to, so one block runs
// per SM; a decode block at G = 10 stages ~87.5 KB. flash_tile's loops over D
// are not unrolled past 16, so registers do not grow with D. Tiles wholly
// outside the causal / window band of a block's rows are never read (the TPU
// kernel's `run` predicate); inside a tile every (row, key) pair is masked
// by liveness, never by the exponent alone. Not done yet: tensor cores
// (wgmma), TMA/cp.async staging, or a split of a long cache across blocks for
// decode.

#include "common.cuh"

namespace {

constexpr int kPrefillRows = 64;  // query rows (t * G + g) per prefill block
constexpr int kPrefillThreads = 256;
constexpr int kDecodeThreads = 128;

template <int D>
__host__ __device__ constexpr int kv_tile() { return D <= 64 ? 64 : 32; }

// Slot t of a tile starting at key t0 of (b, kv head h): its row in k / v, or
// -1 past the key length.
struct DenseSrc {
  long long base;  // row index of key 0 for (b, h)
  int t0, tk;
  __device__ long long operator()(int t) const {
    const int j = t0 + t;
    return j < tk ? base + j : -1;
  }
};

// Row r of a block is query t = (row0 + r) / G at position q_off + t.
struct BandLive {
  int t0, row0, group, rows_valid, tk, q_off, causal, has_window, window;
  __device__ bool operator()(int r, int t) const {
    const int j = t0 + t;
    if (r >= rows_valid || j >= tk) return false;
    const int qp = q_off + (row0 + r) / group;
    if (causal && j > qp) return false;
    if (has_window && j <= qp - window) return false;
    return true;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kPrefillThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, const int* __restrict__ q_off_ptr, int q_off_val, int hkv,
             int group, int tq, int tk, int causal, int has_window, int window, int rows,
             float scale) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  constexpr int NT = kv_tile<D>();
  const int G = group, R = rows;
  const int row0 = tile * R;
  const int rows_valid = min(R, tq * G - row0);
  extern __shared__ float smem[];
  float* q_s = smem;                    // R * D
  float* k_s = q_s + R * D;             // NT * (D + 1), padded against bank conflicts
  float* v_s = k_s + NT * (D + 1);      // NT * D
  float* s_s = v_s + NT * D;            // R * NT
  float* acc_s = s_s + R * NT;          // R * D
  float* m_s = acc_s + R * D;           // R
  float* l_s = m_s + R;                 // R
  float* alpha_s = l_s + R;             // R

  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  const int hq = hkv * G;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (r < rows_valid) {
      const int gr = row0 + r, t = gr / G, g = gr - t * G;
      x = to_f32(q[((static_cast<size_t>(b) * hq + h * G + g) * tq + t) * D + d]);
    }
    q_s[i] = x;
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  // the keys these rows can see: [j_lo, j_hi)
  const int qp_lo = q_off + row0 / G;
  const int qp_hi = q_off + (row0 + rows_valid - 1) / G;
  int j_lo = 0, j_hi = tk;
  if (causal) j_hi = min(tk, qp_hi + 1);
  if (has_window) j_lo = max(0, qp_lo - window + 1);
  const long long base = (static_cast<long long>(b) * hkv + h) * tk;
  for (int t0 = j_lo; t0 < j_hi; t0 += NT) {
    load_kv_tile<T, D>(k, v, k_s, v_s, NT, DenseSrc{base, t0, tk});
    __syncthreads();
    flash_tile<D>(q_s, k_s, v_s, s_s, m_s, l_s, alpha_s, acc_s, R, NT, scale,
                  BandLive{t0, row0, G, rows_valid, tk, q_off, causal, has_window, window});
  }
  for (int i = threadIdx.x; i < rows_valid * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    const float l = l_s[r];
    out[((static_cast<size_t>(b) * hq + h * G + g) * tq + t) * D + d] =
        from_f32<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* q_off_ptr, int q_off, int batch, int hq, int hkv, int tq,
                   int tk, int causal, int has_window, int window, int rows, int threads,
                   float scale, cudaStream_t stream) {
  const int G = hq / hkv;
  constexpr int NT = kv_tile<D>();
  const size_t R = rows;
  const size_t smem = sizeof(float) *
      (R * D * 2 + static_cast<size_t>(NT) * (2 * D + 1) + R * NT + 3 * R);
  auto kern = flash_kernel<T, D>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  const int tiles = (tq * G + rows - 1) / rows;
  kern<<<dim3(tiles, hkv, batch), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<const int*>(q_off_ptr), q_off, hkv, G, tq, tk, causal,
      has_window, window, rows, scale);
  return cudaGetLastError();
}

#define REPRO_DISPATCH(...)                                                          \
  switch (head_dim) {                                                                \
    case 16: return dtype == 0 ? launch<float, 16>(__VA_ARGS__)                      \
                               : launch<__nv_bfloat16, 16>(__VA_ARGS__);             \
    case 32: return dtype == 0 ? launch<float, 32>(__VA_ARGS__)                      \
                               : launch<__nv_bfloat16, 32>(__VA_ARGS__);             \
    case 64: return dtype == 0 ? launch<float, 64>(__VA_ARGS__)                      \
                               : launch<__nv_bfloat16, 64>(__VA_ARGS__);             \
    case 128: return dtype == 0 ? launch<float, 128>(__VA_ARGS__)                    \
                                : launch<__nv_bfloat16, 128>(__VA_ARGS__);           \
    case 256: return dtype == 0 ? launch<float, 256>(__VA_ARGS__)                    \
                                : launch<__nv_bfloat16, 256>(__VA_ARGS__);           \
    default: return cudaErrorInvalidValue;                                           \
  }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). q_offset_ptr
// points at one int32 on the device, or is null and q_offset is used. A
// window applies when has_window is set. Each returns the cudaError_t of the
// launch (0 on success); nothing here synchronizes.
int repro_flash_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                          const void* q_offset_ptr, int q_offset, int batch, int hq, int hkv,
                          int tq, int tk, int head_dim, int causal, int has_window, int window,
                          float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 ||
      tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(q, k, v, out, q_offset_ptr, q_offset, batch, hq, hkv, tq, tk, causal,
                   has_window, window, kPrefillRows, kPrefillThreads, scale,
                   static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
}

// One-token decode: q (B, Hq, 1, D) against caches (B, Hkv, S, D); slot pos
// is the current token (slots > pos masked and never read). One block per
// (sequence, KV head) holds its G query rows.
int repro_flash_decode(int dtype, const void* q, const void* k_cache, const void* v_cache,
                       void* out, const void* pos_ptr, int pos, int batch, int hq, int hkv,
                       int s_len, int head_dim, int has_window, int window, float scale,
                       void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      hq / hkv > kPrefillRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  const int group = hq / hkv;
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(q, k_cache, v_cache, out, pos_ptr, pos, batch, hq, hkv, 1, s_len, 1,
                   has_window, window, group, kDecodeThreads, scale,
                   static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
