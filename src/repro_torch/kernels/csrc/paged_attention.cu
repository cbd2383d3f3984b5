// Paged GQA attention for Hopper (sm_90a): one-token decode and chunked
// prefill over a paged KV pool, with a plain C interface loaded through ctypes
// (repro_torch/kernels/paged_attention.py holds the wrappers and the plain
// PyTorch versions these kernels are held against).
//
// What they replace (the JAX reference package's Pallas TPU kernels):
//   paged_decode_kernel  <- src/repro/kernels/paged_attention.py::paged_flash_decode
//   paged_chunk_kernel   <- src/repro/kernels/paged_attention.py::paged_flash_prefill_chunk
// Same math as the reference's _flash_update: scores (q . k) * scale, an online
// softmax with f32 (m, l, acc) per query row, and rows with l == 0 output 0.
//
// Pool layout: (num_pages, Hkv, page_size, D), element type T (float or
// __nv_bfloat16); block tables (B, max_pages) int32 map logical page j of
// sequence b to a physical page (entries past the allocation point at the null
// page 0 and are never read: the page loops stop at the live length). Every
// sum runs in f32; outputs are written in q's type.
//
// What bounds them on an H100: bytes. Decode reads each live K/V page once,
// plus q and out (a few MB per step at B = 8, ~2k tokens: microseconds at
// 3.35 TB/s); its arithmetic is 4 * G * len * D flops per (b, h), far below
// the card's rate. Chunked prefill does C * G * (cursor + C) * D * 4 flops per
// (b, h) on the same bytes, which is compute-heavy at C = 256.
//
// What this simple design does about it: one block per (sequence, KV head)
// for decode, so every K/V page is read from device memory exactly once and
// serves all G = Hq / Hkv query heads of its group (the GQA reuse the TPU
// kernel gets from its (G, D) q block); pages are staged through shared
// memory a tile of ~64 tokens at a time (several pages per tile when pages
// are small), and the table is read by the block itself (the TPU kernel's
// scalar prefetch). The chunk kernel adds a tile of 64 query rows per block,
// so a 256-token chunk at G = 7 spreads over 28 blocks per (b, h). What it
// does not do yet: split a long sequence across blocks (decode occupies only
// B * Hkv SMs), vectorized or asynchronous (cp.async/TMA) loads, or tensor
// cores (wgmma) for the chunk's products.
//
// block_pages (the reference's decode block-shape knob) is accepted by the
// Python wrapper for API parity and is not used here: the tile width is fixed
// by the head dim, and the result never depends on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDecodeThreads = 128;
constexpr int kChunkThreads = 256;
constexpr int kChunkRows = 64;          // query rows (t-major: t * G + g) per block
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

// Tokens per shared-memory K/V tile: ~64, fewer for wide heads, and always a
// whole number of pages.
template <int D>
__host__ __device__ inline int tile_pages(int page_size) {
  const int target = D <= 64 ? 64 : 32;
  const int n = target / page_size;
  return n > 0 ? n : 1;
}

// Stage NT token slots of K and V in shared memory as f32. ``src(t)`` gives
// the element offset of slot t's row in the source arrays, or -1 for a slot
// that holds nothing (it is zero-filled and masked dead by the caller).
template <typename T, int D, typename Src>
__device__ inline void load_kv_tile(const T* __restrict__ k, const T* __restrict__ v,
                                    float* k_s, float* v_s, int NT, Src src) {
  for (int i = threadIdx.x; i < NT * D; i += blockDim.x) {
    const int t = i / D, d = i - t * D;
    const long long off = src(t);
    float kv = 0.f, vv = 0.f;
    if (off >= 0) {
      kv = to_f32(k[off + d]);
      vv = to_f32(v[off + d]);
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

struct PagedSrc {
  const int* row;  // this sequence's block-table row
  int j0, n_pages, page_size, num_pages, hkv, h, head_dim;
  __device__ long long operator()(int t) const {
    const int j = j0 + t / page_size;
    if (j >= n_pages) return -1;
    int page = row[j];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    const int slot = t - (t / page_size) * page_size;
    return ((static_cast<long long>(page) * hkv + h) * page_size + slot) * head_dim;
  }
};

struct DecodeLive {
  int base, len;
  __device__ bool operator()(int, int t) const { return base + t < len; }
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, T* __restrict__ out,
                    int hkv, int group, int page_size, int num_pages, int max_pages,
                    float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int np_tile = tile_pages<D>(page_size);
  const int NT = np_tile * page_size;
  const int G = group;
  extern __shared__ float smem[];
  float* q_s = smem;                    // G * D
  float* k_s = q_s + G * D;             // NT * (D + 1), padded against bank conflicts
  float* v_s = k_s + NT * (D + 1);      // NT * D
  float* s_s = v_s + NT * D;            // G * NT
  float* acc_s = s_s + G * NT;          // G * D
  float* m_s = acc_s + G * D;           // G
  float* l_s = m_s + G;                 // G
  float* alpha_s = l_s + G;             // G

  const int len = context_lens[b];
  int n_pages = len > 0 ? (len + page_size - 1) / page_size : 0;
  if (n_pages > max_pages) n_pages = max_pages;
  // q (B, Hq, 1, D): the group's G rows are heads h*G .. h*G + G - 1
  const size_t qoff = (static_cast<size_t>(b) * hkv * G + static_cast<size_t>(h) * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    q_s[i] = to_f32(q[qoff + i]);
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < G; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  const int* row = block_tables + static_cast<size_t>(b) * max_pages;
  for (int j0 = 0; j0 < n_pages; j0 += np_tile) {
    load_kv_tile<T, D>(k_pool, v_pool, k_s, v_s, NT,
                       PagedSrc{row, j0, n_pages, page_size, num_pages, hkv, h, D});
    __syncthreads();
    flash_tile<D>(q_s, k_s, v_s, s_s, m_s, l_s, alpha_s, acc_s, G, NT, scale,
                  DecodeLive{j0 * page_size, len});
  }
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const float l = l_s[i / D];
    out[qoff + i] = from_f32<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

struct PastLive {
  int base, cursor, rows_valid;
  __device__ bool operator()(int r, int t) const { return r < rows_valid && base + t < cursor; }
};

struct ChunkSrc {
  long long base;  // element offset of chunk key 0 for (b, h)
  int tk0, chunk, head_dim;
  __device__ long long operator()(int t) const {
    const int tk = tk0 + t;
    return tk < chunk ? base + static_cast<long long>(tk) * head_dim : -1;
  }
};

struct PresentLive {
  int tk0, row0, group, rows_valid, chunk;
  // row r is query position (row0 + r) / G; it attends chunk keys tk <= t
  __device__ bool operator()(int r, int t) const {
    const int tk = tk0 + t;
    return r < rows_valid && tk < chunk && tk <= (row0 + r) / group;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kChunkThreads)
paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ chunk_k,
                   const T* __restrict__ chunk_v, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ block_tables,
                   const int* __restrict__ cursors, T* __restrict__ out,
                   int hkv, int group, int chunk, int page_size, int num_pages,
                   int max_pages, float scale) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int np_tile = tile_pages<D>(page_size);
  const int NT = np_tile * page_size;
  const int G = group;
  const int R = kChunkRows;
  const int row0 = tile * R;
  const int rows_total = chunk * G;
  const int rows_valid = min(R, rows_total - row0);
  extern __shared__ float smem[];
  float* q_s = smem;                    // R * D
  float* k_s = q_s + R * D;             // NT * (D + 1)
  float* v_s = k_s + NT * (D + 1);      // NT * D
  float* s_s = v_s + NT * D;            // R * NT
  float* acc_s = s_s + R * NT;          // R * D
  float* m_s = acc_s + R * D;           // R
  float* l_s = m_s + R;                 // R
  float* alpha_s = l_s + R;             // R

  const int hq = hkv * G;
  // q / out (B, Hq, C, D): row r of this tile is query t = (row0 + r) / G of head h*G + g
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (r < rows_valid) {
      const int gr = row0 + r, t = gr / G, g = gr - t * G;
      x = to_f32(q[((static_cast<size_t>(b) * hq + h * G + g) * chunk + t) * D + d]);
    }
    q_s[i] = x;
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (rows_valid > 0) {
    // past: pool positions below the cursor, read through the block table
    const int cursor = cursors[b];
    int n_pages = cursor > 0 ? (cursor + page_size - 1) / page_size : 0;
    if (n_pages > max_pages) n_pages = max_pages;
    const int* row = block_tables + static_cast<size_t>(b) * max_pages;
    for (int j0 = 0; j0 < n_pages; j0 += np_tile) {
      load_kv_tile<T, D>(k_pool, v_pool, k_s, v_s, NT,
                         PagedSrc{row, j0, n_pages, page_size, num_pages, hkv, h, D});
      __syncthreads();
      flash_tile<D>(q_s, k_s, v_s, s_s, m_s, l_s, alpha_s, acc_s, R, NT, scale,
                    PastLive{j0 * page_size, cursor, rows_valid});
    }
    // present, applied last: the chunk's own K/V, causal within the chunk
    const int t_hi = (row0 + rows_valid - 1) / G;
    const long long cbase = (static_cast<long long>(b) * hkv + h) * chunk * D;
    for (int tk0 = 0; tk0 <= t_hi; tk0 += NT) {
      load_kv_tile<T, D>(chunk_k, chunk_v, k_s, v_s, NT, ChunkSrc{cbase, tk0, chunk, D});
      __syncthreads();
      flash_tile<D>(q_s, k_s, v_s, s_s, m_s, l_s, alpha_s, acc_s, R, NT, scale,
                    PresentLive{tk0, row0, G, rows_valid, chunk});
    }
  }
  for (int i = threadIdx.x; i < rows_valid * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    const float l = l_s[r];
    out[((static_cast<size_t>(b) * hq + h * G + g) * chunk + t) * D + d] =
        from_f32<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
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

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k_pool, const void* v_pool,
                          const void* block_tables, const void* context_lens, void* out,
                          int batch, int hq, int hkv, int page_size, int num_pages,
                          int max_pages, float scale, cudaStream_t stream) {
  const int G = hq / hkv;
  const int NT = tile_pages<D>(page_size) * page_size;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(G) * D * 2 + static_cast<size_t>(NT) * (2 * D + 1) +
       static_cast<size_t>(G) * NT + 3 * G);
  auto kern = paged_decode_kernel<T, D>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(hkv, batch), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(block_tables), static_cast<const int*>(context_lens),
      static_cast<T*>(out), hkv, G, page_size, num_pages, max_pages, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_chunk(const void* q, const void* chunk_k, const void* chunk_v,
                         const void* k_pool, const void* v_pool, const void* block_tables,
                         const void* cursors, void* out, int batch, int hq, int hkv,
                         int chunk, int page_size, int num_pages, int max_pages,
                         float scale, cudaStream_t stream) {
  const int G = hq / hkv;
  const int NT = tile_pages<D>(page_size) * page_size;
  const size_t R = kChunkRows;
  const size_t smem = sizeof(float) *
      (R * D * 2 + static_cast<size_t>(NT) * (2 * D + 1) + R * NT + 3 * R);
  auto kern = paged_chunk_kernel<T, D>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  const int tiles = (chunk * G + kChunkRows - 1) / kChunkRows;
  kern<<<dim3(tiles, hkv, batch), kChunkThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(chunk_k), static_cast<const T*>(chunk_v),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(block_tables), static_cast<const int*>(cursors),
      static_cast<T*>(out), hkv, G, chunk, page_size, num_pages, max_pages, scale);
  return cudaGetLastError();
}

#define REPRO_DISPATCH(FN, ...)                                              \
  switch (head_dim) {                                                        \
    case 16: return dtype == 0 ? FN<float, 16>(__VA_ARGS__)                  \
                               : FN<__nv_bfloat16, 16>(__VA_ARGS__);         \
    case 32: return dtype == 0 ? FN<float, 32>(__VA_ARGS__)                  \
                               : FN<__nv_bfloat16, 32>(__VA_ARGS__);         \
    case 64: return dtype == 0 ? FN<float, 64>(__VA_ARGS__)                  \
                               : FN<__nv_bfloat16, 64>(__VA_ARGS__);         \
    case 128: return dtype == 0 ? FN<float, 128>(__VA_ARGS__)                \
                                : FN<__nv_bfloat16, 128>(__VA_ARGS__);       \
    default: return cudaErrorInvalidValue;                                   \
  }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Returns the
// cudaError_t of the launch (0 on success); nothing here synchronizes.
int repro_paged_decode(int dtype, const void* q, const void* k_pool, const void* v_pool,
                       const void* block_tables, const void* context_lens, void* out,
                       int batch, int hq, int hkv, int head_dim, int page_size,
                       int num_pages, int max_pages, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0 || page_size <= 0 ||
      num_pages <= 0 || max_pages <= 0 || batch <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(launch_decode, q, k_pool, v_pool, block_tables, context_lens, out,
                   batch, hq, hkv, page_size, num_pages, max_pages, scale,
                   static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
}

int repro_paged_prefill_chunk(int dtype, const void* q, const void* chunk_k,
                              const void* chunk_v, const void* k_pool, const void* v_pool,
                              const void* block_tables, const void* cursors, void* out,
                              int batch, int hq, int hkv, int chunk, int head_dim,
                              int page_size, int num_pages, int max_pages, float scale,
                              void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0 || page_size <= 0 ||
      num_pages <= 0 || max_pages <= 0 || batch <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(launch_chunk, q, chunk_k, chunk_v, k_pool, v_pool, block_tables, cursors,
                   out, batch, hq, hkv, chunk, page_size, num_pages, max_pages, scale,
                   static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
