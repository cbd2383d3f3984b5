// Paged GQA attention for Hopper (sm_90a): one-token decode and chunked
// prefill over a paged KV pool, with a plain C interface loaded through ctypes
// (repro_torch/kernels/paged_attention.py holds the wrappers and the plain
// PyTorch versions these kernels are held against).
//
// What they replace (the JAX reference package's Pallas TPU kernels):
//   split_decode_kernel<DensePool, PagedKeys>  <- src/repro/kernels/paged_attention.py::paged_flash_decode
//   paged_chunk_kernel<DensePool>              <- src/repro/kernels/paged_attention.py::paged_flash_prefill_chunk
//   split_decode_kernel<QuantPool, PagedKeys>  <- src/repro/kernels/paged_attention.py::paged_flash_decode_quant
//   paged_chunk_kernel<QuantPool>              <- src/repro/kernels/paged_attention.py::paged_flash_prefill_chunk_quant
// Same math as the reference's _flash_update: scores (q . k) * scale, an online
// softmax with f32 (m, l, acc) per query row, and rows with l == 0 output 0.
//
// Pool layout: (num_pages, Hkv, page_size, D), element type T (float or
// __nv_bfloat16); block tables (B, max_pages) int32 map logical page j of
// sequence b to a physical page (entries past the allocation point at the null
// page 0 and are never read: the page loops stop at the live length). Every
// sum runs in f32; outputs are written in q's type.
//
// Quantized pools (the accessor customization point composed with the paged
// layout): (num_pages, Hkv, page_size, Dq) int8 bytes, Dq = D for int8 or D / 2
// for int4 packed split-half (byte d holds feature d in the lo nibble and
// d + D/2 in the hi, each sign-extended), plus one f32 scale per (physical
// page, KV head), (num_pages, Hkv). For the chunk kernel a QuantPool stages a
// tile's page scales in shared memory once, then writes float(q) * scale as
// f32 into the same shared tile a dense pool fills, so flash_tile runs
// unchanged; for decode its ``load`` turns 8 features of a row (8 bytes of
// int8, 4 of int4) into f32 the same way. In the chunk kernel only the past
// goes through the pool; the present (the chunk's own K/V) stays in q's type.
// The bytes read per token drop 2x (int8) / 4x (int4) against bf16 pages.
//
// What bounds them on an H100: bytes. Decode reads each live K/V page once,
// plus q and out (a few MB per step at B = 8, ~2k tokens: microseconds at
// 3.35 TB/s); its arithmetic is 4 * G * len * D flops per (b, h), far below
// the card's rate. Chunked prefill does C * G * (cursor + C) * D * 4 flops per
// (b, h) on the same bytes, which is compute-heavy at C = 256.
//
// Decode runs the split-K body the dense-cache decode shares
// (decode_splitk.cuh: the design, the pool policies and the key sources), over
// PagedKeys: the block itself walks the table (the TPU kernel's scalar
// prefetch), the host never reads the lengths, and the planner's runs of
// pages_per_split whole pages (16 splits of 8 pages at the serve shape, 256
// blocks) become runs of pages_per_split * page_size keys. The chunk kernel
// stages pages through shared memory a tile of ~64 tokens at a time (several
// pages per tile when pages are small) into common.cuh's f32 flash_tile, 64
// query rows per block, so a 256-token chunk at G = 7 spreads over 28 blocks
// per (b, h). Not done yet: asynchronous (cp.async/TMA) loads, or tensor
// cores for the chunk's products.
//
// block_pages (the reference's decode block-shape knob) is accepted by the
// Python wrapper for API parity and is not used here: the tile width is fixed
// by the head dim, and the result never depends on it.

#include "decode_splitk.cuh"

namespace {

constexpr int kChunkThreads = 256;
constexpr int kChunkRows = 64;          // query rows (t-major: t * G + g) per block

// Tokens per shared-memory K/V tile: ~64, fewer for wide heads, and always a
// whole number of pages.
template <int D>
__host__ __device__ inline int tile_pages(int page_size) {
  const int target = D <= 64 ? 64 : 32;
  const int n = target / page_size;
  return n > 0 ? n : 1;
}

struct PagedSrc {
  const int* row;  // this sequence's block-table row
  int j0, n_pages, page_size, num_pages, hkv, h;
  __device__ long long operator()(int t) const {
    const int j = j0 + t / page_size;
    if (j >= n_pages) return -1;
    int page = row[j];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    const int slot = t - (t / page_size) * page_size;
    return (static_cast<long long>(page) * hkv + h) * page_size + slot;
  }
};

struct PastLive {
  int base, cursor, rows_valid;
  __device__ bool operator()(int r, int t) const { return r < rows_valid && base + t < cursor; }
};

struct ChunkSrc {
  long long base;  // row index of chunk key 0 for (b, h)
  int tk0, chunk;
  __device__ long long operator()(int t) const {
    const int tk = tk0 + t;
    return tk < chunk ? base + tk : -1;
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

template <typename T, int D, typename Pool>
__global__ void __launch_bounds__(kChunkThreads)
paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ chunk_k,
                   const T* __restrict__ chunk_v, Pool pool,
                   const int* __restrict__ block_tables,
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
  float* scale_s = alpha_s + R;         // 2 * np_tile (quantized pools)

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
      pool.stage(k_s, v_s, scale_s, NT, page_size,
                 PagedSrc{row, j0, n_pages, page_size, num_pages, hkv, h});
      __syncthreads();
      flash_tile<D>(q_s, k_s, v_s, s_s, m_s, l_s, alpha_s, acc_s, R, NT, scale,
                    PastLive{j0 * page_size, cursor, rows_valid});
    }
    // present, applied last: the chunk's own K/V (q's type, never read through
    // the pool), causal within the chunk
    const int t_hi = (row0 + rows_valid - 1) / G;
    const long long cbase = (static_cast<long long>(b) * hkv + h) * chunk;
    for (int tk0 = 0; tk0 <= t_hi; tk0 += NT) {
      load_kv_tile<T, D>(chunk_k, chunk_v, k_s, v_s, NT, ChunkSrc{cbase, tk0, chunk});
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

template <typename T, int D, typename Pool>
cudaError_t launch_decode(const void* q, Pool pool, const void* block_tables,
                          const void* context_lens, void* out, void* ws, int batch, int hq,
                          int hkv, int page_size, int num_pages, int max_pages, int splits,
                          int pages_per_split, float scale, cudaStream_t stream) {
  const PagedKeys keys{static_cast<const int*>(block_tables),
                       static_cast<const int*>(context_lens), page_size, num_pages, max_pages,
                       hkv};
  return launch_split_decode<T, D>(q, pool, keys, out, ws, batch, hq, hkv, splits,
                                   pages_per_split * page_size, scale, stream);
}

template <typename T, int D, typename Pool>
cudaError_t launch_chunk(const void* q, const void* chunk_k, const void* chunk_v, Pool pool,
                         const void* block_tables, const void* cursors, void* out, int batch,
                         int hq, int hkv, int chunk, int page_size, int num_pages,
                         int max_pages, float scale, cudaStream_t stream) {
  const int G = hq / hkv;
  const int np_tile = tile_pages<D>(page_size);
  const int NT = np_tile * page_size;
  const size_t R = kChunkRows;
  const size_t smem = sizeof(float) *
      (R * D * 2 + static_cast<size_t>(NT) * (2 * D + 1) + R * NT + 3 * R + 2 * np_tile);
  auto kern = paged_chunk_kernel<T, D, Pool>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  const int tiles = (chunk * G + kChunkRows - 1) / kChunkRows;
  kern<<<dim3(tiles, hkv, batch), kChunkThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(chunk_k), static_cast<const T*>(chunk_v),
      pool, static_cast<const int*>(block_tables), static_cast<const int*>(cursors),
      static_cast<T*>(out), hkv, G, chunk, page_size, num_pages, max_pages, scale);
  return cudaGetLastError();
}

// Per-(T, D) entry points: build the pool policy the C interface names.
template <typename T, int D>
cudaError_t decode_dense(const void* q, const void* k_pool, const void* v_pool,
                         const void* block_tables, const void* context_lens, void* out,
                         void* ws, int batch, int hq, int hkv, int page_size, int num_pages,
                         int max_pages, int splits, int pages_per_split, float scale,
                         cudaStream_t stream) {
  const DensePool<T, D> pool{static_cast<const T*>(k_pool), static_cast<const T*>(v_pool)};
  return launch_decode<T, D>(q, pool, block_tables, context_lens, out, ws, batch, hq, hkv,
                             page_size, num_pages, max_pages, splits, pages_per_split, scale,
                             stream);
}

template <typename T, int D>
cudaError_t chunk_dense(const void* q, const void* chunk_k, const void* chunk_v,
                        const void* k_pool, const void* v_pool, const void* block_tables,
                        const void* cursors, void* out, int batch, int hq, int hkv, int chunk,
                        int page_size, int num_pages, int max_pages, float scale,
                        cudaStream_t stream) {
  const DensePool<T, D> pool{static_cast<const T*>(k_pool), static_cast<const T*>(v_pool)};
  return launch_chunk<T, D>(q, chunk_k, chunk_v, pool, block_tables, cursors, out, batch, hq,
                            hkv, chunk, page_size, num_pages, max_pages, scale, stream);
}

template <int BITS, int D>
QuantPool<BITS, D> quant_pool(const void* k_q, const void* k_scale, const void* v_q,
                              const void* v_scale) {
  return QuantPool<BITS, D>{static_cast<const int8_t*>(k_q), static_cast<const float*>(k_scale),
                            static_cast<const int8_t*>(v_q), static_cast<const float*>(v_scale)};
}

template <typename T, int D>
cudaError_t decode_quant(int bits, const void* q, const void* k_q, const void* k_scale,
                         const void* v_q, const void* v_scale, const void* block_tables,
                         const void* context_lens, void* out, void* ws, int batch, int hq,
                         int hkv, int page_size, int num_pages, int max_pages, int splits,
                         int pages_per_split, float scale, cudaStream_t stream) {
  if (bits == 8)
    return launch_decode<T, D>(q, quant_pool<8, D>(k_q, k_scale, v_q, v_scale), block_tables,
                               context_lens, out, ws, batch, hq, hkv, page_size, num_pages,
                               max_pages, splits, pages_per_split, scale, stream);
  return launch_decode<T, D>(q, quant_pool<4, D>(k_q, k_scale, v_q, v_scale), block_tables,
                             context_lens, out, ws, batch, hq, hkv, page_size, num_pages,
                             max_pages, splits, pages_per_split, scale, stream);
}

template <typename T, int D>
cudaError_t chunk_quant(int bits, const void* q, const void* chunk_k, const void* chunk_v,
                        const void* k_q, const void* k_scale, const void* v_q,
                        const void* v_scale, const void* block_tables, const void* cursors,
                        void* out, int batch, int hq, int hkv, int chunk, int page_size,
                        int num_pages, int max_pages, float scale, cudaStream_t stream) {
  if (bits == 8)
    return launch_chunk<T, D>(q, chunk_k, chunk_v, quant_pool<8, D>(k_q, k_scale, v_q, v_scale),
                              block_tables, cursors, out, batch, hq, hkv, chunk, page_size,
                              num_pages, max_pages, scale, stream);
  return launch_chunk<T, D>(q, chunk_k, chunk_v, quant_pool<4, D>(k_q, k_scale, v_q, v_scale),
                            block_tables, cursors, out, batch, hq, hkv, chunk, page_size,
                            num_pages, max_pages, scale, stream);
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

// dtype: 0 = float32, 1 = bfloat16 (q, dense pools, chunk K/V and out share
// it); bits: 8 or 4 for the intN pools. Each returns the cudaError_t of the
// launch (0 on success); nothing here synchronizes.
//
// The decodes split each row's pages over ``splits`` blocks of
// ``pages_per_split`` pages (splits * pages_per_split >= max_pages) and
// combine the partials in a second kernel; ``workspace`` holds
// B * Hq * splits * (D + 2) floats (common.cuh's combine_splits_kernel).
int repro_paged_decode(int dtype, const void* q, const void* k_pool, const void* v_pool,
                       const void* block_tables, const void* context_lens, void* out,
                       void* workspace, int batch, int hq, int hkv, int head_dim,
                       int page_size, int num_pages, int max_pages, int splits,
                       int pages_per_split, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0 || page_size <= 0 ||
      num_pages <= 0 || max_pages <= 0 || batch <= 0 || splits <= 0 ||
      pages_per_split <= 0 || static_cast<long long>(splits) * pages_per_split < max_pages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(decode_dense, q, k_pool, v_pool, block_tables, context_lens, out,
                   workspace, batch, hq, hkv, page_size, num_pages, max_pages, splits,
                   pages_per_split, scale, static_cast<cudaStream_t>(stream))
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
    REPRO_DISPATCH(chunk_dense, q, chunk_k, chunk_v, k_pool, v_pool, block_tables, cursors,
                   out, batch, hq, hkv, chunk, page_size, num_pages, max_pages, scale,
                   static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
}

int repro_paged_decode_quant(int dtype, int bits, const void* q, const void* k_q,
                             const void* k_scale, const void* v_q, const void* v_scale,
                             const void* block_tables, const void* context_lens, void* out,
                             void* workspace, int batch, int hq, int hkv, int head_dim,
                             int page_size, int num_pages, int max_pages, int splits,
                             int pages_per_split, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) || hkv <= 0 || hq % hkv != 0 ||
      page_size <= 0 || num_pages <= 0 || max_pages <= 0 || batch <= 0 || splits <= 0 ||
      pages_per_split <= 0 || static_cast<long long>(splits) * pages_per_split < max_pages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(decode_quant, bits, q, k_q, k_scale, v_q, v_scale, block_tables,
                   context_lens, out, workspace, batch, hq, hkv, page_size, num_pages,
                   max_pages, splits, pages_per_split, scale,
                   static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
}

int repro_paged_prefill_chunk_quant(int dtype, int bits, const void* q, const void* chunk_k,
                                    const void* chunk_v, const void* k_q, const void* k_scale,
                                    const void* v_q, const void* v_scale,
                                    const void* block_tables, const void* cursors, void* out,
                                    int batch, int hq, int hkv, int chunk, int head_dim,
                                    int page_size, int num_pages, int max_pages, float scale,
                                    void* stream) {
  if ((dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) || hkv <= 0 || hq % hkv != 0 ||
      page_size <= 0 || num_pages <= 0 || max_pages <= 0 || batch <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(chunk_quant, bits, q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale,
                   block_tables, cursors, out, batch, hq, hkv, chunk, page_size, num_pages,
                   max_pages, scale, static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
