// Paged GQA attention for Hopper (sm_90a): one-token decode and chunked
// prefill over a paged KV pool, with a plain C interface loaded through ctypes
// (repro_torch/kernels/paged_attention.py holds the wrappers and the plain
// PyTorch versions these kernels are held against).
//
// What they replace (the JAX reference package's Pallas TPU kernels):
//   split_decode_kernel<DensePool, PagedKeys>  <- src/repro/kernels/paged_attention.py::paged_flash_decode
//   paged_chunk_mma_kernel<DensePool> (bf16), paged_chunk_kernel<DensePool> (f32)
//                                              <- src/repro/kernels/paged_attention.py::paged_flash_prefill_chunk
//   split_decode_kernel<QuantPool, PagedKeys>  <- src/repro/kernels/paged_attention.py::paged_flash_decode_quant
//   paged_chunk_mma_kernel<QuantPool> (bf16), paged_chunk_kernel<QuantPool> (f32)
//                                              <- src/repro/kernels/paged_attention.py::paged_flash_prefill_chunk_quant
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
// page, KV head), (num_pages, Hkv). For decode a QuantPool's ``load`` turns 8
// features of a row (8 bytes of int8, 4 of int4) into float(q) * scale; for
// the f32 chunk kernel its ``stage`` writes float(q) * scale into the f32
// tile a dense pool fills; for the bf16 chunk body it stages the raw bytes,
// writes them as bf16 integers (exact) and gives each key column its (page,
// head) scale (below). In the chunk kernels only the past goes through the
// pool; the present (the chunk's own K/V) stays in q's type.
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
// blocks) become runs of pages_per_split * page_size keys.
//
// Chunked prefill in bf16 (paged_chunk_mma_kernel<D, Pool>, every D of the
// dispatch: 16, 32, 64, 112, 128, 256) runs on the tensor cores, as flash_attention.cu's bf16 prefill: 64
// query rows a block (t-major: row = t * G + g), 16 a warp, S = Q . K^T and O
// += P . V on mma.sync m16n8k16 (bf16 in, f32 accumulation), the online
// softmax's row max and sum in registers, P split as P_hi + P_lo (one bf16
// term of P fails the one-ulp gate). Keys come in tiles of 64 (32 at D 256):
// the past first, logical positions below min(cursor, max_pages * page_size),
// a tile spanning as many pages as it holds (each key's row looked up alone,
// table entries clamped), then the present, causal. Tiles are double-buffered
// by 16-byte cp.async (8-byte pieces for intN rows that are no multiple of
// 16 bytes: int4 at D 16, 8 bytes, and at D 112, 56 bytes); a pointer off 16
// bytes stages with plain loads instead. D 112 (kimi-k2) is 7 k-steps of 16
// and 14 output column groups of 8: no step assumes a power of two. An intN past tile lands as raw bytes
// and is written as bf16 integers; each key column's (page, head) scale
// multiplies its column of S (K) and, before the hi/lo split, of P (V), while
// the row sum l takes the unscaled P: the pool policy supplies both, one body
// serves dense and intN pools. At D 256 two warps share a slab, each owning
// half of O's columns. f32 chunks keep paged_chunk_kernel: K/V staged as f32
// through shared memory into common.cuh's flash_tile, CUDA-core products.
//
// Where the 64-row blocks are fewer than the SMs (the serve shape: one
// sequence, C 128, G 7, Hkv 2 gives 28), each block's tiles are cut into
// ``splits`` runs (the wrapper's plan_chunk_splits: about one and a half
// blocks a SM, from shapes alone), each run a block of its own that leaves its partial (m,
// l, O) in an f32 workspace; common.cuh's combine_splits_kernel merges the
// runs by log-sum-exp in run order, as the split decodes do. A run a block
// computes from its own tile count, so no cursor reaches the host.
//
// What still bounds the bf16 body: latency, a handful of dependent tiles of
// loads, products and one softmax step a block, and the combine's second
// launch; no TMA, wgmma or warp specialisation.
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

// ---------------------------------------------------------------------------------
// bf16 chunk body on the tensor cores
// ---------------------------------------------------------------------------------
constexpr int kCmmaRows = 64;  // query rows a block, 16 a warp (slab)
constexpr int kCmmaPad = 8;    // bf16 elements padding a shared-memory row (16 bytes)

template <int D> __host__ __device__ constexpr int cmma_keys() { return D > 128 ? 32 : 64; }
template <int D> __host__ __device__ constexpr int cmma_col_split() { return D > 128 ? 2 : 1; }
template <int D> struct CmmaThreads {
  static constexpr int value = (kCmmaRows / 16) * 32 * cmma_col_split<D>();
};
// Q, two stages of (K, V) in bf16, two stages of raw (K, V) rows (intN pools),
// the tile's K and V column scales
template <int D, typename Pool> __host__ __device__ constexpr size_t cmma_smem() {
  constexpr size_t NK = cmma_keys<D>(), LD = D + kCmmaPad;
  return sizeof(bf16) * LD * (kCmmaRows + 4 * NK) +
         (Pool::kQuant ? 4 * NK * Pool::kRowBytes + 2 * NK * sizeof(float) : 0);
}

// Block (64 query rows of the chunk, t-major: row = t * G + g; KV head h;
// sequence b). Keys come in tiles of NK: first the past, logical positions
// [0, past_len) of the sequence's table (past_len = min(cursor, max_pages *
// page_size); a tile may span pages, each key's row looked up alone), then the
// present, the chunk's own keys [0, t_hi] (t_hi the block's last query
// position). Tiles are double-buffered through cp.async; an intN tile lands
// as raw bytes and is written as bf16 integers before its products, with the
// (page, head) scale of each key column beside it. ``aligned`` 0 (a pointer
// off 16 bytes) stages every tile with plain loads instead.
template <int D, typename Pool>
__global__ void __launch_bounds__(CmmaThreads<D>::value)
paged_chunk_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ chunk_k,
                       const bf16* __restrict__ chunk_v, Pool pool,
                       const int* __restrict__ block_tables, const int* __restrict__ cursors,
                       bf16* __restrict__ out, int hkv, int group, int chunk, int page_size,
                       int num_pages, int max_pages, float scale, int aligned,
                       float* __restrict__ ws, int splits) {
  constexpr int NK = cmma_keys<D>(), CS = cmma_col_split<D>(), NTHR = CmmaThreads<D>::value;
  constexpr int LD = D + kCmmaPad;  // shared-memory row stride, bf16 elements
  constexpr int DC = D / CS;        // output columns a warp owns
  constexpr int CPR = D / 8;        // 16-byte chunks a bf16 row
  constexpr int RB = Pool::kRowBytes;
  constexpr int CB = RB % 16 == 0 ? 16 : 8;  // copy size of a raw row piece
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kCmmaRows * LD
  bf16* kv_s = q_s + kCmmaRows * LD;              // 2 stages of (K, V), NK * LD each
  // intN pools: 2 stages of raw (K, V) rows, NK * RB bytes each
  unsigned char* raw_s = reinterpret_cast<unsigned char*>(kv_s + 4 * NK * LD);
  float* sk_s = reinterpret_cast<float*>(raw_s + (Pool::kQuant ? 4 * NK * RB : 0));
  float* sv_s = sk_s + NK;

  const int h = blockIdx.y, b = blockIdx.z / splits, split = blockIdx.z - b * splits;
  const int G = group, hq = hkv * G;
  const int row0 = blockIdx.x * kCmmaRows;
  const int rows_valid = min(kCmmaRows, chunk * G - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp / CS, col0 = (warp % CS) * DC;
  const bool al = aligned != 0;

  // q (B, Hq, C, D): row r is query t = (row0 + r) / G of head h * G + g
  for (int i = tid; i < kCmmaRows * CPR; i += NTHR) {
    const int r = i / CPR, c = i - r * CPR;
    bf16* dst = q_s + r * LD + c * 8;
    if (r < rows_valid) {
      const int gr = row0 + r, t = gr / G, g = gr - t * G;
      const bf16* src = q + ((static_cast<size_t>(b) * hq + h * G + g) * chunk + t) * D + c * 8;
      if (al) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      }
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int cursor = cursors[b];
  const long long cap = static_cast<long long>(max_pages) * page_size;
  const int past_len = cursor <= 0 ? 0 : static_cast<int>(cursor < cap ? cursor : cap);
  const int n_past = (past_len + NK - 1) / NK;
  const int t_lo = row0 / G, t_hi = rows_valid > 0 ? (row0 + rows_valid - 1) / G : -1;
  const int n_tiles = rows_valid > 0 ? n_past + (t_hi + NK) / NK : 0;
  const int* table = block_tables + static_cast<size_t>(b) * max_pages;
  const long long cbase = (static_cast<long long>(b) * hkv + h) * chunk;  // chunk K/V row of key 0

  // the pool row of past key j (table entries clamped into the pool)
  auto past_row = [&](int j) -> long long {
    const int lp = j / page_size;
    int page = table[lp];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    return (static_cast<long long>(page) * hkv + h) * page_size + (j - lp * page_size);
  };

  auto stage = [&](int it, int buf) {
    bf16* ks = kv_s + buf * 2 * NK * LD;
    bf16* vs = ks + NK * LD;
    if (it < n_past) {
      const int j0 = it * NK;
      if constexpr (Pool::kQuant) {
        unsigned char* kr = raw_s + buf * 2 * NK * RB;
        unsigned char* vr = kr + NK * RB;
        constexpr int PR = RB / CB;  // pieces a row
        for (int i = tid; i < NK * PR; i += NTHR) {
          const int r = i / PR, c = i - r * PR, j = j0 + r;
          const bool in = j < past_len;  // past it: zeros
          const long long row = in ? past_row(j) : 0;
          const unsigned char* ksrc = pool.row_bytes(false, row) + c * CB;
          const unsigned char* vsrc = pool.row_bytes(true, row) + c * CB;
          if (al) {
            if constexpr (CB == 16) {
              cp_async16(kr + r * RB + c * CB, ksrc, in ? 16 : 0);
              cp_async16(vr + r * RB + c * CB, vsrc, in ? 16 : 0);
            } else {
              cp_async8(kr + r * RB + c * CB, ksrc, in ? 8 : 0);
              cp_async8(vr + r * RB + c * CB, vsrc, in ? 8 : 0);
            }
          } else {
            for (int e = 0; e < CB; ++e) {
              kr[r * RB + c * CB + e] = in ? ksrc[e] : 0;
              vr[r * RB + c * CB + e] = in ? vsrc[e] : 0;
            }
          }
        }
      } else {
        for (int i = tid; i < NK * CPR; i += NTHR) {
          const int r = i / CPR, c = i - r * CPR, j = j0 + r;
          const bool in = j < past_len;
          const long long row = in ? past_row(j) : 0;
          const unsigned char* ksrc = pool.row_bytes(false, row) + c * 16;
          const unsigned char* vsrc = pool.row_bytes(true, row) + c * 16;
          if (al) {
            cp_async16(ks + r * LD + c * 8, ksrc, in ? 16 : 0);
            cp_async16(vs + r * LD + c * 8, vsrc, in ? 16 : 0);
          } else {
            const bf16* kb = reinterpret_cast<const bf16*>(ksrc);
            const bf16* vb = reinterpret_cast<const bf16*>(vsrc);
            for (int e = 0; e < 8; ++e) {
              ks[r * LD + c * 8 + e] = in ? kb[e] : __float2bfloat16(0.f);
              vs[r * LD + c * 8 + e] = in ? vb[e] : __float2bfloat16(0.f);
            }
          }
        }
      }
    } else {  // the present: the chunk's own K/V rows, zeros past the chunk
      const int tk0 = (it - n_past) * NK;
      for (int i = tid; i < NK * CPR; i += NTHR) {
        const int r = i / CPR, c = i - r * CPR, tk = tk0 + r;
        const bool in = tk < chunk;
        const size_t off = (cbase + (in ? tk : 0)) * D + c * 8;
        if (al) {
          cp_async16(ks + r * LD + c * 8, chunk_k + off, in ? 16 : 0);
          cp_async16(vs + r * LD + c * 8, chunk_v + off, in ? 16 : 0);
        } else {
          for (int e = 0; e < 8; ++e) {
            ks[r * LD + c * 8 + e] = in ? chunk_k[off + e] : __float2bfloat16(0.f);
            vs[r * LD + c * 8 + e] = in ? chunk_v[off + e] : __float2bfloat16(0.f);
          }
        }
      }
    }
    cp_async_commit();
  };

  // this thread's two rows of the slab (the accumulators' rows lane / 4 and +8)
  const int r_a = slab * 16 + (lane >> 2);
  const int t_a = (row0 + r_a) / G, t_b = (row0 + r_a + 8) / G;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp2f below
  float o[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  // this block's run of the tiles (past, then present): split ``split`` of ``splits``
  const int it_lo = n_tiles * split / splits, it_hi = n_tiles * (split + 1) / splits;
  if (it_lo < it_hi) stage(it_lo, 0);
  for (int it = it_lo; it < it_hi; ++it) {
    const bool past = it < n_past;
    const int t0 = past ? it * NK : (it - n_past) * NK, buf = (it - it_lo) & 1;
    if (it + 1 < it_hi) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bf16* ks = kv_s + buf * 2 * NK * LD;
    bf16* vs = ks + NK * LD;
    const bool scaled = Pool::kQuant && past;
    if constexpr (Pool::kQuant) {
      if (past) {  // raw bytes -> bf16 integers, and each key column's scales
        const unsigned char* kr = raw_s + buf * 2 * NK * RB;
        for (int i = tid; i < 2 * NK * (RB / 4); i += NTHR) {
          const int which = i / (NK * (RB / 4)), rem = i - which * (NK * (RB / 4));
          const int r = rem / (RB / 4), c = rem - r * (RB / 4);
          const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + which * NK * RB + r * RB +
                                                                c * 4);
          Pool::to_bf16(w, c, (which ? vs : ks) + r * LD);
        }
        for (int r = tid; r < NK; r += NTHR) {
          const int j = t0 + r;
          const long long row = j < past_len ? past_row(j) : -1;
          sk_s[r] = row >= 0 ? pool.scale_of(false, row, page_size) : 0.f;
          sv_s[r] = row >= 0 ? pool.scale_of(true, row, page_size) : 0.f;
        }
        __syncthreads();
      }
    }

    // liveness of (row, key): past keys below past_len for every row; present
    // key tk for rows at positions >= tk. A tile inside every row's band skips
    // the test.
    const bool all_live = past ? t0 + NK <= past_len : (t0 + NK <= chunk && t0 + NK - 1 <= t_lo);
    auto live = [&](int col, int hi) {
      const int j = t0 + col;
      return past ? j < past_len : (j < chunk && j <= (hi ? t_b : t_a));
    };
    mma_softmax_tile<D, NK, DC, LD>(q_s, ks, vs, slab, col0, sl2, all_live, live, scaled, sk_s,
                                    sv_s, o, m_r, l_r);
    __syncthreads();  // the next iteration restages this buffer
  }

  // one run: out = O / l (0 for a row with no live key), bf16 pairs; several:
  // the run's partial (m in natural units, l, O) into ws for common.cuh's combine
  const int rows = gridDim.z / splits * hq * chunk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_a + 8 * i;
    if (r >= rows_valid) continue;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    const size_t row = (static_cast<size_t>(b) * hq + h * G + g) * chunk + t;
    if (splits > 1) {
      const size_t slot = row * splits + split;
      float* acc =
          ws + 2 * static_cast<size_t>(rows) * splits + slot * D + col0 + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        acc[n * 8] = o[n][2 * i];
        acc[n * 8 + 1] = o[n][2 * i + 1];
      }
      if ((lane & 3) == 0 && col0 == 0) {
        ws[slot] = l_r[i] > 0.f ? m_r[i] * 0.6931471805599453f : -CUDART_INF_F;
        ws[static_cast<size_t>(rows) * splits + slot] = l_r[i];
      }
      continue;
    }
    const float l = l_r[i] == 0.f ? 1.f : l_r[i];
    bf16* dst = out + row * D + col0 + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(o[n][2 * i] / l, o[n][2 * i + 1] / l);
      if (al) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = v2;
      } else {
        dst[n * 8] = v2.x;
        dst[n * 8 + 1] = v2.y;
      }
    }
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
                         int max_pages, float scale, int aligned, void* ws, int splits,
                         cudaStream_t stream) {
  const int G = hq / hkv;
  if constexpr (sizeof(T) == 2) {  // bf16: the tensor-core body
    constexpr size_t smem = cmma_smem<D, Pool>();
    auto kern = paged_chunk_mma_kernel<D, Pool>;
    static size_t opted[kMaxDevices] = {};
    cudaError_t e = set_smem(kern, smem, opted);
    if (e != cudaSuccess) return e;
    const int tiles = (chunk * G + kCmmaRows - 1) / kCmmaRows;
    kern<<<dim3(tiles, hkv, batch * splits), CmmaThreads<D>::value, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(chunk_k),
        static_cast<const bf16*>(chunk_v), pool, static_cast<const int*>(block_tables),
        static_cast<const int*>(cursors), static_cast<bf16*>(out), hkv, G, chunk, page_size,
        num_pages, max_pages, scale, aligned, static_cast<float*>(ws), splits);
    e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return e;
    return combine_splits<bf16>(static_cast<const float*>(ws), static_cast<bf16*>(out),
                                batch * hq * chunk, splits, D, stream);
  } else {  // f32: flash_tile's CUDA-core products
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
        static_cast<const T*>(q), static_cast<const T*>(chunk_k),
        static_cast<const T*>(chunk_v), pool, static_cast<const int*>(block_tables),
        static_cast<const int*>(cursors), static_cast<T*>(out), hkv, G, chunk, page_size,
        num_pages, max_pages, scale);
    return cudaGetLastError();
  }
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
                        int page_size, int num_pages, int max_pages, float scale, int aligned,
                        void* ws, int splits, cudaStream_t stream) {
  const DensePool<T, D> pool{static_cast<const T*>(k_pool), static_cast<const T*>(v_pool)};
  return launch_chunk<T, D>(q, chunk_k, chunk_v, pool, block_tables, cursors, out, batch, hq,
                            hkv, chunk, page_size, num_pages, max_pages, scale, aligned, ws,
                            splits, stream);
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
                        int num_pages, int max_pages, float scale, int aligned, void* ws,
                        int splits, cudaStream_t stream) {
  if (bits == 8)
    return launch_chunk<T, D>(q, chunk_k, chunk_v, quant_pool<8, D>(k_q, k_scale, v_q, v_scale),
                              block_tables, cursors, out, batch, hq, hkv, chunk, page_size,
                              num_pages, max_pages, scale, aligned, ws, splits, stream);
  return launch_chunk<T, D>(q, chunk_k, chunk_v, quant_pool<4, D>(k_q, k_scale, v_q, v_scale),
                            block_tables, cursors, out, batch, hq, hkv, chunk, page_size,
                            num_pages, max_pages, scale, aligned, ws, splits, stream);
}

// A chunk launch's split of its tiles: 1, or (bf16 only) up to kMaxChunkSplits
// runs whose partials fill ``workspace`` (B * Hq * C * splits * (D + 2)
// floats) for the combine, whose grid takes at most 65535 rows.
constexpr int kMaxChunkSplits = 64;
inline bool chunk_splits_ok(int dtype, int batch, int hq, int chunk, int splits,
                            const void* workspace) {
  if (splits == 1) return true;
  return dtype == 1 && splits > 1 && splits <= kMaxChunkSplits && workspace != nullptr &&
         static_cast<long long>(batch) * hq * chunk <= 65535 &&
         static_cast<long long>(batch) * splits <= 65535;
}

#define REPRO_DISPATCH(FN, ...)                                              \
  switch (head_dim) {                                                        \
    case 16: return dtype == 0 ? FN<float, 16>(__VA_ARGS__)                  \
                               : FN<__nv_bfloat16, 16>(__VA_ARGS__);         \
    case 32: return dtype == 0 ? FN<float, 32>(__VA_ARGS__)                  \
                               : FN<__nv_bfloat16, 32>(__VA_ARGS__);         \
    case 64: return dtype == 0 ? FN<float, 64>(__VA_ARGS__)                  \
                               : FN<__nv_bfloat16, 64>(__VA_ARGS__);         \
    case 112: return dtype == 0 ? FN<float, 112>(__VA_ARGS__)                \
                                : FN<__nv_bfloat16, 112>(__VA_ARGS__);       \
    case 128: return dtype == 0 ? FN<float, 128>(__VA_ARGS__)                \
                                : FN<__nv_bfloat16, 128>(__VA_ARGS__);       \
    case 256: return dtype == 0 ? FN<float, 256>(__VA_ARGS__)                \
                                : FN<__nv_bfloat16, 256>(__VA_ARGS__);       \
    default: return cudaErrorInvalidValue;                                   \
  }

// 1 when q, chunk_k, chunk_v and the two pools start on 16 bytes (the bf16
// chunk body then stages with cp.async), else 0 (plain loads)
inline int aligned16(const void* q, const void* ck, const void* cv, const void* kp,
                     const void* vp) {
  const void* ptrs[] = {q, ck, cv, kp, vp};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  return 1;
}

// What paged_attention.py's GEOMETRY assumes of the bf16 chunk body, in its
// order: query rows a block, keys a tile at head dims 16, 32, 64, 112, 128 and
// 256, and the most runs a launch takes.
constexpr int kGeometry[] = {kCmmaRows,       cmma_keys<16>(),  cmma_keys<32>(),
                             cmma_keys<64>(),  cmma_keys<112>(), cmma_keys<128>(),
                             cmma_keys<256>(), kMaxChunkSplits};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, dense pools, chunk K/V and out share
// it); bits: 8 or 4 for the intN pools. Each returns the cudaError_t of the
// launch (0 on success); nothing here synchronizes. The chunk entries' bf16
// body copies with cp.async where q, chunk_k, chunk_v and the pools start on
// 16 bytes, and with plain loads otherwise.
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
                              void* workspace, int splits, void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0 || page_size <= 0 ||
      num_pages <= 0 || max_pages <= 0 || batch <= 0 || chunk <= 0 ||
      !chunk_splits_ok(dtype, batch, hq, chunk, splits, workspace)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(chunk_dense, q, chunk_k, chunk_v, k_pool, v_pool, block_tables, cursors,
                   out, batch, hq, hkv, chunk, page_size, num_pages, max_pages, scale,
                   aligned16(q, chunk_k, chunk_v, k_pool, v_pool), workspace, splits,
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
                                    void* workspace, int splits, void* stream) {
  if ((dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) || hkv <= 0 || hq % hkv != 0 ||
      page_size <= 0 || num_pages <= 0 || max_pages <= 0 || batch <= 0 || chunk <= 0 ||
      !chunk_splits_ok(dtype, batch, hq, chunk, splits, workspace)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(chunk_quant, bits, q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale,
                   block_tables, cursors, out, batch, hq, hkv, chunk, page_size, num_pages,
                   max_pages, scale, aligned16(q, chunk_k, chunk_v, k_q, v_q), workspace, splits,
                   static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
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
