// Paged GQA attention for Hopper (sm_90a): one-token decode and chunked
// prefill over a paged KV pool, with a plain C interface loaded through ctypes
// (repro_torch/kernels/paged_attention.py holds the wrappers and the plain
// PyTorch versions these kernels are held against).
//
// What they replace (the JAX reference package's Pallas TPU kernels):
//   paged_decode_kernel<DensePool>   <- src/repro/kernels/paged_attention.py::paged_flash_decode
//   paged_chunk_kernel<DensePool>    <- src/repro/kernels/paged_attention.py::paged_flash_prefill_chunk
//   paged_decode_kernel<QuantPool>   <- src/repro/kernels/paged_attention.py::paged_flash_decode_quant
//   paged_chunk_kernel<QuantPool>    <- src/repro/kernels/paged_attention.py::paged_flash_prefill_chunk_quant
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
// int8, 4 of int4) into f32 the same way, as DensePool's turns 8 bf16 or f32
// features (16 or 32 bytes). In the chunk kernel
// only the past goes through the pool; the present (the chunk's own K/V) stays
// in q's type. The bytes read per token drop 2x (int8) / 4x (int4) against
// bf16 pages; the arithmetic is the dense kernels' plus one multiply per
// staged element.
//
// What bounds them on an H100: bytes. Decode reads each live K/V page once,
// plus q and out (a few MB per step at B = 8, ~2k tokens: microseconds at
// 3.35 TB/s); its arithmetic is 4 * G * len * D flops per (b, h), far below
// the card's rate. Chunked prefill does C * G * (cursor + C) * D * 4 flops per
// (b, h) on the same bytes, which is compute-heavy at C = 256.
//
// What the design does about it. Decode (paged_decode_kernel, one body for
// dense and intN pools) splits the keys: a block per (split, KV head,
// sequence) takes a run of pages_per_split pages (the wrapper's planner aims
// for two blocks a SM and at least one ~64-token tile a split; 16 splits of 8
// pages at the serve shape, 256 blocks) and a second, small kernel merges the
// partial (m, l, acc) by log-sum-exp (common.cuh's combine_splits_kernel).
// Inside a split nothing goes through shared memory until the end: a lane
// group of D / 8 lanes holds one token, each lane loads 8 features of its K
// and V rows and keeps the same 8 features of q and of the accumulator of
// every query row in registers, and each warp runs its own online softmax
// (shuffles for the dot and the row max); the 4 warps' partials meet once, in
// shared memory. Every K/V page is read from device memory once and serves
// all G = Hq / Hkv query heads of its group (the GQA reuse the TPU kernel
// gets from its (G, D) q block; a group of more than 8 heads takes one block
// per 8, the later ones reading the pages from L2). A lane loads 8 features,
// not always 16 bytes (8 bytes of int8, 4 of int4): that keeps q and the
// accumulator at 8 registers a row whatever the pool, and a warp's load
// still covers 256 contiguous bytes of a page. The table is read by the
// block itself (the TPU kernel's scalar prefetch) and the host never reads
// the lengths: a split past a row's length writes an empty partial. The chunk
// kernel stages pages through shared memory a tile of ~64 tokens at a time
// (several pages per tile when pages are small) into common.cuh's f32
// flash_tile, 64 query rows per block, so a 256-token chunk at G = 7 spreads
// over 28 blocks per (b, h). Not done yet: asynchronous (cp.async/TMA) loads,
// or tensor cores for the chunk's products.
//
// block_pages (the reference's decode block-shape knob) is accepted by the
// Python wrapper for API parity and is not used here: the tile width is fixed
// by the head dim, and the result never depends on it.
//
// The tile stage, the online-softmax update (flash_tile) and the shared-memory
// opt-in live in common.cuh, shared with the dense-cache kernels
// (flash_attention.cu).

#include "common.cuh"

namespace {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeRows = 8;    // query rows of a group a decode block holds (in registers)
constexpr int kDecodeUnroll = 2;  // tokens a decode lane group loads before its arithmetic
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

// A pool of dense pages in T (the unquantized kernels).
template <typename T, int D>
struct DensePool {
  static constexpr int F = 8;       // features a decode lane loads of a row (16 or 32 bytes)
  static constexpr int CH = D / F;  // lanes a row
  const T* k;
  const T* v;
  __device__ static int feature(int c, int i) { return c * F + i; }
  // features c * 8 .. c * 8 + 7 of row ``row`` of the K (or V) pool as f32
  __device__ void load(bool is_v, long long row, int /*page_size*/, int c, float (&x)[F]) const {
    const uint4* src = reinterpret_cast<const uint4*>((is_v ? v : k) + row * D + c * F);
    if constexpr (sizeof(T) == 4) {
      const uint4 a = src[0], b = src[1];
      x[0] = __uint_as_float(a.x);
      x[1] = __uint_as_float(a.y);
      x[2] = __uint_as_float(a.z);
      x[3] = __uint_as_float(a.w);
      x[4] = __uint_as_float(b.x);
      x[5] = __uint_as_float(b.y);
      x[6] = __uint_as_float(b.z);
      x[7] = __uint_as_float(b.w);
    } else {
      const uint4 u = src[0];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    }
  }
  template <typename Src>
  __device__ void stage(float* k_s, float* v_s, float* /*scale_s*/, int NT, int /*page_size*/,
                        Src src) const {
    load_kv_tile<T, D>(k, v, k_s, v_s, NT, src);
  }
};

__device__ __forceinline__ float signed_nibble(int b) {
  const int n = b & 0xF;
  return static_cast<float>(n >= 8 ? n - 16 : n);
}

// A pool of intN pages with one f32 scale per (page, head). ``stage`` takes a
// whole number of pages (NT / page_size of them): it reads each staged page's
// two scales once into scale_s (2 * NT / page_size floats), then dequantizes
// the bytes as float(q) * scale, the reference's dequantize_pages.
template <int BITS, int D>
struct QuantPool {
  static_assert(BITS == 8 || (BITS == 4 && D % 2 == 0), "int8, or int4 with an even D");
  static constexpr int DQ = BITS == 8 ? D : D / 2;
  static constexpr int F = 8;                       // features a decode lane loads of a row
  static constexpr int CB = BITS == 8 ? 8 : 4;      // bytes they take
  static constexpr int CH = DQ / CB;                // lanes a row (D / 8)
  const int8_t* k;
  const float* k_scale;
  const int8_t* v;
  const float* v_scale;
  // int4 split-half: byte j of a row holds feature j (lo) and j + D/2 (hi)
  __device__ static int feature(int c, int i) {
    if (BITS == 8 || i < CB) return c * CB + i;
    return D / 2 + c * CB + (i - CB);
  }
  // bytes c * CB .. c * CB + CB - 1 of row ``row`` as float(q) * the (page,
  // head) scale, the arithmetic of ``stage`` and of the reference's
  // dequantize_pages
  __device__ void load(bool is_v, long long row, int page_size, int c, float (&x)[F]) const {
    const int8_t* src = (is_v ? v : k) + row * DQ + c * CB;
    const float sc = (is_v ? v_scale : k_scale)[row / page_size];
    alignas(8) int8_t by[CB];
    if constexpr (CB == 8) {
      *reinterpret_cast<uint2*>(by) = *reinterpret_cast<const uint2*>(src);
    } else {
      *reinterpret_cast<uint32_t*>(by) = *reinterpret_cast<const uint32_t*>(src);
    }
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      if constexpr (BITS == 8) {
        x[i] = static_cast<float>(by[i]) * sc;
      } else {
        x[i] = signed_nibble(by[i]) * sc;
        x[CB + i] = signed_nibble(by[i] >> 4) * sc;
      }
    }
  }
  template <typename Src>
  __device__ void stage(float* k_s, float* v_s, float* scale_s, int NT, int page_size,
                        Src src) const {
    const int np = NT / page_size;
    for (int p = threadIdx.x; p < np; p += blockDim.x) {
      const long long row = src(p * page_size);
      // row = (page * Hkv + head) * page_size + slot: the scale index is row / page_size
      const long long ph = row >= 0 ? row / page_size : -1;
      scale_s[p] = ph >= 0 ? k_scale[ph] : 0.f;
      scale_s[np + p] = ph >= 0 ? v_scale[ph] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < NT * DQ; i += blockDim.x) {
      const int t = i / DQ, j = i - t * DQ;
      const long long row = src(t);
      float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      if (row >= 0) {
        const int p = t / page_size;
        const float sk = scale_s[p], sv = scale_s[np + p];
        const int kb = k[row * DQ + j], vb = v[row * DQ + j];
        if (BITS == 8) {
          k0 = static_cast<float>(kb) * sk;
          v0 = static_cast<float>(vb) * sv;
        } else {
          k0 = signed_nibble(kb) * sk;
          k1 = signed_nibble(kb >> 4) * sk;
          v0 = signed_nibble(vb) * sv;
          v1 = signed_nibble(vb >> 4) * sv;
        }
      }
      k_s[t * (D + 1) + j] = k0;
      v_s[t * D + j] = v0;
      if (BITS == 4) {
        k_s[t * (D + 1) + j + D / 2] = k1;
        v_s[t * D + j + D / 2] = v1;
      }
    }
  }
};

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

// The split-K decode body, one block per (split, KV head and row block,
// sequence): split s takes logical pages [s * P, min((s + 1) * P, n_pages))
// of the row's table (P = pages_per_split) and leaves its partial (m, l, acc)
// for up to kDecodeRows query rows of the KV head's group in ws (layout in
// common.cuh's combine_splits_kernel); a group of G > kDecodeRows rows takes
// ceil(G / kDecodeRows) blocks. A split past the row's length writes
// m = -inf, l = 0 and exits. Inside a split, with no barrier until the end:
//   lanes   a lane group of CH = D / 8 lanes holds one token; each lane loads
//           8 features of its K and V rows (Pool::load: 16 bytes of bf16, 32
//           of f32, 8 of int8, 4 of int4; f32 after the page's scale) and
//           holds the same 8 features of q for every row, in registers;
//   steps   each warp takes kDecodeUnroll tokens a lane group at a time, all
//           loads issued before any arithmetic; dead tokens are not read;
//   scores  the lane's 8-term dot, summed over its group by shuffles;
//   softmax each warp keeps its own running (m, l, acc) for every row in
//           registers: the row max by shuffles across the lane groups, dead
//           tokens masked by liveness, P . V into the lane's 8 features;
//   end     the lane groups' l and acc are summed by shuffles, and the
//           kDecodeWarps warps' partials merged by log-sum-exp through
//           shared memory into the split's partial.
template <typename T, int D, typename Pool>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, Pool pool, const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, float* __restrict__ ws,
                    int hkv, int group, int page_size, int num_pages, int max_pages,
                    int pages_per_split, float scale) {
  constexpr int F = Pool::F, CH = Pool::CH, TPW = 32 / CH;  // lanes a token, tokens a warp load
  constexpr int GR = kDecodeRows, U = kDecodeUnroll, NW = kDecodeThreads / 32;
  static_assert(F == 8 && CH >= 1 && CH <= 32 && (CH & (CH - 1)) == 0, "a row is 1..32 lanes");
  const int split = blockIdx.x, b = blockIdx.z;
  const int rblocks = (group + GR - 1) / GR;
  const int h = blockIdx.y / rblocks, g0 = (blockIdx.y - h * rblocks) * GR;
  const int gn = min(GR, group - g0);  // query rows this block holds
  const int splits = gridDim.x, rows = gridDim.z * hkv * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / CH, sub = lane - grp * CH;
  const size_t row_g0 = (static_cast<size_t>(b) * hkv + h) * group + g0;  // q / ws row of row 0
  float* ws_m = ws;
  float* ws_l = ws + static_cast<size_t>(rows) * splits;
  float* ws_acc = ws + 2 * static_cast<size_t>(rows) * splits;

  const int len = context_lens[b];
  int n_pages = len > 0 ? (len + page_size - 1) / page_size : 0;
  if (n_pages > max_pages) n_pages = max_pages;
  const int p_lo = split * pages_per_split;
  const int p_hi = min(p_lo + pages_per_split, n_pages);
  if (p_lo >= p_hi) {
    for (int g = tid; g < gn; g += blockDim.x) {
      ws_m[(row_g0 + g) * splits + split] = -CUDART_INF_F;
      ws_l[(row_g0 + g) * splits + split] = 0.f;
    }
    return;
  }
  const int lim = min(len, p_hi * page_size);  // token j of the row is live iff j < lim

  // q (B, Hq, 1, D): this lane's 8 features of each of the block's rows
  float qr[GR][F], acc[GR][F], m[GR], l[GR];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      qr[g][i] = g < gn ? to_f32(q[(row_g0 + g) * D + Pool::feature(sub, i)]) : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  const int* row = block_tables + static_cast<size_t>(b) * max_pages;
  for (int t0 = p_lo * page_size + warp * TPW * U; t0 < lim; t0 += NW * TPW * U) {
    float kx[U][F], vx[U][F];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * TPW + grp;  // the lane groups of a load take consecutive tokens
      live[u] = t < lim;
      if (live[u]) {
        const int j = t / page_size;
        int page = row[j];
        page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
        const long long r = (static_cast<long long>(page) * hkv + h) * page_size +
                            (t - j * page_size);
        pool.load(false, r, page_size, sub, kx[u]);
        pool.load(true, r, page_size, sub, vx[u]);
      } else {
#pragma unroll
        for (int i = 0; i < F; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float s[U];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < F; ++i) dot = fmaf(qr[g][i], kx[u][i], dot);
#pragma unroll
        for (int o = CH / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u] = live[u] ? dot * scale : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
#pragma unroll
      for (int o = 16; o >= CH; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < F; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = live[u] ? expf(s[u] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int i = 0; i < F; ++i) acc[g][i] = fmaf(p, vx[u][i], acc[g][i]);
      }
    }
  }
  // the warp's partial: m is the same on every lane; l and acc sum over the
  // lane groups (every lane of a group holds its group's sum)
#pragma unroll
  for (int g = 0; g < GR; ++g) {
#pragma unroll
    for (int o = 16; o >= CH; o >>= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int i = 0; i < F; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
    }
  }
  __shared__ float w_m[NW][GR], w_l[NW][GR], w_acc[NW][GR][D];
  if (lane < CH) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
#pragma unroll
      for (int i = 0; i < F; ++i) w_acc[warp][g][Pool::feature(sub, i)] = acc[g][i];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      w_m[warp][g] = m[g];
      w_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  // merge the warps by log-sum-exp (a warp that saw no live token has
  // m = kNegInf and l = acc = 0, so its weight is 0)
  for (int idx = tid; idx < gn * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, w_m[w][g]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a = fmaf(w_acc[w][g][d], expf(w_m[w][g] - mx), a);
    ws_acc[((row_g0 + g) * splits + split) * D + d] = a;
  }
  for (int g = tid; g < gn; g += blockDim.x) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, w_m[w][g]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) sum = fmaf(w_l[w][g], expf(w_m[w][g] - mx), sum);
    ws_m[(row_g0 + g) * splits + split] = mx;
    ws_l[(row_g0 + g) * splits + split] = sum;
  }
}

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
  const int G = hq / hkv;
  const int rblocks = (G + kDecodeRows - 1) / kDecodeRows;
  paged_decode_kernel<T, D, Pool><<<dim3(splits, hkv * rblocks, batch), kDecodeThreads, 0,
                                    stream>>>(
      static_cast<const T*>(q), pool, static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(ws), hkv, G, page_size,
      num_pages, max_pages, pages_per_split, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return combine_splits<T>(static_cast<const float*>(ws), static_cast<T*>(out), batch * hq,
                           splits, D, stream);
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
