// The split-K one-token decode body that every decode of the port runs
// (included by paged_attention.cu for the paged pools and by
// flash_attention.cu for the dense cache and the ring; kernels/_build.py
// hashes every header under csrc/ into each library's name), with the pool
// policies it reads K/V through.
//
// One body, templated on two policies:
//   Pool  the element policy: DensePool<T, D> (pages or a cache in T) or
//         QuantPool<BITS, D> (int8 / int4 split-half bytes with one f32 scale
//         per (page, head)); ``load`` turns 8 features of one K or V row into
//         f32, ``stage`` fills the f32 paged chunk kernel's shared-memory
//         tile, and ``row_bytes`` / ``to_bf16`` / ``scale_of`` feed the bf16
//         chunk body's tensor-core tile.
//   Keys  the key-source policy: ``at(b, h)`` gives sequence b's live keys as
//         one interval [lo, hi) and ``row(j)`` the K/V row of key j.
//         PagedKeys walks the block table (live iff j < context_lens[b]);
//         DenseKeys reads a (B, Hkv, S, D) cache, row (b * Hkv + h) * S + j,
//         live iff j <= pos and, with a window, j > pos - window, with pos
//         read on the device.
//
// What bounds a decode on an H100: bytes. It reads each live K/V row once and
// does 4 * G * D flops a key for the G = Hq / Hkv query heads of its group,
// far below the card's rate. What keeps it from the byte rate is parallelism:
// one block per (sequence, KV head) gives 2 blocks for recurrentgemma's MQA
// ring (B 2, Hkv 1) and 16 at qwen2's serve shape. So the keys are split: a
// block per (split, KV head and row block, sequence) takes keys_per_split keys
// (the wrapper's plan_decode_splits aims for two blocks a SM and at least one
// ~64-key tile a split, 32 keys at D > 64), leaves its partial (m, l, acc) in
// an f32 workspace, and common.cuh's combine_splits_kernel merges the splits
// by log-sum-exp. A split that holds no live key (wholly past the length or
// pos, or wholly before pos - window) writes m = -inf, l = 0 and exits; a row
// with no live key at all comes out as exact zeros.
//
// Inside a split nothing goes through shared memory until the end:
//   lanes   a lane group of LG lanes holds one key: LG is CH = D / 8 rounded
//           up to a power of two (a whole warp at D 256; 16 at D 112, whose
//           14 feature lanes leave lanes 14 and 15 of each group idle: they
//           load nothing and hold zeros, so the group's shuffle sums are
//           unchanged and the pools keep their (…, ps, 112) rows); each of
//           the CH feature lanes loads 8 features of its K and V rows
//           (Pool::load: 16 bytes of bf16, 32 of f32, 8 of int8, 4 of int4)
//           and holds the same 8 features of q for up to kDecodeRows query
//           rows of the group, and of their accumulators, in registers; a
//           group of G > kDecodeRows rows takes ceil(G / kDecodeRows) blocks
//           holding G / blocks rows each (10: 5 and 5), the later ones
//           reading the same keys again, from L2;
//   steps   each warp takes kDecodeUnroll keys a lane group at a time, all
//           loads issued before any arithmetic; dead keys are not read;
//   scores  the lane's 8-term dot, summed over its group by shuffles;
//   softmax each warp keeps its own running (m, l, acc) for every row: the
//           row max by shuffles across the lane groups, dead keys masked by
//           liveness (never by the exponent alone), P . V into the lane's 8
//           features;
//   end     the lane groups' l and acc are summed by shuffles, and the warps'
//           partials merged by log-sum-exp through shared memory into the
//           split's partial.
// Every sum is f32 whatever T is; f32 and bf16 run the same body.
#pragma once

#include "common.cuh"

namespace {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeRows = 8;    // query rows of a group a decode block holds (in registers)
constexpr int kDecodeUnroll = 2;  // keys a decode lane group loads before its arithmetic

// the least power of two >= n (n >= 1)
__host__ __device__ constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

// A pool (or cache) of dense rows in T.
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
  // the bf16 chunk body (paged_attention.cu::paged_chunk_mma_kernel): a row
  // is staged as it is stored, straight into the bf16 tile, with no scale
  static constexpr bool kQuant = false;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  __device__ const unsigned char* row_bytes(bool is_v, long long row) const {
    return reinterpret_cast<const unsigned char*>((is_v ? v : k) + row * D);
  }
};

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
  // the bf16 chunk body: a row's DQ bytes are staged raw, then ``to_bf16``
  // writes 4 of them (bytes 4c .. 4c + 3) as bf16 integers (exact) into the
  // row's features, and ``scale_of`` gives the (page, head) scale that
  // multiplies the row's column of S (K) or of P (V)
  static constexpr bool kQuant = true;
  static constexpr int kRowBytes = DQ;
  __device__ const unsigned char* row_bytes(bool is_v, long long row) const {
    return reinterpret_cast<const unsigned char*>((is_v ? v : k) + row * DQ);
  }
  __device__ float scale_of(bool is_v, long long row, int page_size) const {
    return (is_v ? v_scale : k_scale)[row / page_size];
  }
  __device__ static void to_bf16(uint32_t w, int c, __nv_bfloat16* dst) {
    float f[4];
    if constexpr (BITS == 8) {
      int8x4_to_f32(w, f);
      *reinterpret_cast<__nv_bfloat162*>(dst + 4 * c) = __floats2bfloat162_rn(f[0], f[1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + 4 * c + 2) = __floats2bfloat162_rn(f[2], f[3]);
    } else {  // split-half: lo nibbles are features 4c.., hi nibbles D/2 + 4c..
      nib4_to_f32(w & 0x0F0F0F0Fu, f);
      *reinterpret_cast<__nv_bfloat162*>(dst + 4 * c) = __floats2bfloat162_rn(f[0], f[1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + 4 * c + 2) = __floats2bfloat162_rn(f[2], f[3]);
      nib4_to_f32((w >> 4) & 0x0F0F0F0Fu, f);
      *reinterpret_cast<__nv_bfloat162*>(dst + D / 2 + 4 * c) = __floats2bfloat162_rn(f[0], f[1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + D / 2 + 4 * c + 2) =
          __floats2bfloat162_rn(f[2], f[3]);
    }
  }
};

// Paged keys: sequence b's keys are the first min(context_lens[b], max_pages
// * page_size) slots of its block-table row; key j lives in logical page
// j / page_size (table entries clamped into the pool).
struct PagedKeys {
  const int* block_tables;  // (B, max_pages)
  const int* context_lens;  // (B,)
  int page_size, num_pages, max_pages, hkv;
  struct Seq {
    const int* table;
    int lo, hi, page_size, num_pages, hkv, h;
    __device__ long long row(int j) const {
      const int p = j / page_size;
      int page = table[p];
      page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
      return (static_cast<long long>(page) * hkv + h) * page_size + (j - p * page_size);
    }
  };
  __device__ Seq at(int b, int h) const {
    const long long cap = static_cast<long long>(max_pages) * page_size;
    const long long len = context_lens[b];
    const int hi = static_cast<int>(len < 0 ? 0 : (len < cap ? len : cap));
    return Seq{block_tables + static_cast<size_t>(b) * max_pages, 0, hi, page_size, num_pages,
               hkv, h};
  }
};

// Dense keys: a (B, Hkv, S, D) cache (or a ring of S slots) whose slot j is
// live iff j <= pos (the current token) and, with a window, j > pos - window.
// pos is read on the device from one int32 when pos_ptr is set, so a decode
// step never waits on the host.
struct DenseKeys {
  const int* pos_ptr;
  int pos_val, s_len, hkv, has_window, window;
  struct Seq {
    long long base;  // row of slot 0 of (b, h)
    int lo, hi, page_size;
    __device__ long long row(int j) const { return base + j; }
  };
  __device__ Seq at(int b, int h) const {
    const int pos = pos_ptr != nullptr ? *pos_ptr : pos_val;
    const int hi = pos < 0 ? 0 : (pos < s_len ? pos + 1 : s_len);
    int lo = 0;
    if (has_window && pos - window + 1 > 0) lo = pos - window + 1;
    return Seq{(static_cast<long long>(b) * hkv + h) * s_len, lo, hi > lo ? hi : lo, 1};
  }
};

// The split-K decode body (see the top of this file): block (split, KV head h
// x row block, sequence b) takes keys [split * keys_per_split, (split + 1) *
// keys_per_split) of the sequence's live interval and leaves its partial for
// up to kDecodeRows query rows of h's group in ws (layout in common.cuh's
// combine_splits_kernel). q (B, Hq, 1, D) in T.
template <typename T, int D, typename Pool, typename Keys>
__global__ void __launch_bounds__(kDecodeThreads)
split_decode_kernel(const T* __restrict__ q, Pool pool, Keys keys, float* __restrict__ ws,
                    int hkv, int group, int keys_per_split, float scale) {
  constexpr int F = Pool::F, CH = Pool::CH;  // features a lane, lanes holding a row's features
  constexpr int LG = pow2_ceil(CH), TPW = 32 / LG;  // a key's lane group, keys a warp loads
  constexpr int GR = kDecodeRows, U = kDecodeUnroll, NW = kDecodeThreads / 32;
  static_assert(F == 8 && CH >= 1 && LG <= 32, "a row is 1..32 lanes");
  const int split = blockIdx.x, b = blockIdx.z;
  // the group's rows spread evenly over its ceil(G / GR) blocks (G 10: 5 and
  // 5, not 8 and 2); a block skips the arithmetic of the rows it does not hold
  const int rblocks = (group + GR - 1) / GR, rpb = (group + rblocks - 1) / rblocks;
  const int h = blockIdx.y / rblocks, g0 = (blockIdx.y - h * rblocks) * rpb;
  const int gn = min(rpb, group - g0);  // query rows this block holds, 1..GR
  const int splits = gridDim.x, rows = gridDim.z * hkv * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LG, sub = lane - grp * LG;
  const bool feat = sub < CH;  // the lane holds features (lanes CH..LG-1 of a group idle)
  const size_t row_g0 = (static_cast<size_t>(b) * hkv + h) * group + g0;  // q / ws row of row 0
  float* ws_m = ws;
  float* ws_l = ws + static_cast<size_t>(rows) * splits;
  float* ws_acc = ws + 2 * static_cast<size_t>(rows) * splits;

  const typename Keys::Seq seq = keys.at(b, h);
  const long long k0 = static_cast<long long>(split) * keys_per_split;
  const int j_lo = static_cast<int>(k0 > seq.lo ? k0 : seq.lo);
  const int j_hi = static_cast<int>(k0 + keys_per_split < seq.hi ? k0 + keys_per_split : seq.hi);
  if (j_lo >= j_hi) {  // no live key in this split
    for (int g = tid; g < gn; g += blockDim.x) {
      ws_m[(row_g0 + g) * splits + split] = -CUDART_INF_F;
      ws_l[(row_g0 + g) * splits + split] = 0.f;
    }
    return;
  }

  // q (B, Hq, 1, D): this lane's 8 features of each of the block's rows
  float qr[GR][F], acc[GR][F], m[GR], l[GR];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      qr[g][i] = g < gn && feat ? to_f32(q[(row_g0 + g) * D + Pool::feature(sub, i)]) : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  for (int t0 = j_lo + warp * TPW * U; t0 < j_hi; t0 += NW * TPW * U) {
    float kx[U][F], vx[U][F];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * TPW + grp;  // the lane groups of a load take consecutive keys
      live[u] = t < j_hi;
      if (live[u] && feat) {
        const long long r = seq.row(t);
        pool.load(false, r, seq.page_size, sub, kx[u]);
        pool.load(true, r, seq.page_size, sub, vx[u]);
      } else {
#pragma unroll
        for (int i = 0; i < F; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      if (g >= gn) break;  // the same on every lane
      float s[U];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < F; ++i) dot = fmaf(qr[g][i], kx[u][i], dot);
#pragma unroll
        for (int o = LG / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u] = live[u] ? dot * scale : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
#pragma unroll
      for (int o = 16; o >= LG; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
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
    if (g >= gn) break;
#pragma unroll
    for (int o = 16; o >= LG; o >>= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int i = 0; i < F; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
    }
  }
  __shared__ float w_m[NW][GR], w_l[NW][GR], w_acc[NW][GR][D];
  if (lane < CH) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      if (g >= gn) break;
#pragma unroll
      for (int i = 0; i < F; ++i) w_acc[warp][g][Pool::feature(sub, i)] = acc[g][i];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      if (g >= gn) break;
      w_m[warp][g] = m[g];
      w_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  // merge the warps by log-sum-exp (a warp that saw no live key has
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

// The split body over ``splits`` splits of ``keys_per_split`` keys, then the
// log-sum-exp combine into out (B, Hq, 1, D) in T. ws: B * Hq * splits * (D +
// 2) floats. ``lse``, when not null, receives each row's log-sum-exp (B, Hq)
// f32 from the combine's kLse epilogue.
template <typename T, int D, typename Pool, typename Keys>
cudaError_t launch_split_decode(const void* q, Pool pool, Keys keys, void* out, void* ws,
                                int batch, int hq, int hkv, int splits, int keys_per_split,
                                float scale, cudaStream_t stream, float* lse = nullptr) {
  const int G = hq / hkv;
  const int rblocks = (G + kDecodeRows - 1) / kDecodeRows;
  split_decode_kernel<T, D, Pool, Keys><<<dim3(splits, hkv * rblocks, batch), kDecodeThreads,
                                          0, stream>>>(
      static_cast<const T*>(q), pool, keys, static_cast<float*>(ws), hkv, G, keys_per_split,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return combine_splits<T>(static_cast<const float*>(ws), static_cast<T*>(out), batch * hq,
                           splits, D, stream, lse);
}

}  // namespace
