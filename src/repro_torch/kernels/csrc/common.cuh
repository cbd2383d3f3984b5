// Helpers the port's kernels share (included by every source under csrc/;
// kernels/_build.py hashes every header under csrc/ into each library's name,
// so an edit here rebuilds them all): f32 conversions, warp reductions, the
// f32 K/V tile stage and the online-softmax tile update, the tensor-core and
// cp.async pieces of the bf16 bodies and the staged kernels (mma.sync
// m16n8k16, ldmatrix, 16-, 8- and 4-byte copies, the hi + lo split of an f32
// pair), integer-to-float conversion, the log-sum-exp combine of
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

// ---------------------------------------------------------------------------------
// Tensor-core and asynchronous-copy pieces (flash_attention.cu's bf16 prefill,
// paged_attention.cu's bf16 chunk body, quant_matmul.cu's chunk schedule)
// ---------------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; ``bytes`` 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
// 8 bytes global -> shared (rows shorter than 16 bytes); ``bytes`` 0 fills zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
// 4 bytes global -> shared (single f32 values, bf16 pairs); ``bytes`` 0 fills zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarriers in shared memory (rglru_scan.cu's and rglru_scan_bwd.cu's rings)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(bar))
               : "memory");
  (void)state;
}
// arrives on ``bar`` once every cp.async this thread issued before has landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// waits until the phase of ``bar`` with parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> the bf16 pair nearest to it, and the bf16 pair of what that leaves
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// the signed value of the low nibble of b
__device__ __forceinline__ float signed_nibble(int b) {
  const int n = b & 0xF;
  return static_cast<float>(n >= 8 ? n - 16 : n);
}

// One online-softmax step of a warp's 16-row slab of queries over a staged
// tile of NK keys, on the tensor cores (flash_attention.cu's bf16 prefill and
// paged_attention.cu's bf16 chunk body). q_s and the K / V tiles are bf16 rows
// of LD elements; the warp's rows are slab * 16 .. + 15, and it owns output
// columns col0 .. col0 + DC - 1 of o. S = Q . K^T and O += P . V run on
// mma.sync m16n8k16 with f32 accumulation; scores go in log2 units (sl2 =
// scale * log2 e, exp2f). ``live(col, hi)`` says whether key col of the tile
// is live for the lane's row (hi: the row 8 below); ``all_live`` skips the
// test. With ``scaled``, key column c's S is multiplied by sk[c] and its P by
// sv[c] before P . V (the row sum l takes the plain P): an intN tile staged as
// bf16 integers. P enters P . V as P_hi + P_lo, two bf16 terms (one fails the
// one-ulp gate). Dead pairs are masked by liveness, never by the exponent
// alone. m_r, l_r: the lane's two rows' running max and sum.
template <int D, int NK, int DC, int LD, typename Live>
__device__ __forceinline__ void mma_softmax_tile(const bf16* q_s, const bf16* ks, const bf16* vs,
                                                 int slab, int col0, float sl2, bool all_live,
                                                 Live live, bool scaled, const float* sk,
                                                 const float* sv, float (&o)[DC / 8][4],
                                                 float (&m_r)[2], float (&l_r)[2]) {
  const int lane = threadIdx.x & 31;
  float s[NK / 8][4];
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int dk = 0; dk < D / 16; ++dk) {
    uint32_t a[4];
    ldsm_x4(a, q_s + (slab * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dk * 16 +
                    (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < NK / 16; ++nj) {
      uint32_t bk[4];
      ldsm_x4(bk, ks + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD + dk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * nj], a, bk[0], bk[1]);
      mma_bf16(s[2 * nj + 1], a, bk[2], bk[3]);
    }
  }
  uint32_t dead = 0;  // bit n * 4 + e: s[n][e] is dead
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hi = e >> 1, col = n * 8 + (lane & 3) * 2 + (e & 1);
      float x = s[n][e] * sl2;
      if (scaled) x *= sk[col];
      if (!all_live && !live(col, hi)) {
        dead |= 1u << (n * 4 + e);
        x = kNegInf;
      }
      s[n][e] = x;
      mx[hi] = fmaxf(mx[hi], x);
    }
  }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_r[i], mx[i]);
    alpha[i] = exp2f(m_r[i] - m_new);
    m_r[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = (dead >> (n * 4 + e)) & 1u ? 0.f : exp2f(s[n][e] - m_r[e >> 1]);
      rs[e >> 1] += p;
      s[n][e] = scaled ? p * sv[n * 8 + (lane & 3) * 2 + (e & 1)] : p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l_r[i] = l_r[i] * alpha[i] + rs[i];
  }
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  // O += P . V: the S accumulator of keys 16 kk .. 16 kk + 15 is the A operand
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t p_hi[4], p_lo[4];
    split_bf16x2(s[2 * kk][0], s[2 * kk][1], p_hi[0], p_lo[0]);
    split_bf16x2(s[2 * kk][2], s[2 * kk][3], p_hi[1], p_lo[1]);
    split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], p_hi[2], p_lo[2]);
    split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], p_hi[3], p_lo[3]);
#pragma unroll
    for (int nd = 0; nd < DC / 16; ++nd) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + col0 +
                            nd * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * nd], p_hi, bv[0], bv[1]);
      mma_bf16(o[2 * nd + 1], p_hi, bv[2], bv[3]);
      mma_bf16(o[2 * nd], p_lo, bv[0], bv[1]);
      mma_bf16(o[2 * nd + 1], p_lo, bv[2], bv[3]);
    }
  }
}

// Integers to floats without the I2F unit: byte i of ``w`` (a signed int8, or
// a signed nibble held in the byte's low four bits with ``nibbles``) becomes
// the float of its value. The byte is biased to unsigned (xor 0x80, or 0x08),
// put in the mantissa of 2^23 and the bias and 2^23 subtracted: exact.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(0x4B000000u | ((u >> (8 * i)) & 0xFFu)) - 8388736.f;
}
__device__ __forceinline__ void nib4_to_f32(uint32_t w, float (&f)[4]) {  // bytes 0x0N
  const uint32_t u = w ^ 0x08080808u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(0x4B000000u | ((u >> (8 * i)) & 0xFFu)) - 8388616.f;
}

// Two signed int8 (the low two bytes of w), or the two signed nibbles of one
// byte (lo first), as a bf16 pair of the same integers: exact.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  return bf16x2_bits(__floats2bfloat162_rn(
      __uint_as_float(0x4B000000u | (u & 0xFFu)) - 8388736.f,
      __uint_as_float(0x4B000000u | ((u >> 8) & 0xFFu)) - 8388736.f));
}
__device__ __forceinline__ uint32_t nib2_to_bf16x2(uint32_t b) {
  const uint32_t u = b ^ 0x88u;
  return bf16x2_bits(__floats2bfloat162_rn(
      __uint_as_float(0x4B000000u | (u & 0xFu)) - 8388616.f,
      __uint_as_float(0x4B000000u | ((u >> 4) & 0xFu)) - 8388616.f));
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
//
// kLse (a compile-time flag, so the serving decode's instantiation is the one
// it always was) also writes each row's natural log-sum-exp of the scaled
// scores, m* + log l*, into lse[row] (-inf for a row with no live key): the
// partial a rank holding one slice of a sequence-split cache hands the
// cross-rank merge (models/attention.py). Block (0, row) writes it.
constexpr int kCombineWarps = 8;

template <typename T, bool kLse = false>
__global__ void __launch_bounds__(kCombineWarps * 32)
combine_splits_kernel(const float* __restrict__ ws, T* __restrict__ out, int rows, int splits,
                      int D, float* __restrict__ lse = nullptr) {
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
    if constexpr (kLse) {
      if (lane == 0 && blockIdx.x == 0) lse[r] = ls > 0.f ? mx + logf(ls) : -CUDART_INF_F;
    }
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
                           cudaStream_t stream, float* lse = nullptr) {
  if (rows > 65535 || static_cast<size_t>(splits) * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
  const dim3 grid((D + 31) / 32, rows);
  const size_t smem = static_cast<size_t>(splits) * sizeof(float);
  if (lse != nullptr)
    combine_splits_kernel<T, true><<<grid, kCombineWarps * 32, smem, stream>>>(
        ws, out, rows, splits, D, lse);
  else
    combine_splits_kernel<T><<<grid, kCombineWarps * 32, smem, stream>>>(ws, out, rows,
                                                                         splits, D);
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
