// The backward pass of dense GQA flash attention for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (repro_torch/kernels/flash_vjp.py
// holds the wrapper, FlashAttentionFn, the planner of the dK/dV split, and the
// plain PyTorch backward and split schedule these kernels are held against).
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
// and delta (B, Hq, Tq) f32; all contiguous, one element type for q, k, v,
// out, dO and the gradients (float or bf16); sums in f32, the gradients
// rounded to the element type once. No float atomics: two runs are bit-equal.
//
// What bounds it on an H100: operations. S and dP are recomputed by both the
// dK/dV and the dQ kernels (the price of determinism without atomics), so
// the bf16 bodies run ~2x the forward's flops, plus three hi + lo pairs.
//
// bf16, on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulation), three launches on one stream:
//   dq_mma_kernel    a block per (64 query rows, q head, sequence), 16 rows a
//                    warp: its prologue writes delta for its rows (16-byte
//                    loads of O and dO); then over the key tiles the rows can
//                    see (64 keys, 32 at D 256; the causal and window cut),
//                    S = Q . K^T and dP = dO . V^T, dS in the accumulators
//                    from each row's lse and delta, dQ += dS . K with dS as
//                    the A operand straight from registers;
//   dkdv_mma_kernel  a block per (64 keys, kv head, sequence, split), 16 keys
//                    a warp: over its share of the walk (the group's query
//                    heads, then the query tiles that can see the keys: 64
//                    rows, 32 at D > 64), S^T = K . Q^T and dP^T = V . dO^T,
//                    P^T and dS^T in the accumulators from each column's lse
//                    and delta, dV += P^T . dO and dK += dS^T . Q with P^T and
//                    dS^T as the A operand from registers;
//   fold_splits_kernel  with more than one split, dK and dV summed from the
//                    splits' f32 partials (ws) in split order, rounded once.
// P and dS enter their products as hi + lo, two bf16 terms each (one term
// fails the one-ulp gate, as it did for the forward's P . V). Q and dO (K and
// V in the dQ walk) come in as B operands through ldmatrix (.trans where they
// are the product's k rows); their tiles are staged as bf16 by 16-byte
// cp.async into a ring of two stages, rows padded by 16 bytes, so the next
// tile loads while this one is multiplied. At D 256 two warps share a slab of
// 16 keys, each owning 128 columns of dK and dV (the same S^T in both), since
// one warp's 256 columns of two f32 accumulators do not fit its registers.
// The split (flash_vjp.py's bwd_plan) cuts a key tile's walk into up to
// kMaxSplits contiguous pieces only where the (key tile, kv head, sequence)
// grid is under one wave of resident blocks: GQA groups at few key tiles.
//
// f32 keeps the CUDA-core bodies (tensor cores would need TF32, which fails the
// 1e-4 gate): delta_kernel (one warp a row), dkdv_kernel (one block per (key
// tile, kv head, sequence) walking the group's heads and query tiles) and
// dq_kernel, 256 threads as a 16 x 16 grid over f32 tiles staged by scalar
// loads, 64 x 64 up to D 128 and 32 x 32 at D 256. It never splits.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------------
constexpr int kBwdThreads = 256;

template <int D> __host__ __device__ constexpr int bwd_rows() { return D > 128 ? 32 : 64; }
template <int D> __host__ __device__ constexpr int bwd_keys() { return D > 128 ? 32 : 64; }

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

// ---------------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------------
constexpr int kMmaWarps = 4;             // warps a block (dK/dV: times the column split)
constexpr int kKvKeys = 16 * kMmaWarps;  // keys a dK/dV block, 16 a warp
constexpr int kKvRows = 64;              // query rows a tile of the dK/dV walk, D <= 64
constexpr int kKvRowsWide = 32;          // the same at D 112, 128 and 256
constexpr int kQRows = 16 * kMmaWarps;   // query rows a dQ block, 16 a warp
constexpr int kQKeys = 64;               // keys a tile of the dQ walk, D <= 128
constexpr int kQKeysD256 = 32;           // the same at D 256
constexpr int kStages = 2;               // the cp.async ring of both walks
constexpr int kMaxSplits = 16;           // dK/dV splits of one key tile's walk
constexpr int kPad = 8;                  // bf16 elements padding a shared-memory row (16 bytes)
constexpr int kFoldThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> __host__ __device__ constexpr int kv_rows() {
  return D > 64 ? kKvRowsWide : kKvRows;
}
template <int D> __host__ __device__ constexpr int kv_col_split() { return D > 128 ? 2 : 1; }
template <int D> struct KvThreads {
  static constexpr int value = kMmaWarps * kv_col_split<D>() * 32;
  // resident blocks an SM the registers are cut for: 3 at D <= 64 (168
  // registers and 16 bytes of spill stores at D 64; uncut the body takes
  // 194, and 2 fit), 1 above (the D 128 body takes 254)
  static constexpr int min_blocks = D <= 64 ? 3 : 1;
};
template <int D> __host__ __device__ constexpr int q_keys() {
  return D > 128 ? kQKeysD256 : kQKeys;
}
constexpr int kQThreads = kMmaWarps * 32;

// dynamic shared memory of the dK/dV block (K, V; the ring of Q, dO, lse and
// delta) and of the dQ block (Q, dO; the ring of K and V; delta)
template <int D> __host__ __device__ constexpr size_t kv_smem() {
  return sizeof(bf16) * (D + kPad) * (2 * kKvKeys + 2 * kStages * kv_rows<D>()) +
         sizeof(float) * 2 * kStages * kv_rows<D>();
}
template <int D> __host__ __device__ constexpr size_t q_smem() {
  return sizeof(bf16) * (D + kPad) * (2 * kQRows + 2 * kStages * q_keys<D>()) +
         sizeof(float) * kQRows;
}

// the planner's constants (kernels/flash_vjp.py::GEOMETRY), in its order: the
// f32 bodies' threads and tiles, then the bf16 bodies'
constexpr int kGeometry[] = {kBwdThreads,   bwd_rows<64>(),  bwd_keys<64>(), bwd_rows<256>(),
                             bwd_keys<256>(), kMmaWarps,     kKvRows,        kKvRowsWide,
                             kv_col_split<256>(), kQKeys,    kQKeysD256,     kStages,
                             kMaxSplits};

// (query t, key j) live: the forward's mask
__device__ __forceinline__ bool live_pair(int t, int j, int tq, int tk, int q_off, int causal,
                                          int has_window, int window) {
  return t < tq && j < tk && (!causal || j <= q_off + t) && (!has_window || j > q_off + t - window);
}

// One (key tile, kv head, sequence) block's share of its walk: the query rows
// that can see keys [j0, j0 + kKvKeys) start at t_lo (the causal start, down
// to a multiple of the tile) and end before t_hi (the window's end); the walk
// is item i = g * n_qt + tile over the group's heads g, and split s of
// ``splits`` takes items [s * n / splits, (s + 1) * n / splits).
// flash_vjp.py's kv_walk is its twin.
template <int D>
__global__ void __launch_bounds__(KvThreads<D>::value, KvThreads<D>::min_blocks)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ ws, int splits,
                const int* __restrict__ q_off_ptr, int q_off_val, int hkv, int group, int tq,
                int tk, int causal, int has_window, int window, float scale) {
  constexpr int NK = kKvKeys, BQ = kv_rows<D>(), CS = kv_col_split<D>();
  constexpr int NTHR = KvThreads<D>::value, LD = D + kPad, DC = D / CS, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + NK * LD;
  bf16* q_s = v_s + NK * LD;            // kStages x BQ rows
  bf16* do_s = q_s + kStages * BQ * LD;  // kStages x BQ rows
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * BQ * LD);  // kStages x BQ
  float* dl_s = lse_s + kStages * BQ;                                 // kStages x BQ

  const int tile = blockIdx.x / splits, split = blockIdx.x - tile * splits;
  const int j0 = tile * NK, h = blockIdx.y, b = blockIdx.z;
  const int G = group, hq = hkv * G;
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp / CS, col0 = (warp % CS) * DC;
  const size_t kv_row0 = (static_cast<size_t>(b) * hkv + h) * tk;

  const int j_last = min(j0 + NK, tk) - 1;
  const int t_lo = causal ? max(0, j0 - q_off) / BQ * BQ : 0;
  const int t_hi = has_window ? min(tq, j_last + window - q_off) : tq;
  const int n_qt = t_hi > t_lo ? (t_hi - t_lo + BQ - 1) / BQ : 0;
  const int n_items = G * n_qt;
  const int i_begin = static_cast<int>(static_cast<long long>(split) * n_items / splits);
  const int i_end = static_cast<int>(static_cast<long long>(split + 1) * n_items / splits);

  auto stage = [&](int item, int buf) {
    const int g = item / n_qt, t0 = t_lo + (item - g * n_qt) * BQ;
    const size_t q_row0 = (static_cast<size_t>(b) * hq + h * G + g) * tq;
    bf16* qs = q_s + buf * BQ * LD;
    bf16* dos = do_s + buf * BQ * LD;
    for (int i = tid; i < BQ * CPR; i += NTHR) {
      const int r = i / CPR, c = i - r * CPR, t = t0 + r;
      const bool in = t < tq;  // past Tq: zeros (dead by liveness)
      const size_t off = (q_row0 + (in ? t : 0)) * D + c * 8;
      cp_async16(qs + r * LD + c * 8, q + off, in ? 16 : 0);
      cp_async16(dos + r * LD + c * 8, dout + off, in ? 16 : 0);
    }
    for (int i = tid; i < BQ; i += NTHR) {
      const bool in = t0 + i < tq;
      const size_t off = q_row0 + (in ? t0 + i : 0);
      cp_async4(lse_s + buf * BQ + i, lse + off, in ? 4 : 0);
      cp_async4(dl_s + buf * BQ + i, delta + off, in ? 4 : 0);
    }
    cp_async_commit();
  };

  const int n_mine = i_end - i_begin;
  if (n_mine > 0) {
    for (int i = tid; i < NK * CPR; i += NTHR) {
      const int r = i / CPR, c = i - r * CPR, j = j0 + r;
      const bool in = j < tk;  // past Tk: zeros, so a dead key's S is finite
      const size_t off = (kv_row0 + (in ? j : 0)) * D + c * 8;
      cp_async16(k_s + r * LD + c * 8, k + off, in ? 16 : 0);
      cp_async16(v_s + r * LD + c * 8, v + off, in ? 16 : 0);
    }
    cp_async_commit();
    stage(i_begin, 0);
  }

  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2f below
  const int ja = j0 + slab * 16 + (lane >> 2);  // the lane's keys: ja and ja + 8
  float dv_acc[DC / 8][4], dk_acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[n][e] = dk_acc[n][e] = 0.f;

  for (int it = 0; it < n_mine; ++it) {
    const int item = i_begin + it;
    if (it + 1 < n_mine) {
      stage(item + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1;
    const bf16* qs = q_s + buf * BQ * LD;
    const bf16* dos = do_s + buf * BQ * LD;
    const float* lse_t = lse_s + buf * BQ;
    const float* dl_t = dl_s + buf * BQ;
    const int g = item / n_qt, t0 = t_lo + (item - g * n_qt) * BQ;

    // S^T = K . Q^T and dP^T = V . dO^T over the warp's 16 keys (rows) and the
    // tile's BQ queries (columns)
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ak[4], av[4];
      const int a_off = (slab * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kd * 16 +
                        (lane >> 4) * 8;
      ldsm_x4(ak, k_s + a_off);
      ldsm_x4(av, v_s + a_off);
#pragma unroll
      for (int nj = 0; nj < BQ / 16; ++nj) {
        uint32_t bq[4], bo[4];
        const int b_off = (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kd * 16 +
                          ((lane >> 3) & 1) * 8;
        ldsm_x4(bq, qs + b_off);
        ldsm_x4(bo, dos + b_off);
        mma_bf16(s[2 * nj], ak, bq[0], bq[1]);
        mma_bf16(s[2 * nj + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * nj], av, bo[0], bo[1]);
        mma_bf16(dp[2 * nj + 1], av, bo[2], bo[3]);
      }
    }
    // P^T and dS^T / scale in place, from each column's lse and delta; dead
    // pairs are zero by liveness, never through the exponent
    const bool all_live = t0 + BQ <= tq && j0 + NK <= tk &&
                          (!causal || j0 + NK - 1 <= q_off + t0) &&
                          (!has_window || j0 > q_off + t0 + BQ - 1 - window);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + (lane & 3) * 2 + (e & 1), j = ja + (e >> 1) * 8;
        const bool live = all_live ||
                          live_pair(t0 + col, j, tq, tk, q_off, causal, has_window, window);
        const float p = live ? exp2f(fmaf(s[n][e], sl2, -lse_t[col] * kLog2e)) : 0.f;
        s[n][e] = p;
        dp[n][e] = live ? p * (dp[n][e] - dl_t[col]) : 0.f;
      }
    }
    // dV += P^T . dO and dK += dS^T . Q: the accumulators of queries
    // 16 kk .. 16 kk + 15 are the A operand, each as hi + lo bf16 terms
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t p_hi[4], p_lo[4], d_hi[4], d_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * kk + (i >> 1), e = (i & 1) * 2;
        split_bf16x2(s[n][e], s[n][e + 1], p_hi[i], p_lo[i]);
        split_bf16x2(dp[n][e], dp[n][e + 1], d_hi[i], d_lo[i]);
      }
#pragma unroll
      for (int nd = 0; nd < DC / 16; ++nd) {
        uint32_t bo[4], bq[4];
        const int b_off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + col0 +
                          nd * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(bo, dos + b_off);
        ldsm_x4_trans(bq, qs + b_off);
        mma_bf16(dv_acc[2 * nd], p_hi, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * nd + 1], p_hi, bo[2], bo[3]);
        mma_bf16(dv_acc[2 * nd], p_lo, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * nd + 1], p_lo, bo[2], bo[3]);
        mma_bf16(dk_acc[2 * nd], d_hi, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * nd + 1], d_hi, bq[2], bq[3]);
        mma_bf16(dk_acc[2 * nd], d_lo, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * nd + 1], d_lo, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the next iteration restages this buffer
  }

  // one split: bf16 dK (times scale) and dV; more: this split's f32 partials
  // in ws (splits, B, Hkv, Tk, D), dK's then dV's, for the fold
  const size_t n_all = static_cast<size_t>(gridDim.z) * hkv * tk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = ja + 8 * i;
    if (j >= tk) continue;
    const size_t row = (kv_row0 + j) * D + col0 + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const float k0 = dk_acc[n][2 * i] * scale, k1 = dk_acc[n][2 * i + 1] * scale;
      const float v0 = dv_acc[n][2 * i], v1 = dv_acc[n][2 * i + 1];
      if (splits == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row + n * 8) = __floats2bfloat162_rn(k0, k1);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + n * 8) = __floats2bfloat162_rn(v0, v1);
      } else {
        float* wk = ws + split * n_all + row + n * 8;
        *reinterpret_cast<float2*>(wk) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(wk + splits * n_all) = make_float2(v0, v1);
      }
    }
  }
}

// dK and dV from the splits' partials: summed in split order, rounded once.
// Thread i takes four values; i < n4 reads dK's partials, the rest dV's.
__global__ void __launch_bounds__(kFoldThreads)
fold_splits_kernel(const float* __restrict__ ws, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   long long n4, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (i >= 2 * n4) return;
  const int which = i >= n4;
  const long long idx = i - which * n4;
  const float4* src = reinterpret_cast<const float4*>(ws) + which * splits * n4 + idx;
  float4 a = src[0];
  for (int s = 1; s < splits; ++s) {
    const float4 x = src[s * n4];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(which ? dv : dk) + 2 * idx;
  dst[0] = __floats2bfloat162_rn(a.x, a.y);
  dst[1] = __floats2bfloat162_rn(a.z, a.w);
}

// dQ for kQRows query rows of one q head, walking the key tiles they can see;
// its prologue writes delta = rowsum(dO o O) of its rows (the dK/dV kernel,
// launched after it, reads it).
template <int D>
__global__ void __launch_bounds__(kQThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ out, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
              const int* __restrict__ q_off_ptr, int q_off_val, int hkv, int group, int tq,
              int tk, int causal, int has_window, int window, float scale) {
  constexpr int BQ = kQRows, NK = q_keys<D>(), NTHR = kQThreads, LD = D + kPad, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BQ * LD;
  bf16* kv_s = do_s + BQ * LD;  // kStages x (K, V), NK rows each
  float* dl_s = reinterpret_cast<float*>(kv_s + kStages * 2 * NK * LD);

  const int t0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int G = group;
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_row0 = (static_cast<size_t>(b) * hkv * G + hh) * tq;
  const size_t kv_row0 = (static_cast<size_t>(b) * hkv + hh / G) * tk;

  for (int i = tid; i < BQ * CPR; i += NTHR) {
    const int r = i / CPR, c = i - r * CPR, t = t0 + r;
    const bool in = t < tq;
    const size_t off = (q_row0 + (in ? t : 0)) * D + c * 8;
    cp_async16(q_s + r * LD + c * 8, q + off, in ? 16 : 0);
    cp_async16(do_s + r * LD + c * 8, dout + off, in ? 16 : 0);
  }
  cp_async_commit();

  // the keys these rows can see: [j_lo, j_hi)
  const int t_last = min(t0 + BQ, tq) - 1;
  const int j_lo = has_window ? max(0, q_off + t0 - window + 1) : 0;
  const int j_hi = causal ? min(tk, q_off + t_last + 1) : tk;
  const int n_tiles = j_hi > j_lo ? (j_hi - j_lo + NK - 1) / NK : 0;
  auto stage = [&](int jt, int buf) {
    bf16* ks = kv_s + buf * 2 * NK * LD;
    bf16* vs = ks + NK * LD;
    for (int i = tid; i < NK * CPR; i += NTHR) {
      const int r = i / CPR, c = i - r * CPR, j = jt + r;
      const bool in = j < tk;
      const size_t off = (kv_row0 + (in ? j : 0)) * D + c * 8;
      cp_async16(ks + r * LD + c * 8, k + off, in ? 16 : 0);
      cp_async16(vs + r * LD + c * 8, v + off, in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) stage(j_lo, 0);

  // delta, two threads a row, 16-byte loads of O and dO
  {
    const int r = tid >> 1, t = t0 + r;
    float acc = 0.f;
    if (t < tq) {
      const uint4* o_row = reinterpret_cast<const uint4*>(out + (q_row0 + t) * D);
      const uint4* g_row = reinterpret_cast<const uint4*>(dout + (q_row0 + t) * D);
      for (int c = tid & 1; c < CPR; c += 2) {
        const uint4 ov = o_row[c], gv = g_row[c];
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[w]));
          const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[w]));
          acc = fmaf(of.x, gf.x, acc);
          acc = fmaf(of.y, gf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      dl_s[r] = acc;
      if (t < tq) delta[q_row0 + t] = acc;
    }
  }

  // this lane's two rows of the warp's 16 (the accumulators' rows lane / 4 and + 8)
  const int r_a = warp * 16 + (lane >> 2);
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + r_a + 8 * i;
    lse2[i] = t < tq ? lse[q_row0 + t] * kLog2e : 0.f;
  }
  const float sl2 = scale * kLog2e;
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  float dlt[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int jt = j_lo + it * NK;
    if (it + 1 < n_tiles) {
      stage(jt + NK, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      dlt[0] = dl_s[r_a];
      dlt[1] = dl_s[r_a + 8];
    }
    const bf16* ks = kv_s + (it & 1) * 2 * NK * LD;
    const bf16* vs = ks + NK * LD;

    // S = Q . K^T and dP = dO . V^T over the warp's 16 rows and the tile's keys
    float s[NK / 8][4], dp[NK / 8][4];
#pragma unroll
    for (int n = 0; n < NK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t aq[4], ao[4];
      const int a_off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kd * 16 +
                        (lane >> 4) * 8;
      ldsm_x4(aq, q_s + a_off);
      ldsm_x4(ao, do_s + a_off);
#pragma unroll
      for (int nj = 0; nj < NK / 16; ++nj) {
        uint32_t bk[4], bv[4];
        const int b_off = (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kd * 16 +
                          ((lane >> 3) & 1) * 8;
        ldsm_x4(bk, ks + b_off);
        ldsm_x4(bv, vs + b_off);
        mma_bf16(s[2 * nj], aq, bk[0], bk[1]);
        mma_bf16(s[2 * nj + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * nj], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * nj + 1], ao, bv[2], bv[3]);
      }
    }
    // dS / scale = P o (dP - delta) in place, dead pairs zero by liveness
    const bool all_live = t0 + BQ <= tq && jt + NK <= tk &&
                          (!causal || jt + NK - 1 <= q_off + t0) &&
                          (!has_window || jt > q_off + t0 + BQ - 1 - window);
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, j = jt + n * 8 + (lane & 3) * 2 + (e & 1);
        const bool live = all_live ||
                          live_pair(t0 + r_a + 8 * i, j, tq, tk, q_off, causal, has_window, window);
        s[n][e] = live ? exp2f(fmaf(s[n][e], sl2, -lse2[i])) * (dp[n][e] - dlt[i]) : 0.f;
      }
    }
    // dQ += dS . K: the accumulators of keys 16 kk .. 16 kk + 15 are the A
    // operand, as hi + lo bf16 terms
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t d_hi[4], d_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * kk + (i >> 1), e = (i & 1) * 2;
        split_bf16x2(s[n][e], s[n][e + 1], d_hi[i], d_lo[i]);
      }
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + nd * 16 +
                              (lane >> 4) * 8);
        mma_bf16(dq_acc[2 * nd], d_hi, bk[0], bk[1]);
        mma_bf16(dq_acc[2 * nd + 1], d_hi, bk[2], bk[3]);
        mma_bf16(dq_acc[2 * nd], d_lo, bk[0], bk[1]);
        mma_bf16(dq_acc[2 * nd + 1], d_lo, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the next iteration restages this buffer
  }
  if (n_tiles == 0) cp_async_wait<0>();  // Q and dO land before the block ends

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + r_a + 8 * i;
    if (t >= tq) continue;
    bf16* dst = dq + (q_row0 + t) * D + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
    }
  }
}

template <int D>
cudaError_t prepare_dkdv(size_t* smem) {
  *smem = kv_smem<D>();
  static size_t opted[kMaxDevices] = {};
  return set_smem(dkdv_mma_kernel<D>, *smem, opted);
}

// dQ (and delta), then dK / dV over ``splits`` splits of each key tile's
// walk, then, with more than one split, the fold of ws into dK and dV.
template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, const float* lse, float* delta, void* dq, void* dk,
                           void* dv, float* ws, int splits, const void* q_off_ptr, int q_off,
                           int batch, int hq, int hkv, int tq, int tk, int causal,
                           int has_window, int window, float scale, cudaStream_t stream) {
  const int G = hq / hkv;
  {
    static size_t opted[kMaxDevices] = {};
    constexpr size_t smem = q_smem<D>();
    cudaError_t e = set_smem(dq_mma_kernel<D>, smem, opted);
    if (e != cudaSuccess) return e;
    dq_mma_kernel<D><<<dim3((tq + kQRows - 1) / kQRows, hq, batch), kQThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse, delta,
        static_cast<bf16*>(dq), static_cast<const int*>(q_off_ptr), q_off, hkv, G, tq, tk,
        causal, has_window, window, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  size_t smem = 0;
  cudaError_t e = prepare_dkdv<D>(&smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (tk + kKvKeys - 1) / kKvKeys;
  if (tiles * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  dkdv_mma_kernel<D><<<dim3(static_cast<unsigned>(tiles * splits), hkv, batch),
                       KvThreads<D>::value, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      ws, splits, static_cast<const int*>(q_off_ptr), q_off, hkv, G, tq, tk, causal,
      has_window, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long n4 = static_cast<long long>(batch) * hkv * tk * D / 4;
  const long long blocks = (2 * n4 + kFoldThreads - 1) / kFoldThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fold_splits_kernel<<<static_cast<unsigned>(blocks), kFoldThreads, 0, stream>>>(
      ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n4, splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkdv_occupancy(int* blocks) {
  size_t smem = 0;
  const cudaError_t e = prepare_dkdv<D>(&smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dkdv_mma_kernel<D>,
                                                       KvThreads<D>::value, smem);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout and the gradients
// share it). lse is the forward's (B, Hq, Tq) f32 log-sum-exp of the scaled
// scores (-1e30 on a row with no live key); delta is (B, Hq, Tq) f32
// scratch. ``splits`` (bf16: 1 .. kMaxSplits; f32: 1) cuts each key tile's
// dK/dV walk; with more than one, ws holds 2 x splits x B x Hkv x Tk x D
// floats of partials. q_offset_ptr points at one int32 on the device, or is
// null and q_offset is used. bf16 tensors start on 16-byte boundaries.
// Returns the cudaError_t of the launches (0 on success); nothing here
// synchronizes.
int repro_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                              const void* out, const void* dout, const float* lse,
                              float* delta, void* dq, void* dk, void* dv, float* ws,
                              int splits, const void* q_offset_ptr, int q_offset, int batch,
                              int hq, int hkv, int tq, int tk, int head_dim, int causal,
                              int has_window, int window, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || batch > 65535 || hkv <= 0 ||
      hq % hkv != 0 || hq > 65535 || tq <= 0 || tk <= 0 || splits < 1 ||
      splits > (dtype == 0 ? 1 : kMaxSplits) || (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only these launches' errors to them
  const auto st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(DIM)                                                                     \
  case DIM:                                                                                \
    return static_cast<int>(                                                               \
        dtype == 0                                                                         \
            ? launch_bwd<float, DIM>(q, k, v, out, dout, lse, delta, dq, dk, dv,           \
                                     q_offset_ptr, q_offset, batch, hq, hkv, tq, tk,       \
                                     causal, has_window, window, scale, st)                \
            : launch_bwd_mma<DIM>(q, k, v, out, dout, lse, delta, dq, dk, dv, ws, splits, \
                                  q_offset_ptr, q_offset, batch, hq, hkv, tq, tk, causal,  \
                                  has_window, window, scale, st));
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

// Blocks of the bf16 dK/dV kernel at ``head_dim`` that fit on one SM at once,
// registers and shared memory included, into *blocks: the planner splits a
// grid that is under this times the SMs.
int repro_flash_bwd_blocks_per_sm(int head_dim, int* blocks) {
  if (blocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  switch (head_dim) {
    case 16: return static_cast<int>(dkdv_occupancy<16>(blocks));
    case 32: return static_cast<int>(dkdv_occupancy<32>(blocks));
    case 64: return static_cast<int>(dkdv_occupancy<64>(blocks));
    case 112: return static_cast<int>(dkdv_occupancy<112>(blocks));
    case 128: return static_cast<int>(dkdv_occupancy<128>(blocks));
    case 256: return static_cast<int>(dkdv_occupancy<256>(blocks));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
