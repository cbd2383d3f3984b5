// The backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), ngroups
// 1, with a plain C interface loaded through ctypes
// (repro_torch/kernels/ssd_scan.py holds the wrapper, SSDScanFn and the plain
// twin ssd_bwd_torch it is held against, chunk for chunk).
//
// What it replaces: the gradient the reference gets by autodiff of its
// chunked jnp twin (src/repro/kernels/ops.py:437::ssd_jnp). Given dy and an
// optional gradient of the final state, it returns dx, ddt, dA, dB, dC and the
// initial state's gradient. Per head h and 64-step chunk, with s the running
// sum of dt * A inside the chunk, e_t = exp(s_t), w_u = exp(s_Q - s_u) dt_u,
// L[t, u] = exp(min(s_t - s_u, 0)) for u <= t, CB = C . B^T:
//   S_c    the state entering chunk c (the forward's carry),
//   Lam_c  the adjoint of the state leaving chunk c: Lam_{c-1} = exp(s_Q) Lam_c
//          + sum_t e_t dy_t C_t^T, from the final state's gradient;
//   dM = dy . x^T, M = CB o L o dt, dCB = dM o L o dt,
//   dx = M^T . dy + w o (B . Lam^T),
//   dC = e o (dy . S) + dCB . B,   dB = w o (x . Lam) + dCB^T . C,
//   ds (the log-decay adjoint) from e, from L (Z = dM o M: + row sums at t,
//   - column sums at u), from exp(s_Q) (Lam o S) and from w; r its reverse
//   cumsum inside the chunk; ddt = sum_t dM CB L + exp(s_Q - s) (x . Lam . B)
//   + A r and dA = sum_u dt r.
//
// Layout: x, dy, dx (b, t, h, p) and B, C, dB, dC (b, t, n) in T (float or
// __nv_bfloat16); dt, ddt (b, t, h), A, dA (h,), the states (b, h, p, n) in
// f32. Workspaces (f32, from the caller): the chunk-start states and the state
// adjoints (b, nc, h, p, n) each, C . B (b, nc, 64, 64), the per-head partials
// of dB and dC (b, t, h, n) each, and dA's per-(sequence, chunk) partials
// (b, nc, h).
//
// Six kernels on one stream, one C entry:
// 1. cb_kernel, a block per (sequence, chunk): C . B^T, the 64 x 64 lower
//    triangle (zeros above), once for every head of the sequence.
// 2. state_pass_kernel<false>, a block per (64 state columns, head,
//    sequence), walking the chunks forward: writes S_c, then S <- exp(s_Q) S +
//    (w o x)^T . B. The state tile (64 x 64) lives in registers.
// 3. state_pass_kernel<true>, the same block walking the chunks backward:
//    writes Lam_c, then Lam <- exp(s_Q) Lam + (e o dy)^T . C; what is left
//    after chunk 0 is the initial state's gradient.
// 4. chunk_kernel, a block per (chunk, head, sequence): every product above
//    for its chunk, the state columns in tiles of 64. Writes dx and ddt, and
//    its head's partials of dB and dC and its (sequence, chunk)'s of dA.
// 5. fold_kernel: dB and dC, the partials summed over the heads in head order.
// 6. fold_da_kernel: dA, the partials summed over (sequence, chunk) in order.
// No float atomics: every sum runs in a fixed order, so two runs give the
// same bits.
//
// The products: in f32, register-tiled FFMA on the CUDA cores (a thread owns
// rows ty + 16 i and columns tx + 16 j of a 64 x 64 output; operands in
// shared memory with rows of 65 floats, so the row-wise and the transposed
// reads are both free of bank conflicts). In bf16, mma.sync m16n8k16 with f32
// accumulation (mm_tc): a warp computes a 16 x 32 piece from the same f32
// tiles; an operand that holds a staged bf16 input (x, dy, B, C) is exact in
// bf16 and enters once, one that holds an f32 value computed here (C . B, M,
// dCB, the states, w o x) enters as a bf16 hi + lo pair (two mma, the
// recipe in ssd_scan.cu); no product has two such operands. The piece goes
// through a shared scratch tile into the CUDA-core layout, so both types share
// every epilogue. Tiles come in with 16-byte loads, all of a stage's tiles in
// flight before any is stored (fetch / put). wgmma, TMA, a ring of stages and
// more than one chunk block an SM are for a later change.
//
// Limits: ngroups 1, head dim p <= 64 (one tile), n <= 256; any t (a ragged
// last chunk is staged as dt = x = dy = B = C = 0, which adds nothing).

#include "common.cuh"

namespace {

constexpr int kQ = 64;          // time steps a chunk
constexpr int kTile = 64;       // rows / columns of a product tile (p, n)
constexpr int kLd = kTile + 1;  // row stride of a staged tile, in floats
constexpr int kMaxP = 64;
constexpr int kMaxState = 256;
constexpr int kThreads = 256;
constexpr int kTileFloats = kQ * kLd;

// kernels/ssd_scan.py's BWD_GEOMETRY, in its order
constexpr int kGeometry[] = {kQ, kTile, kMaxP, kThreads};

// out[i][j] += sum_k A(ty + 16 i, k) B(k, tx + 16 j), k < 64, with A(r, k) at
// a[r * ar + k * ak] and B(k, c) at b[k * bk + c * bc] in shared memory
__device__ __forceinline__ void mm(float (&out)[4][4], const float* a, int ar, int ak,
                                   const float* b, int bk, int bc, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * bk + (tx + 16 * j) * bc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&v)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
}

// The bf16 route of a product: out[i][j] += sum_k A(ty + 16 i, k) B(k, tx +
// 16 j) as mm computes it, on mma.sync. Warp w computes rows 16 (w & 3) and
// columns 32 (w >> 2) onwards; kSplitA / kSplitB: that operand is an f32 value
// and enters as hi + lo (two mma), else it is exact in bf16 (one). The piece
// goes through ``scratch`` (64 rows of kLd floats) into out's layout. Every
// thread of the block calls it (it synchronizes the block twice).
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mm_tc(float (&out)[4][4], const float* a, int ar, int ak,
                                      const float* b, int bk, int bc, float* scratch) {
  static_assert(!(kSplitA && kSplitB), "at most one operand is split");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = (lane & 3) * 2;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  float acc[4][4];
  zero(acc);
#pragma unroll
  for (int k0 = 0; k0 < kTile; k0 += 16) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {  // rows g, g + 8; columns q, q + 8 of the 16 x 16 A
      const int r = r0 + g + 8 * (v & 1), k = k0 + q + 8 * (v >> 1);
      const float x0 = a[r * ar + k * ak], x1 = a[r * ar + (k + 1) * ak];
      if (kSplitA) split_bf16x2(x0, x1, ah[v], al[v]);
      else ah[v] = bf16x2_bits(__floats2bfloat162_rn(x0, x1));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c0 + 8 * nt + g;
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {  // k rows q and q + 8 of the 16 x 8 B
        const int k = k0 + q + 8 * v;
        const float x0 = b[k * bk + col * bc], x1 = b[(k + 1) * bk + col * bc];
        if (kSplitB) split_bf16x2(x0, x1, bh[v], bl[v]);
        else bh[v] = bf16x2_bits(__floats2bfloat162_rn(x0, x1));
      }
      mma_bf16(acc[nt], ah, bh[0], bh[1]);
      if (kSplitA) mma_bf16(acc[nt], al, bh[0], bh[1]);
      if (kSplitB) mma_bf16(acc[nt], ah, bl[0], bl[1]);
    }
  }
  __syncthreads();  // the last product's reads of scratch are done
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float* d = scratch + (r0 + g) * kLd + c0 + 8 * nt + q;
    d[0] = acc[nt][0];
    d[1] = acc[nt][1];
    d[8 * kLd] = acc[nt][2];
    d[8 * kLd + 1] = acc[nt][3];
  }
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] += scratch[(ty + 16 * i) * kLd + tx + 16 * j];
}

// A product on the element type's route: FFMA for f32, mma.sync for bf16.
template <typename T, bool kSplitA, bool kSplitB>
__device__ __forceinline__ void product(float (&out)[4][4], const float* a, int ar, int ak,
                                        const float* b, int bk, int bc, int ty, int tx,
                                        float* scratch) {
  if constexpr (sizeof(T) == 2) {
    mm_tc<kSplitA, kSplitB>(out, a, ar, ak, b, bk, bc, scratch);
  } else {
    mm(out, a, ar, ak, b, bk, bc, ty, tx);
  }
}

// A 64 x 64 tile into dst (row stride kLd) as f32: dst[r][k] = src[r * stride +
// k] for r < rows and k < cols, zeros elsewhere.
template <typename S>
__device__ __forceinline__ void stage(float* dst, const S* src, size_t stride, int rows, int cols) {
  for (int i = threadIdx.x; i < kQ * kTile; i += kThreads) {
    const int r = i >> 6, k = i & 63;
    dst[r * kLd + k] = (r < rows && k < cols) ? to_f32(src[r * stride + k]) : 0.f;
  }
}

// A tile staged in two steps, so that the loads of several tiles are in
// flight together: fetch() issues a whole, 16-byte aligned tile's loads into
// registers (16 bytes a load, kLoads a thread) and put() writes them to its
// destination as f32; any other tile fetch() stages at once, element by
// element, and put() has nothing left to do. Fetch after the barrier that
// frees the destination.
template <typename S>
struct Fetch {
  static constexpr int kVec = 16 / sizeof(S);              // elements a load
  static constexpr int kLoads = kQ * kTile / kVec / kThreads;
  uint4 v[kLoads];
  float* dst;
  bool vec;
};

template <typename S>
__device__ __forceinline__ void fetch(Fetch<S>& f, float* dst, const S* src, size_t stride,
                                      int rows, int cols) {
  constexpr int kPerRow = kTile / Fetch<S>::kVec;
  f.dst = dst;
  f.vec = cols == kTile && stride % Fetch<S>::kVec == 0 &&
          (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (!f.vec) {
    stage(dst, src, stride, rows, cols);
    return;
  }
#pragma unroll
  for (int it = 0; it < Fetch<S>::kLoads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / kPerRow;
    const int k = (i % kPerRow) * Fetch<S>::kVec;
    f.v[it] = r < rows ? __ldg(reinterpret_cast<const uint4*>(src + r * stride + k))
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename S>
__device__ __forceinline__ void put(const Fetch<S>& f) {
  constexpr int kPerRow = kTile / Fetch<S>::kVec;
  if (!f.vec) return;
#pragma unroll
  for (int it = 0; it < Fetch<S>::kLoads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / kPerRow;
    float* d = f.dst + r * kLd + (i % kPerRow) * Fetch<S>::kVec;
    const uint32_t w[4] = {f.v[it].x, f.v[it].y, f.v[it].z, f.v[it].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (sizeof(S) == 4) {
        d[q] = __uint_as_float(w[q]);
      } else {  // two bf16, the low one first: an f32 is a bf16 with 16 more zero bits
        d[2 * q] = __uint_as_float(w[q] << 16);
        d[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
      }
    }
  }
}

// the 16 lanes of a half-warp (one ty) summed
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The running sums s of dt * A over a chunk (one thread, in step order) into
// ss; dts holds the chunk's dt (zeros past the sequence).
__device__ __forceinline__ void chunk_sums(const float* dts, float a, float* ss) {
  float s = 0.f;
  for (int u = 0; u < kQ; ++u) {
    s += dts[u] * a;
    ss[u] = s;
  }
}

template <typename T>
struct Params {
  const T* x;
  const float* dt;
  const float* A;
  const T* Bm;
  const T* Cm;
  const T* dy;
  const float* s0;   // may be null
  const float* dsf;  // may be null
  T* dx;
  float* ddt;
  float* dA;
  T* dB;
  T* dC;
  float* ds0;        // may be null
  float* states;     // b x nc x h x p x n
  float* lams;       // b x nc x h x p x n
  float* cb;         // b x nc x 64 x 64
  float* dbp;        // b x t x h x n
  float* dcp;        // b x t x h x n
  float* dap;        // b x nc x h
  int batch, t_len, heads, hdim, N, nc;
};

// ---------------------------------------------------------------------------------
// 1. C . B^T a (sequence, chunk)
// ---------------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) cb_kernel(const Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;
  float* bs = cs + kTileFloats;
  float* scr = bs + kTileFloats;
  const int c = blockIdx.x, b = blockIdx.y, c0 = c * kQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int rows = min(kQ, p.t_len - c0);
  const size_t tok = static_cast<size_t>(b) * p.t_len + c0;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    __syncthreads();
    Fetch<T> fc, fb;
    fetch(fc, cs, p.Cm + tok * p.N + n0, p.N, rows, min(kTile, p.N - n0));
    fetch(fb, bs, p.Bm + tok * p.N + n0, p.N, rows, min(kTile, p.N - n0));
    put(fc);
    put(fb);
    __syncthreads();
    product<T, false, false>(acc, cs, kLd, 1, bs, 1, kLd, ty, tx, scr);  // C[t][n] B[u][n]
  }
  float* out = p.cb + (static_cast<size_t>(b) * p.nc + c) * kQ * kQ;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = ty + 16 * i, u = tx + 16 * j;
      out[t * kQ + u] = u <= t ? acc[i][j] : 0.f;
    }
}

// ---------------------------------------------------------------------------------
// 2. / 3. the state pass (forward: S_c) and the adjoint pass (reverse: Lam_c)
// ---------------------------------------------------------------------------------
template <typename T, bool kRev>
__global__ void __launch_bounds__(kThreads) state_pass_kernel(const Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;               // x (forward) or dy (reverse): [u][p]
  float* ks = vs + kTileFloats;   // B (forward) or C (reverse): [u][n]
  float* dts = ks + kTileFloats;
  float* ss = dts + kQ;
  float* wt = ss + kQ;
  float* scr = wt + kQ;
  const int n0 = blockIdx.x * kTile, hh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int P = p.hdim, N = p.N;
  const int ncols = min(kTile, N - n0);
  const float a = p.A[hh];
  const T* v = kRev ? p.dy : p.x;
  const T* k = kRev ? p.Cm : p.Bm;
  const float* init = kRev ? p.dsf : p.s0;
  float* ws = kRev ? p.lams : p.states;
  // acc[i][j]: state row pp = ty + 16 i, column n0 + tx + 16 j
  float acc[4][4];
  const size_t srow = (static_cast<size_t>(b) * p.heads + hh) * P;  // row (b, h, 0) of a state
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = ty + 16 * i, n = tx + 16 * j;
      acc[i][j] = (init != nullptr && pp < P && n < ncols) ? init[(srow + pp) * N + n0 + n] : 0.f;
    }
  for (int it = 0; it < p.nc; ++it) {
    const int c = kRev ? p.nc - 1 - it : it;
    const int c0 = c * kQ, rows = min(kQ, p.t_len - c0);
    const size_t tok = static_cast<size_t>(b) * p.t_len + c0;
    __syncthreads();  // the last chunk's reads are done
    for (int u = threadIdx.x; u < kQ; u += kThreads)
      dts[u] = u < rows ? p.dt[(tok + u) * p.heads + hh] : 0.f;
    Fetch<T> fv, fk;
    fetch(fv, vs, v + (tok * p.heads + hh) * P, static_cast<size_t>(p.heads) * P, rows, P);
    fetch(fk, ks, k + tok * N + n0, N, rows, ncols);
    put(fv);
    put(fk);
    __syncthreads();
    if (threadIdx.x == 0) chunk_sums(dts, a, ss);
    __syncthreads();
    if (threadIdx.x < kQ) {
      const int u = threadIdx.x;
      wt[u] = kRev ? expf(ss[u]) : expf(ss[kQ - 1] - ss[u]) * dts[u];
    }
    // the state entering chunk c (forward) / the adjoint leaving it (reverse)
    float* out = ws + ((static_cast<size_t>(b) * p.nc + c) * p.heads + hh) * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = ty + 16 * i, n = tx + 16 * j;
        if (pp < P && n < ncols) out[static_cast<size_t>(pp) * N + n0 + n] = acc[i][j];
      }
    __syncthreads();
    const float decay = expf(ss[kQ - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
    if constexpr (sizeof(T) == 2) {  // (w o v)^T . k on mma.sync, w o v split hi + lo
      for (int i = threadIdx.x; i < kQ * kTile; i += kThreads)
        vs[(i >> 6) * kLd + (i & 63)] *= wt[i >> 6];
      __syncthreads();
      mm_tc<true, false>(acc, vs, 1, kLd, ks, kLd, 1, scr);
    } else {
#pragma unroll 4
      for (int u = 0; u < kQ; ++u) {
        const float w = wt[u];
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = vs[u * kLd + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ks[u * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  if (kRev && p.ds0 != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = ty + 16 * i, n = tx + 16 * j;
        if (pp < P && n < ncols) p.ds0[(srow + pp) * N + n0 + n] = acc[i][j];
      }
  }
}

// ---------------------------------------------------------------------------------
// 4. the chunk-local products: a block per (chunk, head, sequence)
// ---------------------------------------------------------------------------------
constexpr int kChunkTiles = 10;
constexpr size_t kChunkSmem =
    sizeof(float) * (static_cast<size_t>(kChunkTiles) * kTileFloats + 9 * kQ + kThreads / 32);

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) chunk_kernel(const Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // x [u][p]
  float* dys = xs + kTileFloats;    // dy [t][p]
  float* ys = dys + kTileFloats;    // CB [t][u], then Y = dM o CB o L
  float* ms = ys + kTileFloats;     // M [t][u]
  float* dcbs = ms + kTileFloats;   // dCB [t][u]
  float* bts = dcbs + kTileFloats;  // B tile [u][n]
  float* cts = bts + kTileFloats;   // C tile [t][n]
  float* s0s = cts + kTileFloats;   // S_c tile [p][n]
  float* lts = s0s + kTileFloats;   // Lam_c tile [p][n]
  float* scr = lts + kTileFloats;   // mm_tc's scratch (bf16)
  float* dts = scr + kTileFloats;
  float* ss = dts + kQ;
  float* ee = ss + kQ;
  float* ww = ee + kQ;
  float* zrow = ww + kQ;    // sum_u Z[t][u]
  float* coly = zrow + kQ;  // sum_t Y[t][u]
  float* cdys = coly + kQ;  // sum_n C[t][n] (dy . S)[t][n]
  float* xlb = cdys + kQ;   // sum_n (x . Lam)[u][n] B[u][n]
  float* dsv = xlb + kQ;
  float* red = dsv + kQ;    // one a warp

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int P = p.hdim, N = p.N;
  const int c0 = c * kQ, rows = min(kQ, p.t_len - c0);
  const size_t tok = static_cast<size_t>(b) * p.t_len + c0;
  const size_t xstride = static_cast<size_t>(p.heads) * P;
  const float a = p.A[hh];

  for (int u = tid; u < kQ; u += kThreads) dts[u] = u < rows ? p.dt[(tok + u) * p.heads + hh] : 0.f;
  {
    Fetch<T> fx, fdy;
    Fetch<float> fcb;
    fetch(fx, xs, p.x + (tok * p.heads + hh) * P, xstride, rows, P);
    fetch(fdy, dys, p.dy + (tok * p.heads + hh) * P, xstride, rows, P);
    fetch(fcb, ys, p.cb + (static_cast<size_t>(b) * p.nc + c) * kQ * kQ, kQ, kQ, kQ);
    put(fx);
    put(fdy);
    put(fcb);
  }
  __syncthreads();
  if (tid == 0) chunk_sums(dts, a, ss);
  __syncthreads();
  if (tid < kQ) {
    ee[tid] = expf(ss[tid]);
    ww[tid] = expf(ss[kQ - 1] - ss[tid]) * dts[tid];
  }

  // dM, then M, dCB, Y = dM o CB o L (Z = Y o dt) on the thread's own tile
  float dm[4][4];
  zero(dm);
  product<T, false, false>(dm, dys, kLd, 1, xs, 1, kLd, ty, tx, scr);  // dy[t][p] x[u][p]
  float mv[4][4], dcb[4][4], yv[4][4], zr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    zr[i] = 0.f;
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = tx + 16 * j;
      const float l = u <= t ? expf(fminf(ss[t] - ss[u], 0.f)) : 0.f;
      const float cbv = ys[t * kLd + u], d = dts[u];
      mv[i][j] = cbv * l * d;
      dcb[i][j] = dm[i][j] * l * d;
      yv[i][j] = dm[i][j] * cbv * l;
      zr[i] += yv[i][j] * d;
    }
  }
  __syncthreads();  // every read of CB is done
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = tx + 16 * j;
      ms[t * kLd + u] = mv[i][j];
      dcbs[t * kLd + u] = dcb[i][j];
      ys[t * kLd + u] = yv[i][j];
    }
    const float z = half_warp_sum(zr[i]);
    if (tx == 0) zrow[t] = z;
  }
  __syncthreads();
  if (tid < kQ) {
    float s = 0.f;
    for (int t = 0; t < kQ; ++t) s += ys[t * kLd + tid];
    coly[tid] = s;
  }

  // dx's first term: M^T . dy
  float dxa[4][4], bl[4][4];
  zero(dxa);
  zero(bl);
  product<T, true, false>(dxa, ms, 1, kLd, dys, kLd, 1, ty, tx, scr);  // M[t][u] dy[t][p]

  // the state columns, a tile of 64 at a time
  float cd[4] = {0.f, 0.f, 0.f, 0.f}, xb[4] = {0.f, 0.f, 0.f, 0.f}, ls = 0.f;
  const size_t srow = ((static_cast<size_t>(b) * p.nc + c) * p.heads + hh) * P;  // (b, c, h, 0)
  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int ncols = min(kTile, N - n0);
    __syncthreads();  // the last tile's reads are done
    Fetch<T> fb, fc;
    Fetch<float> fs, fl;
    fetch(fb, bts, p.Bm + tok * N + n0, N, rows, ncols);
    fetch(fc, cts, p.Cm + tok * N + n0, N, rows, ncols);
    fetch(fs, s0s, p.states + srow * N + n0, N, P, ncols);
    fetch(fl, lts, p.lams + srow * N + n0, N, P, ncols);
    put(fb);
    put(fc);
    put(fs);
    put(fl);
    __syncthreads();
    float dys_t[4][4], xl[4][4], acc[4][4];
    zero(dys_t);
    zero(xl);
    product<T, false, true>(dys_t, dys, kLd, 1, s0s, kLd, 1, ty, tx, scr);  // dy[t][p] S[p][n]
    product<T, false, true>(xl, xs, kLd, 1, lts, kLd, 1, ty, tx, scr);      // x[u][p] Lam[p][n]
    product<T, false, true>(bl, bts, kLd, 1, lts, 1, kLd, ty, tx, scr);     // B[u][n] Lam[p][n]
    // dC = e o (dy . S) + dCB . B, this head's partial
    zero(acc);
    product<T, true, false>(acc, dcbs, kLd, 1, bts, kLd, 1, ty, tx, scr);  // dCB[t][u] B[u][n]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        cd[i] += cts[t * kLd + n] * dys_t[i][j];
        xb[i] += xl[i][j] * bts[t * kLd + n];
        ls += lts[t * kLd + n] * s0s[t * kLd + n];
        if (t < rows && n < ncols)
          p.dcp[((tok + t) * p.heads + hh) * N + n0 + n] = ee[t] * dys_t[i][j] + acc[i][j];
      }
    }
    // dB = w o (x . Lam) + dCB^T . C, this head's partial
    zero(acc);
    product<T, true, false>(acc, dcbs, 1, kLd, cts, kLd, 1, ty, tx, scr);  // dCB[t][u] C[t][n]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (u < rows && n < ncols)
          p.dbp[((tok + u) * p.heads + hh) * N + n0 + n] = ww[u] * xl[i][j] + acc[i][j];
      }
    }
  }
  // dx = M^T . dy + w o (B . Lam^T)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = tx + 16 * j;
      if (u < rows && pp < P)
        p.dx[(tok + u) * xstride + static_cast<size_t>(hh) * P + pp] =
            from_f32<T>(dxa[i][j] + ww[u] * bl[i][j]);
    }
    const float v1 = half_warp_sum(cd[i]), v2 = half_warp_sum(xb[i]);
    if (tx == 0) {
      cdys[u] = v1;
      xlb[u] = v2;
    }
  }
  const float lw = warp_sum(ls);
  if ((tid & 31) == 0) red[tid >> 5] = lw;
  __syncthreads();
  if (tid == 0) {
    float lsum = 0.f, wsum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) lsum += red[w];
    for (int u = 0; u < kQ; ++u) {
      const float wx = ww[u] * xlb[u];
      dsv[u] = ee[u] * cdys[u] + zrow[u] - dts[u] * coly[u] - wx;
      wsum += wx;
    }
    dsv[kQ - 1] += wsum + expf(ss[kQ - 1]) * lsum;
    float r = 0.f, da = 0.f;
    for (int u = kQ - 1; u >= 0; --u) {
      r += dsv[u];
      if (u < rows)
        p.ddt[(tok + u) * p.heads + hh] = coly[u] + expf(ss[kQ - 1] - ss[u]) * xlb[u] + a * r;
      da += dts[u] * r;
    }
    p.dap[(static_cast<size_t>(b) * p.nc + c) * p.heads + hh] = da;
  }
}

// ---------------------------------------------------------------------------------
// 5. / 6. the folds, in a fixed order
// ---------------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) fold_kernel(const Params<T> p) {
  const size_t total = static_cast<size_t>(p.batch) * p.t_len * p.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const size_t bt = i / p.N, n = i - bt * p.N;
  const size_t base = bt * p.heads * p.N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < p.heads; ++h) {
    sb += p.dbp[base + static_cast<size_t>(h) * p.N];
    sc += p.dcp[base + static_cast<size_t>(h) * p.N];
  }
  p.dB[i] = from_f32<T>(sb);
  p.dC[i] = from_f32<T>(sc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fold_da_kernel(const Params<T> p) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= p.heads) return;
  float s = 0.f;
  for (int i = 0; i < p.batch * p.nc; ++i) s += p.dap[static_cast<size_t>(i) * p.heads + h];
  p.dA[h] = s;
}

template <typename T>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  static size_t opted_pass[2][kMaxDevices] = {}, opted_chunk[kMaxDevices] = {},
                opted_cb[kMaxDevices] = {};
  const size_t pass_smem = sizeof(float) * (3 * kTileFloats + 3 * kQ);
  const size_t cb_smem = sizeof(float) * 3 * kTileFloats;
  cudaError_t e = set_smem(cb_kernel<T>, cb_smem, opted_cb);
  if (e == cudaSuccess) e = set_smem(state_pass_kernel<T, false>, pass_smem, opted_pass[0]);
  if (e == cudaSuccess) e = set_smem(state_pass_kernel<T, true>, pass_smem, opted_pass[1]);
  if (e == cudaSuccess) e = set_smem(chunk_kernel<T>, kChunkSmem, opted_chunk);
  if (e != cudaSuccess) return e;
  const int ntiles = (p.N + kTile - 1) / kTile;
  cb_kernel<T><<<dim3(p.nc, p.batch), kThreads, cb_smem, stream>>>(p);
  state_pass_kernel<T, false><<<dim3(ntiles, p.heads, p.batch), kThreads, pass_smem, stream>>>(p);
  state_pass_kernel<T, true><<<dim3(ntiles, p.heads, p.batch), kThreads, pass_smem, stream>>>(p);
  chunk_kernel<T><<<dim3(p.nc, p.heads, p.batch), kThreads, kChunkSmem, stream>>>(p);
  const size_t total = static_cast<size_t>(p.batch) * p.t_len * p.N;
  fold_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(p);
  fold_da_kernel<T><<<(p.heads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy and dx, dB, dC share it). s0
// (the initial state), dsf (the final state's gradient) and ds0 (the initial
// state's gradient, written) may be null. ws: the five f32 workspaces in the
// order states, lams, cb, dbp, dcp, dap (sizes in the header). Launches the
// six kernels on ``stream``; returns the cudaError_t of the launches (0 on
// success); nothing here synchronizes.
int repro_ssd_scan_bwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* dy, const void* s0, const void* dsf, void* dx,
                       void* ddt, void* dA, void* dB, void* dC, void* ds0, void* states,
                       void* lams, void* cb, void* dbp, void* dcp, void* dap, int batch,
                       int t_len, int heads, int head_dim, int n_state, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || batch > 65535 || t_len <= 0 || heads <= 0 ||
      heads > 65535 || head_dim <= 0 || head_dim > kMaxP || n_state <= 0 ||
      n_state > kMaxState || states == nullptr || lams == nullptr || cb == nullptr ||
      dbp == nullptr || dcp == nullptr || dap == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (t_len + kQ - 1) / kQ;
  cudaError_t e;
  if (dtype == 0) {
    const Params<float> p{
        static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const float*>(Bm), static_cast<const float*>(Cm),
        static_cast<const float*>(dy), static_cast<const float*>(s0),
        static_cast<const float*>(dsf), static_cast<float*>(dx), static_cast<float*>(ddt),
        static_cast<float*>(dA), static_cast<float*>(dB), static_cast<float*>(dC),
        static_cast<float*>(ds0), static_cast<float*>(states), static_cast<float*>(lams),
        static_cast<float*>(cb), static_cast<float*>(dbp), static_cast<float*>(dcp),
        static_cast<float*>(dap), batch, t_len, heads, head_dim, n_state, nc};
    e = launch<float>(p, s);
  } else {
    const Params<bf16> p{
        static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy),
        static_cast<const float*>(s0), static_cast<const float*>(dsf), static_cast<bf16*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<bf16*>(dB),
        static_cast<bf16*>(dC), static_cast<float*>(ds0), static_cast<float*>(states),
        static_cast<float*>(lams), static_cast<float*>(cb), static_cast<float*>(dbp),
        static_cast<float*>(dcp), static_cast<float*>(dap), batch, t_len, heads, head_dim,
        n_state, nc};
    e = launch<bf16>(p, s);
  }
  return static_cast<int>(e);
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
