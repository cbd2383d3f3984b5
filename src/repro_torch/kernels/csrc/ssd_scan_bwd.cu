// The backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), ngroups
// 1, with a plain C interface loaded through ctypes
// (repro_torch/kernels/ssd_scan.py holds the wrapper, the head-group planner,
// SSDScanFn and the plain twin ssd_bwd_torch, which folds in the same order).
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
//   ds (the log-decay adjoint) from e (C o (dy . S) row sums), from L (Z = dM
//   o M: + row sums at t, - column sums at u), from exp(s_Q) (Lam o S) and
//   from w (x . Lam o B row sums); r its reverse cumsum inside the chunk;
//   ddt = sum_t dM CB L + exp(s_Q - s) (x . Lam . B) + A r and dA = sum_u dt r.
// With ngroups 1 every head of a sequence shares B, C and C . B, so dB and dC
// are sums over heads: sum_h dCB_h . B is (sum_h dCB_h) . B, and the other
// terms are products whose contraction runs over the heads one after another.
//
// Layout: x, dy, dx (b, t, h, p) and B, C, dB, dC (b, t, n) in T (float or
// __nv_bfloat16); dt, ddt (b, t, h), A, dA (h,), the states (b, h, p, n) in
// f32. Workspaces (from the caller, 4 bytes an element in either type): S_c
// and Lam_c, (b, nc, h, 64, np) each (np = n rounded up to 64, p padded to 64
// with zeros: every tile is whole and on 16 bytes), in bf16 as a hi plane then
// a lo plane (hi + lo = the f32 value to 16 bits), in f32 as f32; the
// group's summed dCB, (b, nc, groups, 64, 64) the same way; the ds pieces a
// head (b, nc, h, 3, 64) f32; the group partials of dB and dC (b, t, groups,
// n) f32, only when there is more than one group; dA's (sequence, chunk)
// partials (b, nc, h).
//
// Five kernels on one stream, one C entry:
// 1. pass_kernel, one launch for both walks: a block (4 warps) per (64 state
//    columns, head, sequence, direction). The forward half walks the chunks
//    up, writing S_c and then S <- exp(s_Q) S + (w o x)^T . B; the reverse half
//    walks them down, writing Lam_c and then Lam <- exp(s_Q) Lam + (e o
//    dy)^T . C; what the reverse half holds after chunk 0 is the initial
//    state's gradient. A chunk's x / dy, B / C and dt come in with 16-byte
//    cp.async into a ring of kStages stages, the next chunk's in flight
//    while this one's product runs; every warp scans s itself (a warp scan,
//    in log2 units); the 64 x 64 state tile lives in the warps' accumulators
//    (warp w: rows 16 w .. 16 w + 15). bf16: (w o x)^T is read by ldmatrix.trans,
//    scaled and split into hi + lo once a chunk, then mma.sync m16n8k16 with
//    f32 accumulation against B (two mma); the state is written as its hi and
//    lo planes, lanes q and q ^ 1 trading a word so that every row's 32 bytes
//    go out as one whole sector (written as two 16-byte halves, the planes'
//    stores took 0.51 of the launch's 0.63 ms at mamba2's shape). f32: FFMA
//    on the same fragment layout.
// 2. lam_kernel, a block per (head group, chunk, sequence): stages B and C
//    once and computes C . B into shared memory (f32, each thread's fragment
//    in a row of its own); then for each head of the group: dM (tiles above
//    the diagonal skipped), M / dCB / Z in the dM accumulators, M split into
//    hi + lo planes once, dx = w o (B . Lam^T) + M^T . dy and dB's w o (x .
//    Lam) term accumulated over the heads in registers, Lam staged a
//    64-column tile at a time (two tiles in flight with x and dy, in the space
//    C leaves); the row sums of Z and of B o (x . Lam) and the column sums of
//    dM o CB o L go to the ds workspace. dCB is summed over the heads in
//    registers; at the end it is split into planes (to shared memory and to
//    its workspace), C is staged again and dB += dCB^T . C. dB is written in
//    T when the group holds every head, else as the group's f32 partial.
// 3. s_kernel, a block per (head group, chunk, sequence): stages B, C and the
//    group's dCB planes; for each head: dy . S (S a 64-column tile at a time,
//    both tiles in flight with dy) consumed in the fragment layout into dC's
//    e o (dy . S) term (accumulated over the heads) and the row sums of C o
//    (dy . S); Lam o S summed over the tile (Lam read from its workspace);
//    then one warp turns the ds pieces into ds, its reverse cumsum (a warp
//    scan), ddt and the head's dA partial. At the end dC += dCB . B.
// 4. fold_kernel (more than one group): dB and dC, the group partials summed
//    in group order.
// 5. fold_da_kernel: dA, the partials summed over (sequence, chunk) in order.
// No float atomics: every sum runs in a fixed order (the mma's own, the heads
// of a group in order, the groups in order), so two runs give the same bits.
//
// The products: bf16 on mma.sync m16n8k16 with f32 accumulation (warp_product):
// a bf16 input (x, dy, B, C) enters as staged, an f32 value computed here (M,
// dCB, S_c, Lam_c) as its hi + lo planes, split once where it is produced
// (two mma; no product has two such operands). Operands are staged bf16 with
// rows padded by 16 bytes, so ldmatrix and ldmatrix.trans read 8 rows from 8
// bank groups. Accumulators are consumed where they lie (the mma fragment
// layout) by every epilogue: no product goes through a scratch tile. f32
// (no TF32): FFMA on the CUDA cores in the same fragment layout, operands f32
// in shared memory with rows padded by 16 bytes.
//
// Head groups: the wrapper picks G heads a group (ssd_scan.py::bwd_head_groups,
// checked here against head_group_size): G = ceil(heads / want), where want
// groups would make batch x nc x groups reach kFillBlocks blocks (two blocks
// an SM, two waves on 132 SMs), at most one a head; a head count G does not
// divide gets a short last group.
//
// What bounds it on an H100: at mamba2-780m's training shape (4, 2048, 48,
// 64), N 128, bf16 by bytes (the inputs read once, the outputs written once:
// 0.0485 ms), f32 by operations (0.628 ms on the FMA pipes). Workspaces: 459.8
// MB a call at that shape (ssd_scan.py::bwd_workspace_bytes). The bytes the
// design still moves through them: S_c and Lam_c, 201 MB each, written once
// and read once (0.24 ms of the memory's time at 3.35 TB/s), because the
// chunk-local products need both states for every chunk and keeping either on
// chip would walk the chunks in series; s_kernel reads Lam_c once more for Lam
// o S (201 MB); the group partials of dB and dC are 21 MB each at 5 groups,
// the dCB planes 10.5 MB, the ds pieces 4.7 MB. The measured times and
// scripts/time_scan_bwd.py --phases' cuts are in PERF.md.
//
// Limits: ngroups 1, head dim p <= 64 (one tile), n <= 256 (np <= 128: 8 warps
// a chunk block, at most 113 KB of shared memory in bf16, two blocks an SM;
// np 256: 16 warps, one block an SM); any t (a ragged last chunk is staged as
// dt = x = dy = B = C = 0, which adds nothing).

#include "common.cuh"

namespace {

constexpr int kQ = 64;            // time steps a chunk
constexpr int kNT = 64;           // state columns a tile
constexpr int kMaxP = 64;
constexpr int kMaxState = 256;
constexpr int kPassThreads = 128;  // pass_kernel: a warp per 16 rows of the 64 x 64 state tile
// pass_kernel's ring; scripts/time_scan_bwd.py --phases times 4 stages (no
// faster at mamba2-780m's shape: bf16 0.8139 ms against 0.8165 for the
// whole backward, f32 slower)
constexpr int kStages = 2;
constexpr int kChunkThreads = 256;  // lam_kernel / s_kernel at np <= 128 (512 at np 256)
constexpr int kFillBlocks = 528;    // chunk-kernel blocks the head groups aim for
constexpr float kLog2e = 1.4426950408889634f;

// kernels/ssd_scan.py's BWD_GEOMETRY, in its order
constexpr int kGeometry[] = {kQ, kNT, kMaxP, kPassThreads, kStages, kChunkThreads, kFillBlocks};

template <typename T> constexpr bool kBf16 = sizeof(T) == 2;
template <typename T> constexpr int kPad = 16 / static_cast<int>(sizeof(T));  // 16 bytes of T
template <typename T> constexpr int kPlanes = kBf16<T> ? 2 : 1;

int head_group_size(int batch, int nc, int heads) {
  const long long pairs = static_cast<long long>(batch) * nc;
  const long long want = (kFillBlocks + pairs - 1) / pairs;
  const long long groups = want < 1 ? 1 : (want > heads ? heads : want);
  return static_cast<int>((heads + groups - 1) / groups);
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
  T* st;             // S_c planes: b x nc x h x 64 x np (hi, then lo in bf16)
  T* lam;            // Lam_c planes, the same
  T* dcb;            // the groups' summed dCB: b x nc x groups x 64 x 64 (hi, then lo)
  float* aux;        // b x nc x h x 3 x 64: Z row sums, dM o CB o L column sums, x . Lam . B
  float* dbp;        // b x t x groups x n (null with one group)
  float* dcp;
  float* dap;        // b x nc x h
  int batch, t_len, heads, hdim, N, nc, np, G, groups;
  size_t st_plane, dcb_plane;  // elements a plane (the lo plane's offset)
  int vx;  // x, dy, dx rows on 16 bytes: cp.async and paired stores
  int vb;  // B, C rows on 16 bytes
};

// Stage kQ rows of ``cols`` elements (a multiple of 16 bytes) from src (row r
// at src + r * stride) into dst (row stride ld); rows at or past ``rows`` and
// columns past ``width`` are zeros. ``vec``: rows on 16 bytes, with cp.async
// (commit after); else element by element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, size_t stride, int rows,
                                      int cols, int width, bool vec) {
  constexpr int kEl = kPad<T>;
  if (vec) {
    const int per = cols / kEl;
    for (int i = threadIdx.x; i < kQ * per; i += blockDim.x) {
      const int r = i / per, k = (i - r * per) * kEl;
      const bool live = r < rows && k < width;
      cp_async16(dst + r * ld + k, live ? src + r * stride + k : src, live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kQ * cols; i += blockDim.x) {
      const int r = i / cols, k = i - r * cols;
      dst[r * ld + k] = (r < rows && k < width) ? src[r * stride + k] : from_f32<T>(0.f);
    }
  }
}

// a chunk's dt (zeros past the sequence) with 4-byte cp.async
__device__ __forceinline__ void stage_dt(float* dst, const float* dt, size_t tok, int heads,
                                         int hh, int rows) {
  for (int u = threadIdx.x; u < kQ; u += blockDim.x) {
    const bool live = u < rows;
    cp_async4(dst + u, live ? dt + (tok + u) * heads + hh : dt, live ? 4 : 0);
  }
}

// The running sums of dt * A over a chunk, in log2 units (s2 = s log2 e), by
// one warp: lane l holds s2 at steps 2 l and 2 l + 1 and dt there; ``last`` is
// s2 at the chunk's last step, in every lane.
struct ChunkScan {
  float sa, sb, last, da, db;
};
__device__ __forceinline__ ChunkScan scan_chunk(const float* dts, float a2, int lane) {
  const float2 d = *reinterpret_cast<const float2*>(dts + 2 * lane);
  const float l0 = d.x * a2, l1 = d.y * a2;
  float incl = l0 + l1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  return {incl - (l0 + l1) + l0, incl, __shfl_sync(0xffffffffu, incl, 31), d.x, d.y};
}
// the pair (v[2 k], v[2 k + 1]) of a value held two steps a lane
__device__ __forceinline__ float2 step_pair(float va, float vb, int k) {
  return make_float2(__shfl_sync(0xffffffffu, va, k), __shfl_sync(0xffffffffu, vb, k));
}
// s2 at step t
__device__ __forceinline__ float step_at(const ChunkScan& sc, int t) {
  const float2 v = step_pair(sc.sa, sc.sb, t >> 1);
  return (t & 1) ? v.y : v.x;
}

// ---------------------------------------------------------------------------------
// a warp's product: acc[j] += A(m0 .. m0 + 15, k) B(k, n0 + 8 j .. + 7), k in [k0, k1)
// ---------------------------------------------------------------------------------
// acc[j][e]: row m0 + g + 8 (e >> 1), column n0 + 8 j + 2 q + (e & 1) (the
// mma.sync accumulator layout, g = lane / 4, q = lane % 4). A (m x k) in
// shared memory: kRowA, A(m, k) at a[m * lda + k], else at a[k * lda + m]; B
// (k x n): kRowB, B(k, n) at b[k * ldb + n], else at b[n * ldb + k]. bf16: a
// split operand's lo plane lies ``a_lo`` / ``b_lo`` elements past its hi plane
// (two mma); f32: every operand is exact, FFMA. Column pairs (16 columns) from
// ``n_live`` on are skipped (zero past a triangle). k0, k1: multiples of 16.
template <typename T, int NT, bool kRowA, bool kRowB, bool kSplitA, bool kSplitB>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4], const T* a, int lda, int a_lo,
                                             const T* b, int ldb, int b_lo, int m0, int n0, int k0,
                                             int k1, int n_live) {
  static_assert(NT % 2 == 0, "column pairs");
  static_assert(!(kSplitA && kSplitB), "at most one split operand");
  const int lane = threadIdx.x & 31;
  if constexpr (kBf16<T>) {
    for (int k = k0; k < k1; k += 16) {
      uint32_t ah[4], al[4];
      const int aoff = kRowA ? (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * lda + k + (lane >> 4) * 8
                             : (k + (lane & 7) + ((lane >> 4) & 1) * 8) * lda + m0 +
                                   ((lane >> 3) & 1) * 8;
      if (kRowA) ldsm_x4(ah, a + aoff); else ldsm_x4_trans(ah, a + aoff);
      if (kSplitA) {
        if (kRowA) ldsm_x4(al, a + a_lo + aoff); else ldsm_x4_trans(al, a + a_lo + aoff);
      }
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        const int c0 = n0 + 16 * j2;
        if (c0 >= n_live) break;
        uint32_t bh[4], bl[4];
        const int boff = kRowB ? (k + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + c0 + (lane >> 4) * 8
                               : (c0 + (lane & 7) + (lane >> 4) * 8) * ldb + k +
                                     ((lane >> 3) & 1) * 8;
        if (kRowB) ldsm_x4_trans(bh, b + boff); else ldsm_x4(bh, b + boff);
        mma_bf16(acc[2 * j2], ah, bh[0], bh[1]);
        mma_bf16(acc[2 * j2 + 1], ah, bh[2], bh[3]);
        if (kSplitA) {
          mma_bf16(acc[2 * j2], al, bh[0], bh[1]);
          mma_bf16(acc[2 * j2 + 1], al, bh[2], bh[3]);
        }
        if (kSplitB) {
          if (kRowB) ldsm_x4_trans(bl, b + b_lo + boff); else ldsm_x4(bl, b + b_lo + boff);
          mma_bf16(acc[2 * j2], ah, bl[0], bl[1]);
          mma_bf16(acc[2 * j2 + 1], ah, bl[2], bl[3]);
        }
      }
    }
  } else {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float a0 = kRowA ? a[(m0 + g) * lda + k] : a[k * lda + m0 + g];
      const float a1 = kRowA ? a[(m0 + g + 8) * lda + k] : a[k * lda + m0 + g + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        if (n0 + 16 * (j / 2) >= n_live) break;
        float b0, b1;
        if (kRowB) {
          const float2 v = *reinterpret_cast<const float2*>(b + k * ldb + col);
          b0 = v.x, b1 = v.y;
        } else {
          b0 = b[col * ldb + k], b1 = b[(col + 1) * ldb + k];
        }
        acc[j][0] = fmaf(a0, b0, acc[j][0]);
        acc[j][1] = fmaf(a0, b1, acc[j][1]);
        acc[j][2] = fmaf(a1, b0, acc[j][2]);
        acc[j][3] = fmaf(a1, b1, acc[j][3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&v)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
}

// An f32 pair at (row, col), (row, col + 1) into a plane pair: bf16 hi / lo
// (plane ``lo`` elements apart), or f32.
template <typename T>
__device__ __forceinline__ void put_pair(T* dst, size_t lo, float v0, float v1) {
  if constexpr (kBf16<T>) {
    uint32_t hi, lw;
    split_bf16x2(v0, v1, hi, lw);
    *reinterpret_cast<uint32_t*>(dst) = hi;
    *reinterpret_cast<uint32_t*>(dst + lo) = lw;
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  }
}

// (v0, v1) into out[0], out[1] (out[1] only when col + 1 < width), as a pair
// where ``pair`` (rows on 4 bytes) says so
template <typename T>
__device__ __forceinline__ void store_two(T* out, float v0, float v1, int col, int width,
                                          bool pair) {
  if (col >= width) return;
  if (pair && col + 1 < width) {
    if constexpr (kBf16<T>) {
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
    } else {
      *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
    }
  } else {
    out[0] = from_f32<T>(v0);
    if (col + 1 < width) out[1] = from_f32<T>(v1);
  }
}

// Two bf16 words of one row from two n8 accumulator tiles (a: columns 2 q,
// 2 q + 1; b: 8 + 2 q, 8 + 2 q + 1) into out[0 .. 15]: lanes q and q ^ 1 trade
// a word, so each lane stores 8 bytes and a row's 32 bytes go out as one
// whole sector, not as two 16-byte halves from two instructions.
// Every lane calls it; ``live`` says whether it stores.
__device__ __forceinline__ void store_words16(bf16* out, uint32_t a, uint32_t b, int q,
                                              bool live) {
  const bool odd = q & 1;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
  if (live)
    *reinterpret_cast<uint2*>(out + (odd ? 8 + 2 * (q - 1) : 2 * q)) =
        odd ? make_uint2(got, b) : make_uint2(a, got);
}

// One row's values of two n8 accumulator tiles (v0, v1 at columns 2 q, 2 q +
// 1; v2, v3 at 8 + 2 q, 8 + 2 q + 1) into a plane pair's out[0 .. 15]: bf16 hi /
// lo (planes ``lo`` elements apart) by store_words16, or f32.
template <typename T>
__device__ __forceinline__ void put_row16(T* out, size_t lo, float v0, float v1, float v2,
                                          float v3, int q) {
  if constexpr (kBf16<T>) {
    uint32_t ah, al, bh, bl;
    split_bf16x2(v0, v1, ah, al);
    split_bf16x2(v2, v3, bh, bl);
    store_words16(out, ah, bh, q, true);
    store_words16(out + lo, al, bl, q, true);
  } else {
    *reinterpret_cast<float2*>(out + 2 * q) = make_float2(v0, v1);
    *reinterpret_cast<float2*>(out + 8 + 2 * q) = make_float2(v2, v3);
  }
}

// A row's values of a warp's n8 accumulator tiles (acc[j][2 r], acc[j][2 r + 1]
// at column c0 + 8 j + 2 q) into out (column 0 at out[0]) in T, for columns
// below ``width`` and where ``live``: bf16 rows of whole 16-column blocks on 16
// bytes (``vec``) by store_words16, else pairs or elements. Every lane calls it.
template <typename T, int NT>
__device__ __forceinline__ void store_row(T* out, const float (&acc)[NT][4], int r, int c0,
                                          int width, bool vec, bool live) {
  const int q = threadIdx.x & 3;
  if constexpr (kBf16<T>) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < NT / 2; ++k) {
        const uint32_t a =
            bf16x2_bits(__floats2bfloat162_rn(acc[2 * k][2 * r], acc[2 * k][2 * r + 1]));
        const uint32_t b =
            bf16x2_bits(__floats2bfloat162_rn(acc[2 * k + 1][2 * r], acc[2 * k + 1][2 * r + 1]));
        store_words16(out + c0 + 16 * k, a, b, q, live && c0 + 16 * k < width);
      }
      return;
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = c0 + 8 * j + 2 * q;
    store_two(out + col, acc[j][2 * r], acc[j][2 * r + 1], col, width, vec || (width & 1) == 0);
  }
}

// ---------------------------------------------------------------------------------
// 1. the state pass (forward: S_c) and the adjoint pass (reverse: Lam_c), one launch
// ---------------------------------------------------------------------------------
template <typename T>
__host__ __device__ constexpr int pass_ld() { return kNT + kPad<T>; }
template <typename T>
__host__ __device__ constexpr size_t pass_stage_bytes() {
  return 2 * sizeof(T) * kQ * pass_ld<T>() + sizeof(float) * kQ;
}

template <typename T>
__global__ void __launch_bounds__(kPassThreads) pass_kernel(const Params<T> p) {
  constexpr int ld = pass_ld<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * kNT, hh = blockIdx.y, b = blockIdx.z >> 1;
  const bool rev = blockIdx.z & 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int P = p.hdim, N = p.N;
  const T* v = rev ? p.dy : p.x;
  const T* k = rev ? p.Cm : p.Bm;
  const float* init = rev ? p.dsf : p.s0;
  T* ws = rev ? p.lam : p.st;
  const float a2 = p.A[hh] * kLog2e;
  auto vs_at = [&](int s) { return reinterpret_cast<T*>(smem_raw + s * pass_stage_bytes<T>()); };
  auto ks_at = [&](int s) { return vs_at(s) + kQ * ld; };
  auto dts_at = [&](int s) { return reinterpret_cast<float*>(ks_at(s) + kQ * ld); };
  auto load_chunk = [&](int it) {
    const int s = it % kStages, c = rev ? p.nc - 1 - it : it;
    const int c0 = c * kQ, rows = min(kQ, p.t_len - c0);
    const size_t tok = static_cast<size_t>(b) * p.t_len + c0;
    stage(vs_at(s), ld, v + (tok * p.heads + hh) * P, static_cast<size_t>(p.heads) * P, rows, kNT,
          P, p.vx);
    stage(ks_at(s), ld, k + tok * N + n0, static_cast<size_t>(N), rows, kNT, min(kNT, N - n0), p.vb);
    stage_dt(dts_at(s), p.dt, tok, p.heads, hh, rows);
    cp_async_commit();
  };

  // st[j][e]: state row 16 warp + g + 8 (e >> 1), column n0 + 8 j + 2 q + (e & 1)
  float st[8][4];
  const size_t srow = (static_cast<size_t>(b) * p.heads + hh) * P;  // row (b, h, 0) of a state
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = 16 * warp + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * q + (e & 1);
      st[j][e] = (init != nullptr && pp < P && n < N) ? init[(srow + pp) * N + n] : 0.f;
    }

#pragma unroll 1
  for (int it = 0; it < kStages - 1 && it < p.nc; ++it) load_chunk(it);
#pragma unroll 1
  for (int it = 0; it < p.nc; ++it) {
    const int s = it % kStages, c = rev ? p.nc - 1 - it : it;
    if (it + kStages - 1 < p.nc) {
      load_chunk(it + kStages - 1);
      cp_async_wait<kStages - 1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* vs = vs_at(s);
    const T* ks = ks_at(s);
    const ChunkScan sc = scan_chunk(dts_at(s), a2, lane);
    // the weights a lane holds: w_u = exp(s_Q - s_u) dt_u (forward), e_t = exp(s_t) (reverse)
    const float wa = rev ? exp2f(sc.sa) : exp2f(sc.last - sc.sa) * sc.da;
    const float wb = rev ? exp2f(sc.sb) : exp2f(sc.last - sc.sb) * sc.db;
    // the state entering chunk c (forward) / the adjoint leaving it (reverse)
    T* out = ws + ((static_cast<size_t>(b) * p.nc + c) * p.heads + hh) * kQ * p.np + n0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        put_row16(out + (16 * warp + g + 8 * r) * p.np + 16 * k, p.st_plane, st[2 * k][2 * r],
                  st[2 * k][2 * r + 1], st[2 * k + 1][2 * r], st[2 * k + 1][2 * r + 1], q);
    const float decay = exp2f(sc.last);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= decay;
    if constexpr (kBf16<T>) {
      // (w o v)^T: rows of p, k = steps, by ldmatrix.trans; split hi + lo once
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        uint32_t va[4];
        ldsm_x4_trans(va, vs + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + warp * 16 +
                              ((lane >> 3) & 1) * 8);
        const float2 w0 = step_pair(wa, wb, kk * 8 + q), w1 = step_pair(wa, wb, kk * 8 + q + 4);
        uint32_t vh[4], vl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&va[i]));
          const float2 w = i >= 2 ? w1 : w0;
          split_bf16x2(f.x * w.x, f.y * w.y, vh[i], vl[i]);
        }
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + j2 * 16 +
                                (lane >> 4) * 8);
          mma_bf16(st[2 * j2], vh, bv[0], bv[1]);
          mma_bf16(st[2 * j2 + 1], vh, bv[2], bv[3]);
          mma_bf16(st[2 * j2], vl, bv[0], bv[1]);
          mma_bf16(st[2 * j2 + 1], vl, bv[2], bv[3]);
        }
      }
    } else {
      const float* vf = reinterpret_cast<const float*>(vs);
      const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll 2
      for (int u2 = 0; u2 < kQ / 2; ++u2) {
        const float2 w2 = step_pair(wa, wb, u2);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int u = 2 * u2 + h2;
          const float w = h2 ? w2.y : w2.x;
          const float a0 = vf[u * ld + 16 * warp + g] * w, a1 = vf[u * ld + 16 * warp + g + 8] * w;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(kf + u * ld + 8 * j + 2 * q);
            st[j][0] = fmaf(a0, bb.x, st[j][0]);
            st[j][1] = fmaf(a0, bb.y, st[j][1]);
            st[j][2] = fmaf(a1, bb.x, st[j][2]);
            st[j][3] = fmaf(a1, bb.y, st[j][3]);
          }
        }
      }
    }
    __syncthreads();  // every read of stage s is done before it is refilled
  }
  if (rev && p.ds0 != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 16 * warp + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * q + (e & 1);
        if (pp < P && n < N) p.ds0[(srow + pp) * N + n] = st[j][e];
      }
  }
}

// ---------------------------------------------------------------------------------
// 2. / 3. the chunk kernels: a block per (head group, chunk, sequence)
// ---------------------------------------------------------------------------------
// Shared-memory layouts (the same on host and device). lam_kernel: x and dy
// [step][p]; B [step][n]; two 64-column tiles of Lam's planes [p][n] (C
// [step][n] in their place while C . B and dCB^T . C run); the M planes, then
// the group's dCB planes [t][u]; C . B (f32, a thread's 16 values in a row of
// its own). s_kernel: dy; B and C; two tiles of S's planes; the group's dCB
// planes. Then the scalars: dt and the partial sums of the ds pieces.
template <typename T>
struct Layout {
  int ldx = 0, ldb = 0;
  size_t xs = 0, dys = 0, bs = 0, cs = 0, t0 = 0, t1 = 0, tm = 0, ex = 0, scal = 0, bytes = 0;
  __host__ __device__ Layout(int np, int cg, bool lam) {
    ldx = kNT + kPad<T>;
    ldb = np + kPad<T>;
    const size_t tile = sizeof(T) * kQ * ldx * kPlanes<T>, rows = sizeof(T) * kQ * ldb;
    size_t o = 0;
    if (lam) {
      xs = o;
      o += sizeof(T) * kQ * ldx;
    }
    dys = o;
    o += sizeof(T) * kQ * ldx;
    bs = o;
    o += rows;
    if (!lam) {
      cs = o;
      o += rows;
    }
    t0 = o;
    t1 = o + tile;
    if (lam) {
      cs = t0;
      o += 2 * tile > rows ? 2 * tile : rows;
      tm = o;
      o += tile;
      ex = o;
      o += sizeof(float) * kQ * kQ;
    } else {
      o += 2 * tile;
      ex = o;
      o += tile;
    }
    scal = o;
    // dts, then [cg][64] row sums of Z / C o (dy . S), [4][64] column sums, [cg][64] row
    // sums of B o (x . Lam), [4 cg] a warp's Lam o S
    bytes = scal + sizeof(float) * (kQ + kQ * cg + 4 * kQ + kQ * cg + 4 * cg);
  }
};

template <typename T, int kCG>
__host__ __device__ constexpr int min_blocks() { return kBf16<T> && kCG == 2 ? 2 : 1; }

// lam_kernel: dM, M, dx, dB (x . Lam and dCB^T . C), dCB summed over the group
template <typename T, int kCG>
__global__ void __launch_bounds__(kCG * 128, (min_blocks<T, kCG>()))
lam_kernel(const Params<T> p) {
  constexpr int kWarps = 4 * kCG, NTW = 8 / kCG;  // n8 tiles of a warp in 64 columns
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * p.G, h1 = min(h0 + p.G, p.heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int rs = warp & 3, cg = warp >> 2, m0 = 16 * rs, wc = cg * 8 * NTW;
  const int P = p.hdim, N = p.N, np = p.np, ntiles = np / kNT;
  const int c0 = c * kQ, rows = min(kQ, p.t_len - c0);
  const size_t tok = static_cast<size_t>(b) * p.t_len + c0;
  const size_t xstride = static_cast<size_t>(p.heads) * P;
  const Layout<T> L(np, kCG, true);
  const int ldx = L.ldx, ldb = L.ldb, tlo = kQ * ldx;  // a tile's lo plane, elements past its hi
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs);
  T* dys = reinterpret_cast<T*>(smem_raw + L.dys);
  T* bs = reinterpret_cast<T*>(smem_raw + L.bs);
  T* cs = reinterpret_cast<T*>(smem_raw + L.cs);  // over the Lam tiles, while C is used
  T* tb[2] = {reinterpret_cast<T*>(smem_raw + L.t0), reinterpret_cast<T*>(smem_raw + L.t1)};
  T* tm = reinterpret_cast<T*>(smem_raw + L.tm);
  float* cbf = reinterpret_cast<float*>(smem_raw + L.ex);
  float* dts = reinterpret_cast<float*>(smem_raw + L.scal);
  float* zpart = dts + kQ;          // [kCG][64]: Z row sums by column group
  float* cpart = zpart + kQ * kCG;  // [4][64]: dM o CB o L column sums by row slab
  float* xpart = cpart + 4 * kQ;    // [kCG][64]: B o (x . Lam) row sums by column group

  const T* lam_c = p.lam + (static_cast<size_t>(b) * p.nc + c) * p.heads * kQ * np;
  auto load_tile = [&](int hh, int j) {
    const T* src = lam_c + static_cast<size_t>(hh) * kQ * np + j * kNT;
    for (int pl = 0; pl < kPlanes<T>; ++pl)
      stage(tb[j & 1] + pl * tlo, ldx, src + pl * p.st_plane, static_cast<size_t>(np), kQ, kNT,
            kNT, true);
    cp_async_commit();
  };
  auto load_inputs = [&](int hh) {
    stage(xs, ldx, p.x + (tok * p.heads + hh) * P, xstride, rows, kNT, P, p.vx);
    stage(dys, ldx, p.dy + (tok * p.heads + hh) * P, xstride, rows, kNT, P, p.vx);
    stage_dt(dts, p.dt, tok, p.heads, hh, rows);
    cp_async_commit();
  };
  auto load_tiles = [&](int hh) {
    load_tile(hh, 0);
    if (ntiles > 1) load_tile(hh, 1);
  };
  auto stage_c = [&]() {
    stage(cs, ldb, p.Cm + tok * N, static_cast<size_t>(N), rows, np, N, p.vb);
    cp_async_commit();
  };

  stage(bs, ldb, p.Bm + tok * N, static_cast<size_t>(N), rows, np, N, p.vb);
  stage_c();
  load_inputs(h0);
  cp_async_wait<1>();
  __syncthreads();
  {  // C . B: rows t, columns u; each thread keeps its fragment in a row of its own
    float cb[NTW][4];
    zero(cb);
    warp_product<T, NTW, true, false, false, false>(cb, cs, ldb, 0, bs, ldb, 0, m0, wc, 0, np,
                                                    m0 + 16);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      *reinterpret_cast<float4*>(cbf + (j * kWarps * 32 + tid) * 4) =
          make_float4(cb[j][0], cb[j][1], cb[j][2], cb[j][3]);
  }
  __syncthreads();  // every read of C is done: its space takes the Lam tiles
  load_tiles(h0);

  // dB's accumulators: rows u = m0 + g (+ 8), tile j's columns j * 64 + wc + 8 i + 2 q (+ 1)
  float dbacc[kCG][NTW][4];
  float dcbs[NTW][4];  // dCB summed over the group: rows t, columns u
#pragma unroll
  for (int j = 0; j < kCG; ++j) zero(dbacc[j]);
  zero(dcbs);
  const int ta = m0 + g, tb8 = ta + 8;  // the lane's two rows

#pragma unroll 1
  for (int hh = h0; hh < h1; ++hh) {
    if (ntiles > 1) cp_async_wait<2>(); else cp_async_wait<1>();
    __syncthreads();
    const float a2 = p.A[hh] * kLog2e;
    const ChunkScan sc = scan_chunk(dts, a2, lane);
    const float s_ta = step_at(sc, ta), s_tb = step_at(sc, tb8);
    // dM = dy . x^T (tiles past the diagonal skipped), then M, dCB and the Z / Y sums
    float acc[NTW][4];
    zero(acc);
    warp_product<T, NTW, true, false, false, false>(acc, dys, ldx, 0, xs, ldx, 0, m0, wc, 0, kNT,
                                                    m0 + 16);
    float zr[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int u = wc + 8 * j + 2 * q;
      const float2 su = step_pair(sc.sa, sc.sb, u >> 1);
      const float2 du = *reinterpret_cast<const float2*>(dts + u);
      const float4 cb4 = *reinterpret_cast<const float4*>(cbf + (j * kWarps * 32 + tid) * 4);
      const float cbv[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
      float cy[2] = {0.f, 0.f}, mv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = (e >> 1) ? tb8 : ta, uu = u + (e & 1);
        const float s_t = (e >> 1) ? s_tb : s_ta, s_u = (e & 1) ? su.y : su.x;
        const float d = (e & 1) ? du.y : du.x;
        const float l = uu <= t ? exp2f(fminf(s_t - s_u, 0.f)) : 0.f;
        const float y = acc[j][e] * cbv[e] * l;
        mv[e] = cbv[e] * l * d;
        dcbs[j][e] = fmaf(acc[j][e] * l, d, dcbs[j][e]);
        zr[e >> 1] = fmaf(y, d, zr[e >> 1]);
        cy[e & 1] += y;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        put_pair(tm + ((r ? tb8 : ta) * ldx + u), tlo, mv[2 * r], mv[2 * r + 1]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // over the rows g
        cy[0] += __shfl_xor_sync(0xffffffffu, cy[0], o);
        cy[1] += __shfl_xor_sync(0xffffffffu, cy[1], o);
      }
      if (g == 0) *reinterpret_cast<float2*>(cpart + rs * kQ + u) = make_float2(cy[0], cy[1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      zr[r] += __shfl_xor_sync(0xffffffffu, zr[r], 1);
      zr[r] += __shfl_xor_sync(0xffffffffu, zr[r], 2);
    }
    if (q == 0) {
      zpart[cg * kQ + ta] = zr[0];
      zpart[cg * kQ + tb8] = zr[1];
    }

    // B . Lam^T (dx's second term, before w) and dB's w o (x . Lam) with the row
    // sums of B o (x . Lam), a 64-column tile of Lam at a time
    const float w_a = exp2f(sc.last - s_ta) * dts[ta], w_b = exp2f(sc.last - s_tb) * dts[tb8];
    float dxa[NTW][4], xb[2] = {0.f, 0.f};
    zero(dxa);
#pragma unroll
    for (int j = 0; j < kCG; ++j) {
      if (j >= ntiles) break;
      if (j + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();  // tile j is in; (j = 0) the M planes and the partial sums are whole
      const T* lt = tb[j & 1];
      float xl[NTW][4];
      zero(xl);
      warp_product<T, NTW, true, true, false, kBf16<T>>(xl, xs, ldx, 0, lt, ldx, tlo, m0, wc, 0,
                                                        kNT, kQ);
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int n = j * kNT + wc + 8 * i + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int u = r ? tb8 : ta;
          const float w = r ? w_b : w_a;
          xb[r] += to_f32(bs[u * ldb + n]) * xl[i][2 * r] +
                   to_f32(bs[u * ldb + n + 1]) * xl[i][2 * r + 1];
          dbacc[j][i][2 * r] = fmaf(w, xl[i][2 * r], dbacc[j][i][2 * r]);
          dbacc[j][i][2 * r + 1] = fmaf(w, xl[i][2 * r + 1], dbacc[j][i][2 * r + 1]);
        }
      }
      warp_product<T, NTW, true, false, false, kBf16<T>>(dxa, bs + j * kNT, ldb, 0, lt, ldx, tlo,
                                                         m0, wc, 0, kNT, kQ);
      if (j + 2 < ntiles) {
        __syncthreads();
        load_tile(hh, j + 2);
      }
    }
    // dx = w o (B . Lam^T) + M^T . dy (M^T[u][t] is zero for t < u: k from the row slab on)
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      dxa[i][0] *= w_a;
      dxa[i][1] *= w_a;
      dxa[i][2] *= w_b;
      dxa[i][3] *= w_b;
    }
    warp_product<T, NTW, false, true, kBf16<T>, false>(dxa, tm, ldx, tlo, dys, ldx, 0, m0, wc, m0,
                                                       kQ, kQ);
    T* dxp = p.dx + tok * xstride + static_cast<size_t>(hh) * P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = r ? tb8 : ta;
      store_row(dxp + u * xstride, dxa, r, wc, P, p.vx && P % 16 == 0, u < rows);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xb[r] += __shfl_xor_sync(0xffffffffu, xb[r], 1);
      xb[r] += __shfl_xor_sync(0xffffffffu, xb[r], 2);
    }
    if (q == 0) {
      xpart[cg * kQ + ta] = xb[0];
      xpart[cg * kQ + tb8] = xb[1];
    }
    __syncthreads();  // the partial sums are whole; x, dy, the M planes and the tiles are free
    if (hh + 1 < h1) {
      load_inputs(hh + 1);
      load_tiles(hh + 1);
    }
    if (tid < kQ) {
      float z = 0.f, cyv = 0.f, xv = 0.f;
#pragma unroll
      for (int i = 0; i < kCG; ++i) {
        z += zpart[i * kQ + tid];
        xv += xpart[i * kQ + tid];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) cyv += cpart[i * kQ + tid];
      float* ax = p.aux + ((static_cast<size_t>(b) * p.nc + c) * p.heads + hh) * 3 * kQ;
      ax[tid] = z;
      ax[kQ + tid] = cyv;
      ax[2 * kQ + tid] = xv;
    }
  }

  // the group's dCB as planes, into tm (for dCB^T . C) and its workspace (for s_kernel); C
  // back over the Lam tiles
  T* dcbg = p.dcb + ((static_cast<size_t>(b) * p.nc + c) * p.groups + grp) * kQ * kQ;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r ? tb8 : ta;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      put_pair(tm + t * ldx + wc + 8 * j + 2 * q, tlo, dcbs[j][2 * r], dcbs[j][2 * r + 1]);
#pragma unroll
    for (int k = 0; k < NTW / 2; ++k)
      put_row16(dcbg + t * kQ + wc + 16 * k, p.dcb_plane, dcbs[2 * k][2 * r], dcbs[2 * k][2 * r + 1],
                dcbs[2 * k + 1][2 * r], dcbs[2 * k + 1][2 * r + 1], q);
  }
  stage_c();
  cp_async_wait<0>();
  __syncthreads();
  // dB += dCB^T . C: rows u, k = t from the row slab on (dCB is zero for t < u)
  const bool one = p.groups == 1;
#pragma unroll
  for (int j = 0; j < kCG; ++j) {
    if (j >= ntiles) break;
    warp_product<T, NTW, false, true, kBf16<T>, false>(dbacc[j], tm, ldx, tlo, cs + j * kNT, ldb,
                                                       0, m0, wc, m0, kQ, kQ);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = r ? tb8 : ta;
      if (one)
        store_row(p.dB + (tok + u) * N, dbacc[j], r, j * kNT + wc, N, p.vb && N % 16 == 0, u < rows);
      else
        store_row(p.dbp + ((tok + u) * p.groups + grp) * N, dbacc[j], r, j * kNT + wc, N, false,
                  u < rows);
    }
  }
}

// s_kernel: dC (dy . S and dCB . B), the row sums of C o (dy . S), Lam o S,
// and the ds pieces turned into ds, ddt and dA's partial
template <typename T, int kCG>
__global__ void __launch_bounds__(kCG * 128, (min_blocks<T, kCG>()))
s_kernel(const Params<T> p) {
  constexpr int kWarps = 4 * kCG, NTW = 8 / kCG;
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * p.G, h1 = min(h0 + p.G, p.heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int rs = warp & 3, cg = warp >> 2, m0 = 16 * rs, wc = cg * 8 * NTW;
  const int P = p.hdim, N = p.N, np = p.np, ntiles = np / kNT;
  const int c0 = c * kQ, rows = min(kQ, p.t_len - c0);
  const size_t tok = static_cast<size_t>(b) * p.t_len + c0;
  const size_t xstride = static_cast<size_t>(p.heads) * P;
  const Layout<T> L(np, kCG, false);
  const int ldx = L.ldx, ldb = L.ldb, tlo = kQ * ldx;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dys = reinterpret_cast<T*>(smem_raw + L.dys);
  T* bs = reinterpret_cast<T*>(smem_raw + L.bs);
  T* cs = reinterpret_cast<T*>(smem_raw + L.cs);
  T* tb[2] = {reinterpret_cast<T*>(smem_raw + L.t0), reinterpret_cast<T*>(smem_raw + L.t1)};
  T* dcb = reinterpret_cast<T*>(smem_raw + L.ex);
  float* dts = reinterpret_cast<float*>(smem_raw + L.scal);
  float* cdpart = dts + kQ;                          // [kCG][64]: C o (dy . S) row sums
  float* lspart = cdpart + kQ * kCG + 4 * kQ + kQ * kCG;  // [kWarps]: Lam o S

  const size_t cbase = (static_cast<size_t>(b) * p.nc + c) * p.heads * kQ * np;
  auto load_tile = [&](int hh, int j) {
    const T* src = p.st + cbase + static_cast<size_t>(hh) * kQ * np + j * kNT;
    for (int pl = 0; pl < kPlanes<T>; ++pl)
      stage(tb[j & 1] + pl * tlo, ldx, src + pl * p.st_plane, static_cast<size_t>(np), kQ, kNT,
            kNT, true);
    cp_async_commit();
  };
  auto load_head = [&](int hh) {
    stage(dys, ldx, p.dy + (tok * p.heads + hh) * P, xstride, rows, kNT, P, p.vx);
    stage_dt(dts, p.dt, tok, p.heads, hh, rows);
    cp_async_commit();
    load_tile(hh, 0);
    if (ntiles > 1) load_tile(hh, 1);
  };

  stage(bs, ldb, p.Bm + tok * N, static_cast<size_t>(N), rows, np, N, p.vb);
  stage(cs, ldb, p.Cm + tok * N, static_cast<size_t>(N), rows, np, N, p.vb);
  {
    const T* src = p.dcb + ((static_cast<size_t>(b) * p.nc + c) * p.groups + grp) * kQ * kQ;
    for (int pl = 0; pl < kPlanes<T>; ++pl)
      stage(dcb + pl * tlo, ldx, src + pl * p.dcb_plane, static_cast<size_t>(kQ), kQ, kQ, kQ, true);
  }
  cp_async_commit();
  load_head(h0);

  // dC's accumulators: rows t = m0 + g (+ 8), tile j's columns j * 64 + wc + 8 i + 2 q (+ 1)
  float dcacc[kCG][NTW][4];
#pragma unroll
  for (int j = 0; j < kCG; ++j) zero(dcacc[j]);
  const int ta = m0 + g, tb8 = ta + 8;

#pragma unroll 1
  for (int hh = h0; hh < h1; ++hh) {
    if (ntiles > 1) cp_async_wait<2>(); else cp_async_wait<1>();
    __syncthreads();
    const float a2 = p.A[hh] * kLog2e;
    const ChunkScan sc = scan_chunk(dts, a2, lane);
    const float e_a = exp2f(step_at(sc, ta)), e_b = exp2f(step_at(sc, tb8));
    float cd[2] = {0.f, 0.f}, ls = 0.f;
    const T* lam_h = p.lam + cbase + static_cast<size_t>(hh) * kQ * np;
#pragma unroll
    for (int j = 0; j < kCG; ++j) {
      if (j >= ntiles) break;
      if (j + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      const T* stl = tb[j & 1];
      // Lam o S over the tile: 8 columns a step, Lam from its workspace
      for (int i = tid; i < kQ * (kNT / 8); i += kWarps * 32) {
        const int r = i >> 3, k8 = (i & 7) * 8;
        const T* lp = lam_h + static_cast<size_t>(r) * np + j * kNT + k8;
        const T* sp = stl + r * ldx + k8;
        if constexpr (kBf16<T>) {
          const uint4 lh = __ldg(reinterpret_cast<const uint4*>(lp));
          const uint4 ll = __ldg(reinterpret_cast<const uint4*>(lp + p.st_plane));
          const uint4 sh = *reinterpret_cast<const uint4*>(sp);
          const uint4 sl = *reinterpret_cast<const uint4*>(sp + tlo);
          const uint32_t lhw[4] = {lh.x, lh.y, lh.z, lh.w}, llw[4] = {ll.x, ll.y, ll.z, ll.w};
          const uint32_t shw[4] = {sh.x, sh.y, sh.z, sh.w}, slw[4] = {sl.x, sl.y, sl.z, sl.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lhw[w]));
            const float2 a_l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&llw[w]));
            const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&shw[w]));
            const float2 s_l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&slw[w]));
            ls = fmaf(a.x + a_l.x, s.x + s_l.x, ls);
            ls = fmaf(a.y + a_l.y, s.y + s_l.y, ls);
          }
        } else {
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(lp) + w);
            const float4 s = *(reinterpret_cast<const float4*>(sp) + w);
            ls = fmaf(a.x, s.x, ls);
            ls = fmaf(a.y, s.y, ls);
            ls = fmaf(a.z, s.z, ls);
            ls = fmaf(a.w, s.w, ls);
          }
        }
      }
      // dy . S: rows t, the tile's columns, k = p
      float ys[NTW][4];
      zero(ys);
      warp_product<T, NTW, true, true, false, kBf16<T>>(ys, dys, ldx, 0, stl, ldx, tlo, m0, wc, 0,
                                                        kNT, kQ);
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int n = j * kNT + wc + 8 * i + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = r ? tb8 : ta;
          const float e = r ? e_b : e_a;
          cd[r] += to_f32(cs[t * ldb + n]) * ys[i][2 * r] +
                   to_f32(cs[t * ldb + n + 1]) * ys[i][2 * r + 1];
          dcacc[j][i][2 * r] = fmaf(e, ys[i][2 * r], dcacc[j][i][2 * r]);
          dcacc[j][i][2 * r + 1] = fmaf(e, ys[i][2 * r + 1], dcacc[j][i][2 * r + 1]);
        }
      }
      if (j + 2 < ntiles) {
        __syncthreads();
        load_tile(hh, j + 2);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cd[r] += __shfl_xor_sync(0xffffffffu, cd[r], 1);
      cd[r] += __shfl_xor_sync(0xffffffffu, cd[r], 2);
    }
    if (q == 0) {
      cdpart[cg * kQ + ta] = cd[0];
      cdpart[cg * kQ + tb8] = cd[1];
    }
    ls = warp_sum(ls);
    if (lane == 0) lspart[warp] = ls;
    __syncthreads();  // the partial sums are whole; dy, dt and the tiles are free
    if (hh + 1 < h1) load_head(hh + 1);
    if (warp == 0) {
      // ds at steps 2 lane, 2 lane + 1, its reverse cumsum r, ddt and dA's partial
      const size_t hrow = (static_cast<size_t>(b) * p.nc + c) * p.heads + hh;
      const float* ax = p.aux + hrow * 3 * kQ;
      const int u = 2 * lane;
      const float2 zr = *reinterpret_cast<const float2*>(ax + u);
      const float2 cy = *reinterpret_cast<const float2*>(ax + kQ + u);
      const float2 xb = *reinterpret_cast<const float2*>(ax + 2 * kQ + u);
      float cda = 0.f, cdb = 0.f, lsum = 0.f;
#pragma unroll
      for (int i = 0; i < kCG; ++i) {
        cda += cdpart[i * kQ + u];
        cdb += cdpart[i * kQ + u + 1];
      }
#pragma unroll
      for (int i = 0; i < kWarps; ++i) lsum += lspart[i];
      const float xwa = exp2f(sc.last - sc.sa), xwb = exp2f(sc.last - sc.sb);  // exp(s_Q - s)
      const float wxa = xwa * sc.da * xb.x, wxb = xwb * sc.db * xb.y;
      float dsa = exp2f(sc.sa) * cda + zr.x - sc.da * cy.x - wxa;
      float dsb = exp2f(sc.sb) * cdb + zr.y - sc.db * cy.y - wxb;
      const float wsum = warp_sum(wxa + wxb);
      if (lane == 31) dsb += wsum + exp2f(sc.last) * lsum;
      // reverse inclusive cumsum over the lanes' pairs
      float incl = dsa + dsb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float dn = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += dn;
      }
      const float ra = incl, rb = incl - dsa;
      const float A = p.A[hh];
      float* dd = p.ddt + tok * p.heads + hh;
      if (u < rows) dd[static_cast<size_t>(u) * p.heads] = cy.x + xwa * xb.x + A * ra;
      if (u + 1 < rows) dd[static_cast<size_t>(u + 1) * p.heads] = cy.y + xwb * xb.y + A * rb;
      const float da = warp_sum(sc.da * ra + sc.db * rb);
      if (lane == 0) p.dap[hrow] = da;
    }
  }

  // dC += dCB . B: rows t, k = u up to the row slab's end (dCB is zero for u > t)
  const bool one = p.groups == 1;
#pragma unroll
  for (int j = 0; j < kCG; ++j) {
    if (j >= ntiles) break;
    warp_product<T, NTW, true, true, kBf16<T>, false>(dcacc[j], dcb, ldx, tlo, bs + j * kNT, ldb, 0,
                                                      m0, wc, 0, m0 + 16, kQ);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r ? tb8 : ta;
      if (one)
        store_row(p.dC + (tok + t) * N, dcacc[j], r, j * kNT + wc, N, p.vb && N % 16 == 0, t < rows);
      else
        store_row(p.dcp + ((tok + t) * p.groups + grp) * N, dcacc[j], r, j * kNT + wc, N, false,
                  t < rows);
    }
  }
}

// ---------------------------------------------------------------------------------
// 4. / 5. the folds, in a fixed order
// ---------------------------------------------------------------------------------
constexpr int kFoldThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(const Params<T> p) {
  const size_t total = static_cast<size_t>(p.batch) * p.t_len * p.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (i >= total) return;
  const size_t bt = i / p.N, n = i - bt * p.N;
  const size_t base = bt * p.groups * p.N + n;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < p.groups; ++k) {
    sb += p.dbp[base + static_cast<size_t>(k) * p.N];
    sc += p.dcp[base + static_cast<size_t>(k) * p.N];
  }
  p.dB[i] = from_f32<T>(sb);
  p.dC[i] = from_f32<T>(sc);
}

template <typename T>
__global__ void __launch_bounds__(kFoldThreads) fold_da_kernel(const Params<T> p) {
  const int h = blockIdx.x * kFoldThreads + threadIdx.x;
  if (h >= p.heads) return;
  float s = 0.f;
  for (int i = 0; i < p.batch * p.nc; ++i) s += p.dap[static_cast<size_t>(i) * p.heads + h];
  p.dA[h] = s;
}

// Opt ``kern`` in to ``smem`` bytes and, once per device, to the largest
// shared-memory carveout (the resident blocks min_blocks counts on).
template <typename Kernel>
cudaError_t prepare(Kernel kern, size_t smem, size_t* opted, bool* carved) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!carved[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    carved[dev] = true;
  }
  return set_smem(kern, smem, opted);
}

template <typename T, int kCG>
cudaError_t prepare_chunk(int np, size_t* smem_lam, size_t* smem_s) {
  static size_t opted[2][kMaxDevices] = {};
  static bool carved[2][kMaxDevices] = {};
  *smem_lam = Layout<T>(np, kCG, true).bytes;
  *smem_s = Layout<T>(np, kCG, false).bytes;
  cudaError_t e = prepare(lam_kernel<T, kCG>, *smem_lam, opted[0], carved[0]);
  if (e == cudaSuccess) e = prepare(s_kernel<T, kCG>, *smem_s, opted[1], carved[1]);
  return e;
}

template <typename T, int kCG>
cudaError_t launch_chunks(const Params<T>& p, cudaStream_t stream) {
  size_t smem_lam = 0, smem_s = 0;
  const cudaError_t e = prepare_chunk<T, kCG>(p.np, &smem_lam, &smem_s);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.groups, p.nc, p.batch);
  lam_kernel<T, kCG><<<grid, kCG * 128, smem_lam, stream>>>(p);
  s_kernel<T, kCG><<<grid, kCG * 128, smem_s, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  static size_t opted_pass[kMaxDevices] = {};
  static bool carved_pass[kMaxDevices] = {};
  const size_t pass_smem = kStages * pass_stage_bytes<T>();
  cudaError_t e = prepare(pass_kernel<T>, pass_smem, opted_pass, carved_pass);
  if (e != cudaSuccess) return e;
  pass_kernel<T><<<dim3(p.np / kNT, p.heads, 2 * p.batch), kPassThreads, pass_smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = p.np <= 128 ? launch_chunks<T, 2>(p, stream) : launch_chunks<T, 4>(p, stream);
  if (e != cudaSuccess) return e;
  if (p.groups > 1) {
    const size_t total = static_cast<size_t>(p.batch) * p.t_len * p.N;
    fold_kernel<T><<<static_cast<unsigned>((total + kFoldThreads - 1) / kFoldThreads),
                     kFoldThreads, 0, stream>>>(p);
  }
  fold_da_kernel<T><<<(p.heads + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// out: lam_kernel's and s_kernel's blocks an SM, pass_kernel's, and the two
// chunk kernels' shared memory bytes
template <typename T, int kCG>
cudaError_t occupancy_cg(int np, int* out) {
  size_t smem_lam = 0, smem_s = 0;
  cudaError_t e = prepare_chunk<T, kCG>(np, &smem_lam, &smem_s);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, lam_kernel<T, kCG>, kCG * 128, smem_lam);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, s_kernel<T, kCG>, kCG * 128, smem_s);
  out[3] = static_cast<int>(smem_lam);
  out[4] = static_cast<int>(smem_s);
  return e;
}

template <typename T>
cudaError_t occupancy(int np, int* out) {
  cudaError_t e = np <= 128 ? occupancy_cg<T, 2>(np, out) : occupancy_cg<T, 4>(np, out);
  static size_t opted_pass[kMaxDevices] = {};
  static bool carved_pass[kMaxDevices] = {};
  const size_t pass_smem = kStages * pass_stage_bytes<T>();
  if (e == cudaSuccess) e = prepare(pass_kernel<T>, pass_smem, opted_pass, carved_pass);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, pass_kernel<T>, kPassThreads,
                                                      pass_smem);
  return e;
}

bool on16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy and dx, dB, dC share it). s0
// (the initial state), dsf (the final state's gradient) and ds0 (the initial
// state's gradient, written) may be null. Workspaces (sizes in the header, on
// 16 bytes): st, lam, dcb, aux, dbp and dcp (null with one group), dap.
// ``group``: heads a group, as head_group_size plans it (else
// cudaErrorInvalidValue). Launches the kernels on ``stream``; returns the
// cudaError_t of the launches (0 on success); nothing here synchronizes.
int repro_ssd_scan_bwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* dy, const void* s0, const void* dsf, void* dx,
                       void* ddt, void* dA, void* dB, void* dC, void* ds0, void* st, void* lam,
                       void* dcb, void* aux, void* dbp, void* dcp, void* dap, int batch, int t_len,
                       int heads, int head_dim, int n_state, int group, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || batch > 32767 || t_len <= 0 || heads <= 0 ||
      heads > 65535 || head_dim <= 0 || head_dim > kMaxP || n_state <= 0 ||
      n_state > kMaxState || st == nullptr || lam == nullptr || dcb == nullptr ||
      aux == nullptr || dap == nullptr || !on16(st) || !on16(lam) || !on16(dcb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = (t_len + kQ - 1) / kQ;
  if (nc > 65535 || group != head_group_size(batch, nc, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (heads + group - 1) / group;
  if (groups > 1 && (dbp == nullptr || dcp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esz = dtype == 0 ? 4 : 2;
  const int np = (n_state + kNT - 1) / kNT * kNT;
  const size_t st_plane = static_cast<size_t>(batch) * nc * heads * kQ * np;
  const size_t dcb_plane = static_cast<size_t>(batch) * nc * groups * kQ * kQ;
  const int vx = on16(x) && on16(dy) && on16(dx) && (head_dim * esz) % 16 == 0;
  const int vb = on16(Bm) && on16(Cm) && on16(dB) && on16(dC) && (n_state * esz) % 16 == 0;
  cudaError_t e;
  if (dtype == 0) {
    const Params<float> p{
        static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const float*>(Bm), static_cast<const float*>(Cm),
        static_cast<const float*>(dy), static_cast<const float*>(s0),
        static_cast<const float*>(dsf), static_cast<float*>(dx), static_cast<float*>(ddt),
        static_cast<float*>(dA), static_cast<float*>(dB), static_cast<float*>(dC),
        static_cast<float*>(ds0), static_cast<float*>(st), static_cast<float*>(lam),
        static_cast<float*>(dcb), static_cast<float*>(aux), static_cast<float*>(dbp),
        static_cast<float*>(dcp), static_cast<float*>(dap), batch, t_len, heads, head_dim,
        n_state, nc, np, group, groups, st_plane, dcb_plane, vx, vb};
    e = launch<float>(p, s);
  } else {
    const Params<bf16> p{
        static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy),
        static_cast<const float*>(s0), static_cast<const float*>(dsf), static_cast<bf16*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<bf16*>(dB),
        static_cast<bf16*>(dC), static_cast<float*>(ds0), static_cast<bf16*>(st),
        static_cast<bf16*>(lam), static_cast<bf16*>(dcb), static_cast<float*>(aux),
        static_cast<float*>(dbp), static_cast<float*>(dcp), static_cast<float*>(dap), batch, t_len,
        heads, head_dim, n_state, nc, np, group, groups, st_plane, dcb_plane, vx, vb};
    e = launch<bf16>(p, s);
  }
  return static_cast<int>(e);
}

// Blocks of lam_kernel (out[0]), s_kernel (out[1]) and pass_kernel (out[2])
// that fit on one SM at once (registers and shared memory for ``n_state``),
// and the shared memory bytes of lam_kernel (out[3]) and s_kernel (out[4]).
int repro_ssd_bwd_blocks_per_sm(int dtype, int n_state, int* out) {
  if ((dtype != 0 && dtype != 1) || n_state <= 0 || n_state > kMaxState || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  const int np = (n_state + kNT - 1) / kNT * kNT;
  return static_cast<int>(dtype == 0 ? occupancy<float>(np, out) : occupancy<bf16>(np, out));
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
