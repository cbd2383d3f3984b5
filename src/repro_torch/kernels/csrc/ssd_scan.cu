// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a), ngroups
// 1, with a plain C interface loaded through ctypes
// (repro_torch/kernels/ssd_scan.py holds the wrapper and the plain PyTorch
// version it is held against).
//
// What it replaces: src/repro/kernels/ssd_scan.py::ssd_scan (Pallas TPU).
// Same math, per head h with a_t = exp(dt_t * A_h) and s_t the running sum of
// dt * A inside a chunk:
//   y_t     = exp(s_t) (C_t . S_0) + sum_{u <= t} exp(min(s_t - s_u, 0)) dt_u (C_t . B_u) x_u
//   S_chunk = exp(s_Q) S_0 + sum_u exp(s_Q - s_u) dt_u x_u B_u^T
// with the reference's exp(min(seg, 0)) guard kept. Every sum is in f32; y is
// written in x's type, the final state in f32.
//
// Layout: x (b, t, h, p) and B / C (b, t, n) in T (float or __nv_bfloat16);
// dt (b, t, h), A (h,), the initial and final states (b, h, p, n) in f32.
//
// Two kernels on one stream, one C entry:
// 1. cb_kernel, a block per (sequence, chunk): CB = C_chunk . B_chunk^T, the
//    64 x 64 lower triangle in f32, as the 16 x 16 tiles on and below the
//    diagonal (zeros above it inside them; the tiles above are neither
//    written nor read), into a workspace of b x ceil(t / 64) x 64 x 64 floats. With ngroups 1 every head of a
//    sequence shares it, so it is computed once, not once per head and slice.
//    bf16 on mma.sync (the products of two bf16 are exact in f32), f32 on
//    register-tiled FFMA.
// 2. ssd_kernel, a block per (sequence, head, kPS columns of P), walking its
//    chunks in order as the TPU kernel's sequential chunk grid does, its
//    kPS x N state kept on-chip across them. A chunk: x, B, C and CB staged
//    with 16-byte cp.async (zero-filled past t and past N), one barrier; the
//    running sums s of dt * A by a warp scan (in log2 units, for exp2f); then
//    y = exp(s) (C . S^T) + M . x with M = CB o exp(min(s_t - s_u, 0)) o dt_u,
//    and S <- exp(s_Q) S + (w o x)^T . B with w_u = exp(s_Q - s_u) dt_u; one
//    barrier.
//    Half the warps compute y while the other half run the state update
//    (they read disjoint state: the old copy, and the update's own tiles).
//    Every warp scans the chunk itself in registers, so a chunk has two
//    block barriers.
//    bf16: the y warps build M in their A fragments from the staged CB; the
//    three products run on mma.sync m16n8k16 with f32 accumulation; the bf16
//    operands (C, x, B) enter as given, the f32 one of each product (S, M,
//    w o x) as a bf16 hi + lo pair (two mma, as common.cuh's
//    mma_softmax_tile feeds P). The f32 state lives in the update warps'
//    accumulator registers; its hi / lo copy in shared memory feeds C . S^T.
//    f32: the y warps build M in place of CB (behind their own barrier); every
//    product is register-tiled FFMA (no TF32), 4 x kYC tiles of y and 4 x 8
//    tiles of the update, operands read from shared memory as 16-byte
//    vectors, each feeding kYC or 8 multiply-adds (a 16-byte read costs four
//    wavefronts however many lanes share it, so the tile sizes, not the
//    layout, set the reads a multiply-add); the state lives in shared memory.
//    y is stored as bf16 pairs / f32 vectors. No float atomics: two runs give
//    the same bits.
//
// Chunk length: the block walks its own chunks of kQ = 64 steps whatever
// chunk the caller's plain version uses (the recurrence is exact at any chunk
// length; the two differ in rounding only). A ragged tail is masked as dt = 0,
// x = 0, B = C = 0, which is exact: those steps decay nothing and add nothing,
// and their y is never written.
//
// What bounds it on an H100: bf16 is bytes-bound on paper (each input read
// once: 0.011 ms at mamba2-780m's (4, 512, 48, 64), N 128), f32 is
// operations-bound (3.65 GFLOP on the FMA pipes, 0.054 ms). This design is
// bound by neither. scripts/time_ssd_scan.py --phases cuts one phase at a
// time (numbers in PERF.md): in bf16 the y warps' mma chains and the staging cost
// about a third of the time each, the state update hides behind the y warps;
// the staging is each block restaging its sequence's B, C and CB (the heads
// share them) from L2 every chunk: ~140 MB a call at B 4 (~6 TB/s over the
// phase's time). In f32 the y products lead: a 16-byte shared read costs four
// wavefronts, and a 4 x 4 register tile feeds two multiply-adds a wavefront.
// One stage, no ring: a second would cost a chunk's staging bytes again and
// the resident blocks that hide the first. Not done: sharing a sequence's
// staged chunk across the blocks of its heads (clusters, TMA multicast),
// wgmma, or splitting the sequence over blocks (a second pass for the states).

#include "common.cuh"

namespace {

constexpr int kQ = 64;              // time steps per chunk
// kPS and kWarps: scripts/time_ssd_scan.py --variants times 16 and 64 columns
// and 16 warps against them at the generate phase's shapes
constexpr int kPS = 32;             // columns of the head dim per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCbThreads = 128;     // cb_kernel: a warp per 16 rows of the chunk
constexpr int kMaxState = 256;

template <typename T> constexpr bool kBf16 = sizeof(T) == 2;

// Shared-memory layout of one block for state size N (the same on host and
// device). The rows of B, C, x and the state are a whole number of 16-byte
// chunks plus one: ldmatrix and 16-byte reads of eight consecutive rows then
// hit eight different bank groups.
template <typename T>
struct Layout {
  int np = 0;   // N rounded up to 16 (zero columns past N)
  int ldt = 0;  // row stride of the staged B and C, in T
  int ldx = 0;  // row stride of the staged x slice, in T
  int lds = 0;  // row stride of the state copy: bf16 hi / lo pairs, or f32
  int ldm = 0;  // row stride of CB / M, in floats
  size_t x = 0, b = 0, c = 0, m = 0, s = 0, s_lo = 0, scal = 0, bytes = 0;
  __host__ __device__ constexpr explicit Layout(int N) {
    constexpr int pad = 16 / static_cast<int>(sizeof(T));
    np = (N + 15) / 16 * 16;
    ldt = np + pad;
    ldx = kPS + pad;
    lds = kBf16<T> ? np + 8 : np + 4;
    ldm = kBf16<T> ? kQ : kQ + 4;  // bf16: rows swizzled (m_at), f32: padded
    x = 0;
    b = x + sizeof(T) * kQ * ldx;
    c = b + sizeof(T) * kQ * ldt;
    m = c + sizeof(T) * kQ * ldt;
    s = m + sizeof(float) * kQ * ldm;
    const size_t s_bytes = (kBf16<T> ? 2 : 4) * static_cast<size_t>(kPS) * lds;
    s_lo = s + (kBf16<T> ? s_bytes : 0);
    scal = s_lo + s_bytes;
    bytes = scal + sizeof(float) * 2 * kQ;  // dt, s
  }
};

template <typename T>
struct Params {
  const T* x;
  const float* dt;
  const float* A;
  const T* Bm;
  const T* Cm;
  const float* s0;  // may be null: a zero initial state
  float* cb;        // b x nc x kQ x kQ
  T* y;
  float* sf;
  int t_len, heads, hdim, N, nc;
  int vec;    // x, B, C rows start on 16 bytes: stage with cp.async
  int vec_y;  // y rows start on 16 bytes: packed stores
};

// Stage kQ rows of ``cols`` elements (of ``width`` live ones, a multiple of
// 16 bytes where ``vec``) from src (row r at src + r * stride) into dst (row
// stride ld); rows at or past ``rows`` and columns past ``width`` are zeros.
template <typename T, int NT>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, size_t stride, int rows,
                                           int cols, int width, bool vec, const T* any) {
  constexpr int kEl = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    const int per = cols / kEl;
    for (int i = threadIdx.x; i < kQ * per; i += NT) {
      const int r = i / per, k = (i - r * per) * kEl;
      const bool live = r < rows && k < width;
      cp_async16(dst + r * ld + k, live ? src + r * stride + k : any, live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kQ * cols; i += NT) {
      const int r = i / cols, k = i - r * cols;
      dst[r * ld + k] = (r < rows && k < width) ? src[r * stride + k] : from_f32<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------------
// 1. C . B once per (sequence, chunk)
// ---------------------------------------------------------------------------------
template <typename T>
size_t cb_smem(int N) {
  const Layout<T> L(N);
  return 2 * sizeof(T) * kQ * L.ldt;
}

template <typename T>
__global__ void __launch_bounds__(kCbThreads)
cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb, int t_len,
          int N, int nc, int vec) {
  const int c = blockIdx.x, b = blockIdx.y, c0 = c * kQ;
  const Layout<T> L(N);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);
  T* bs = cs + kQ * L.ldt;
  const size_t row0 = (static_cast<size_t>(b) * t_len + c0) * N;
  const int rows = min(kQ, t_len - c0);
  stage_rows<T, kCbThreads>(cs, L.ldt, Cm + row0, N, rows, L.np, N, vec, Cm);
  stage_rows<T, kCbThreads>(bs, L.ldt, Bm + row0, N, rows, L.np, N, vec, Bm);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* out = cb + (static_cast<size_t>(b) * nc + c) * kQ * kQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kBf16<T>) {
    // warp w: rows 16 w .. 16 w + 15, the 16-column groups 0 .. w (the triangle)
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int kk = 0; kk < L.np / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, cs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.ldt + kk * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        if (nj > warp) break;
        uint32_t bk[4];
        ldsm_x4(bk, bs + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * L.ldt + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * nj], a, bk[0], bk[1]);
        mma_bf16(acc[2 * nj + 1], a, bk[2], bk[3]);
      }
    }
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n / 2 > warp) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = warp * 16 + g + 8 * r, u = n * 8 + 2 * q;
        *reinterpret_cast<float2*>(out + t * kQ + u) =
            make_float2(u <= t ? acc[n][2 * r] : 0.f, u + 1 <= t ? acc[n][2 * r + 1] : 0.f);
      }
    }
  } else {
    // thread: rows rg + 16 i (i < 4), columns 8 cg .. 8 cg + 7
    const int rg = threadIdx.x & 15, cg = threadIdx.x >> 4;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const float* cf = reinterpret_cast<const float*>(cs);
    const float* bf = reinterpret_cast<const float*>(bs);
#pragma unroll 2
    for (int n = 0; n < L.np; n += 4) {
      float4 cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = *reinterpret_cast<const float4*>(cf + (rg + 16 * i) * L.ldt + n);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(bf + (cg * 8 + j) * L.ldt + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = acc[i][j];
          v = fmaf(cv[i].x, bv.x, v);
          v = fmaf(cv[i].y, bv.y, v);
          v = fmaf(cv[i].z, bv.z, v);
          acc[i][j] = fmaf(cv[i].w, bv.w, v);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((cg >> 1) > i) continue;  // above the diagonal tiles
      const int t = rg + 16 * i;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = cg * 8 + j <= t ? acc[i][j] : 0.f;
      float4* o = reinterpret_cast<float4*>(out + t * kQ + cg * 8);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// ---------------------------------------------------------------------------------
// 2. the scan: a block per (sequence, head, kPS columns of P)
// ---------------------------------------------------------------------------------
// Warp roles: the first kYWarps warps compute y while the other kUWarps run
// the state update. bf16: a y warp takes a 16-row slab of the chunk and
// kYCols columns of the slice, an update warp a 16-row slab of P and the
// state column groups sg + kSGroups j (16 columns each). f32: a y thread takes
// rows ty + 16 i (i < 4) and kYC columns, an update thread 4 rows of P and 8
// state columns (kUT such tiles at most).
constexpr int kYWarps = kWarps / 2;
constexpr int kUWarps = kWarps - kYWarps;
constexpr int kYCols = kPS / (kYWarps / 4);
constexpr int kPSlabs = kPS / 16;
constexpr int kSGroups = kUWarps / kPSlabs;
constexpr int kYC = kPS / (2 * kYWarps);
constexpr int kPG = kPS / 4;
constexpr float kLog2e = 1.4426950408889634f;

// the y warps' own barrier (f32: M built, then read)
__device__ __forceinline__ void y_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kYWarps * 32) : "memory");
}

// Blocks an SM the register budget is cut for: as many as the shared memory
// at N = kMaxN lets in (sm_90: 228 KB an SM, 1 KB of it reserved a block),
// leaving a thread at least 64 of the SM's 65536 registers.
constexpr size_t kSmemPerSm = 233472;
template <typename T, int kMaxN>
__host__ __device__ constexpr int min_blocks() {
  const size_t by_smem = kSmemPerSm / (Layout<T>(kMaxN).bytes + 1024);
  const size_t by_regs = 65536 / (kThreads * 64);
  const size_t m = by_smem < by_regs ? by_smem : by_regs;
  return m < 1 ? 1 : static_cast<int>(m);
}

// Where M[t, u] (bf16: CB[t, u]) lies in its stage: the bf16 rows are
// XOR-swizzled in 8-float groups, so the fragment reads of rows g = 0..3 (a
// half-warp's float2) hit four different bank groups without padding; the
// f32 rows are padded.
template <typename T>
__device__ __forceinline__ int m_at(int ldm, int t, int u) {
  return t * ldm + (kBf16<T> ? u ^ ((t & 3) << 3) : u);
}

// kN consecutive floats (on 4 kN bytes, or 16 for kN 8) loaded and stored
// as vectors
template <int kN>
__device__ __forceinline__ void load_floats(const float* src, float (&dst)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4 < kN ? 4 : kN) {
    if constexpr (kN >= 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x, dst[i + 1] = v.y, dst[i + 2] = v.z, dst[i + 3] = v.w;
    } else if constexpr (kN == 2) {
      const float2 v = *reinterpret_cast<const float2*>(src);
      dst[0] = v.x, dst[1] = v.y;
    } else {
      dst[0] = src[0];
    }
  }
}
template <int kN>
__device__ __forceinline__ void store_floats(float* dst, const float (&v)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4 < kN ? 4 : kN) {
    if constexpr (kN >= 4) {
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else if constexpr (kN == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
      dst[0] = v[0];
    }
  }
}

// The running sums of dt * A over a chunk, in log2 units (s2 = s log2 e, so
// exp(s) = exp2(s2)), by one warp: lane l holds s2 at steps 2 l and 2 l + 1;
// ``last`` is s2 at the chunk's last step, in every lane.
struct ChunkScan {
  float sa, sb, last;
};
__device__ __forceinline__ ChunkScan scan_chunk(const float* dts, float a2, int lane) {
  const float l0 = dts[2 * lane] * a2, l1 = dts[2 * lane + 1] * a2;
  float incl = l0 + l1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  return {incl - (l0 + l1) + l0, incl, __shfl_sync(0xffffffffu, incl, 31)};
}
// the pair (v[2 k], v[2 k + 1]) of a value held two steps a lane
__device__ __forceinline__ float2 step_pair(float va, float vb, int k) {
  return make_float2(__shfl_sync(0xffffffffu, va, k), __shfl_sync(0xffffffffu, vb, k));
}

template <typename T, int kMaxN>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, kMaxN>()))
ssd_kernel(const Params<T> p) {
  static_assert(kPS % 16 == 0 && kYWarps % 4 == 0 && kYCols % 16 == 0,
                "the bf16 y warps take 16-row slabs and 16-column steps");
  static_assert(kUWarps % kPSlabs == 0 && (kMaxN / 16) % kSGroups == 0,
                "the bf16 state tiles divide among the update warps");
  static_assert((kYC == 1 || kYC == 2 || kYC % 4 == 0) && 2 * kYWarps * kYC == kPS,
                "f32 y tiles of 1, 2 or 4 k columns cover the slice");
  constexpr int kSTiles = kMaxN / 16 / kSGroups * 2;  // bf16: n8 state tiles a warp
  constexpr int kUT = (kPG * (kMaxN / 8) + kUWarps * 32 - 1) / (kUWarps * 32);  // f32: update
                                                                                  // tiles a thread

  const int p0 = blockIdx.x * kPS, hh = blockIdx.y, b = blockIdx.z;
  const int ps = min(kPS, p.hdim - p0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const Layout<T> L(p.N);
  const int np = L.np;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw + L.x);
  T* bs = reinterpret_cast<T*>(smem_raw + L.b);
  T* cs = reinterpret_cast<T*>(smem_raw + L.c);
  float* ms = reinterpret_cast<float*>(smem_raw + L.m);
  float* dts = reinterpret_cast<float*>(smem_raw + L.scal);
  float* ss = dts + kQ;  // f32: the running sums (log2 units) for the M pass
  const float a2 = p.A[hh] * kLog2e;
  const size_t state0 = (static_cast<size_t>(b) * p.heads + hh) * p.hdim + p0;  // row of (b, h, p0)

  // bf16: the state in the update warps' accumulators, hi / lo in shared
  // memory; f32: in shared memory
  const bool y_warp = warp < kYWarps;
  const int uw = warp - kYWarps, sp = uw % kPSlabs, sg = uw / kPSlabs;
  float st[kSTiles][4];
  bf16* shi = reinterpret_cast<bf16*>(smem_raw + L.s);
  bf16* slo = reinterpret_cast<bf16*>(smem_raw + L.s_lo);
  float* sfs = reinterpret_cast<float*>(smem_raw + L.s);

  auto split_state = [&]() {  // bf16 update warps: the hi / lo copy for C . S^T
#pragma unroll
    for (int j = 0; j < kSTiles / 2; ++j) {
      const int grp = sg + kSGroups * j;
      if (grp * 16 >= np) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = grp * 16 + half * 8 + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = sp * 16 + g + 8 * r;
          uint32_t hi, lo;
          split_bf16x2(st[2 * j + half][2 * r], st[2 * j + half][2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(shi + row * L.lds + col) = hi;
          *reinterpret_cast<uint32_t*>(slo + row * L.lds + col) = lo;
        }
      }
    }
  };

  if constexpr (kBf16<T>) {
    if (!y_warp) {
#pragma unroll
      for (int j = 0; j < kSTiles / 2; ++j) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int half = e >> 2, r = (e >> 1) & 1;
          const int n = (sg + kSGroups * j) * 16 + half * 8 + 2 * q + (e & 1);
          const int pp = sp * 16 + g + 8 * r;
          st[2 * j + half][e & 3] =
              (p.s0 != nullptr && pp < ps && n < p.N) ? p.s0[(state0 + pp) * p.N + n] : 0.f;
        }
      }
      split_state();
    }
  } else {
    for (int i = tid; i < kPS * np; i += kThreads) {
      const int pp = i / np, n = i - pp * np;
      sfs[pp * L.lds + n] =
          (p.s0 != nullptr && pp < ps && n < p.N) ? p.s0[(state0 + pp) * p.N + n] : 0.f;
    }
  }

  const size_t xstep = static_cast<size_t>(p.heads) * p.hdim;
  for (int c = 0; c < p.nc; ++c) {
    const int c0 = c * kQ, rows = min(kQ, p.t_len - c0);
    // stage the chunk; steps past t_len are dt = x = B = C = 0
    const size_t tok = static_cast<size_t>(b) * p.t_len + c0;
    stage_rows<T, kThreads>(xs, L.ldx, p.x + (tok * p.heads + hh) * p.hdim + p0, xstep, rows,
                            kPS, ps, p.vec, p.x);
    stage_rows<T, kThreads>(bs, L.ldt, p.Bm + tok * p.N, p.N, rows, np, p.N, p.vec, p.Bm);
    stage_rows<T, kThreads>(cs, L.ldt, p.Cm + tok * p.N, p.N, rows, np, p.N, p.vec, p.Cm);
    const float* cbg = p.cb + (static_cast<size_t>(b) * p.nc + c) * kQ * kQ;
    for (int i = tid; i < kQ * kQ / 4; i += kThreads) {  // the 16 x 16 tiles on and below the diagonal
      const int r = i >> 4, k = (i & 15) * 4;
      if (k < (r & ~15) + 16) cp_async16(ms + m_at<T>(L.ldm, r, k), cbg + r * kQ + k, 16);
    }
    cp_async_commit();
    for (int u = tid; u < kQ; u += kThreads)
      dts[u] = u < rows ? p.dt[(tok + u) * p.heads + hh] : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    if constexpr (kBf16<T>) {
      // every warp scans the chunk itself: no barrier, no shared copy
      const ChunkScan sc = scan_chunk(dts, a2, lane);
      if (y_warp) {
        // y = exp(s) (C . S^T) + M . x, M = CB o exp(min(s_t - s_u, 0)) o dt_u
        // built in the A fragments: rows t0 = ry * 16 + g and t0 + 8
        const int ry = warp % 4, yc0 = (warp / 4) * kYCols, t0 = ry * 16 + g;
        float yacc[kYCols / 8][4];
#pragma unroll
        for (int n = 0; n < kYCols / 8; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kMaxN / 16; ++kk) {
          if (kk * 16 >= np) break;
          uint32_t af[4];
          ldsm_x4(af, cs + (ry * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.ldt + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
          for (int nj = 0; nj < kYCols / 16; ++nj) {
            const int off = (yc0 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * L.lds + kk * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, shi + off);
            ldsm_x4(bl, slo + off);
            mma_bf16(yacc[2 * nj], af, bh[0], bh[1]);
            mma_bf16(yacc[2 * nj + 1], af, bh[2], bh[3]);
            mma_bf16(yacc[2 * nj], af, bl[0], bl[1]);
            mma_bf16(yacc[2 * nj + 1], af, bl[2], bl[3]);
          }
        }
        const float2 st0 = step_pair(sc.sa, sc.sb, t0 >> 1), st1 = step_pair(sc.sa, sc.sb, (t0 + 8) >> 1);
        const float s_t0 = (g & 1) ? st0.y : st0.x, s_t1 = (g & 1) ? st1.y : st1.x;
        const float e0 = exp2f(s_t0), e1 = exp2f(s_t1);
#pragma unroll
        for (int n = 0; n < kYCols / 8; ++n) {
          yacc[n][0] *= e0;
          yacc[n][1] *= e0;
          yacc[n][2] *= e1;
          yacc[n][3] *= e1;
        }
        for (int kk = 0; kk <= ry; ++kk) {  // M is zero above the diagonal
          uint32_t mh[4], ml[4];
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {  // columns u, u + 1 with u = kk * 16 + 2 q + 8 hc
            const int u = kk * 16 + 2 * q + 8 * hc;
            const float2 su = step_pair(sc.sa, sc.sb, u >> 1);
            const float2 du = *reinterpret_cast<const float2*>(dts + u);
#pragma unroll
            for (int r = 0; r < 2; ++r) {  // rows t0, t0 + 8
              const int t = t0 + 8 * r;
              const float s_t = r ? s_t1 : s_t0;
              const float2 cb = *reinterpret_cast<const float2*>(ms + m_at<T>(L.ldm, t, u));
              const float m0 = u <= t ? cb.x * exp2f(fminf(s_t - su.x, 0.f)) * du.x : 0.f;
              const float m1 = u + 1 <= t ? cb.y * exp2f(fminf(s_t - su.y, 0.f)) * du.y : 0.f;
              split_bf16x2(m0, m1, mh[2 * hc + r], ml[2 * hc + r]);
            }
          }
#pragma unroll
          for (int nd = 0; nd < kYCols / 16; ++nd) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, xs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.ldx + yc0 +
                                  nd * 16 + (lane >> 4) * 8);
            mma_bf16(yacc[2 * nd], mh, bv[0], bv[1]);
            mma_bf16(yacc[2 * nd + 1], mh, bv[2], bv[3]);
            mma_bf16(yacc[2 * nd], ml, bv[0], bv[1]);
            mma_bf16(yacc[2 * nd + 1], ml, bv[2], bv[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kYCols / 8; ++n) {
          const int col = yc0 + n * 8 + 2 * q;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = t0 + 8 * r;
            if (t >= rows || col >= ps) continue;
            T* yp = p.y + ((tok + t) * p.heads + hh) * p.hdim + p0 + col;
            if (p.vec_y) {
              *reinterpret_cast<__nv_bfloat162*>(yp) =
                  __floats2bfloat162_rn(yacc[n][2 * r], yacc[n][2 * r + 1]);
            } else {
              yp[0] = from_f32<T>(yacc[n][2 * r]);
              if (col + 1 < ps) yp[1] = from_f32<T>(yacc[n][2 * r + 1]);
            }
          }
        }
      } else {
        // S <- exp(s_Q) S + (w o x)^T . B, w_u = exp(s_Q - s_u) dt_u; the A
        // operand (w o x)^T from x by ldmatrix.trans, split hi + lo
        const float wa = exp2f(sc.last - sc.sa) * dts[2 * lane];
        const float wb = exp2f(sc.last - sc.sb) * dts[2 * lane + 1];
        const float decay = exp2f(sc.last);
#pragma unroll
        for (int i = 0; i < kSTiles; ++i) {
          st[i][0] *= decay;
          st[i][1] *= decay;
          st[i][2] *= decay;
          st[i][3] *= decay;
        }
#pragma unroll
        for (int kk = 0; kk < kQ / 16; ++kk) {
          uint32_t xa[4];
          ldsm_x4_trans(xa, xs + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * L.ldx +
                                sp * 16 + ((lane >> 3) & 1) * 8);
          const float2 w0 = step_pair(wa, wb, kk * 8 + q), w1 = step_pair(wa, wb, kk * 8 + q + 4);
          uint32_t xh[4], xl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[i]));
            const float2 w = i >= 2 ? w1 : w0;
            split_bf16x2(f.x * w.x, f.y * w.y, xh[i], xl[i]);
          }
#pragma unroll
          for (int j = 0; j < kSTiles / 2; ++j) {
            const int grp = sg + kSGroups * j;
            if (grp * 16 >= np) break;
            uint32_t bv[4];
            ldsm_x4_trans(bv, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.ldt +
                                  grp * 16 + (lane >> 4) * 8);
            mma_bf16(st[2 * j], xh, bv[0], bv[1]);
            mma_bf16(st[2 * j + 1], xh, bv[2], bv[3]);
            mma_bf16(st[2 * j], xl, bv[0], bv[1]);
            mma_bf16(st[2 * j + 1], xl, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // every read of the chunk and of the old hi / lo copy is done
      if (!y_warp) split_state();
    } else {
      // f32: every warp scans the chunk itself; the y warps build M in place
      // of CB (warp 0 shares the running sums with them) while the update
      // warps run. Register tiles of 4 x kYC (y) and 4 x 8 (the update): each
      // 16-byte shared read (four wavefronts) feeds kYC or 8 multiply-adds.
      const ChunkScan sc = scan_chunk(dts, a2, lane);
      const float* xf = reinterpret_cast<const float*>(xs);
      const float* bf = reinterpret_cast<const float*>(bs);
      const float* cf = reinterpret_cast<const float*>(cs);
      const float decay = exp2f(sc.last);
      float uacc[kUT][4][8];
      if (y_warp) {
        if (warp == 0) {
          ss[2 * lane] = sc.sa;
          ss[2 * lane + 1] = sc.sb;
        }
        y_barrier();
#pragma unroll
        for (int tr = 0; tr < kQ / 16; ++tr) {  // the tiles y reads: row slab tr, columns < 16 (tr + 1)
          const int w = 16 * (tr + 1);
          for (int i = tid; i < 16 * w; i += kYWarps * 32) {
            const int t = 16 * tr + i / w, u = i % w;
            float* mp = ms + m_at<T>(L.ldm, t, u);
            *mp = u <= t ? *mp * exp2f(fminf(ss[t] - ss[u], 0.f)) * dts[u] : 0.f;
          }
        }
        y_barrier();
        // y = exp(s) (C . S^T) + M . x: rows ty + 16 i, columns tx kYC ..
        const int ty = (lane & 3) + 4 * (warp & 3), tx = (lane >> 2) + 8 * (warp >> 2);
        float acc[4][kYC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kYC; ++j) acc[i][j] = 0.f;
#pragma unroll 2
        for (int n = 0; n < np; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(cf + (ty + 16 * i) * L.ldt + n);
#pragma unroll
          for (int j = 0; j < kYC; ++j) {
            const float4 sv = *reinterpret_cast<const float4*>(sfs + (tx * kYC + j) * L.lds + n);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float v = acc[i][j];
              v = fmaf(cv[i].x, sv.x, v);
              v = fmaf(cv[i].y, sv.y, v);
              v = fmaf(cv[i].z, sv.z, v);
              acc[i][j] = fmaf(cv[i].w, sv.w, v);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = exp2f(ss[ty + 16 * i]);
#pragma unroll
          for (int j = 0; j < kYC; ++j) acc[i][j] *= e;
        }
#pragma unroll
        for (int ub = 0; ub < 4; ++ub) {  // row slab i takes u < 16 (i + 1): M is zero past t
#pragma unroll 2
          for (int u = ub * 16; u < ub * 16 + 16; u += 4) {
            float xv[4][kYC];
#pragma unroll
            for (int k = 0; k < 4; ++k) load_floats(xf + (u + k) * L.ldx + tx * kYC, xv[k]);
#pragma unroll
            for (int i = ub; i < 4; ++i) {
              const float4 mv = *reinterpret_cast<const float4*>(ms + (ty + 16 * i) * L.ldm + u);
#pragma unroll
              for (int j = 0; j < kYC; ++j) {
                float v = acc[i][j];
                v = fmaf(mv.x, xv[0][j], v);
                v = fmaf(mv.y, xv[1][j], v);
                v = fmaf(mv.z, xv[2][j], v);
                acc[i][j] = fmaf(mv.w, xv[3][j], v);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i, col = tx * kYC;
          if (t >= rows || col >= ps) continue;
          float* yp = reinterpret_cast<float*>(p.y) + ((tok + t) * p.heads + hh) * p.hdim + p0 + col;
          if (p.vec_y) {
            store_floats(yp, acc[i]);
          } else {
#pragma unroll
            for (int j = 0; j < kYC; ++j)
              if (col + j < ps) yp[j] = acc[i][j];
          }
        }
      } else {
        // S <- exp(s_Q) S + (w o x)^T . B: tiles of 4 rows of P x 8 state
        // columns, a quarter-warp's lanes on 8 row groups and one column group
        const float wa = exp2f(sc.last - sc.sa) * dts[2 * lane];
        const float wb = exp2f(sc.last - sc.sb) * dts[2 * lane + 1];
        const int ut = tid - kYWarps * 32;
#pragma unroll
        for (int k = 0; k < kUT; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c8 = 0; c8 < 8; ++c8) uacc[k][r][c8] = 0.f;
#pragma unroll 2
        for (int u2 = 0; u2 < kQ / 2; ++u2) {
          const float2 w2 = step_pair(wa, wb, u2);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int u = 2 * u2 + h2;
            const float w = h2 ? w2.y : w2.x;
#pragma unroll
            for (int k = 0; k < kUT; ++k) {
              const int tix = ut + k * kUWarps * 32, pg = tix % kPG, ng = tix / kPG;
              if (ng * 8 >= np) break;
              const float4 xv = *reinterpret_cast<const float4*>(xf + u * L.ldx + pg * 4);
              const float4 b0 = *reinterpret_cast<const float4*>(bf + u * L.ldt + ng * 8);
              const float4 b1 = *reinterpret_cast<const float4*>(bf + u * L.ldt + ng * 8 + 4);
              const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
              const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
              for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c8 = 0; c8 < 8; ++c8) uacc[k][r][c8] = fmaf(xw[r], bv[c8], uacc[k][r][c8]);
            }
          }
        }
      }
      __syncthreads();  // every read of the chunk and of the old state is done
      if (!y_warp) {
        const int ut = tid - kYWarps * 32;
#pragma unroll
        for (int k = 0; k < kUT; ++k) {
          const int tix = ut + k * kUWarps * 32, pg = tix % kPG, ng = tix / kPG;
          if (ng * 8 >= np) break;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int h4 = 0; h4 < 2; ++h4) {
              float4* sp4 = reinterpret_cast<float4*>(sfs + (pg * 4 + r) * L.lds + ng * 8 + 4 * h4);
              const float4 o = *sp4;
              const float* a = uacc[k][r] + 4 * h4;
              *sp4 = make_float4(fmaf(o.x, decay, a[0]), fmaf(o.y, decay, a[1]),
                                 fmaf(o.z, decay, a[2]), fmaf(o.w, decay, a[3]));
            }
          }
        }
      }
    }
  }
  // the final state
  if constexpr (kBf16<T>) {
    if (!y_warp) {
#pragma unroll
      for (int j = 0; j < kSTiles / 2; ++j) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int half = e >> 2, r = (e >> 1) & 1;
          const int n = (sg + kSGroups * j) * 16 + half * 8 + 2 * q + (e & 1);
          const int pp = sp * 16 + g + 8 * r;
          if (pp < ps && n < p.N) p.sf[(state0 + pp) * p.N + n] = st[2 * j + half][e & 3];
        }
      }
    }
  } else {
    __syncthreads();
    for (int i = tid; i < ps * p.N; i += kThreads) {
      const int pp = i / p.N, n = i - pp * p.N;
      p.sf[(state0 + pp) * p.N + n] = sfs[pp * L.lds + n];
    }
  }
}

template <typename T>
using ScanKernel = void (*)(Params<T>);

// Opt the instance in to ``smem`` bytes and, once per device, to the largest
// shared-memory carveout (the resident blocks min_blocks counts on).
template <typename T, int kMaxN>
cudaError_t prepare(size_t smem) {
  static size_t opted[kMaxDevices] = {};
  static bool carved[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!carved[dev]) {
    e = cudaFuncSetAttribute(ssd_kernel<T, kMaxN>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    carved[dev] = true;
  }
  return set_smem(ssd_kernel<T, kMaxN>, smem, opted);
}

// The scan's instance for state size N, prepared, and its shared memory: N <=
// 128 (mamba2's) gets the instance cut for as many blocks an SM as its
// shared memory allows, N up to kMaxState the other.
template <typename T>
cudaError_t scan_instance(int N, ScanKernel<T>* kern, size_t* smem) {
  *smem = Layout<T>(N).bytes;
  *kern = N <= 128 ? ssd_kernel<T, 128> : ssd_kernel<T, kMaxState>;
  return N <= 128 ? prepare<T, 128>(*smem) : prepare<T, kMaxState>(*smem);
}

template <typename T>
cudaError_t launch(const Params<T>& p, int batch, cudaStream_t stream) {
  {
    const size_t smem = cb_smem<T>(p.N);
    static size_t opted[kMaxDevices] = {};
    const cudaError_t e = set_smem(cb_kernel<T>, smem, opted);
    if (e != cudaSuccess) return e;
    cb_kernel<T><<<dim3(p.nc, batch), kCbThreads, smem, stream>>>(p.Bm, p.Cm, p.cb, p.t_len, p.N,
                                                                 p.nc, p.vec);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return le;
  }
  ScanKernel<T> kern = nullptr;
  size_t smem = 0;
  const cudaError_t e = scan_instance<T>(p.N, &kern, &smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((p.hdim + kPS - 1) / kPS, p.heads, batch), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int N, int* blocks) {
  ScanKernel<T> kern = nullptr;
  size_t smem = 0;
  const cudaError_t e = scan_instance<T>(N, &kern, &smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads, smem);
}

bool on16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The constants the Python side assumes (ssd_scan.py's GEOMETRY), in its order.
constexpr int kGeometry[] = {kQ, kPS, kThreads};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it); s0 may be null
// (a zero initial state); cb: the C . B workspace, batch x ceil(t_len / 64) x
// 64 x 64 floats on 16 bytes. Launches cb_kernel then ssd_kernel on ``stream``.
// Returns the cudaError_t of the launches (0 on success); nothing here
// synchronizes.
int repro_ssd_scan(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* s0, void* y, void* sf, void* cb, int batch,
                   int t_len, int heads, int head_dim, int n_state, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || batch > 65535 || t_len <= 0 || heads <= 0 ||
      heads > 65535 || head_dim <= 0 || n_state <= 0 || n_state > kMaxState || cb == nullptr ||
      !on16(cb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esz = dtype == 0 ? 4 : 2;
  const int nc = (t_len + kQ - 1) / kQ;
  const int vec = on16(x) && on16(Bm) && on16(Cm) && (n_state * esz) % 16 == 0 &&
                  (head_dim * esz) % 16 == 0;
  const int vec_y = on16(y) && (head_dim * esz) % 16 == 0;
  cudaError_t e;
  if (dtype == 0) {
    const Params<float> p{static_cast<const float*>(x), static_cast<const float*>(dt),
                          static_cast<const float*>(A), static_cast<const float*>(Bm),
                          static_cast<const float*>(Cm), static_cast<const float*>(s0),
                          static_cast<float*>(cb), static_cast<float*>(y), static_cast<float*>(sf),
                          t_len, heads, head_dim, n_state, nc, vec, vec_y};
    e = launch<float>(p, batch, s);
  } else {
    const Params<bf16> p{static_cast<const bf16*>(x), static_cast<const float*>(dt),
                         static_cast<const float*>(A), static_cast<const bf16*>(Bm),
                         static_cast<const bf16*>(Cm), static_cast<const float*>(s0),
                         static_cast<float*>(cb), static_cast<bf16*>(y), static_cast<float*>(sf),
                         t_len, heads, head_dim, n_state, nc, vec, vec_y};
    e = launch<bf16>(p, batch, s);
  }
  return static_cast<int>(e);
}

// Blocks of ssd_kernel that fit on one SM at once (registers and shared memory
// for ``n_state``), into *blocks.
int repro_ssd_blocks_per_sm(int dtype, int n_state, int* blocks) {
  if ((dtype != 0 && dtype != 1) || n_state <= 0 || n_state > kMaxState || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  return static_cast<int>(dtype == 0 ? occupancy<float>(n_state, blocks)
                                     : occupancy<bf16>(n_state, blocks));
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
