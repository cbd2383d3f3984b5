// The paper's benchmark-suite kernels for Hopper (sm_90a): Sum3D, Stencil3D,
// TinyMatrixSum (static and dynamic inner extents) and MatVec (layout_right
// and layout_left), with a plain C interface loaded through ctypes
// (repro_torch/kernels/{sum3d,stencil3d,tinymatsum,matvec}.py hold the
// wrappers and the plain PyTorch versions they are held against).
//
// What they replace (the JAX reference package's Pallas TPU kernels):
//   sum3d_kernel<T>                  <- src/repro/kernels/sum3d.py::sum3d_pallas
//   stencil3d_kernel                 <- src/repro/kernels/stencil3d.py::stencil3d_pallas
//   tinymatsum_static_kernel<T,J,K>  <- src/repro/kernels/tinymatsum.py::tinymatsum_static
//   tinymatsum_dynamic_kernel<T>     <- src/repro/kernels/tinymatsum.py::tinymatsum_dynamic
//   matvec_kernel<T, Right, VEC>     <- src/repro/kernels/matvec.py::matvec_right
//   matvec_kernel<T, Left, VEC>      <- src/repro/kernels/matvec.py::matvec_left
//     (+ matvec_splits_kernel where Left splits j across blocks)
//
// These are the paper's own C++ experiments, so the C++ says what the paper
// says. Each computes the reference function, not the Pallas BlockSpecs:
//
//   Sum3D       bound by the bytes: it reads each element once and adds it
//               once. Reaching the copy rate takes enough bytes in flight:
//               at ~3e12 B/s and 0.6-0.8 us of latency an SM needs some
//               14-18 KB outstanding. One scalar a load, four in flight a
//               thread, gives a bf16 SM ~16 KB, just at the edge; so each
//               thread loads whole 16-byte vectors (4 f32, 8 bf16), kSumVecs
//               of them in flight a step (64 B), with f32 accumulators, and
//               the grid is the blocks resident on the card at once (the
//               occupancy query x the SMs; fewer where the buffer is small),
//               split evenly by a grid-stride walk, so every SM holds the
//               same share and no last wave runs part-empty. The elements
//               before the first 16-byte boundary and after the last whole
//               vector (each fewer than a vector's) are added one a thread by
//               block 0. One cooperative launch: each block writes its
//               partial, the grid synchronizes (the grid is one wave, so it
//               is co-resident; a launch the card cannot hold is refused
//               with an error), and block 0 folds the partials in index
//               order. Deterministic: every addition's order is fixed by n,
//               the alignment and the grid (which depend on the size and
//               the device only), none by timing, and no float atomics, so
//               repeated runs are bit-identical.
//   Stencil3D   each output sums its 27 neighbours from 0 in f32 in the
//               plain version's order (di, dj, dk); interior only, the
//               boundary (and I, J or K < 3) gives 0. A block owns a
//               kStJ x kStK tile of (j, k) and walks a run of i-planes; each
//               input plane's (kStJ + 2) x (kStK + 2) window lands in a ring
//               of kStPlanes planes in shared memory, kStPlanes - 1 planes
//               ahead (cp.async), and each thread keeps the neighbourhoods
//               of its kStRows outputs of three planes in registers,
//               reading (kStRows + 2) x 3 values a plane from shared memory
//               instead of 27 an output from L1. Loads are reused, never
//               partial sums: a separable or running sum would round
//               differently (below, at the Stencil3D section).
//   TinyMatSum  one body, tinymatsum_body<T, Ext>, templated on an extents
//               policy: StaticJK<J, K> (the card's extents<3, 3>: J and K are
//               template arguments, the per-matrix loops unroll and every
//               offset folds to a constant) or DynamicJK (runtime ints, runtime
//               loops and index math), over the same unpadded (N, J, K)
//               buffers (the reference pads to (jmax, kmax) only for TPU
//               sublane alignment). Paper Fig. 5 is the gap between the two.
//               Each thread sums whole matrices by that loop nest; the bytes
//               move apart from it: a block stages contiguous spans of
//               matrices through shared memory with 16-byte copies and
//               stores them back with 16-byte stores, other blocks' loads in
//               flight meanwhile (below, at the TinyMatrixSum section).
//               Reading one matrix a thread from global memory would put a
//               warp's 32 lanes 36 bytes apart on every load and store.
//               Dynamic matrices too large to stage are summed a block a
//               matrix from global memory (the unstaged form).
//   MatVec      one kernel body templated on a layout policy (Right / Left,
//               each an offset(i, j) functor and the fact of which index it
//               stores at stride 1, as mdspan's layout_right / layout_left).
//               The policy picks the schedule, as the reference's Pallas
//               kernels do (contraction on lanes for right, a reduction
//               across sublanes over a (J-blocks x I-blocks) grid for left):
//               the lanes always walk the stride-1 index, 16 bytes a lane,
//               with several loads in flight (below, at the MatVec section).
//               Paper Fig. 6 is the right / left gap of the SAME schedule;
//               with one thread per row a layout_right warp reads 32 rows a
//               stride of J apart, so the gap here is the schedule's.
//
// What bounds them on an H100: all four are bytes-bound (at most 27 adds, or
// 2 flops, per element read); the bound is the bytes each must move (inputs
// read once, outputs written once) over the device memory rate. Offsets are
// int64: the phase sizes pass 2^27 elements.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiny = 8;  // static TinyMatSum instantiates J, K in 1..8

// ---- Sum3D ------------------------------------------------------------------
// The buffer as the kernel reads it: ``head`` elements before the first
// 16-byte boundary (the launch derives it from x's address), then nvec whole
// 16-byte vectors, then the tail (head and tail each fewer than a vector's
// elements). Vector v belongs to thread v % kSumThreads of block
// (v / kSumThreads) % gridDim.x: a grid-stride walk, kSumVecs vectors in
// flight a step, so the blocks' shares differ by at most one vector a thread.
// A thread adds lane k of each vector into acc[k] in walk order, then sums
// its lanes pairwise; block 0's threads add one head and one tail element
// each; block_sum gives the block's partial.
constexpr int kSumThreads = 256;
constexpr int kSumVecBytes = 16;
constexpr int kSumVecs = 4;

// Sum of v over the block, in a fixed order (warp shuffles, then warp 0 over
// the per-warp sums); the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  constexpr int kSumWarps = kSumThreads / 32;
  __shared__ float warp_sums[kSumWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kSumWarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// The elements of one 16-byte vector into acc: 4 f32, or 8 bf16 (a bf16's
// f32 value is its bits in the high half).
__device__ __forceinline__ void add_vec(float (&acc)[4], const uint4 v) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}
__device__ __forceinline__ void add_vec(float (&acc)[8], const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] += __uint_as_float(w[k] << 16);
    acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum3d_kernel(const T* __restrict__ x, int64_t n, int head, float* __restrict__ partials,
             float* __restrict__ out) {
  constexpr int L = kSumVecBytes / static_cast<int>(sizeof(T));
  const int64_t nvec = (n - head) / L;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSumThreads;
  int64_t v = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  float acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0.f;
  for (; v + (kSumVecs - 1) * stride < nvec; v += kSumVecs * stride) {
    uint4 r[kSumVecs];
#pragma unroll
    for (int u = 0; u < kSumVecs; ++u) r[u] = __ldg(xv + v + u * stride);
#pragma unroll
    for (int u = 0; u < kSumVecs; ++u) add_vec(acc, r[u]);
  }
  for (; v < nvec; v += stride) add_vec(acc, __ldg(xv + v));
#pragma unroll
  for (int w = 1; w < L; w *= 2) {
#pragma unroll
    for (int k = 0; k < L; k += 2 * w) acc[k] += acc[k + w];
  }
  float s = acc[0];
  if (blockIdx.x == 0) {
    const int64_t tail = head + nvec * L;
    const int t = static_cast<int>(threadIdx.x);
    if (t < head) s += to_f32(x[t]);
    if (t < n - tail) s += to_f32(x[tail + t]);
  }
  const float total = block_sum(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
  cooperative_groups::this_grid().sync();  // every partial written and visible
  if (blockIdx.x != 0) return;
  float f = 0.f;
  for (int p = threadIdx.x; p < static_cast<int>(gridDim.x); p += kSumThreads) {
    f += __ldcg(partials + p);
  }
  f = block_sum(f);
  if (threadIdx.x == 0) out[0] = f;
}

// ---- Stencil3D --------------------------------------------------------------
// A block owns the tile j0 .. j0 + kStJ - 1, k0 .. k0 + kStK - 1 (a thread a
// k, kStRows consecutive j-rows each) and the run of output planes
// i0 .. i0 + run - 1 (blockIdx: k-tile, j-tile, run; the wrapper's
// plan_stencil3d picks run). Its interior planes ib .. ie - 1 (0 and I - 1
// excluded) need input planes ib - 1 .. ie; each is staged as the window
// j0 - 1 .. j0 + kStJ, k0 - 1 .. k0 + kStK (cells outside the array as zeros:
// only boundary outputs, which are 0, would read them). A staged row keeps
// the body on 16 bytes: the body at kPad (the elements in 16 bytes), the halo
// at kPad - 1 and kPad + kStK. With ``vec`` (x on 16 bytes, K * sizeof(T) a
// multiple of 16: the entry point checks) the body goes by 16-byte cp.async and each halo by one
// 4-byte cp.async (f32: the value; bf16: the aligned pair that holds it),
// each thread's copies fixed for the run but for the plane's offset;
// otherwise by plain loads. Plane n is read after the copies of plane
// n + kStPlanes - 1 are issued, so kStPlanes - 1 planes are in flight.
//
// What bounds it: the bytes (x read once, out written once), and in bf16 the
// additions come close: an output is 27 dependent f32 additions whatever the
// schedule (the order is fixed); what the schedule decides is the rest. A thread keeps its (kStRows + 2) x 3
// values of each of three planes in registers, reads (kStRows + 2) x 3 new
// values a plane from shared memory (4.5 an output at kStRows 4, against 27
// loads from L1 one output a thread), sums its kStRows outputs side by side
// (independent chains), and the plane loop is unrolled by three so that the
// window rotates by renaming, not by moves. The tile is wide in k (a staged
// row is 256 bytes in f32) and one block holds few threads, so that several
// blocks share an SM: scripts/time_rglru_stencil.py --variants times the
// alternatives.
constexpr int kStJ = 8;          // j-rows of a tile
constexpr int kStK = 64;         // k of a tile: a thread each (two warps a row group)
constexpr int kStRows = 4;       // consecutive j-rows a thread
constexpr int kStPlanes = 4;     // planes of the ring (>= 2)
constexpr int kStRun = 32;       // output planes of a run at most (the planner's ceiling)
constexpr int kStThreads = kStJ / kStRows * kStK;
constexpr int kStMaxGridYZ = 65535;
static_assert(kStJ % kStRows == 0, "whole rows a thread");

template <typename T>
struct StencilStage {
  static constexpr int kPad = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  static constexpr int kLD = 2 * kPad + kStK;                     // a staged row
  static constexpr int kRows = kStJ + 2;
  static constexpr int kPlane = kRows * kLD;
  static constexpr int kChunks = kStK / kPad;               // 16-byte copies a row body
  static constexpr int kCopies = kRows * kChunks + 2 * kRows;  // a plane's copies (vec)
  static constexpr int kMine = (kCopies + kStThreads - 1) / kStThreads;  // a thread's
};

// One cp.async of each staged plane, fixed for the block: ``src`` the offset
// in a plane of x (-1: a cell outside the array, zero-filled), ``dst`` in a
// plane of the ring (-1: none), 16 or 4 bytes.
struct StencilCopy {
  int64_t src;
  int dst;
  bool wide;
};

template <typename T>
__device__ __forceinline__ StencilCopy stencil_copy(int c, int j0, int k0, int J, int K) {
  using S = StencilStage<T>;
  if (c >= S::kCopies) return {-1, -1, false};
  if (c < S::kRows * S::kChunks) {  // body: K * sizeof(T) % 16 == 0, a chunk is in or out
    const int r = c / S::kChunks, col = (c - r * S::kChunks) * S::kPad;
    const int jr = j0 - 1 + r, kc = k0 + col;
    const bool ok = jr >= 0 && jr < J && kc < K;
    return {ok ? static_cast<int64_t>(jr) * K + kc : -1, r * S::kLD + S::kPad + col, true};
  }
  // halo: f32 the value, bf16 the 4-byte pair that holds it (in the value's
  // row: K is a multiple of 8); ``lo`` elements of the copy precede the value
  const int h = c - S::kRows * S::kChunks, r = h >> 1, right = h & 1;
  const int lo = static_cast<int>(4 / sizeof(T)) - 1;
  const int jr = j0 - 1 + r, kc = right ? k0 + kStK : k0 - 1 - lo;
  const bool ok = jr >= 0 && jr < J && kc >= 0 && kc + lo < K;
  return {ok ? static_cast<int64_t>(jr) * K + kc : -1,
          r * S::kLD + (right ? S::kPad + kStK : S::kPad - 1 - lo), false};
}

// Stage input plane p into ``dst`` (a plane of the ring).
template <typename T>
__device__ __forceinline__ void stencil_stage(const T* __restrict__ x, T* dst, int p,
                                              const StencilCopy (&mine)[StencilStage<T>::kMine],
                                              int j0, int k0, int J, int K, bool vec) {
  using S = StencilStage<T>;
  const int64_t base = static_cast<int64_t>(p) * J * K;
  if (vec) {
#pragma unroll
    for (int m = 0; m < S::kMine; ++m) {
      const StencilCopy& c = mine[m];
      if (c.dst < 0) continue;
      const T* src = c.src >= 0 ? x + base + c.src : x;
      if (c.wide) {
        cp_async16(dst + c.dst, src, c.src >= 0 ? 16 : 0);
      } else {
        cp_async4(dst + c.dst, src, c.src >= 0 ? 4 : 0);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < S::kRows * (kStK + 2); e += kStThreads) {
    const int r = e / (kStK + 2), c = e - r * (kStK + 2) - 1;  // c in -1 .. kStK
    const int jr = j0 - 1 + r, kc = k0 + c;
    dst[r * S::kLD + S::kPad + c] = jr >= 0 && jr < J && kc >= 0 && kc < K
                                        ? x[base + static_cast<int64_t>(jr) * K + kc]
                                        : from_f32<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kStThreads)
stencil3d_kernel(const T* __restrict__ x, T* __restrict__ out, int I, int J, int K, int run,
                 bool vec) {
  using S = StencilStage<T>;
  constexpr int W = kStRows + 2;  // staged rows a thread reads
  __shared__ __align__(16) T ring[kStPlanes * S::kPlane];
  const int kk = threadIdx.x % kStK, jt = threadIdx.x / kStK * kStRows;
  const int k0 = blockIdx.x * kStK, j0 = blockIdx.y * kStJ;
  const int i0 = blockIdx.z * run, i1 = min(i0 + run, I);
  const int k = k0 + kk;
  const int64_t jk = static_cast<int64_t>(J) * K;
  T* op = out + static_cast<int64_t>(j0 + jt) * K + k;
  bool in[kStRows], inner[kStRows];
#pragma unroll
  for (int q = 0; q < kStRows; ++q) {
    const int j = j0 + jt + q;
    in[q] = j < J && k < K;
    inner[q] = j > 0 && j < J - 1 && k > 0 && k < K - 1;
    if (in[q]) {  // the run's boundary planes
      if (i0 == 0) op[q * K] = from_f32<T>(0.f);
      if (I > 1 && I - 1 >= i0 && I - 1 < i1) op[q * K + (I - 1) * jk] = from_f32<T>(0.f);
    }
  }
  const int ib = max(i0, 1), ie = min(i1, I - 1);
  if (ib >= ie) return;
  const int n_in = ie - ib + 2;  // staged planes ib - 1 .. ie
  StencilCopy mine[S::kMine];
#pragma unroll
  for (int m = 0; m < S::kMine; ++m)
    mine[m] = stencil_copy<T>(threadIdx.x + m * kStThreads, j0, k0, J, K);
#pragma unroll
  for (int n = 0; n < kStPlanes - 1; ++n) {
    if (n < n_in) stencil_stage(x, ring + n * S::kPlane, ib - 1 + n, mine, j0, k0, J, K, vec);
    cp_async_commit();
  }
  // Plane n: wait for it, issue plane n + kStPlanes - 1, read the thread's
  // W x 3 values of it into ``cur`` and, from n 2 on, write output plane
  // ib + n - 2 = the sum over (older, mid, cur) in the order (di, dj, dk).
  auto plane = [&](int n, const float (&older)[W][3], const float (&mid)[W][3],
                   float (&cur)[W][3]) {
    cp_async_wait<kStPlanes - 2>();
    __syncthreads();  // plane n landed; every thread is done with plane n - 1's slot
    const int ahead = n + kStPlanes - 1;
    if (ahead < n_in)
      stencil_stage(x, ring + (ahead % kStPlanes) * S::kPlane, ib - 1 + ahead, mine, j0, k0, J,
                    K, vec);
    cp_async_commit();
    const T* sp = ring + (n % kStPlanes) * S::kPlane + jt * S::kLD + S::kPad - 1 + kk;
#pragma unroll
    for (int r = 0; r < W; ++r)
#pragma unroll
      for (int dk = 0; dk < 3; ++dk) cur[r][dk] = to_f32(sp[r * S::kLD + dk]);
    if (n < 2) return;
    // the kStRows sums side by side (independent chains), each in the order
    // (di, dj, dk); a boundary output takes 0 instead
    float acc[kStRows];
#pragma unroll
    for (int q = 0; q < kStRows; ++q) acc[q] = 0.f;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int dk = 0; dk < 3; ++dk)
#pragma unroll
        for (int q = 0; q < kStRows; ++q) acc[q] += older[q + dj][dk];
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int dk = 0; dk < 3; ++dk)
#pragma unroll
        for (int q = 0; q < kStRows; ++q) acc[q] += mid[q + dj][dk];
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int dk = 0; dk < 3; ++dk)
#pragma unroll
        for (int q = 0; q < kStRows; ++q) acc[q] += cur[q + dj][dk];
    T* o = op + (ib - 2 + n) * jk;
#pragma unroll
    for (int q = 0; q < kStRows; ++q)
      if (in[q]) o[q * K] = from_f32<T>(inner[q] ? acc[q] : 0.f);
  };
  float wa[W][3], wb[W][3], wc[W][3];  // the window's three planes, rotated by name
  for (int n = 0; n < n_in; n += 3) {
    plane(n, wb, wc, wa);
    if (n + 1 < n_in) plane(n + 1, wc, wa, wb);
    if (n + 2 < n_in) plane(n + 2, wa, wb, wc);
  }
}

// ---- TinyMatrixSum ----------------------------------------------------------
// A block walks spans of bn consecutive matrices, span blockIdx.x, then
// + gridDim.x, ...: bn J K elements of each operand, bn J K sizeof(T) a
// multiple of 16 bytes (the wrapper's plan_tinymatsum picks bn and the grid).
// A span's o and s land in shared memory; each thread then runs the paper's
// loop nest over (j, k) for its matrices of the span (m = threadIdx.x,
// + kThreads, ...) out of it, writing o + s over o's copy, and the block
// stores the span. The plan makes the grid the blocks that fit on the card at
// once (registers included: a block left for a second wave would run with few
// others on its SM), so an SM's other blocks keep loads in flight while one
// block sums and stores.
//
// Vector form (o, s and out on 16 bytes, N J K sizeof(T) a multiple of 16):
// 16-byte cp.async copies in and 16-byte stores out, consecutive lanes on
// consecutive chunks. Scalar form (anything else): the same spans and stage
// layout, one element a lane, consecutive lanes on consecutive elements,
// through registers.
//
// Stage layout: matrix m of a span at m * P elements (tiny_stride). A warp
// reads element (j, k) of 32 matrices P apart, so P = J K with J K sizeof(T)
// an even number of 16-byte chunks would put 8 to 32 lanes on one bank; such
// a matrix gets one chunk of padding, an odd chunk count: 16-byte reads then
// hit distinct bank groups and 4-byte ones at most 4 lanes a bank. A padded
// matrix is whole chunks, so the 16-byte copies stay whole; an odd J K (the
// paper's 3 x 3) needs no padding, its stride already spreads the banks.
//
// Unstaged form (bn 0; dynamic extents only): matrices so large that the
// fewest that make whole chunks do not fit a block's shared memory (f32 J K
// past ~7264) are summed straight from global memory, a block a matrix.
__host__ __device__ constexpr int tiny_stride(int jk, int esize) {
  return (jk * esize) % 16 == 0 && (jk * esize / 16) % 2 == 0 ? jk + 16 / esize : jk;
}

// Extents policies, as mdspan's extents<J, K> and dextents<2>.
template <int J, int K> struct StaticJK {
  __device__ static constexpr int j() { return J; }
  __device__ static constexpr int k() { return K; }
};
struct DynamicJK {
  int J, K;
  __device__ int j() const { return J; }
  __device__ int k() const { return K; }
};

// The paper's per-matrix loop nest, o's copy a += s's copy b: with static
// extents both loops unroll (a constant trip count) and every offset is a
// constant; with dynamic ones they stay runtime loops over runtime offsets
// (scripts/time_tinymatsum.py --sass counts each one's instructions a matrix).
template <typename T, typename Ext> struct WholeChunks : std::false_type {};
template <typename T, int J, int K>
struct WholeChunks<T, StaticJK<J, K>>
    : std::bool_constant<tiny_stride(J * K, sizeof(T)) * sizeof(T) % 16 == 0> {};

template <typename T, typename Ext>
__device__ __forceinline__ void sum_matrix(T* __restrict__ a, const T* __restrict__ b, Ext ext) {
  if constexpr (WholeChunks<T, Ext>::value) {
    a = static_cast<T*>(__builtin_assume_aligned(a, 16));  // a whole number of chunks
    b = static_cast<const T*>(__builtin_assume_aligned(b, 16));
  }
#pragma unroll
  for (int j = 0; j < ext.j(); ++j)
#pragma unroll
    for (int k = 0; k < ext.k(); ++k) {
      const int e = j * ext.k() + k;
      a[e] = from_f32<T>(to_f32(a[e]) + to_f32(b[e]));
    }
}

// Items i = threadIdx.x, + kThreads, ... of a span cut into matrices of
// ``per`` items: (m, w) = (i / per, i % per), advanced without a division.
struct SpanWalk {
  int per, m, w, dm, dw;
  __device__ explicit SpanWalk(int per_)
      : per(per_), m(threadIdx.x / per_), w(threadIdx.x % per_), dm(kThreads / per_),
        dw(kThreads % per_) {}
  __device__ void next() {
    m += dm;
    w += dw;
    if (w >= per) {
      w -= per;
      ++m;
    }
  }
};

template <typename T, typename Ext>
__device__ __forceinline__ void tinymatsum_body(const T* __restrict__ o, const T* __restrict__ s,
                                                T* __restrict__ out, int64_t n, Ext ext, int bn,
                                                bool vec) {
  extern __shared__ __align__(16) unsigned char tiny_smem[];
  constexpr int V = 16 / sizeof(T);
  const int JK = ext.j() * ext.k();
  const int P = tiny_stride(JK, sizeof(T));
  T* const so = reinterpret_cast<T*>(tiny_smem);  // o's copy of the span
  T* const ss = so + bn * P;                      // s's copy
  const int64_t spans = (n + bn - 1) / bn;
  for (int64_t span = blockIdx.x; span < spans; span += gridDim.x) {
    const int64_t e0 = span * bn * JK;
    const int64_t left = n - span * bn;
    const int cnt = static_cast<int>(left < bn ? left : bn);  // matrices in the span
    const int elems = cnt * JK;
    if (vec && P == JK) {
      for (int c = threadIdx.x; c < elems / V; c += kThreads) {
        cp_async16(so + c * V, o + e0 + c * V, 16);
        cp_async16(ss + c * V, s + e0 + c * V, 16);
      }
    } else if (vec) {  // padded: J K sizeof(T) is whole chunks
      SpanWalk w(JK / V);
      for (int c = threadIdx.x; c < elems / V; c += kThreads, w.next()) {
        const int d = w.m * P + w.w * V;
        cp_async16(so + d, o + e0 + c * V, 16);
        cp_async16(ss + d, s + e0 + c * V, 16);
      }
    } else {
      SpanWalk w(JK);
      for (int e = threadIdx.x; e < elems; e += kThreads, w.next()) {
        const int d = w.m * P + w.w;
        so[d] = o[e0 + e];
        ss[d] = s[e0 + e];
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int m = threadIdx.x; m < cnt; m += kThreads) sum_matrix(so + m * P, ss + m * P, ext);
    __syncthreads();
    if (vec && P == JK) {
      for (int c = threadIdx.x; c < elems / V; c += kThreads) {
        *reinterpret_cast<uint4*>(out + e0 + c * V) = *reinterpret_cast<const uint4*>(so + c * V);
      }
    } else if (vec) {
      SpanWalk w(JK / V);
      for (int c = threadIdx.x; c < elems / V; c += kThreads, w.next()) {
        *reinterpret_cast<uint4*>(out + e0 + c * V) =
            *reinterpret_cast<const uint4*>(so + w.m * P + w.w * V);
      }
    } else {
      SpanWalk w(JK);
      for (int e = threadIdx.x; e < elems; e += kThreads, w.next()) out[e0 + e] = so[w.m * P + w.w];
    }
    __syncthreads();  // the next span's copies overwrite the stage
  }
}

// The unstaged form: matrix m by block m, + gridDim.x, ...; the block's
// threads take its elements in the loop nest's (row-major) order,
// consecutive lanes on consecutive elements.
template <typename T>
__device__ __forceinline__ void tinymatsum_unstaged(const T* __restrict__ o,
                                                    const T* __restrict__ s,
                                                    T* __restrict__ out, int64_t n, int J, int K) {
  const int64_t jk = static_cast<int64_t>(J) * K;
  for (int64_t m = blockIdx.x; m < n; m += gridDim.x) {
    for (int64_t e = m * jk + threadIdx.x; e < (m + 1) * jk; e += kThreads) {
      out[e] = from_f32<T>(to_f32(o[e]) + to_f32(s[e]));
    }
  }
}

template <typename T, int J, int K>
__global__ void __launch_bounds__(kThreads)
tinymatsum_static_kernel(const T* __restrict__ o, const T* __restrict__ s, T* __restrict__ out,
                         int64_t n, int bn, int vec) {
  tinymatsum_body(o, s, out, n, StaticJK<J, K>{}, bn, vec != 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tinymatsum_dynamic_kernel(const T* __restrict__ o, const T* __restrict__ s, T* __restrict__ out,
                          int64_t n, int J, int K, int bn, int vec) {
  if (bn == 0) {
    tinymatsum_unstaged(o, s, out, n, J, K);
  } else {
    tinymatsum_body(o, s, out, n, DynamicJK{J, K}, bn, vec != 0);
  }
}

// ---- MatVec -----------------------------------------------------------------
// One body, matvec_kernel<T, Layout, VEC>, mapping the warp's lanes to the
// index its layout stores at stride 1 (Layout::kStrideOneI), with f32
// accumulation, output in T and every sum in a fixed order (no float atomics:
// repeated runs are bit-identical). A lane holds V = 16 /
// sizeof(T) elements of a run of 32 * V along the contiguous index: in the
// vector form the lane's V are adjacent and come in one 16-byte load; in the
// scalar form (a buffer off a 16-byte boundary, or a contiguous extent that
// is no multiple of V) they lie 32 apart and come in V coalesced loads.
// Either way a warp's load covers 32 * V consecutive elements.
//
// The layout picks the schedule:
//   Right (row-major, j contiguous): a warp per row i, kWarps rows a block;
//         each lane loads kRightUnroll runs of A's row and of x before their
//         FMAs (x, 64 KB at J 16384, is read by every row: it stays in L1 and
//         L2); the lane's V sums, then the warp's 32, are added in a fixed
//         order (warp_sum).
//   Left  (column-major, i contiguous): a block per run of 32 * V rows (and
//         per split of j, below); its kWarps warps take every kWarps-th j,
//         kLeftUnroll columns of A in flight a warp before their FMAs, each
//         lane accumulating its V rows; the warps' partial y meet once in
//         shared memory, added in warp order. Where the runs of rows are too
//         few for two blocks a SM (I 16384 f32: 128), j is split across
//         blocks too: each split writes its partial y to an f32 workspace
//         and matvec_splits_kernel adds the splits in order.
//
// Layout policies, as mdspan's layout_right / layout_left: the offset of
// A(i, j) in the stored buffer, and which index is stride-1 there.
struct Right {  // buffer (I, J)
  static constexpr bool kStrideOneI = false;
  int64_t I, J;
  __device__ __forceinline__ int64_t offset(int64_t i, int64_t j) const { return i * J + j; }
};
struct Left {  // buffer (J, I)
  static constexpr bool kStrideOneI = true;
  int64_t I, J;
  __device__ __forceinline__ int64_t offset(int64_t i, int64_t j) const { return j * I + i; }
};

constexpr int kRightUnroll = 4;  // runs of A and of x a lane loads before its FMAs
constexpr int kLeftUnroll = 8;   // columns of A a warp loads before its FMAs

template <typename T> struct VecWidth { static constexpr int value = 16 / sizeof(T); };

// The lane's V elements of a run starting at p, of which the first n >= 1
// exist: adjacent (VEC, one 16-byte load; then n is a multiple of V) or 32
// apart (V loads); absent ones are 0. Every load is issued unconditionally
// (an absent element's address is clamped into the run and its value
// dropped), so a caller's loads of several runs go out back to back.
template <typename T, bool VEC>
__device__ __forceinline__ void load_run(const T* __restrict__ p, int lane, int64_t n,
                                         float (&x)[VecWidth<T>::value]) {
  constexpr int V = VecWidth<T>::value;
  if constexpr (VEC) {
    const bool in = static_cast<int64_t>(lane) * V < n;
    const uint4 u = *reinterpret_cast<const uint4*>(p + (in ? lane * V : n - V));
    if constexpr (sizeof(T) == 4) {
      x[0] = __uint_as_float(u.x);
      x[1] = __uint_as_float(u.y);
      x[2] = __uint_as_float(u.z);
      x[3] = __uint_as_float(u.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < V / 2; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = in ? x[e] : 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int64_t k = lane + 32 * e;
      const float v = to_f32(p[k < n ? k : n - 1]);
      x[e] = k < n ? v : 0.f;
    }
  }
}

// the run offset of the lane's e-th element
template <int V, bool VEC>
__device__ __forceinline__ int run_elem(int lane, int e) { return VEC ? lane * V + e : lane + 32 * e; }

// j on the lanes: block b holds rows b * kWarps + warp
template <typename T, bool VEC, typename Layout>
__device__ __forceinline__ void matvec_rows_on_warps(const T* __restrict__ a,
                                                     const T* __restrict__ x,
                                                     T* __restrict__ y, Layout map) {
  constexpr int V = VecWidth<T>::value, RUN = 32 * V, U = kRightUnroll;
  const int64_t I = map.I, J = map.J;
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= I) return;
  const T* row = a + map.offset(i, 0);
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  int64_t j0 = 0;
  for (; j0 + U * RUN <= J; j0 += U * RUN) {
    float av[U][V], xv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_run<T, VEC>(row + j0 + u * RUN, lane, RUN, av[u]);
      load_run<T, VEC>(x + j0 + u * RUN, lane, RUN, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(av[u][e], xv[u][e], acc[e]);
  }
  for (; j0 < J; j0 += RUN) {  // the tail: fewer than U runs, the last one ragged
    float av[V], xv[V];
    load_run<T, VEC>(row + j0, lane, J - j0, av);
    load_run<T, VEC>(x + j0, lane, J - j0, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = fmaf(av[e], xv[e], acc[e]);
  }
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) s += acc[e];
  s = warp_sum(s);
  if (lane == 0) y[i] = from_f32<T>(s);
}

// i on the lanes: block (b, s) holds rows [b * 32 V, (b + 1) * 32 V) over
// columns [s * cols_per_split, (s + 1) * cols_per_split)
template <typename T, bool VEC, typename Layout>
__device__ __forceinline__ void matvec_cols_on_warps(const T* __restrict__ at,
                                                     const T* __restrict__ x,
                                                     T* __restrict__ y, float* __restrict__ ws,
                                                     Layout map, int64_t cols_per_split) {
  constexpr int V = VecWidth<T>::value, RUN = 32 * V, U = kLeftUnroll;
  const int64_t I = map.I, J = map.J;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * RUN;
  const int64_t n = I - i0 < RUN ? I - i0 : RUN;  // rows of this run that exist
  const int64_t j_lo = blockIdx.y * cols_per_split;
  const int64_t j_hi = j_lo + cols_per_split < J ? j_lo + cols_per_split : J;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  int64_t j = j_lo + warp;
  for (; j + (U - 1) * kWarps < j_hi; j += U * kWarps) {
    float av[U][V], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_run<T, VEC>(at + map.offset(i0, j + u * kWarps), lane, n, av[u]);
      xv[u] = to_f32(x[j + u * kWarps]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(av[u][e], xv[u], acc[e]);
  }
  for (; j < j_hi; j += kWarps) {
    float av[V];
    load_run<T, VEC>(at + map.offset(i0, j), lane, n, av);
    const float xj = to_f32(x[j]);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = fmaf(av[e], xj, acc[e]);
  }
  __shared__ float part[kWarps][RUN];
#pragma unroll
  for (int e = 0; e < V; ++e) part[warp][run_elem<V, VEC>(lane, e)] = acc[e];
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][r];
    if (gridDim.y == 1) {
      y[i0 + r] = from_f32<T>(s);
    } else {
      ws[blockIdx.y * I + i0 + r] = s;
    }
  }
}

template <typename T, typename Layout, bool VEC>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ y,
              float* __restrict__ ws, Layout map, int64_t cols_per_split) {
  if constexpr (Layout::kStrideOneI) {
    matvec_cols_on_warps<T, VEC>(a, x, y, ws, map, cols_per_split);
  } else {
    matvec_rows_on_warps<T, VEC>(a, x, y, map);
  }
}

// y[i] = the sum of the splits' partials ws[s * I + i], s in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_splits_kernel(const float* __restrict__ ws, T* __restrict__ y, int64_t I, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= I) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += ws[k * I + i];
  y[i] = from_f32<T>(s);
}

// ---- launchers ----------------------------------------------------------------
unsigned int grid_for(int64_t n) { return static_cast<unsigned int>((n + kThreads - 1) / kThreads); }

// One cooperative launch of ``grid`` blocks; the head runs to x's first
// 16-byte boundary (all n where n is fewer).
template <typename T>
cudaError_t launch_sum3d(const void* x, int64_t n, int grid, void* partials, void* out,
                         cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int64_t to_boundary = static_cast<int64_t>(
      (kSumVecBytes - reinterpret_cast<uintptr_t>(x) % kSumVecBytes) % kSumVecBytes) /
      static_cast<int64_t>(sizeof(T));
  int head = static_cast<int>(to_boundary < n ? to_boundary : n);
  float* pt = static_cast<float*>(partials);
  float* ot = static_cast<float*>(out);
  void* args[] = {&xt, &n, &head, &pt, &ot};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sum3d_kernel<T>), grid,
                                     kSumThreads, args, 0, st);
}

template <typename T>
cudaError_t launch_stencil3d(const void* x, void* out, int I, int J, int K, int run, bool vec,
                             cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(K) + kStK - 1) / kStK),
                  static_cast<unsigned>((static_cast<int64_t>(J) + kStJ - 1) / kStJ),
                  static_cast<unsigned>((static_cast<int64_t>(I) + run - 1) / run));
  stencil3d_kernel<T><<<grid, kStThreads, 0, st>>>(static_cast<const T*>(x),
                                                   static_cast<T*>(out), I, J, K, run, vec);
  return cudaGetLastError();
}

// The wrapper's plan: matrices a span (0: the unstaged form), blocks, and the
// vector form (1) or the scalar one (0).
struct TinyPlan {
  int bn, grid, vec;
};

// Shared memory of a block: both operands' copies of a span.
int64_t tiny_smem_bytes(int64_t jk, int esize, const TinyPlan& p) {
  if (p.bn == 0) return 0;
  return 2 * static_cast<int64_t>(p.bn) * tiny_stride(static_cast<int>(jk), esize) * esize;
}

// A kernel instantiation and its record for set_smem (the attribute is
// raised once, where a plan needs more than 48 KB).
template <typename Kernel> struct TinyKernel {
  Kernel kern;
  size_t* opted;
};
template <typename T>
using StaticFn = void (*)(const T*, const T*, T*, int64_t, int, int);
template <typename T>
using DynamicFn = void (*)(const T*, const T*, T*, int64_t, int, int, int, int);

template <typename T, int J, int K> TinyKernel<StaticFn<T>> static_entry() {
  static size_t opted[kMaxDevices] = {};
  return {tinymatsum_static_kernel<T, J, K>, opted};
}

// Runtime (J, K) -> the instantiation with those template arguments
// (kern nullptr where there is none).
template <typename T, int J> TinyKernel<StaticFn<T>> static_for_k(int K) {
  switch (K) {
    case 1: return static_entry<T, J, 1>();
    case 2: return static_entry<T, J, 2>();
    case 3: return static_entry<T, J, 3>();
    case 4: return static_entry<T, J, 4>();
    case 5: return static_entry<T, J, 5>();
    case 6: return static_entry<T, J, 6>();
    case 7: return static_entry<T, J, 7>();
    case 8: return static_entry<T, J, 8>();
    default: return {nullptr, nullptr};
  }
}

template <typename T> TinyKernel<StaticFn<T>> static_kernel(int J, int K) {
  switch (J) {
    case 1: return static_for_k<T, 1>(K);
    case 2: return static_for_k<T, 2>(K);
    case 3: return static_for_k<T, 3>(K);
    case 4: return static_for_k<T, 4>(K);
    case 5: return static_for_k<T, 5>(K);
    case 6: return static_for_k<T, 6>(K);
    case 7: return static_for_k<T, 7>(K);
    case 8: return static_for_k<T, 8>(K);
    default: return {nullptr, nullptr};
  }
}

template <typename T> TinyKernel<DynamicFn<T>> dynamic_kernel() {
  static size_t opted[kMaxDevices] = {};
  return {tinymatsum_dynamic_kernel<T>, opted};
}

// Blocks of ``k`` with ``smem`` bytes of shared memory that fit on one SM at once
// (registers included), into *blocks.
template <typename Kernel>
cudaError_t tiny_occupancy(const TinyKernel<Kernel>& k, int64_t smem, int* blocks) {
  if (k.kern == nullptr) return cudaErrorInvalidValue;
  const cudaError_t e = set_smem(k.kern, static_cast<size_t>(smem), k.opted);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k.kern, kThreads,
                                                       static_cast<size_t>(smem));
}

template <typename Kernel, typename... Args>
cudaError_t launch_tiny(const TinyKernel<Kernel>& k, int64_t smem, const TinyPlan& p,
                        cudaStream_t st, Args... args) {
  if (k.kern == nullptr) return cudaErrorInvalidValue;
  const cudaError_t e = set_smem(k.kern, static_cast<size_t>(smem), k.opted);
  if (e != cudaSuccess) return e;
  const Kernel kern = k.kern;
  kern<<<p.grid, kThreads, smem, st>>>(args..., p.bn, p.vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_tiny(int is_static, int J, int K, const void* o, const void* s, void* out,
                     int64_t n, const TinyPlan& p, int64_t smem, cudaStream_t st) {
  const T* op = static_cast<const T*>(o);
  const T* sp = static_cast<const T*>(s);
  T* outp = static_cast<T*>(out);
  if (is_static) return launch_tiny(static_kernel<T>(J, K), smem, p, st, op, sp, outp, n);
  return launch_tiny(dynamic_kernel<T>(), smem, p, st, op, sp, outp, n, J, K);
}

// The vector form wherever the buffers allow 16-byte loads along the
// contiguous index, the scalar form elsewhere.
template <typename T>
cudaError_t launch_matvec(int layout, const void* a, const void* x, void* y, void* ws, int I,
                          int J, int splits, int cols_per_split, cudaStream_t st) {
  constexpr int V = VecWidth<T>::value;
  const T* ap = static_cast<const T*>(a);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const bool a16 = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (layout == 0) {
    const bool vec = a16 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && J % V == 0;
    const unsigned int grid = static_cast<unsigned int>((I + kWarps - 1) / kWarps);
    const Right map{I, J};
    if (vec) {
      matvec_kernel<T, Right, true><<<grid, kThreads, 0, st>>>(ap, xp, yp, nullptr, map, 0);
    } else {
      matvec_kernel<T, Right, false><<<grid, kThreads, 0, st>>>(ap, xp, yp, nullptr, map, 0);
    }
    return cudaGetLastError();
  }
  const bool vec = a16 && I % V == 0;
  const dim3 grid(static_cast<unsigned int>((I + 32 * V - 1) / (32 * V)), splits);
  float* wp = static_cast<float*>(ws);
  const Left map{I, J};
  if (vec) {
    matvec_kernel<T, Left, true><<<grid, kThreads, 0, st>>>(ap, xp, yp, wp, map, cols_per_split);
  } else {
    matvec_kernel<T, Left, false><<<grid, kThreads, 0, st>>>(ap, xp, yp, wp, map,
                                                             cols_per_split);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  matvec_splits_kernel<T><<<grid_for(I), kThreads, 0, st>>>(wp, yp, I, splits);
  return cudaGetLastError();
}

// What _paper_suite.py's GEOMETRY assumes of this file, in its order:
// threads a block, the shared memory a block gets without opting in and with
// it, the static kernel's largest J and K, tiny_stride at two shapes (8 x 8
// f32, 4 x 4 bf16: padded) and one (3 x 3 f32: not) that the planner's copy
// of it must match; then the stencil's tile (j, k), its j-rows a thread, its
// longest run, the planes of its ring and its threads a block; then Sum3D's
// threads a block, vector bytes and vectors in flight a thread.
constexpr int kGeometry[] = {kThreads, 48 * 1024, static_cast<int>(kMaxSmem),
                             kMaxTiny, tiny_stride(64, 4), tiny_stride(16, 2),
                             tiny_stride(9, 4), kStJ, kStK, kStRows, kStRun, kStPlanes,
                             kStThreads, kSumThreads, kSumVecBytes, kSumVecs};

}  // namespace

extern "C" {

// Every entry point: dtype 0 = float32, 1 = bfloat16 (all operands share it);
// returns the cudaError_t of the launch (0 on success); nothing here
// synchronizes or allocates.

// Sum of the n elements of x into out[0] (f32), in one cooperative launch
// of ``grid`` blocks (sum3d.py's plan_sum3d: at least 1, at most the blocks
// the card holds at once; a larger grid is refused with
// cudaErrorCooperativeLaunchTooLarge). Scratch: ``partials``, grid f32.
int repro_sum3d(int dtype, const void* x, int64_t n, int grid, void* partials, void* out,
                void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || n < 0 || reinterpret_cast<uintptr_t>(x) % esize != 0 ||
      grid < 1 || partials == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0
      ? launch_sum3d<float>(x, n, grid, partials, out, s)
      : launch_sum3d<__nv_bfloat16>(x, n, grid, partials, out, s);
  return static_cast<int>(e);
}

// Blocks of the Sum3D kernel for ``dtype`` that fit on one SM at once, into
// *blocks: the planner's grid is at most this times the SMs (one wave).
int repro_sum3d_blocks_per_sm(int dtype, int* blocks) {
  if ((dtype != 0 && dtype != 1) || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  return static_cast<int>(
      dtype == 0
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sum3d_kernel<float>,
                                                          kSumThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sum3d_kernel<__nv_bfloat16>,
                                                          kSumThreads, 0));
}

// out (I, J, K) = the 27-point box sum of x on the interior, 0 elsewhere. The
// plan (stencil3d.py's plan_stencil3d): ``run`` output planes a block (1 ..
// kStRun), so the grid is (ceil(K / kStK), ceil(J / kStJ), ceil(I / run)),
// its y and z at most kStMaxGridYZ. The staging takes the 16-byte copies
// where x lies on 16 bytes and K * sizeof(T) is a multiple of 16, plain loads
// elsewhere.
int repro_stencil3d(int dtype, const void* x, void* out, int I, int J, int K, int run,
                    void* stream) {
  if ((dtype != 0 && dtype != 1) || I < 1 || J < 1 || K < 1 || run < 1 || run > kStRun ||
      (static_cast<int64_t>(J) + kStJ - 1) / kStJ > kStMaxGridYZ ||
      (static_cast<int64_t>(I) + run - 1) / run > kStMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   static_cast<int64_t>(K) * esize % 16 == 0;
  (void)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch_stencil3d<float>(x, out, I, J, K, run, vec, s)
                                   : launch_stencil3d<__nv_bfloat16>(x, out, I, J, K, run, vec, s);
  return static_cast<int>(e);
}

// Blocks of the stencil kernel for ``dtype`` that fit on one SM at once
// (registers and the ring), into *blocks: the planner's count of resident
// blocks, from which it picks the run length.
int repro_stencil3d_blocks_per_sm(int dtype, int* blocks) {
  if ((dtype != 0 && dtype != 1) || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  return static_cast<int>(
      dtype == 0
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, stencil3d_kernel<float>,
                                                          kStThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, stencil3d_kernel<__nv_bfloat16>,
                                                          kStThreads, 0));
}

// out = o + s over n (J, K) matrices; is_static picks the kernel with J and K
// as template arguments (1..8 each) or as runtime ints. The plan
// (tinymatsum.py's plan_tinymatsum): bn matrices a span (bn J K sizeof(T) a
// multiple of 16), staged in 2 bn tiny_stride(J K) elements (at most kMaxSmem
// bytes), or bn 0 for the dynamic kernel's unstaged form (vec 0); ``grid``
// blocks; ``vec`` 1 only where o, s and out lie on 16 bytes and n J K
// sizeof(T) is a multiple of 16.
int repro_tinymatsum(int dtype, int is_static, const void* o, const void* s, void* out, int64_t n,
                     int J, int K, int bn, int grid, int vec, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const int64_t jk = static_cast<int64_t>(J) * K;
  const bool aligned = reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if ((dtype != 0 && dtype != 1) || n < 1 || J < 1 || K < 1 ||
      (is_static && (J > kMaxTiny || K > kMaxTiny)) || bn < 0 || (bn == 0 && (is_static || vec)) ||
      grid < 1 || (vec != 0 && vec != 1) ||
      (bn > 0 && (jk * esize > static_cast<int64_t>(kMaxSmem) || bn * jk * esize % 16 != 0)) ||
      (vec && (!aligned || n * jk * esize % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TinyPlan p{bn, grid, vec};
  const int64_t smem = tiny_smem_bytes(jk, esize, p);
  if (smem > static_cast<int64_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? run_tiny<float>(is_static, J, K, o, s, out, n, p, smem, st)
                 : run_tiny<__nv_bfloat16>(is_static, J, K, o, s, out, n, p, smem, st);
  return static_cast<int>(e);
}

// How many blocks of the kernel repro_tinymatsum would launch for (dtype,
// is_static, J, K) with ``smem`` bytes of shared memory fit on one SM at once, into
// *blocks (0 where none fits): the planner's grid, so that every block is
// resident and the walk over spans is persistent.
int repro_tinymatsum_blocks_per_sm(int dtype, int is_static, int J, int K, int64_t smem,
                                   int* blocks) {
  if ((dtype != 0 && dtype != 1) || J < 1 || K < 1 || smem < 0 ||
      smem > static_cast<int64_t>(kMaxSmem) || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  cudaError_t e;
  if (dtype == 0) {
    e = is_static ? tiny_occupancy(static_kernel<float>(J, K), smem, blocks)
                  : tiny_occupancy(dynamic_kernel<float>(), smem, blocks);
  } else {
    e = is_static ? tiny_occupancy(static_kernel<__nv_bfloat16>(J, K), smem, blocks)
                  : tiny_occupancy(dynamic_kernel<__nv_bfloat16>(), smem, blocks);
  }
  return static_cast<int>(e);
}

// y (I) = A x, A stored as layout 0 = right (buffer (I, J)) or 1 = left
// (buffer (J, I)). Left cuts j into ``splits`` runs of ``cols_per_split``
// (splits * cols_per_split >= J); with more than one, ``workspace`` holds
// splits * I floats of partial y. Right takes splits 1 and no workspace.
int repro_matvec(int dtype, int layout, const void* a, const void* x, void* y, void* workspace,
                 int I, int J, int splits, int cols_per_split, void* stream) {
  if ((dtype != 0 && dtype != 1) || (layout != 0 && layout != 1) || I < 1 || J < 0 ||
      splits < 1 || splits > 65535 || cols_per_split < 1 ||
      static_cast<int64_t>(splits) * cols_per_split < J || (layout == 0 && splits != 1) ||
      (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? launch_matvec<float>(layout, a, x, y, workspace, I, J, splits, cols_per_split, s)
                 : launch_matvec<__nv_bfloat16>(layout, a, x, y, workspace, I, J, splits,
                                                cols_per_split, s);
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
