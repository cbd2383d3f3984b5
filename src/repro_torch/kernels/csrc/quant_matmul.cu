// Quantized matmul for Hopper (sm_90a): y = x @ dequant(W)^T, with a plain C
// interface loaded through ctypes (repro_torch/kernels/quant_matmul.py holds
// the wrapper, the planner that picks a schedule and the plain PyTorch
// version it is held against).
//
// What it replaces (the JAX reference package's Pallas TPU kernel):
//   qmm_stream_kernel / qmm_mma_kernel / qmm_fma_kernel
//                        <- src/repro/kernels/quant_matmul.py::quant_matmul
//
// Operands: x (M, K) float or __nv_bfloat16; W stored output-major as q (N, K)
// int8, or (N, K/2) int4 in ADJACENT nibbles (byte j holds value 2j in the lo
// nibble and 2j + 1 in the hi, each sign-extended); scale (N, K / qblock) f32,
// one per (row, K-block). Output (M, N) in x's type; every sum is f32.
//
// The scale comes out of the product on the tensor cores: y[m, n] = sum_kb
// scale[n, kb] * (sum_{k in kb} x[m, k] * q[n, k]). An int8 or int4 value is
// exact in bf16, so the inner sums differ from the plain version (which
// dequantizes W first) only in rounding order.
//
// What bounds it on an H100: the int8 weight bytes at decode (4.4 MB a call
// at the MLP's 896 x 4864 and 4864 x 896, M = 8: ~1.5 us at the copy rate),
// and, at one 128-token chunk, the tensor cores' rate not far below that
// (1.1 GFLOP). Three schedules; the wrapper's planner (plan_quant_matmul)
// picks one by M, x's type, the block and alignment:
//
// stream (M <= 16, bf16 x, qblock a multiple of 64 (int8) / 128 (int4), 16-
//   byte aligned operands): q streamed straight into tensor-core fragments.
//   A block owns 8 rows of q; each of its warps a 256-value slice of K. Lane
//   (g, t) loads 16 bytes of row g at each of the slice's spans (a warp load
//   is 8 rows x 64 contiguous bytes, int8), and holds x rows g and g + 8 over
//   the same values as bf16 pairs in registers: every load of the block is in
//   flight before the first product. mma.sync m16n8k16 takes the lane's 4
//   values a k-step in place of 4 neighbours (A and B agree, and the sum over
//   k is order-free), so no byte is moved through shared memory. A span lies
//   in one K-block, whose f32 sum is multiplied by its scale when it ends; the
//   warps' totals meet in shared memory in warp order. Up to 16 warps (4096
//   values of K) a block; past that K is split over blocks (w_down: 2).
// mma (M > 16, bf16 x, qblock a multiple of 16, aligned): a 32 x 64 tile of y
//   a block, four warps of 32 x 16, K-steps of 64 staged by cp.async (x as
//   bf16, q as bytes) in a ring of four; B fragments are read from the byte
//   tile and made bf16 integers in registers (exact), mma.sync accumulates
//   each K-block apart, and its f32 sum is multiplied by the column's scale
//   (loaded when the block starts) into the total. K splits for ~2 blocks a
//   SM (w_down: 5).
// fma (everything else: f32 x at any M, and bf16 shapes or operands the
//   tensor-core schedules do not take): a BM x 64 tile of y a block on CUDA
//   cores (BM 16 for M <= 16, else 64), W dequantized as float(q) * scale,
//   read byte by byte, while staging each K-block in shared memory as f32; K
//   split for ~1 block a SM. f32 stays off the tensor cores: it holds the
//   port to the reference at 2e-5.
// Split partials go to an f32 workspace (splits, M, N) that
// qmm_sum_splits_kernel adds in split order: no float atomics, the same bits
// every run.
//
// What still bounds it: stream is latency-bound, one round trip of loads a
// warp, plus the second kernel where K splits. mma takes 2.4-3.8x
// torch.matmul's device time at M 128 on an H100; which of its per-step costs
// (four warps a block, mma.sync behind dependent fragment loads, one barrier
// a K-step) bounds it is not measured yet, and wgmma with TMA is the next
// design to try. fma is a plain CUDA-core tile; it serves the f32 exactness
// runs, not the bf16 serve path.

#include "common.cuh"

namespace {

constexpr int kMaxQBlock = 256;  // the wrapper refuses larger blocks

// ---------------------------------------------------------------------------------
// the split sum
// ---------------------------------------------------------------------------------
// y = the splits of ws (splits, M, N) summed in split order
template <typename T>
__global__ void qmm_sum_splits_kernel(const float* __restrict__ ws, T* __restrict__ y,
                                      long long mn, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[p * mn + i];
  y[i] = from_f32<T>(s);
}

// ---------------------------------------------------------------------------------
// stream: M <= 16 decode rows, bf16 x, q streamed into tensor-core fragments
// ---------------------------------------------------------------------------------
constexpr int kStreamMaxWarps = 16;
// values a quad of lanes covers with one 16-byte load each (a span), and
// the spans a warp holds x for in registers
template <int BITS> __host__ __device__ constexpr int stream_span() { return BITS == 8 ? 64 : 128; }
template <int BITS> __host__ __device__ constexpr int stream_spans() { return BITS == 8 ? 4 : 2; }

// The 4 values of k-step j of a lane's 16-byte chunk as two bf16 pairs (the
// B fragment of mma m16n8k16: b0 holds the first two, b1 the last two). int8:
// bytes 4j .. 4j + 3; int4 (adjacent nibbles): bytes 2j and 2j + 1, lo then hi.
template <int BITS>
__device__ __forceinline__ void stream_b(const uint4& c, int j, uint32_t& b0, uint32_t& b1) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  float f[4];
  if constexpr (BITS == 8) {
    int8x4_to_f32(w[j], f);
  } else {
    const uint32_t half = (w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
    nib4_to_f32((half & 0xFu) | ((half >> 4) & 0xFu) << 8 | ((half >> 8) & 0xFu) << 16 |
                    ((half >> 12) & 0xFu) << 24,
                f);
  }
  b0 = bf16x2_bits(__floats2bfloat162_rn(f[0], f[1]));
  b1 = bf16x2_bits(__floats2bfloat162_rn(f[2], f[3]));
}

// Block (8 output rows of q, K-split): warp w takes values [k_lo + w * S *
// SPAN, + S * SPAN) of the split. Lane (g = lane / 4, t = lane % 4) loads 16
// bytes of row n0 + g at value offset t * VPL of each span (VPL = SPAN / 4;
// a warp load reads 8 rows x 64 contiguous bytes), and x rows g and g + 8 at
// the same values. Inside a span the 16 values of a k-step are the lanes'
// values 4j .. 4j + 3 (j = 0 .. VPL / 4 - 1), not 16 neighbours: the sum over
// k does not care which k an mma slot holds, as long as A and B agree. A span
// lies in one K-block (qblock % SPAN == 0), so a block's f32 sum is folded
// into the total with its scale once it ends. The warps' totals meet in
// shared memory, summed in warp order.
template <int BITS>
__global__ void __launch_bounds__(kStreamMaxWarps * 32)
qmm_stream_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, bf16* __restrict__ y, float* __restrict__ ws,
                  int M, int N, int K, int qblock, int kps) {
  constexpr int SPAN = stream_span<BITS>(), S = stream_spans<BITS>(), VPL = SPAN / 4;
  constexpr int XW = VPL / 2;  // bf16 pairs of x a lane holds per row and span
  __shared__ float red[kStreamMaxWarps][32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n0 = blockIdx.x * 8, n = n0 + g;
  const int k_hi = min(K, (split + 1) * kps);
  const int kw0 = split * kps + warp * S * SPAN;
  const int row_bytes = BITS == 8 ? K : K / 2, nb = K / qblock;

  // every load first: q chunks, x fragments, the two columns' scales
  uint4 qc[S];
  uint32_t xg[S][XW], xh[S][XW];
  float s0[S], s1[S];
  const int c0 = n0 + 2 * t;
#pragma unroll
  for (int p = 0; p < S; ++p) {
    const int ks = kw0 + p * SPAN;
    const bool in = ks < k_hi;
    qc[p] = in && n < N ? __ldg(reinterpret_cast<const uint4*>(
                              q + static_cast<size_t>(n) * row_bytes + (BITS == 8 ? ks : ks / 2) +
                              t * 16))
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = g + 8 * hf;
      uint32_t* dst = hf ? xh[p] : xg[p];
#pragma unroll
      for (int i = 0; i < XW / 4; ++i) {
        const uint4 v = in && m < M ? __ldg(reinterpret_cast<const uint4*>(
                                          x + static_cast<size_t>(m) * K + ks + t * VPL) + i)
                                    : make_uint4(0u, 0u, 0u, 0u);
        dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
      }
    }
    const int kb = in ? ks / qblock : 0;
    s0[p] = in && c0 < N ? __ldg(scale + static_cast<size_t>(c0) * nb + kb) : 0.f;
    s1[p] = in && c0 + 1 < N ? __ldg(scale + static_cast<size_t>(c0 + 1) * nb + kb) : 0.f;
  }

  float tot[4] = {0.f, 0.f, 0.f, 0.f}, blk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < S; ++p) {
    const int ks = kw0 + p * SPAN;
    if (ks >= k_hi) break;  // the same on every lane
#pragma unroll
    for (int j = 0; j < VPL / 4; ++j) {
      uint32_t b0, b1;
      stream_b<BITS>(qc[p], j, b0, b1);
      const uint32_t a[4] = {xg[p][2 * j], xh[p][2 * j], xg[p][2 * j + 1], xh[p][2 * j + 1]};
      mma_bf16(blk, a, b0, b1);
    }
    if ((ks + SPAN) % qblock == 0 || ks + SPAN >= k_hi || p == S - 1) {  // fold in the scale
      tot[0] = fmaf(blk[0], s0[p], tot[0]);
      tot[1] = fmaf(blk[1], s1[p], tot[1]);
      tot[2] = fmaf(blk[2], s0[p], tot[2]);
      tot[3] = fmaf(blk[3], s1[p], tot[3]);
      blk[0] = blk[1] = blk[2] = blk[3] = 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[warp][lane][e] = tot[e];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = 0.f;
    for (int w = 0; w < nwarps; ++w) v += red[w][lane][e];
    const int m = g + 8 * (e >> 1), c = c0 + (e & 1);
    if (m >= M || c >= N) continue;
    if (splits == 1)
      y[static_cast<size_t>(m) * N + c] = __float2bfloat16(v);
    else
      ws[(static_cast<size_t>(split) * M + m) * N + c] = v;
  }
}

// ---------------------------------------------------------------------------------
// mma: M > 16, bf16 x, on the tensor cores
// ---------------------------------------------------------------------------------
constexpr int kMmaBM = 32, kMmaBN = 64, kMmaBK = 64;
constexpr int kMmaWN = 4;                        // warps across the tile's columns
constexpr int kMmaWM = kMmaBM / 32;              // warps down its rows (32 rows each)
constexpr int kMmaThreads = kMmaWM * kMmaWN * 32;
constexpr int kMmaWC = kMmaBN / kMmaWN;          // columns a warp owns
constexpr int kMmaNJ = kMmaWC / 8;               // n8 tiles a warp
constexpr int kMmaStages = 4;  // K-steps in flight: a step's loads are issued 3 steps ahead
constexpr int kXld = kMmaBK + 8;  // bf16 elements a row of the x tile
template <int BITS> __host__ __device__ constexpr int q_tile_ld() {  // bytes a raw q row
  return (BITS == 8 ? kMmaBK : kMmaBK / 2) + 16;
}
template <int BITS> __host__ __device__ constexpr size_t mma_smem() {
  return kMmaStages *
         (sizeof(bf16) * kMmaBM * kXld + static_cast<size_t>(kMmaBN) * q_tile_ld<BITS>());
}

template <int BITS>
__global__ void __launch_bounds__(kMmaThreads)
qmm_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, bf16* __restrict__ y, float* __restrict__ ws,
               int M, int N, int K, int qblock, int kps) {
  constexpr int QLD = q_tile_ld<BITS>(), QB = BITS == 8 ? kMmaBK : kMmaBK / 2;  // bytes a K-step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // kMmaStages x BM * kXld
  int8_t* q_raw = reinterpret_cast<int8_t*>(x_s + kMmaStages * kMmaBM * kXld);  // x BN * QLD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kMmaWN, wn = warp % kMmaWN;
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_lo = split * kps, k_hi = min(K, k_lo + kps);
  const int row_bytes = BITS == 8 ? K : K / 2, nb = K / qblock;
  const int n_steps = (k_hi - k_lo + kMmaBK - 1) / kMmaBK;
  const int kb_steps = qblock / 16;  // k16 steps a K-block (k_lo starts one)

  auto stage = [&](int step, int buf) {
    const int k0 = k_lo + step * kMmaBK;
    bf16* xs = x_s + buf * kMmaBM * kXld;
    for (int i = tid; i < kMmaBM * (kMmaBK / 8); i += kMmaThreads) {
      const int r = i / (kMmaBK / 8), c = i - r * (kMmaBK / 8);
      const int m = m0 + r, k = k0 + c * 8;
      const bool in = m < M && k < k_hi;
      cp_async16(xs + r * kXld + c * 8, x + (in ? static_cast<size_t>(m) * K + k : 0),
                 in ? 16 : 0);
    }
    int8_t* qs = q_raw + buf * kMmaBN * QLD;
    const int kq0 = BITS == 8 ? k0 : k0 / 2, kq_hi = BITS == 8 ? k_hi : k_hi / 2;
    for (int i = tid; i < kMmaBN * (QB / 16); i += kMmaThreads) {
      const int r = i / (QB / 16), c = i - r * (QB / 16);
      const int n = n0 + r, kq = kq0 + c * 16;
      const bool in = n < N && kq < kq_hi;
      cp_async16(qs + r * QLD + c * 16, q + (in ? static_cast<size_t>(n) * row_bytes + kq : 0),
                 in ? 16 : 0);
    }
    cp_async_commit();
  };

  float tot[2][kMmaNJ][4], blk[2][kMmaNJ][4], sc[kMmaNJ][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMmaNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][j][e] = blk[i][j][e] = 0.f;

  int kc = 0;  // k16 steps into the current K-block
  // a ring of kMmaStages buffers; every iteration commits one group (empty
  // past the last step), so waiting for all but kMmaStages - 2 groups means
  // step ``it`` has landed
#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_steps) stage(st, st);
    else cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    const int k0 = k_lo + it * kMmaBK, buf = it % kMmaStages;
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // step it is in; every warp is done with step it - 1's buffer
    if (it + kMmaStages - 1 < n_steps)
      stage(it + kMmaStages - 1, (it + kMmaStages - 1) % kMmaStages);
    else cp_async_commit();
    const int8_t* qs = q_raw + buf * kMmaBN * QLD;
    const bf16* xs = x_s + buf * kMmaBM * kXld;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const int kg = k0 + kk * 16;
      if (kg >= k_hi) break;  // the same on every thread
      if (kc == 0) {  // a K-block starts: load the scales its end folds in
        const int kb = kg / qblock;
#pragma unroll
        for (int j = 0; j < kMmaNJ; ++j) {
          const int n = n0 + wn * kMmaWC + j * 8 + (lane & 3) * 2;
          sc[j][0] = n < N ? __ldg(scale + static_cast<size_t>(n) * nb + kb) : 0.f;
          sc[j][1] = n + 1 < N ? __ldg(scale + static_cast<size_t>(n + 1) * nb + kb) : 0.f;
        }
      }
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], xs + (wm * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kXld +
                          kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kMmaNJ; ++j) {
        // B of n8 tile j: row g of the tile, k 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1),
        // read as bytes and made bf16 integers here
        const int8_t* row = qs + (wn * kMmaWC + j * 8 + (lane >> 2)) * QLD;
        const int t = lane & 3;
        uint32_t b0, b1;
        if constexpr (BITS == 8) {
          b0 = int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(row + kk * 16 + 2 * t));
          b1 = int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(row + kk * 16 + 8 + 2 * t));
        } else {
          b0 = nib2_to_bf16x2(static_cast<uint8_t>(row[kk * 8 + t]));
          b1 = nib2_to_bf16x2(static_cast<uint8_t>(row[kk * 8 + 4 + t]));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(blk[i][j], a[i], b0, b1);
      }
      if (++kc == kb_steps || kg + 16 >= k_hi) {  // a K-block ends: fold in its scale
        kc = 0;
#pragma unroll
        for (int j = 0; j < kMmaNJ; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            tot[i][j][0] = fmaf(blk[i][j][0], sc[j][0], tot[i][j][0]);
            tot[i][j][1] = fmaf(blk[i][j][1], sc[j][1], tot[i][j][1]);
            tot[i][j][2] = fmaf(blk[i][j][2], sc[j][0], tot[i][j][2]);
            tot[i][j][3] = fmaf(blk[i][j][3], sc[j][1], tot[i][j][3]);
            blk[i][j][0] = blk[i][j][1] = blk[i][j][2] = blk[i][j][3] = 0.f;
          }
        }
      }
    }
  }
  // y (or the split's ws slice): a lane's two neighbouring columns as one pair
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm * 32 + i * 16 + (lane >> 2) + hf * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kMmaNJ; ++j) {
        const int n = n0 + wn * kMmaWC + j * 8 + (lane & 3) * 2;
        if (n >= N) continue;
        const float v0 = tot[i][j][hf * 2], v1 = tot[i][j][hf * 2 + 1];
        const bool pair = n + 1 < N && N % 2 == 0;
        if (splits == 1) {
          bf16* dst = y + static_cast<size_t>(m) * N + n;
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16(v0);
            if (n + 1 < N) dst[1] = __float2bfloat16(v1);
          }
        } else {
          float* dst = ws + (static_cast<size_t>(split) * M + m) * N + n;
          if (pair) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (n + 1 < N) dst[1] = v1;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------------
// fma: CUDA cores (f32 x; bf16 shapes or operands the tensor-core schedules do not take)
// ---------------------------------------------------------------------------------
constexpr int kFmaThreads = 256;  // 16 x 16 threads
constexpr int kFmaBN = 64;        // output columns per block (4 per thread)
template <int TM> __host__ __device__ constexpr int fma_rows() { return 16 * TM; }
// output rows a thread owns: 1 (16 a block) for M <= 16, else 4 (64)
__host__ __device__ constexpr int fma_tm(int M) { return M <= 16 ? 1 : 4; }

// One block: rows m0 .. m0 + 16 TM - 1, columns n0 .. n0 + 63 of y (each
// thread TM x 4 of them), K-blocks of split blockIdx.z.
template <typename T, int BITS, int TM>
__global__ void __launch_bounds__(kFmaThreads)
qmm_fma_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, T* __restrict__ y, float* __restrict__ ws,
               int M, int N, int K, int qblock, int kps) {
  constexpr int BM = fma_rows<TM>();
  const int BK = qblock, LD = qblock + 1;
  const int nblocks = K / qblock;
  const int kq_row = BITS == 8 ? K : K / 2;  // bytes per row of q
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kFmaBN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int kb_lo = split * kps / qblock, kb_hi = min(nblocks, (split + 1) * kps / qblock);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* x_s = smem;             // BM * LD
  float* w_s = x_s + BM * LD;    // kFmaBN * LD

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BK;
    for (int i = threadIdx.x; i < BM * BK; i += kFmaThreads) {
      const int r = i / BK, c = i - r * BK;
      const int m = m0 + r;
      x_s[r * LD + c] = m < M ? to_f32(x[static_cast<size_t>(m) * K + k0 + c]) : 0.f;
    }
    if (BITS == 8) {
      for (int i = threadIdx.x; i < kFmaBN * BK; i += kFmaThreads) {
        const int r = i / BK, c = i - r * BK;
        const int n = n0 + r;
        float w = 0.f;
        if (n < N) {
          w = static_cast<float>(q[static_cast<size_t>(n) * kq_row + k0 + c]) *
              scale[static_cast<size_t>(n) * nblocks + kb];
        }
        w_s[r * LD + c] = w;
      }
    } else {
      const int BKB = BK / 2;  // bytes per row of the staged tile
      for (int i = threadIdx.x; i < kFmaBN * BKB; i += kFmaThreads) {
        const int r = i / BKB, c = i - r * BKB;
        const int n = n0 + r;
        float lo = 0.f, hi = 0.f;
        if (n < N) {
          const int b = q[static_cast<size_t>(n) * kq_row + k0 / 2 + c];
          const float s = scale[static_cast<size_t>(n) * nblocks + kb];
          lo = signed_nibble(b) * s;
          hi = signed_nibble(b >> 4) * s;
        }
        w_s[r * LD + 2 * c] = lo;
        w_s[r * LD + 2 * c + 1] = hi;
      }
    }
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float a[TM], w[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = x_s[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = w_s[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (splits == 1)
        y[static_cast<size_t>(m) * N + n] = from_f32<T>(acc[i][j]);
      else
        ws[(static_cast<size_t>(split) * M + m) * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------------
template <typename T>
cudaError_t sum_splits(const float* ws, void* y, int M, int N, int splits, cudaStream_t st) {
  const long long mn = static_cast<long long>(M) * N;
  qmm_sum_splits_kernel<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(
      ws, static_cast<T*>(y), mn, splits);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_stream(const void* x, const void* q, const void* scale, void* y, void* ws,
                          int M, int N, int K, int qblock, int splits, int kps,
                          cudaStream_t st) {
  constexpr int slice = stream_span<BITS>() * stream_spans<BITS>();  // values a warp takes
  const int warps = (kps + slice - 1) / slice;
  if (warps > kStreamMaxWarps) return cudaErrorInvalidValue;
  qmm_stream_kernel<BITS><<<dim3((N + 7) / 8, splits), warps * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<bf16*>(y), static_cast<float*>(ws), M, N, K,
      qblock, kps);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_mma(const void* x, const void* q, const void* scale, void* y, void* ws, int M,
                       int N, int K, int qblock, int splits, int kps, cudaStream_t st) {
  constexpr size_t smem = mma_smem<BITS>();
  auto kern = qmm_mma_kernel<BITS>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  kern<<<dim3((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM, splits), kMmaThreads, smem,
         st>>>(static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
               static_cast<const float*>(scale), static_cast<bf16*>(y), static_cast<float*>(ws),
               M, N, K, qblock, kps);
  return cudaGetLastError();
}

template <typename T, int BITS, int TM>
cudaError_t launch_fma(const void* x, const void* q, const void* scale, void* y, void* ws, int M,
                       int N, int K, int qblock, int splits, int kps, cudaStream_t st) {
  constexpr int BM = fma_rows<TM>();
  const size_t smem = sizeof(float) * static_cast<size_t>(BM + kFmaBN) * (qblock + 1);
  auto kern = qmm_fma_kernel<T, BITS, TM>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  kern<<<dim3((N + kFmaBN - 1) / kFmaBN, (M + BM - 1) / BM, splits), kFmaThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<T*>(y), static_cast<float*>(ws), M, N, K, qblock, kps);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t run(int schedule, const void* x, const void* q, const void* scale, void* y, void* ws,
                int M, int N, int K, int qblock, int splits, int kps, cudaStream_t st) {
  cudaError_t e;
  if (schedule == 2) {
    e = fma_tm(M) == 1
            ? launch_fma<T, BITS, 1>(x, q, scale, y, ws, M, N, K, qblock, splits, kps, st)
            : launch_fma<T, BITS, 4>(x, q, scale, y, ws, M, N, K, qblock, splits, kps, st);
  } else if constexpr (sizeof(T) == 2) {
    e = schedule == 0
            ? launch_stream<BITS>(x, q, scale, y, ws, M, N, K, qblock, splits, kps, st)
            : launch_mma<BITS>(x, q, scale, y, ws, M, N, K, qblock, splits, kps, st);
  } else {
    return cudaErrorInvalidValue;  // the tensor-core schedules take bf16 x only
  }
  if (e != cudaSuccess || splits == 1) return e;
  return sum_splits<T>(static_cast<const float*>(ws), y, M, N, splits, st);
}

// What the wrapper's planner assumes of this file, in the order of
// quant_matmul.py's GEOMETRY: stream's span (int8, int4), the values a warp
// of it takes (int8, int4) and its warps a block; the mma tile's rows,
// columns and K-step; fma's columns and its rows at M <= 16 and above.
constexpr int kGeometry[] = {stream_span<8>(),
                             stream_span<4>(),
                             stream_span<8>() * stream_spans<8>(),
                             stream_span<4>() * stream_spans<4>(),
                             kStreamMaxWarps,
                             kMmaBM,
                             kMmaBN,
                             kMmaBK,
                             kFmaBN,
                             fma_rows<fma_tm(16)>(),
                             fma_rows<fma_tm(17)>()};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y share it); bits: 8 or 4. K must
// be a multiple of qblock, qblock even and <= 256. schedule (the wrapper's
// plan_quant_matmul): 0 = stream (bf16 x, M <= 16, qblock a multiple of 64
// (int8) or 128 (int4), x and q on 16 bytes), 1 = mma (bf16 x; qblock a
// multiple of 16; x, q and their rows 16-byte aligned), 2 = fma (any). K is
// cut into ``splits`` runs of ``k_per_split`` (a multiple of qblock; splits *
// k_per_split >= K); with splits > 1, ``workspace`` holds splits * M * N
// floats and a second kernel sums them in split order. Returns the
// cudaError_t of the launches (0 on success); nothing here synchronizes.
int repro_quant_matmul(int dtype, int bits, const void* x, const void* q, const void* scale,
                       void* y, void* workspace, int M, int N, int K, int qblock, int schedule,
                       int splits, int k_per_split, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if ((dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) || M <= 0 || N <= 0 || K <= 0 ||
      qblock <= 0 || qblock > kMaxQBlock || qblock % 2 != 0 || K % qblock != 0 ||
      schedule < 0 || schedule > 2 || splits <= 0 || splits > 65535 || k_per_split <= 0 ||
      k_per_split % qblock != 0 || static_cast<long long>(splits) * k_per_split < K ||
      static_cast<long long>(splits - 1) * k_per_split >= K ||
      (splits > 1 && workspace == nullptr) ||
      (schedule == 0 && (dtype != 1 || M > 16 || !aligned ||
                         qblock % (bits == 8 ? 64 : 128) != 0 ||
                         k_per_split % (bits == 8 ? 64 : 128) != 0)) ||
      (schedule == 1 && (dtype != 1 || !aligned || qblock % 16 != 0 || K % 8 != 0 ||
                         (bits == 8 ? K : K / 2) % 16 != 0 ||
                         (splits > 1 && k_per_split % kMmaBK != 0)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = bits == 8 ? run<float, 8>(schedule, x, q, scale, y, workspace, M, N, K, qblock, splits,
                                  k_per_split, s)
                  : run<float, 4>(schedule, x, q, scale, y, workspace, M, N, K, qblock, splits,
                                  k_per_split, s);
  } else {
    e = bits == 8 ? run<bf16, 8>(schedule, x, q, scale, y, workspace, M, N, K, qblock, splits,
                                 k_per_split, s)
                  : run<bf16, 4>(schedule, x, q, scale, y, workspace, M, N, K, qblock, splits,
                                 k_per_split, s);
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
