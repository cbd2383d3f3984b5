// Dense-cache GQA flash attention for Hopper (sm_90a): the prefill kernels
// (a block of query rows against contiguous K/V) and one-token decode against
// a contiguous cache or ring, with a plain C interface loaded through ctypes
// (repro_torch/kernels/flash_attention.py holds the wrappers and the plain
// PyTorch versions these kernels are held against).
//
// What they replace (the JAX reference package's Pallas TPU kernels):
//   repro_flash_attention  <- src/repro/kernels/flash_attention.py::flash_attention
//   repro_flash_decode     <- src/repro/kernels/flash_attention.py::flash_decode
// Same math as the reference's _flash_kernel / _decode_kernel: scores
// (q . k) * scale, an online softmax with f32 (m, l, acc) per query row, and
// fully masked rows output 0. Query row t sits at absolute position
// q_offset + t; key j is live when j < Tk, j <= q_pos (causal) and
// j > q_pos - window (window set). q_offset (the decode position) is read on
// the device from an int32 scalar when the caller passes a tensor, so a step
// never waits on the host.
//
// Layout: q / out (B, Hq, Tq, D), k / v (B, Hkv, Tk, D), all contiguous, one
// element type T (float or __nv_bfloat16); sums in f32, out in T.
//
// What bounds them on an H100: prefill is operations-heavy (4 * Tq * Tk * D
// per head, halved by the causal band), decode is bytes: it reads each live
// cache slot once (~0.6 MB per layer at B 8, S 288, bf16; 2 MB over
// recurrentgemma's 2048-slot ring at D 256), microseconds at the card's rate.
//
// Prefill takes the G = Hq / Hkv query heads of one KV head together (rows
// ordered t-major: row = t * G + g), so every K/V tile serves all G heads of
// its group (GQA reuse, as the TPU kernel's (G, D) block). Tiles wholly
// outside the causal / window band of a block's rows are never read (the TPU
// kernel's `run` predicate); inside a tile every (row, key) pair is masked by
// liveness, never by the exponent alone, and a row with no live key outputs 0.
//
// Each prefill body has two instantiations: kLse = true also writes each row's
// lse (training's forward); serving runs kLse = false, without that epilogue.
//
// bf16 prefill, flash_mma_kernel<D, kLse> (D 16, 32, 64, 112, 128, 256): 64 rows a block,
// 16 rows a warp. The products run on the tensor cores
// (mma.sync.aligned.m16n8k16, bf16 operands, f32 accumulation): S = Q . K^T
// and O += P . V. The Q tile is loaded once into shared memory; K/V tiles of
// 64 keys (32 at D 256) are double-buffered in shared memory with 16-byte
// cp.async copies, each row padded by 16 bytes so that ldmatrix reads it
// without bank conflicts. A warp keeps S, the online softmax's row max and
// sum (reduced across the 4 lanes of a quad by shuffles) and O in registers;
// P goes from the S accumulator straight into the A operand of P . V.
// P is split as P_hi + P_lo, two bf16 operands and two products into one
// accumulator: rounding P to one bf16 errs by up to 2^-9 a term, which put
// outputs near 0 outside the bf16 gate (one bf16 ulp of the plain output plus
// 2e-5) at every shape tried, 256 to 2600 keys; the split leaves ~2^-17 and
// doubles only the P . V half. At D 256 the 128 f32
// registers a thread would need for one warp's O are halved: two warps share a
// 16-row slab, each computes the same S (bit for bit, so their row max and sum
// agree without an exchange) and owns 128 of the 256 output columns.
//
// f32 prefill runs flash_kernel<float, D, kLse>: f32 CUDA-core products through
// common.cuh's flash_tile, K/V staged as f32 through shared memory (64 keys a
// tile, 32 for D 128 and 256; at D 256 a 64-row block stages 205,696 bytes,
// so one block runs per SM). f32 stays off the tensor cores on purpose: it is
// the path that holds the port to the reference in f32 (the 2e-5 gate), and
// the tensor cores would need TF32, which keeps about three decimal digits.
//
// Decode, f32 and bf16 alike, runs the split-K body the paged decodes share
// (decode_splitk.cuh) over DenseKeys: slot j of (b, h) is row (b * Hkv + h) *
// S + j, live iff j <= pos and, with a window, j > pos - window. The wrapper
// plans the split with the paged planner at page_size 1 (tiles of 64 keys at
// D <= 64, 32 above; two blocks a SM where the cache has that many tiles):
// recurrentgemma's ring (B 2, Hkv 1, S 2048, D 256) runs 64 splits of 32 keys
// and, its MQA group of 10 taking two blocks of 5 rows, 256 blocks; qwen2's
// (8, 2, 288, 64) 5 splits of 64, 80 blocks. The second row block of the ring
// reads the same keys again, mostly from L2 (the first block's split of the
// same keys runs in the same wave). That second read was not measured on its
// own; the arithmetic was what mattered: 5 and 5 rows a block instead of 8
// and 2 took the split kernel from 14.0 to 10.4 us on an H100 80GB HBM3 at
// 700 W (scripts/time_decode_matvec.py --profile), below SDPA's device time.
// The D 256 instantiation is the decode's alone: no paged path serves D 256.

#include "decode_splitk.cuh"

namespace {

constexpr int kPrefillRows = 64;  // query rows (t * G + g) per prefill block
constexpr int kPrefillThreads = 256;

template <int D>
__host__ __device__ constexpr int kv_tile() { return D <= 64 ? 64 : 32; }

// Slot t of a tile starting at key t0 of (b, kv head h): its row in k / v, or
// -1 past the key length.
struct DenseSrc {
  long long base;  // row index of key 0 for (b, h)
  int t0, tk;
  __device__ long long operator()(int t) const {
    const int j = t0 + t;
    return j < tk ? base + j : -1;
  }
};

// Row r of a block is query t = (row0 + r) / G at position q_off + t.
struct BandLive {
  int t0, row0, group, rows_valid, tk, q_off, causal, has_window, window;
  __device__ bool operator()(int r, int t) const {
    const int j = t0 + t;
    if (r >= rows_valid || j >= tk) return false;
    const int qp = q_off + (row0 + r) / group;
    if (causal && j > qp) return false;
    if (has_window && j <= qp - window) return false;
    return true;
  }
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kPrefillThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ q_off_ptr,
             int q_off_val, int hkv, int group, int tq, int tk, int causal, int has_window,
             int window, float scale) {
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  constexpr int NT = kv_tile<D>(), R = kPrefillRows;
  const int G = group;
  const int row0 = tile * R;
  const int rows_valid = min(R, tq * G - row0);
  extern __shared__ float smem[];
  float* q_s = smem;                    // R * D
  float* k_s = q_s + R * D;             // NT * (D + 1), padded against bank conflicts
  float* v_s = k_s + NT * (D + 1);      // NT * D
  float* s_s = v_s + NT * D;            // R * NT
  float* acc_s = s_s + R * NT;          // R * D
  float* m_s = acc_s + R * D;           // R
  float* l_s = m_s + R;                 // R
  float* alpha_s = l_s + R;             // R

  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  const int hq = hkv * G;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (r < rows_valid) {
      const int gr = row0 + r, t = gr / G, g = gr - t * G;
      x = to_f32(q[((static_cast<size_t>(b) * hq + h * G + g) * tq + t) * D + d]);
    }
    q_s[i] = x;
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  // the keys these rows can see: [j_lo, j_hi)
  const int qp_lo = q_off + row0 / G;
  const int qp_hi = q_off + (row0 + rows_valid - 1) / G;
  int j_lo = 0, j_hi = tk;
  if (causal) j_hi = min(tk, qp_hi + 1);
  if (has_window) j_lo = max(0, qp_lo - window + 1);
  const long long base = (static_cast<long long>(b) * hkv + h) * tk;
  for (int t0 = j_lo; t0 < j_hi; t0 += NT) {
    load_kv_tile<T, D>(k, v, k_s, v_s, NT, DenseSrc{base, t0, tk});
    __syncthreads();
    flash_tile<D>(q_s, k_s, v_s, s_s, m_s, l_s, alpha_s, acc_s, R, NT, scale,
                  BandLive{t0, row0, G, rows_valid, tk, q_off, causal, has_window, window});
  }
  for (int i = threadIdx.x; i < rows_valid * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    const float l = l_s[r];
    out[((static_cast<size_t>(b) * hq + h * G + g) * tq + t) * D + d] =
        from_f32<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
  if constexpr (kLse) {  // natural-log units of the scaled scores; -1e30 with no live key
    for (int r = threadIdx.x; r < rows_valid; r += blockDim.x) {
      const int gr = row0 + r, t = gr / G, g = gr - t * G;
      const float l = l_s[r];
      lse[(static_cast<size_t>(b) * hq + h * G + g) * tq + t] =
          l == 0.f ? kNegInf : m_s[r] + logf(l);
    }
  }
}

template <typename T, int D, bool kLse>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* out, float* lse,
                      const void* q_off_ptr, int q_off, int batch, int hq, int hkv, int tq,
                      int tk, int causal, int has_window, int window, float scale,
                      cudaStream_t stream) {
  const int G = hq / hkv;
  constexpr int NT = kv_tile<D>();
  constexpr size_t R = kPrefillRows;
  const size_t smem = sizeof(float) *
      (R * D * 2 + static_cast<size_t>(NT) * (2 * D + 1) + R * NT + 3 * R);
  auto kern = flash_kernel<T, D, kLse>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  const int tiles = (tq * G + kPrefillRows - 1) / kPrefillRows;
  kern<<<dim3(tiles, hkv, batch), kPrefillThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, static_cast<const int*>(q_off_ptr), q_off, hkv, G, tq, tk,
      causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   const void* q_off_ptr, int q_off, int batch, int hq, int hkv, int tq,
                   int tk, int causal, int has_window, int window, float scale,
                   cudaStream_t stream) {
  auto body = lse != nullptr ? launch_as<T, D, true> : launch_as<T, D, false>;
  return body(q, k, v, out, lse, q_off_ptr, q_off, batch, hq, hkv, tq, tk, causal, has_window,
              window, scale, stream);
}


// ---------------------------------------------------------------------------------
// bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------------
constexpr int kMmaRows = 64;  // query rows a block, 16 a warp (slab)
constexpr int kPad = 8;       // bf16 elements padding a shared-memory row (16 bytes)

template <int D> __host__ __device__ constexpr int mma_keys() { return D > 128 ? 32 : 64; }
template <int D> __host__ __device__ constexpr int mma_col_split() { return D > 128 ? 2 : 1; }
template <int D> struct MmaThreads {
  static constexpr int value = (kMmaRows / 16) * 32 * mma_col_split<D>();
};
template <int D> __host__ __device__ constexpr size_t mma_smem() {
  return sizeof(bf16) * (D + kPad) * (kMmaRows + 4 * mma_keys<D>());  // Q + 2 stages of K, V
}

template <int D, bool kLse>  // kLse as in flash_kernel
__global__ void __launch_bounds__(MmaThreads<D>::value)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 const int* __restrict__ q_off_ptr, int q_off_val, int hkv, int group, int tq,
                 int tk, int causal, int has_window, int window, float scale) {
  constexpr int NK = mma_keys<D>(), CS = mma_col_split<D>(), NTHR = MmaThreads<D>::value;
  constexpr int LD = D + kPad;  // shared-memory row stride, bf16 elements
  constexpr int DC = D / CS;    // output columns a warp owns
  constexpr int CPR = D / 8;    // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kMmaRows * LD
  bf16* kv_s = q_s + kMmaRows * LD;               // 2 stages of (K, V), NK * LD each

  const int h = blockIdx.y, b = blockIdx.z;
  const int G = group, hq = hkv * G;
  const int row0 = blockIdx.x * kMmaRows;
  const int rows_valid = min(kMmaRows, tq * G - row0);
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp / CS, col0 = (warp % CS) * DC;

  for (int i = tid; i < kMmaRows * CPR; i += NTHR) {
    const int r = i / CPR, c = i - r * CPR;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      const int gr = row0 + r, t = gr / G, g = gr - t * G;
      x = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * hq + h * G + g) * tq + t) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * LD + c * 8) = x;
  }

  // the keys these rows can see: [j_lo, j_hi)
  const int qp_lo = q_off + row0 / G;
  const int qp_hi = q_off + (row0 + rows_valid - 1) / G;
  int j_lo = 0, j_hi = tk;
  if (causal) j_hi = min(tk, qp_hi + 1);
  if (has_window) j_lo = max(0, qp_lo - window + 1);
  const int n_tiles = j_hi > j_lo ? (j_hi - j_lo + NK - 1) / NK : 0;
  const size_t kv_row0 = (static_cast<size_t>(b) * hkv + h) * tk;

  auto stage = [&](int t0, int buf) {
    bf16* ks = kv_s + buf * 2 * NK * LD;
    bf16* vs = ks + NK * LD;
    for (int i = tid; i < NK * CPR; i += NTHR) {
      const int r = i / CPR, c = i - r * CPR, j = t0 + r;
      const bool in = j < tk;  // past Tk: zeros, so a dead V row is finite
      const size_t off = (kv_row0 + (in ? j : 0)) * D + c * 8;
      cp_async16(ks + r * LD + c * 8, k + off, in ? 16 : 0);
      cp_async16(vs + r * LD + c * 8, v + off, in ? 16 : 0);
    }
    cp_async_commit();
  };

  // this thread's two rows of the slab (the accumulators' rows lane / 4 and +8)
  const int r_a = slab * 16 + (lane >> 2);
  const int qp_a = q_off + (row0 + r_a) / G, qp_b = q_off + (row0 + r_a + 8) / G;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp2f below
  float o[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  if (n_tiles > 0) stage(j_lo, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = j_lo + it * NK;
    if (it + 1 < n_tiles) {
      stage(t0 + NK, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv_s + (it & 1) * 2 * NK * LD;
    const bf16* vs = ks + NK * LD;

    // liveness of (row, key); a tile inside every row's band skips the test
    const bool all_live = t0 + NK <= tk && (!causal || t0 + NK - 1 <= qp_lo) &&
                          (!has_window || t0 > qp_hi - window);
    auto live = [&](int col, int hi) {
      const int j = t0 + col, qp = hi ? qp_b : qp_a;
      return j < tk && (!causal || j <= qp) && (!has_window || j > qp - window);
    };
    mma_softmax_tile<D, NK, DC, LD>(q_s, ks, vs, slab, col0, sl2, all_live, live, false,
                                    nullptr, nullptr, o, m_r, l_r);
    __syncthreads();  // the next iteration restages this buffer
  }

  // out = O / l (0 for a row with no live key), bf16 pairs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_a + 8 * i;
    if (r >= rows_valid) continue;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    const float l = l_r[i] == 0.f ? 1.f : l_r[i];
    // the lse in natural-log units (m_r is in log2 units of the scaled scores);
    // the quad's lanes and a slab's column warps hold the same m and l
    if (kLse && (lane & 3) == 0 && col0 == 0) {
      lse[(static_cast<size_t>(b) * hq + h * G + g) * tq + t] =
          l_r[i] == 0.f ? kNegInf : (m_r[i] + log2f(l_r[i])) * 0.6931471805599453f;
    }
    bf16* dst = out + ((static_cast<size_t>(b) * hq + h * G + g) * tq + t) * D + col0 +
                (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * i] / l, o[n][2 * i + 1] / l);
    }
  }
}

template <int D, bool kLse>
cudaError_t launch_mma_as(const void* q, const void* k, const void* v, void* out, float* lse,
                          const void* q_off_ptr, int q_off, int batch, int hq, int hkv, int tq,
                          int tk, int causal, int has_window, int window, float scale,
                          cudaStream_t stream) {
  const int G = hq / hkv;
  constexpr size_t smem = mma_smem<D>();
  auto kern = flash_mma_kernel<D, kLse>;
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = set_smem(kern, smem, opted);
  if (e != cudaSuccess) return e;
  const int tiles = (tq * G + kMmaRows - 1) / kMmaRows;
  kern<<<dim3(tiles, hkv, batch), MmaThreads<D>::value, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, static_cast<const int*>(q_off_ptr), q_off, hkv, G, tq, tk,
      causal, has_window, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                       const void* q_off_ptr, int q_off, int batch, int hq, int hkv, int tq,
                       int tk, int causal, int has_window, int window, float scale,
                       cudaStream_t stream) {
  auto body = lse != nullptr ? launch_mma_as<D, true> : launch_mma_as<D, false>;
  return body(q, k, v, out, lse, q_off_ptr, q_off, batch, hq, hkv, tq, tk, causal, has_window,
              window, scale, stream);
}

// One-token decode over the dense cache: the split body, then the combine.
template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k_cache, const void* v_cache, void* out,
                          void* ws, float* lse, const void* pos_ptr, int pos, int batch, int hq,
                          int hkv, int s_len, int has_window, int window, int splits,
                          int keys_per_split, float scale, cudaStream_t stream) {
  const DensePool<T, D> pool{static_cast<const T*>(k_cache), static_cast<const T*>(v_cache)};
  const DenseKeys keys{static_cast<const int*>(pos_ptr), pos, s_len, hkv, has_window, window};
  return launch_split_decode<T, D>(q, pool, keys, out, ws, batch, hq, hkv, splits,
                                   keys_per_split, scale, stream, lse);
}

#define REPRO_DISPATCH(FN, ...)                                                      \
  switch (head_dim) {                                                                \
    case 16: return dtype == 0 ? FN<float, 16>(__VA_ARGS__)                          \
                               : FN<__nv_bfloat16, 16>(__VA_ARGS__);                 \
    case 32: return dtype == 0 ? FN<float, 32>(__VA_ARGS__)                          \
                               : FN<__nv_bfloat16, 32>(__VA_ARGS__);                 \
    case 64: return dtype == 0 ? FN<float, 64>(__VA_ARGS__)                          \
                               : FN<__nv_bfloat16, 64>(__VA_ARGS__);                 \
    case 112: return dtype == 0 ? FN<float, 112>(__VA_ARGS__)                        \
                                : FN<__nv_bfloat16, 112>(__VA_ARGS__);               \
    case 128: return dtype == 0 ? FN<float, 128>(__VA_ARGS__)                        \
                                : FN<__nv_bfloat16, 128>(__VA_ARGS__);               \
    case 256: return dtype == 0 ? FN<float, 256>(__VA_ARGS__)                        \
                                : FN<__nv_bfloat16, 256>(__VA_ARGS__);               \
    default: return cudaErrorInvalidValue;                                           \
  }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). lse, when not
// null, receives each query row's (B, Hq, Tq) f32 log-sum-exp of the scaled
// scores (-1e30 for a row with no live key): the backward's input; serving
// passes null. q_offset_ptr
// points at one int32 on the device, or is null and q_offset is used. A
// window applies when has_window is set. Each returns the cudaError_t of the
// launch (0 on success); nothing here synchronizes.
int repro_flash_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                          float* lse, const void* q_offset_ptr, int q_offset, int batch, int hq,
                          int hkv, int tq, int tk, int head_dim, int causal, int has_window,
                          int window, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 ||
      tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const auto st = static_cast<cudaStream_t>(stream);
  auto run = [&]() -> cudaError_t {
    if (dtype == 1) {  // bf16: the tensor-core body
      switch (head_dim) {
        case 16: return launch_mma<16>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                       hkv, tq, tk, causal, has_window, window, scale, st);
        case 32: return launch_mma<32>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                       hkv, tq, tk, causal, has_window, window, scale, st);
        case 64: return launch_mma<64>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                       hkv, tq, tk, causal, has_window, window, scale, st);
        case 112: return launch_mma<112>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                         hkv, tq, tk, causal, has_window, window, scale, st);
        case 128: return launch_mma<128>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                         hkv, tq, tk, causal, has_window, window, scale, st);
        case 256: return launch_mma<256>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                         hkv, tq, tk, causal, has_window, window, scale, st);
        default: return cudaErrorInvalidValue;
      }
    }
    switch (head_dim) {  // f32: flash_kernel's CUDA-core products
      case 16: return launch<float, 16>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                        hkv, tq, tk, causal, has_window, window, scale, st);
      case 32: return launch<float, 32>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                        hkv, tq, tk, causal, has_window, window, scale, st);
      case 64: return launch<float, 64>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                        hkv, tq, tk, causal, has_window, window, scale, st);
      case 112: return launch<float, 112>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                          hkv, tq, tk, causal, has_window, window, scale, st);
      case 128: return launch<float, 128>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                          hkv, tq, tk, causal, has_window, window, scale, st);
      case 256: return launch<float, 256>(q, k, v, out, lse, q_offset_ptr, q_offset, batch, hq,
                                          hkv, tq, tk, causal, has_window, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  };
  return static_cast<int>(run());
}

// One-token decode: q (B, Hq, 1, D) against caches (B, Hkv, S, D); slot pos
// is the current token (slots past it, and with a window slots at or before
// pos - window, are masked and never read). The keys are cut into ``splits``
// runs of ``keys_per_split`` (splits * keys_per_split >= S), one block per
// (split, KV head and 8-row block of its group, sequence), merged in a second
// kernel; ``workspace`` holds B * Hq * splits * (D + 2) floats (common.cuh's
// combine_splits_kernel). ``lse``, when not null, receives each row's (B, Hq)
// f32 log-sum-exp of the scaled scores, -inf for a row with no live key (a
// rank's slice of a sequence-split cache lying wholly after the token: pos
// negative); serving's one-device decode passes null and runs the combine
// without that epilogue. pos may be negative (no live key) or past the cache
// (every slot live).
int repro_flash_decode(int dtype, const void* q, const void* k_cache, const void* v_cache,
                       void* out, void* workspace, float* lse, const void* pos_ptr, int pos,
                       int batch, int hq, int hkv, int s_len, int head_dim, int has_window,
                       int window, int splits, int keys_per_split, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || batch > 65535 || hkv <= 0 || hq % hkv != 0 ||
      s_len <= 0 || splits <= 0 || keys_per_split <= 0 ||
      static_cast<long long>(splits) * keys_per_split < s_len ||
      static_cast<long long>(hkv) * ((hq / hkv + kDecodeRows - 1) / kDecodeRows) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();
  auto run = [&]() -> cudaError_t {
    REPRO_DISPATCH(launch_decode, q, k_cache, v_cache, out, workspace, lse, pos_ptr, pos,
                   batch, hq, hkv, s_len, has_window, window, splits, keys_per_split, scale,
                   static_cast<cudaStream_t>(stream))
  };
  return static_cast<int>(run());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
