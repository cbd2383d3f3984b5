// The backward of the RG-LRU recurrence h_t = a_t * h_{t-1} + b_t for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (repro_torch/kernels/rglru_scan.py holds the wrapper, RGLRUScanFn and the
// plain twin rglru_bwd_torch it is held against).
//
// What it replaces: the gradient the reference gets by autodiff of its
// associative scan (src/repro/models/rglru.py:88-94). Given dy (the gradient
// of every h_t), the f32 states h of the forward and an optional gradient of
// the final state, it runs the reverse recurrence
//   Lam_t = dy_t + c,  db_t = Lam_t,  da_t = Lam_t * h_{t-1},  c <- a_t * Lam_t
// from c = d h_final (or 0) at t = T - 1 down to t = 0, with h_{-1} the
// initial state (or 0), and leaves c = a_0 Lam_0, the gradient of the initial
// state. Each product and sum is rounded as the plain twin rounds it
// (__fmul_rn / __fadd_rn, no contraction), so f32 gives its bits.
//
// Layout: a, dy, da, db (B, T, W) in one element type (float or
// __nv_bfloat16), contiguous; h (B, T, W) f32; h0, dh_final and dh0 (B, W)
// f32, each may be null.
//
// What bounds it on an H100: bytes (read a, dy, h; write da, db). The chain is
// sequential in t and independent across (b, w), as the forward's.
//
// The design mirrors csrc/rglru_scan.cu: a block owns one work item (a
// sequence b, kC consecutive columns; B * ceil(W / kC) blocks), its first warp
// runs the chain (lane l on column c0 + l, walking t downward) and stores da
// and db straight from it, one coalesced row a step; its kLoadWarps load warps
// keep a ring of kStages stages full in shared memory. A stage is kS steps x
// kC columns of a, of dy and of h_{t-1} (h shifted one row: the stage's row
// for t = 0 is zeros, the chain takes h0 there), staged from the last time
// block down to the first, with 16-byte cp.async where every row lies on 16
// bytes, else with plain loads. The ring's full / empty mbarriers are the
// forward's. No cross-lane sum, so no atomics: two runs give the same bits.

#include "common.cuh"

namespace {

constexpr int kC = 32;        // columns a work item: one chain lane each
constexpr int kS = 32;        // time steps a stage
constexpr int kStages = 4;    // stages in the ring
constexpr int kLoadWarps = 2;
constexpr int kChainThreads = 32 * ((kC + 31) / 32);
constexpr int kLoadThreads = 32 * kLoadWarps;
constexpr int kThreads = kChainThreads + kLoadThreads;

// kernels/rglru_scan.py's BWD_GEOMETRY, in its order
constexpr int kGeometry[] = {kC, kS, kStages, kThreads};

// a stage: a and dy (T), then h_{t-1} (f32), each kS x kC
template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
  return static_cast<size_t>(kS) * kC * (2 * sizeof(T) + sizeof(float));
}
template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return kStages * stage_bytes<T>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ dy, const float* __restrict__ h,
                 const float* __restrict__ h0, const float* __restrict__ dhf, T* __restrict__ da,
                 T* __restrict__ db, float* __restrict__ dh0, int t_len, int width, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kLoadThreads);
      mbar_init(&empty[s], kChainThreads);
    }
  }
  __syncthreads();
  const int slices = (width + kC - 1) / kC;
  const int bb = blockIdx.x / slices;
  const int c0 = (blockIdx.x - bb * slices) * kC;
  const int stages = (t_len + kS - 1) / kS;
  auto stage_a = [&](int slot) {
    return reinterpret_cast<T*>(smem_raw + static_cast<size_t>(slot) * stage_bytes<T>());
  };
  if (tid < kChainThreads) {
    // ---- the chain: lane tid owns column c0 + tid, t from T - 1 down to 0 -----------
    const int col = c0 + tid;
    const bool live = tid < kC && col < width;
    const size_t sc = static_cast<size_t>(bb) * width + col;
    float c = live && dhf != nullptr ? dhf[sc] : 0.f;
    const float hinit = live && h0 != nullptr ? h0[sc] : 0.f;
    const size_t base = static_cast<size_t>(bb) * t_len * width + col;
    for (int st = 0; st < stages; ++st) {
      const int slot = st % kStages;
      mbar_wait(&full[slot], (st / kStages) & 1u);
      const T* sa = stage_a(slot) + tid;
      const T* sd = sa + kS * kC;
      const float* sh = reinterpret_cast<const float*>(stage_a(slot) + 2 * kS * kC) + tid;
      const int t0 = (stages - 1 - st) * kS, rows = min(kS, t_len - t0);
      if (live) {
        for (int u = rows - 1; u >= 0; --u) {
          const int t = t0 + u;
          const float lam = __fadd_rn(to_f32(sd[u * kC]), c);
          const float hp = t > 0 ? sh[u * kC] : hinit;
          const size_t o = base + static_cast<size_t>(t) * width;
          db[o] = from_f32<T>(lam);
          da[o] = from_f32<T>(__fmul_rn(lam, hp));
          c = __fmul_rn(to_f32(sa[u * kC]), lam);
        }
      }
      mbar_arrive(&empty[slot]);
    }
    if (live && dh0 != nullptr) dh0[sc] = c;
    return;
  }
  // ---- the load warps: fill stage after stage (last time block first) -------------
  const int lt = tid - kChainThreads;
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elements of T a 16-byte copy
  constexpr int kChunksRow = kC / kChunk;
  constexpr int kChunksRowH = kC / 4;                       // f32 h: 4 a copy
  const size_t row0 = static_cast<size_t>(bb) * t_len;
  for (int st = 0; st < stages; ++st) {
    const int slot = st % kStages;
    if (st >= kStages) mbar_wait(&empty[slot], ((st / kStages) & 1u) ^ 1u);
    T* sa = stage_a(slot);
    T* sd = sa + kS * kC;
    float* sh = reinterpret_cast<float*>(sa + 2 * kS * kC);
    const int t0 = (stages - 1 - st) * kS, rows = min(kS, t_len - t0);
    if (vec) {
      for (int q = lt; q < rows * kChunksRow; q += kLoadThreads) {
        const int r = q / kChunksRow, cc = (q - r * kChunksRow) * kChunk;
        const size_t g = (row0 + t0 + r) * width + c0 + cc;
        const bool in = c0 + cc < width;  // W * sizeof(T) % 16 == 0: a chunk is in or out
        cp_async16(sa + r * kC + cc, in ? a + g : a, in ? 16 : 0);
        cp_async16(sd + r * kC + cc, in ? dy + g : dy, in ? 16 : 0);
      }
      for (int q = lt; q < rows * kChunksRowH; q += kLoadThreads) {
        const int r = q / kChunksRowH, cc = (q - r * kChunksRowH) * 4;
        const bool in = c0 + cc < width && t0 + r > 0;
        const size_t g = in ? (row0 + t0 + r - 1) * width + c0 + cc : 0;
        cp_async16(sh + r * kC + cc, h + g, in ? 16 : 0);
      }
      mbar_arrive_on_copies(&full[slot]);
    } else {
#pragma unroll 4
      for (int q = lt; q < rows * kC; q += kLoadThreads) {
        const int r = q / kC, cc = q - r * kC;
        T va = from_f32<T>(0.f), vd = va;
        float vh = 0.f;
        if (c0 + cc < width) {
          const size_t g = (row0 + t0 + r) * width + c0 + cc;
          va = a[g];
          vd = dy[g];
          if (t0 + r > 0) vh = h[g - width];
        }
        sa[r * kC + cc] = va;
        sd[r * kC + cc] = vd;
        sh[r * kC + cc] = vh;
      }
      mbar_arrive(&full[slot]);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Opt the instance in to its ring (48 KB for f32, the static mbarriers
// beside it), once per device.
template <typename T>
cudaError_t prepare(size_t* opted) {
  const size_t smem = ring_bytes<T>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(rglru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) opted[dev] = smem;
  return e;
}

size_t g_opted[2][kMaxDevices];

template <typename T>
cudaError_t launch(const void* a, const void* dy, const void* h, const void* h0, const void* dhf,
                   void* da, void* db, void* dh0, int batch, int t_len, int width, bool vec,
                   size_t* opted, cudaStream_t stream) {
  const cudaError_t e = prepare<T>(opted);
  if (e != cudaSuccess) return e;
  const int64_t blocks = static_cast<int64_t>(batch) * ((width + kC - 1) / kC);
  rglru_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, ring_bytes<T>(), stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(dy), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(dhf), static_cast<T*>(da),
      static_cast<T*>(db), static_cast<float*>(dh0), t_len, width, vec);
  return cudaGetLastError();
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, dy, da and db share it); h the f32
// states of the forward; h0 (the initial state), dhf (the final state's
// gradient) and dh0 (the initial state's gradient, written) may be null. One
// block a work item (B * ceil(W / kC)); 16-byte copies where a, dy and h lie
// on 16 bytes and W * sizeof(T) is a multiple of 16, plain loads elsewhere.
// Returns the cudaError_t of the launch (0 on success); nothing here
// synchronizes.
int repro_rglru_scan_bwd(int dtype, const void* a, const void* dy, const void* h, const void* h0,
                         const void* dhf, void* da, void* db, void* dh0, int batch, int t_len,
                         int width, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || t_len <= 0 || width <= 0 ||
      static_cast<int64_t>(batch) * ((width + kC - 1) / kC) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = on16(a) && on16(dy) && on16(h) && static_cast<int64_t>(width) * esize % 16 == 0;
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0
          ? launch<float>(a, dy, h, h0, dhf, da, db, dh0, batch, t_len, width, vec, g_opted[0], s)
          : launch<__nv_bfloat16>(a, dy, h, h0, dhf, da, db, dh0, batch, t_len, width, vec,
                                  g_opted[1], s);
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
