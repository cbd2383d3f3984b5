// RG-LRU gated linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// over the time axis of (B, T, W), with a plain C interface loaded through
// ctypes (repro_torch/kernels/rglru_scan.py holds the wrapper, its planner and
// the plain PyTorch version it is held against).
//
// What it replaces: src/repro/kernels/rglru_scan.py::rglru_scan (Pallas TPU).
// Same function: a and b are the precomputed decay and input terms (the gates
// stay outside, as there), the state is f32 from an optional f32 h0, y is
// written in a's type, and the f32 final state comes back. Any T: the TPU
// kernel's T % chunk == 0 does not apply.
//
// Layout: a, b, y (B, T, W) in one element type (float or __nv_bfloat16),
// contiguous; h0 and the final state (B, W) f32.
//
// What bounds it on an H100: bytes. Each step is one multiply-add per column
// on 2 loads and 1 store, so the least time is (read a and b, write y) / the
// copy rate. The recurrence is sequential in t and independent across (b, w).
//
// The chain: each column computes h = fmaf(a_t, h, b_t) in t order, from h0 or
// 0, one lane a column, and writes y_t = h rounded to the element type. That
// order is the TPU kernel's, and it makes a run over two chained halves give
// the bits of one run; a chunked scan that composes chunk maps would
// re-associate it, so none is used. The chain is ~T dependent multiply-adds
// (a few microseconds at T 2600); what costs time is getting a_t and b_t to
// it, so the chain never waits on device memory:
//
//   A block owns one work item (a sequence b, kC consecutive columns): the
//   grid is B * ceil(W / kC) blocks (160 at B 2 x W 2560, more than the 132
//   SMs; the hardware places what does not fit at once in later waves). Its
//   first warps run the chain, lane l on column c0 + l, and store y straight
//   from the chain: a step's kC values of y are one coalesced row. Its
//   kLoadWarps load warps keep a ring of kStages stages full in shared
//   memory: a stage is kS steps x kC columns of a and of b, copied with
//   16-byte cp.async where every row lies on 16 bytes (the entry point
//   checks a's and b's pointers and W), else with plain loads (odd W in bf16,
//   W no multiple of 16 bytes, a view's data pointer). Each stage has two
//   mbarriers: ``full``
//   (each load thread arrives when its copies of the stage have landed:
//   cp.async.mbarrier.arrive.noinc, or an arrive after its plain stores) and
//   ``empty`` (each chain thread arrives when it has read the stage). So the
//   loads of kStages - 1 stages are in flight while the chain consumes one,
//   and nothing synchronizes the whole block after the start.
//
// Columns past W (the last slice of a row) are staged as zeros and never
// stored; a last partial stage (T no multiple of kS) and a T shorter than a
// stage take the same loop with fewer rows.

#include "common.cuh"

namespace {

constexpr int kC = 32;        // columns a work item: one chain lane each
constexpr int kS = 32;        // time steps a stage
constexpr int kStages = 4;    // stages in the ring
constexpr int kLoadWarps = 2;
constexpr int kChainThreads = 32 * ((kC + 31) / 32);
constexpr int kLoadThreads = 32 * kLoadWarps;
constexpr int kThreads = kChainThreads + kLoadThreads;

// kernels/rglru_scan.py's GEOMETRY, in its order
constexpr int kGeometry[] = {kC, kS, kStages, kThreads};

template <typename T>
constexpr size_t ring_bytes() {
  return static_cast<size_t>(kStages) * 2 * kS * kC * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ hf, int t_len, int width, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][a, b][kS][kC]
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
  if (tid < kChainThreads) {
    // ---- the chain: lane tid owns column c0 + tid -----------------------------------
    const int col = c0 + tid;
    const bool live = tid < kC && col < width;
    float h = live && h0 != nullptr ? h0[static_cast<size_t>(bb) * width + col] : 0.f;
    T* yp = y + static_cast<size_t>(bb) * t_len * width + col;
    for (int st = 0; st < stages; ++st) {
      const int slot = st % kStages;
      mbar_wait(&full[slot], (st / kStages) & 1u);
      const T* sa = ring + static_cast<size_t>(slot) * 2 * kS * kC + tid;
      const T* sb = sa + kS * kC;
      const int t0 = st * kS, rows = min(kS, t_len - t0);
      if (live) {
        T* yo = yp + static_cast<size_t>(t0) * width;
        if (rows == kS) {
#pragma unroll
          for (int u = 0; u < kS; ++u) {
            h = fmaf(to_f32(sa[u * kC]), h, to_f32(sb[u * kC]));
            yo[static_cast<size_t>(u) * width] = from_f32<T>(h);
          }
        } else {
          for (int u = 0; u < rows; ++u) {
            h = fmaf(to_f32(sa[u * kC]), h, to_f32(sb[u * kC]));
            yo[static_cast<size_t>(u) * width] = from_f32<T>(h);
          }
        }
      }
      mbar_arrive(&empty[slot]);
    }
    if (live) hf[static_cast<size_t>(bb) * width + col] = h;
    return;
  }
  // ---- the load warps: fill stage after stage, kStages - 1 ahead of the chain ---------
  const int lt = tid - kChainThreads;
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte copy
  constexpr int kChunksRow = kC / kChunk;
  const size_t row0 = static_cast<size_t>(bb) * t_len;
  for (int st = 0; st < stages; ++st) {
    const int slot = st % kStages;
    if (st >= kStages) mbar_wait(&empty[slot], ((st / kStages) & 1u) ^ 1u);
    T* da = ring + static_cast<size_t>(slot) * 2 * kS * kC;
    T* db = da + kS * kC;
    const int t0 = st * kS, rows = min(kS, t_len - t0);
    if (vec) {
      for (int q = lt; q < rows * kChunksRow; q += kLoadThreads) {
        const int r = q / kChunksRow, c = (q - r * kChunksRow) * kChunk;
        const size_t g = (row0 + t0 + r) * width + c0 + c;
        const bool in = c0 + c < width;  // W * sizeof(T) % 16 == 0: a chunk is in or out
        cp_async16(da + r * kC + c, in ? a + g : a, in ? 16 : 0);
        cp_async16(db + r * kC + c, in ? b + g : b, in ? 16 : 0);
      }
      mbar_arrive_on_copies(&full[slot]);
    } else {
#pragma unroll 4
      for (int q = lt; q < rows * kC; q += kLoadThreads) {
        const int r = q / kC, c = q - r * kC;
        T va = from_f32<T>(0.f), vb = va;
        if (c0 + c < width) {
          const size_t g = (row0 + t0 + r) * width + c0 + c;
          va = a[g];
          vb = b[g];
        }
        da[r * kC + c] = va;
        db[r * kC + c] = vb;
      }
      mbar_arrive(&full[slot]);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

size_t g_opted[2][kMaxDevices];  // the shared-memory opt-in already made, per dtype

template <typename T>
cudaError_t prepare(size_t* opted) {
  return set_smem(rglru_kernel<T>, ring_bytes<T>(), opted);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* y, void* hf, int batch,
                   int t_len, int width, bool vec, size_t* opted, cudaStream_t stream) {
  const cudaError_t e = prepare<T>(opted);
  if (e != cudaSuccess) return e;
  const int64_t blocks = static_cast<int64_t>(batch) * ((width + kC - 1) / kC);
  rglru_kernel<T><<<static_cast<unsigned>(blocks), kThreads, ring_bytes<T>(), stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hf), t_len, width, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and y share it); h0 may be null (a
// zero initial state); hf receives the f32 final state. One block a work item
// (B * ceil(W / kC)); the ring takes the 16-byte copies where a and b lie on
// 16 bytes and W * sizeof(T) is a multiple of 16, plain loads elsewhere.
// Returns the cudaError_t of the launch (0 on success); nothing here
// synchronizes.
int repro_rglru_scan(int dtype, const void* a, const void* b, const void* h0, void* y, void* hf,
                     int batch, int t_len, int width, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || t_len <= 0 || width <= 0 ||
      static_cast<int64_t>(batch) * ((width + kC - 1) / kC) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   static_cast<int64_t>(width) * esize % 16 == 0;
  (void)cudaGetLastError();  // attribute only this launch's error to it
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? launch<float>(a, b, h0, y, hf, batch, t_len, width, vec, g_opted[0], s)
                 : launch<__nv_bfloat16>(a, b, h0, y, hf, batch, t_len, width, vec, g_opted[1], s);
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
