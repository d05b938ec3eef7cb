// Confusion-matrix counts on Hopper (sm_90a), added into the caller's matrix.
//
// Replaces the TPU kernel
// torchmetrics_tpu/functional/classification/_pallas_confmat.py::confusion_matrix_pallas
// (body _confmat_kernel). That kernel keeps a resident (C_pad, C_pad) f32
// accumulator in VMEM across a sequential grid and adds one-hot outer
// products per 512-row tile. On Hopper the accumulator (4 MB at C=1000) does
// not fit in a block's 227 KB of shared memory, and blocks run in parallel in
// no order, so the design here is a histogram instead, into the (C, C) matrix
// that stays resident in the 50 MB L2. Like the TPU kernel, no (N, C) one-hot
// ever reaches device memory.
//
// Bound: device-memory bytes. The function reads N * (2 * index_bytes + weight_bytes);
// it adds into a matrix the caller holds (a metric's state), so the matrix
// is neither zeroed nor written whole, only its touched cells. It does no
// arithmetic worth counting.
//
// Rows are target labels, columns predicted labels. A row whose target or
// prediction lies outside [0, C), or whose mask is false, adds nothing.
//
// Design (what held the one-atomic-per-row design back: a pixel map that is
// 70% right sends 70% of its rows to the C diagonal cells, thousands of
// same-address L2 atomics per cell per call, and one 8-byte label per load):
// - Wide loads: a thread takes 8 consecutive rows a step, as 16-byte loads
//   of the labels (2 int64 or 4 int32), one 8-byte load of a bool mask and
//   16-byte loads of float weights. The rows before the first 16-byte
//   boundary that all arrays share (`head`, from the host) and the ragged
//   tail go through a scalar loop; arrays with no common boundary go through
//   it whole.
// - The diagonal off the L2 atomics: each block counts the C diagonal cells
//   in shared memory (C * 4 bytes) and flushes them with one global atomic per
//   non-zero counter. The flush costs blocks * C atomics, so the grid is a few
//   large blocks per SM (512 threads, 2 an SM), not many small ones.
// - Coherent maps: a thread merges a run of equal cells among its 8 rows
//   into one add; the run that ends a step is then aggregated across the warp
//   (__match_any_sync on the cell, one atomic with the group's sum), which
//   catches neighbouring pixels that share a cell.
// - Counts are int32 and exact. Float weights take the same route with float
//   sums, whose order (and so last bits) varies from run to run, as any
//   atomic histogram's does.
//
// Cell indices are int32: C <= 46340.
//
// Lane-batched form (tm_confmat_lanes): a StreamPool's micro-batch of B
// tenants counts B matrices in one launch, one grid row (blockIdx.y) per
// lane, each lane's rows and matrix at its own stride, the same body as
// above. It reads B * N * (2 * index_bytes + weight_bytes) and adds into the
// gathered (B, C, C) lanes.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point tm_confmat with ctypes.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 8;  // rows a thread takes per step
constexpr int kMaxClasses = 46340;  // C * C < 2**31
constexpr unsigned kFull = 0xffffffffu;

// weight kinds: none (count 1, int32 out), a bool mask (count 1 where set,
// int32 out), float32 weights (float32 sums out)
constexpr int kWeightNone = 0;
constexpr int kWeightMask = 1;
constexpr int kWeightFloat = 2;

template <int Kind>
using Val = typename std::conditional<Kind == kWeightFloat, float, int>::type;

__device__ __forceinline__ void load_rows(const int64_t* p, int64_t (&x)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) {
    const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(p) + i);
    x[2 * i] = v.x;
    x[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load_rows(const int32_t* p, int32_t (&x)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p) + i);
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

// key: the cell t * C + p, or -1 for a row that adds nothing; diag: t where t == p, else -1
template <typename Idx>
__device__ __forceinline__ void cell_of(Idx t, Idx p, int64_t C, bool keep, int& key, int& diag) {
  keep = keep && t >= 0 && t < C && p >= 0 && p < C;
  key = keep ? static_cast<int>(t) * static_cast<int>(C) + static_cast<int>(p) : -1;
  diag = keep && t == p ? static_cast<int>(t) : -1;
}

template <typename V>
__device__ __forceinline__ void add_direct(int key, int diag, V v, V* diag_s, V* out) {
  if (diag >= 0) {
    atomicAdd(diag_s + diag, v);
  } else if (key >= 0) {
    atomicAdd(out + key, v);
  }
}

// A run that ends a step, added by every lane of the warp at once: the
// diagonal into shared memory, the rest once per group of lanes on one cell.
template <typename V>
__device__ __forceinline__ void add_warp(int key, int diag, V v, V* diag_s, V* out, int lane) {
  if (diag >= 0) atomicAdd(diag_s + diag, v);
  const int off = diag < 0 ? key : -1;
  if (!__any_sync(kFull, off >= 0)) return;
  const unsigned peers = __match_any_sync(kFull, off);
  if (__any_sync(kFull, off >= 0 && __popc(peers) > 1)) {
    V total = 0;  // each group's sum, in lane order
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const V x = __shfl_sync(kFull, v, l);
      if ((peers >> l) & 1u) total += x;
    }
    v = total;
  }
  if (off >= 0 && lane == __ffs(peers) - 1) atomicAdd(out + off, v);
}

template <int Kind>
__device__ __forceinline__ Val<Kind> row_value(const void* weights, int64_t i, bool& keep) {
  if constexpr (Kind == kWeightMask) {
    keep = static_cast<const uint8_t*>(weights)[i] != 0;
    return 1;
  } else if constexpr (Kind == kWeightFloat) {
    keep = true;
    return static_cast<const float*>(weights)[i];
  } else {
    keep = true;
    return 1;
  }
}

// One block's share of one matrix: a grid-stride loop over 8-row steps of
// rows [head, head + 8 * steps), warp-uniform (every lane reaches the warp's
// collectives), then a scalar loop over the rows before `head` and after the
// last step; the block's diagonal counters live in `diag_s` (C values).
template <typename Idx, int Kind>
__device__ __forceinline__ void count_rows(const Idx* __restrict__ preds, const Idx* __restrict__ target,
                                           const void* __restrict__ weights, int64_t n, int64_t num_classes,
                                           int64_t head, Val<Kind>* __restrict__ out, Val<Kind>* diag_s) {
  using V = Val<Kind>;
  for (int64_t c = threadIdx.x; c < num_classes; c += kThreads) diag_s[c] = 0;
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int64_t steps = head < n ? (n - head) / kRows : 0;
  const int64_t warp0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = warp0; base < steps; base += stride) {
    const int64_t step = base + lane;
    const int64_t row0 = head + step * kRows;
    int key[kRows], diag[kRows];
    V val[kRows];
    if (step < steps) {
      Idx t[kRows], p[kRows];
      load_rows(target + row0, t);
      load_rows(preds + row0, p);
      bool keep[kRows];
      if constexpr (Kind == kWeightMask) {
        const unsigned long long m = __ldcs(reinterpret_cast<const unsigned long long*>(
            static_cast<const uint8_t*>(weights) + row0));
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          keep[j] = ((m >> (8 * j)) & 0xffu) != 0;
          val[j] = 1;
        }
      } else if constexpr (Kind == kWeightFloat) {
        const float4* w4 = reinterpret_cast<const float4*>(static_cast<const float*>(weights) + row0);
        const float4 lo = __ldcs(w4), hi = __ldcs(w4 + 1);
        const float w[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          keep[j] = true;
          val[j] = w[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          keep[j] = true;
          val[j] = 1;
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) cell_of(t[j], p[j], num_classes, keep[j], key[j], diag[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        key[j] = diag[j] = -1;
        val[j] = 0;
      }
    }
    // merge runs of one cell among the thread's rows; the last run goes to the warp
    int run_key = key[0], run_diag = diag[0];
    V run_val = val[0];
#pragma unroll
    for (int j = 1; j < kRows; ++j) {
      if (key[j] == run_key) {
        run_val += val[j];
      } else {
        add_direct(run_key, run_diag, run_val, diag_s, out);
        run_key = key[j];
        run_diag = diag[j];
        run_val = val[j];
      }
    }
    add_warp(run_key, run_diag, run_val, diag_s, out, lane);
  }

  const int64_t body_end = head + steps * kRows;
  const int64_t scalar_rows = (head < n ? head : n) + (n - (head < n ? body_end : n));
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < scalar_rows; i += stride) {
    const int64_t row = i < head ? i : body_end + (i - head);
    bool keep;
    const V v = row_value<Kind>(weights, row, keep);
    int key, diag;
    cell_of(target[row], preds[row], num_classes, keep, key, diag);
    add_direct(key, diag, v, diag_s, out);
  }

  __syncthreads();
  for (int64_t c = threadIdx.x; c < num_classes; c += kThreads) {
    if (diag_s[c] != 0) atomicAdd(out + c * (num_classes + 1), diag_s[c]);
  }
}

template <typename Idx, int Kind>
__global__ void __launch_bounds__(kThreads, 2)
    confmat_kernel(const Idx* __restrict__ preds, const Idx* __restrict__ target, const void* __restrict__ weights,
                   int64_t n, int64_t num_classes, int64_t head, Val<Kind>* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  count_rows<Idx, Kind>(preds, target, weights, n, num_classes, head, out, reinterpret_cast<Val<Kind>*>(smem));
}

// The first row at which a lane's labels (and weights) all sit on a 16-byte
// boundary (8 bytes for a bool mask), or n: vector_head() of the wrapper,
// taken per lane on the card, since each lane starts at its own address.
__device__ __forceinline__ int64_t lane_head(const void* preds, const void* target, const void* weights, int idx_bytes,
                                             int weight_bytes, int64_t n) {
  for (int h = 0; h < kRows; ++h) {
    bool ok = (reinterpret_cast<uintptr_t>(preds) + h * idx_bytes) % 16 == 0 &&
              (reinterpret_cast<uintptr_t>(target) + h * idx_bytes) % 16 == 0;
    if (weights != nullptr) {
      ok = ok && (reinterpret_cast<uintptr_t>(weights) + h * weight_bytes) % (weight_bytes == 1 ? 8 : 16) == 0;
    }
    if (ok) return h < n ? h : n;
  }
  return n;
}

// Lane-batched counts for a pool's micro-batch: lane `blockIdx.y` reads rows
// [lane * n, (lane + 1) * n) of the (lanes, n) labels and adds into matrix
// `lane` of the (lanes, C, C) output, at lane stride C * C. Each block counts
// one lane's diagonal in its own shared memory, as confmat_kernel does.
template <typename Idx, int Kind>
__global__ void __launch_bounds__(kThreads, 2)
    confmat_lanes_kernel(const Idx* __restrict__ preds, const Idx* __restrict__ target,
                         const void* __restrict__ weights, int64_t n, int64_t num_classes,
                         Val<Kind>* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int64_t lane = blockIdx.y;
  constexpr int weight_bytes = Kind == kWeightMask ? 1 : 4;
  const Idx* p = preds + lane * n;
  const Idx* t = target + lane * n;
  const void* w = weights == nullptr
                      ? nullptr
                      : static_cast<const void*>(static_cast<const uint8_t*>(weights) + lane * n * weight_bytes);
  const int64_t head = lane_head(p, t, w, sizeof(Idx), weight_bytes, n);
  count_rows<Idx, Kind>(p, t, w, n, num_classes, head, out + lane * num_classes * num_classes,
                        reinterpret_cast<Val<Kind>*>(smem));
}

template <typename Idx, int Kind>
cudaError_t launch(const void* preds, const void* target, const void* weights, int64_t n, int64_t num_classes,
                   int64_t head, void* out, int64_t blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(num_classes) * sizeof(Val<Kind>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(confmat_kernel<Idx, Kind>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  confmat_kernel<Idx, Kind><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const Idx*>(preds), static_cast<const Idx*>(target), weights, n, num_classes, head,
      static_cast<Val<Kind>*>(out));
  return cudaGetLastError();
}

template <typename Idx, int Kind>
cudaError_t launch_lanes(const void* preds, const void* target, const void* weights, int64_t lanes, int64_t n,
                         int64_t num_classes, void* out, int64_t blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(num_classes) * sizeof(Val<Kind>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(confmat_lanes_kernel<Idx, Kind>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(lanes));
  confmat_lanes_kernel<Idx, Kind><<<grid, kThreads, smem, stream>>>(
      static_cast<const Idx*>(preds), static_cast<const Idx*>(target), weights, n, num_classes,
      static_cast<Val<Kind>*>(out));
  return cudaGetLastError();
}

// The one-atomic-per-row design this kernel replaced: a grid-stride loop of
// one global atomic per valid row. Kept as the baseline that chip_smoke.py
// times the kernel against; nothing in the package calls it.
template <typename Idx, int Kind>
__global__ void __launch_bounds__(256) confmat_row_atomics_kernel(const Idx* __restrict__ preds,
                                                                  const Idx* __restrict__ target,
                                                                  const void* __restrict__ weights, int64_t n,
                                                                  int64_t num_classes, Val<Kind>* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    bool keep;
    const Val<Kind> v = row_value<Kind>(weights, i, keep);
    int key, diag;
    cell_of(target[i], preds[i], num_classes, keep, key, diag);
    if (key >= 0) atomicAdd(out + key, v);
  }
}

template <typename Idx, int Kind>
cudaError_t launch_row_atomics(const void* preds, const void* target, const void* weights, int64_t n,
                               int64_t num_classes, int64_t, void* out, int64_t blocks, cudaStream_t stream) {
  confmat_row_atomics_kernel<Idx, Kind><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const Idx*>(preds), static_cast<const Idx*>(target), weights, n, num_classes,
      static_cast<Val<Kind>*>(out));
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*, int64_t, int64_t, int64_t, void*, int64_t,
                                 cudaStream_t);

int dispatch(Launcher const (&table)[6], const void* preds, const void* target, const void* weights, int64_t n,
             int64_t num_classes, int idx_kind, int weight_kind, int64_t head, void* out, int64_t blocks,
             void* stream) {
  if (n <= 0) return cudaSuccess;
  if (blocks < 1 || blocks > 0x7fffffffLL || num_classes < 1 || num_classes > kMaxClasses || head < 0 ||
      idx_kind < 0 || idx_kind > 1 || weight_kind < 0 || weight_kind > 2 || (weights == nullptr) != (weight_kind == 0)) {
    return cudaErrorInvalidValue;
  }
  return table[idx_kind * 3 + weight_kind](preds, target, weights, n, num_classes, head, out, blocks,
                                           static_cast<cudaStream_t>(stream));
}

constexpr Launcher kKernel[6] = {
    launch<int32_t, kWeightNone>, launch<int32_t, kWeightMask>, launch<int32_t, kWeightFloat>,
    launch<int64_t, kWeightNone>, launch<int64_t, kWeightMask>, launch<int64_t, kWeightFloat>,
};
constexpr Launcher kRowAtomics[6] = {
    launch_row_atomics<int32_t, kWeightNone>, launch_row_atomics<int32_t, kWeightMask>,
    launch_row_atomics<int32_t, kWeightFloat>, launch_row_atomics<int64_t, kWeightNone>,
    launch_row_atomics<int64_t, kWeightMask>, launch_row_atomics<int64_t, kWeightFloat>,
};

}  // namespace

// idx_kind: 0 = int32 labels, 1 = int64 labels. weight_kind: see above.
// Adds the counts into `out`, C * C cells of the output type, which the
// caller holds (zeros for a fresh matrix). `head`: the rows before the first
// row at which every array sits on a 16-byte boundary (8 bytes for a mask),
// or n where there is none. Launches on `stream` and returns the launch's
// cudaError_t; it does not synchronise.
extern "C" int tm_confmat(const void* preds, const void* target, const void* weights, int64_t n,
                          int64_t num_classes, int idx_kind, int weight_kind, int64_t head, void* out,
                          int64_t blocks, void* stream) {
  return dispatch(kKernel, preds, target, weights, n, num_classes, idx_kind, weight_kind, head, out, blocks, stream);
}

// The replaced design (see confmat_row_atomics_kernel), same arguments; `head` is not read.
extern "C" int tm_confmat_row_atomics(const void* preds, const void* target, const void* weights, int64_t n,
                                      int64_t num_classes, int idx_kind, int weight_kind, int64_t head, void* out,
                                      int64_t blocks, void* stream) {
  return dispatch(kRowAtomics, preds, target, weights, n, num_classes, idx_kind, weight_kind, head, out, blocks,
                  stream);
}

using LanesLauncher = cudaError_t (*)(const void*, const void*, const void*, int64_t, int64_t, int64_t, void*, int64_t,
                                      cudaStream_t);

// Lane-batched counts: `lanes` (<= 65535) matrices of C * C cells in `out`,
// contiguous, one for each lane of the contiguous (lanes, n) labels and
// weights. Arguments otherwise as tm_confmat; each lane's head is found on
// the card.
extern "C" int tm_confmat_lanes(const void* preds, const void* target, const void* weights, int64_t lanes, int64_t n,
                                int64_t num_classes, int idx_kind, int weight_kind, void* out, int64_t blocks,
                                void* stream) {
  static constexpr LanesLauncher kLanes[6] = {
      launch_lanes<int32_t, kWeightNone>, launch_lanes<int32_t, kWeightMask>, launch_lanes<int32_t, kWeightFloat>,
      launch_lanes<int64_t, kWeightNone>, launch_lanes<int64_t, kWeightMask>, launch_lanes<int64_t, kWeightFloat>,
  };
  if (n <= 0 || lanes <= 0) return cudaSuccess;
  if (lanes > 65535 || blocks < 1 || blocks > 0x7fffffffLL || num_classes < 1 || num_classes > kMaxClasses ||
      idx_kind < 0 || idx_kind > 1 || weight_kind < 0 || weight_kind > 2 || (weights == nullptr) != (weight_kind == 0)) {
    return cudaErrorInvalidValue;
  }
  return kLanes[idx_kind * 3 + weight_kind](preds, target, weights, lanes, n, num_classes, out, blocks,
                                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
