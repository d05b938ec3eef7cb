// Confusion-matrix counts on Hopper (sm_90a).
//
// Replaces the TPU kernel
// torchmetrics_tpu/functional/classification/_pallas_confmat.py::confusion_matrix_pallas
// (body _confmat_kernel). That kernel keeps a resident (C_pad, C_pad) f32
// accumulator in VMEM across a sequential grid and adds one-hot outer
// products per 512-row tile. On Hopper the accumulator (4 MB at C=1000) does
// not fit in a block's 227 KB of shared memory, and blocks run in parallel in
// no order, so the design here is a histogram instead: a grid-stride loop
// reads (target[i], preds[i], weight[i]) and adds one atomic into the (C, C)
// matrix, which stays resident in the 50 MB L2. Like the TPU kernel, no
// (N, C) one-hot ever reaches device memory.
//
// Bound: device-memory bytes. The function reads N * (2 * index_bytes + weight_bytes)
// and writes C * C * 4; it does no arithmetic worth counting.
//
// Rows are target labels, columns predicted labels. A row whose target or
// prediction lies outside [0, C) is skipped, as the one-hot product drops it.
// The ragged tail is masked by i < n; nothing is padded.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point tm_confmat with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// weight kinds: none (count 1, int32 out), a bool mask (count 1 where set,
// int32 out), float32 weights (float32 sums out)
constexpr int kWeightNone = 0;
constexpr int kWeightMask = 1;
constexpr int kWeightFloat = 2;

template <typename Idx, int Kind>
__global__ void __launch_bounds__(kThreads) confmat_kernel(const Idx* __restrict__ preds,
                                                           const Idx* __restrict__ target,
                                                           const void* __restrict__ weights, int64_t n,
                                                           int64_t num_classes, void* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    if constexpr (Kind == kWeightMask) {
      if (!static_cast<const uint8_t*>(weights)[i]) continue;
    }
    const int64_t t = static_cast<int64_t>(target[i]);
    const int64_t p = static_cast<int64_t>(preds[i]);
    if (t < 0 || t >= num_classes || p < 0 || p >= num_classes) continue;
    const int64_t cell = t * num_classes + p;
    if constexpr (Kind == kWeightFloat) {
      atomicAdd(static_cast<float*>(out) + cell, static_cast<const float*>(weights)[i]);
    } else {
      atomicAdd(static_cast<int*>(out) + cell, 1);
    }
  }
}

template <typename Idx, int Kind>
cudaError_t launch(const void* preds, const void* target, const void* weights, int64_t n, int64_t num_classes,
                   void* out, int64_t max_blocks, cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  confmat_kernel<Idx, Kind><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Idx*>(preds), static_cast<const Idx*>(target), weights, n, num_classes, out);
  return cudaGetLastError();
}

}  // namespace

// idx_kind: 0 = int32 labels, 1 = int64 labels. weight_kind: see above.
// `out` must hold C * C zeros of the output type. Launches on `stream` and
// returns the launch's cudaError_t; it does not synchronise.
extern "C" int tm_confmat(const void* preds, const void* target, const void* weights, int64_t n,
                          int64_t num_classes, int idx_kind, int weight_kind, void* out, int64_t max_blocks,
                          void* stream) {
  if (n <= 0) return cudaSuccess;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (idx_kind * 3 + weight_kind) {
    case 0: return launch<int32_t, kWeightNone>(preds, target, weights, n, num_classes, out, max_blocks, s);
    case 1: return launch<int32_t, kWeightMask>(preds, target, weights, n, num_classes, out, max_blocks, s);
    case 2: return launch<int32_t, kWeightFloat>(preds, target, weights, n, num_classes, out, max_blocks, s);
    case 3: return launch<int64_t, kWeightNone>(preds, target, weights, n, num_classes, out, max_blocks, s);
    case 4: return launch<int64_t, kWeightMask>(preds, target, weights, n, num_classes, out, max_blocks, s);
    case 5: return launch<int64_t, kWeightFloat>(preds, target, weights, n, num_classes, out, max_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
