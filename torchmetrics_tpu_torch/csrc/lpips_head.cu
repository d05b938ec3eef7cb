// LPIPS head on Hopper (sm_90a): per batch row,
//   mean over pixels of  sum_c w_c * (f0_c / (||f0|| + 1e-10) - f1_c / (||f1|| + 1e-10))^2
// for two float32 feature maps laid out (B, H*W, C), channels innermost.
//
// Replaces the TPU kernel torchmetrics_tpu/_kernels/lpips_head.py::_pallas_lpips_head
// (body _head_kernel). That kernel pads C to 128 lanes and H*W to 256-row
// tiles in device memory and walks the pixel tiles of a row as a sequential
// grid axis, carrying the row's sum in its output block. On Hopper blocks run
// in parallel in no order, so a block takes a slice of one row's pixels and
// adds its partial sum to out[b] with one atomicAdd; nothing is padded.
//
// Bound: device-memory bytes, 2 * B * H * W * C * 4 read, B * 4 written; the
// arithmetic (about 8 flops per element) is far under the ridge. As on the
// TPU, neither the normalised maps, their difference nor the 1x1 conv output
// is ever written: each pixel is reduced to its scalar in registers.
//
// Design: one warp per pixel. A lane strides over the channels (coalesced:
// neighbouring lanes read neighbouring channels), the two squared norms are
// summed across the warp with shuffles, then the lane reads its channels again
// (from L1, the pixel's 2 * C * 4 bytes were just loaded) and accumulates
// w_c * d_c^2 with the exact x / (||x|| + eps) normalisation, not an rsqrt.
// The per-lane sums are reduced over the block in shared memory.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point tm_lpips_head with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-10f;  // image/_lpips.py _normalize_tensor

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// grid (blocks_per_row, B); block x of row b takes pixels
// [x * pixels_per_block, (x + 1) * pixels_per_block) of that row
__global__ void __launch_bounds__(kThreads)
    lpips_head_kernel(const float* __restrict__ f0, const float* __restrict__ f1, const float* __restrict__ w,
                      int64_t hw, int64_t C, int64_t pixels_per_block, float* __restrict__ out) {
  __shared__ float partial[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t row = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * pixels_per_block;
  const int64_t p1 = p0 + pixels_per_block < hw ? p0 + pixels_per_block : hw;

  float acc = 0.0f;
  for (int64_t p = p0 + warp; p < p1; p += kWarps) {
    const float* a = f0 + (row * hw + p) * C;
    const float* b = f1 + (row * hw + p) * C;
    float sa = 0.0f, sb = 0.0f;
    for (int64_t c = lane; c < C; c += 32) {
      const float va = a[c];
      const float vb = b[c];
      sa = fmaf(va, va, sa);
      sb = fmaf(vb, vb, sb);
    }
    const float na = sqrtf(warp_sum(sa)) + kEps;
    const float nb = sqrtf(warp_sum(sb)) + kEps;
    for (int64_t c = lane; c < C; c += 32) {
      const float d = a[c] / na - b[c] / nb;
      acc = fmaf(d * d, w[c], acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float total = lane < kWarps ? partial[lane] : 0.0f;
    total = warp_sum(total);
    if (lane == 0) atomicAdd(out + row, total);
  }
}

}  // namespace

// f0, f1: (B, hw, C) float32, contiguous; w: (C,) float32; out: (B,) float32,
// zeroed by the caller, receives the per-row SUM over pixels (the caller
// divides by hw). Launches on `stream` and returns the launch's cudaError_t.
extern "C" int tm_lpips_head(const void* f0, const void* f1, const void* w, void* out, int64_t B, int64_t hw,
                             int64_t C, int64_t pixels_per_block, void* stream) {
  if (B <= 0 || hw <= 0) return cudaSuccess;
  if (C <= 0 || pixels_per_block <= 0 || B > 65535) return cudaErrorInvalidValue;
  const int64_t blocks_per_row = (hw + pixels_per_block - 1) / pixels_per_block;
  if (blocks_per_row > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks_per_row), static_cast<unsigned>(B));
  lpips_head_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f0), static_cast<const float*>(f1), static_cast<const float*>(w), hw, C,
      pixels_per_block, static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" const char* tm_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
