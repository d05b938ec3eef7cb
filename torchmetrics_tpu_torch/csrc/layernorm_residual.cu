// LayerNorm of a residual sum on Hopper (sm_90a): per row of C features,
//   y = x + h,  out = (y - mean(y)) * rsqrt(mean(y^2) - mean(y)^2 + eps) * scale + bias
// in float32, whatever the (float32 or bfloat16) types of x and h.
//
// Replaces the TPU kernel torchmetrics_tpu/_kernels/attention.py::_pallas_layernorm_residual
// (body _ln_kernel). That kernel pads the rows to 256-row tiles in device memory
// and takes the Pallas path only for C a multiple of 128. Here nothing is padded,
// every C is taken, and one warp owns one row: its lanes read neighbouring
// columns (coalesced), keep y = x + h in registers for C <= 1024 (C = 768 in
// BERT-base: 24 values a lane), reduce the sum and the sum of squares with
// shuffles, and write the row once. For C > 1024 the row is read twice (the
// second read comes from cache).
//
// Bound: device-memory bytes. x and h are read once and the float32 output
// written once, about 9 flops per element: far under the ridge. The variance is
// the TPU kernel's fast variance mean(y^2) - mean(y)^2, neither Welford nor
// clamped at 0, and rsqrt(var + eps) as _ln_kernel has it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point tm_layernorm_residual with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// the row's x and h may differ in type (a float32 LayerNorm output plus a bf16 Dense output)
__device__ __forceinline__ float load(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// VPL > 0: lane holds columns lane + 32 i, i < VPL, in registers; VPL == 0: any C, x and h read twice
template <int VPL>
__global__ void __launch_bounds__(kThreads)
    layernorm_residual_kernel(const void* __restrict__ x, const void* __restrict__ h,
                              const float* __restrict__ scale, const float* __restrict__ bias,
                              float* __restrict__ out, int64_t rows, int C, bool x_bf16, bool h_bf16, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: one row per warp
  const int64_t base = row * C;
  float sum = 0.0f, sq = 0.0f;
  float y[VPL > 0 ? VPL : 1];
  if constexpr (VPL > 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      y[i] = c < C ? load(x, base + c, x_bf16) + load(h, base + c, h_bf16) : 0.0f;
      sum += y[i];
      sq = fmaf(y[i], y[i], sq);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float yc = load(x, base + c, x_bf16) + load(h, base + c, h_bf16);
      sum += yc;
      sq = fmaf(yc, yc, sq);
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / C;
  const float var = sq / C - mu * mu;  // fast variance, as _ln_kernel: no clamp
  const float inv = rsqrtf(var + eps);
  if constexpr (VPL > 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) out[base + c] = (y[i] - mu) * inv * scale[c] + bias[c];
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float yc = load(x, base + c, x_bf16) + load(h, base + c, h_bf16);
      out[base + c] = (yc - mu) * inv * scale[c] + bias[c];
    }
  }
}

template <int VPL>
cudaError_t launch(const void* x, const void* h, const float* scale, const float* bias, float* out, int64_t rows,
                   int C, bool x_bf16, bool h_bf16, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  layernorm_residual_kernel<VPL><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, h, scale, bias, out, rows, C, x_bf16, h_bf16, eps);
  return cudaGetLastError();
}

}  // namespace

// x, h: (rows, C) contiguous, each float32 (0) or bfloat16 (1) as x_dtype and
// h_dtype say; scale, bias: (C,) float32; out: (rows, C) float32, contiguous.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int tm_layernorm_residual(const void* x, const void* h, const void* scale, const void* bias, void* out,
                                     int64_t rows, int64_t C, int x_dtype, int h_dtype, float eps, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (C <= 0 || C > 0x7fffffffLL || (x_dtype != 0 && x_dtype != 1) || (h_dtype != 0 && h_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(scale);
  const auto bi = static_cast<const float*>(bias);
  const auto o = static_cast<float*>(out);
  const int c = static_cast<int>(C);
  const bool xb = x_dtype == 1, hb = h_dtype == 1;
  if (c <= 128) return launch<4>(x, h, sc, bi, o, rows, c, xb, hb, eps, s);
  if (c <= 256) return launch<8>(x, h, sc, bi, o, rows, c, xb, hb, eps, s);
  if (c <= 512) return launch<16>(x, h, sc, bi, o, rows, c, xb, hb, eps, s);
  if (c <= 768) return launch<24>(x, h, sc, bi, o, rows, c, xb, hb, eps, s);
  if (c <= 1024) return launch<32>(x, h, sc, bi, o, rows, c, xb, hb, eps, s);
  return launch<0>(x, h, sc, bi, o, rows, c, xb, hb, eps, s);
}

extern "C" const char* tm_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
