// Banks of direct-form II transposed biquads on Hopper (sm_90a), float32: kernel S1.
//
// Channel c of a bank reads input row c / K and its own coefficients, those of
// index c % K (K channels a row), and runs S cascaded biquad sections over the
// row's T samples (S = 4: one cochlear channel of a gammatone filterbank,
// divided by its gain at the end; S = 1: one band of SRMR's modulation
// filterbank). Every section is the recurrence of
// torchmetrics_tpu/functional/audio/srmr.py::_biquad (its lax.scan step):
//     y  = b0 * x + z1
//     z1 = b1 * x - a1 * y + z2
//     z2 = b2 * x - a2 * y
// in that order of operations, each product and sum rounded once
// (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into an FMA),
// and the gain divided by an IEEE division (__fdiv_rn). So the kernel gives
// the bits of its plain PyTorch loop (_kernels/biquad.py::biquad_bank_plain),
// which does the same operations one at a time. Each sample goes through
// sections 1 to S in order: the same arithmetic as S passes over the signal.
//
// Replaces no Pallas kernel: the JAX package runs these recurrences as one
// compiled lax.scan each (srmr.py:130-154, scan at :153), four for the
// gammatone cascade and one for the modulation bands. Eager PyTorch has no
// IIR filter, and a loop over time would launch ~10 kernels a sample.
//
// Bound: the byte bound is small, 4 bytes read and 4 written a channel and
// sample, 8 * channels * T / 3.35 TB/s; so is the arithmetic (9 flops a
// section and sample). What bounds a call is the dependency chain: each
// sample waits on the previous one's state, T samples x S sections x ~4
// dependent operations (a1 * y, the subtraction, + z2, then the next
// sample's + z1) of ~4 cycles each; channels run in parallel, time does not.
// Design: one thread a channel, a warp a block of 32 channels, which walks the
// row in tiles of kChunk samples:
// - Loads: the warp's input rows (at most 32; 2 for 23 gammatone channels,
//   4 for 8 modulation bands) are copied tile by tile into shared memory with
//   cp.async, each row's kChunk samples by neighbouring lanes (coalesced),
//   and the next tile's copy is in flight while the chain runs on this one
//   (two buffers). Rows are padded to kChunk + 1 floats, so 32 lanes reading
//   32 rows at one time step hit 32 banks.
// - The chain: each lane keeps its 2 * S state registers and coefficients in
//   registers, reads its sample from shared memory and writes its output to
//   a shared tile (padded as well).
// - Stores: the warp writes the output tile row by row, kChunk consecutive
//   floats of one channel at a time, so each store is a coalesced run.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point tm_biquad_bank with ctypes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kChunk = 64;          // samples a tile
constexpr int kPitch = kChunk + 1;  // a padded shared-memory row
constexpr int kCoefs = 16;          // per coefficient index: b[s][0..2] at 3 s, a1 at 12, a2 at 13, gain at 14

template <int S>
__global__ void __launch_bounds__(kLanes) biquad_bank_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                             const float* __restrict__ coefs, int64_t channels,
                                                             int fanout, int64_t T) {
  __shared__ float in_s[2][kLanes][kPitch];
  __shared__ float out_s[kLanes][kPitch];
  const int lane = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int64_t c = c0 + lane;
  const bool active = c < channels;
  const int tile_channels = static_cast<int>(channels - c0 < kLanes ? channels - c0 : kLanes);
  const int64_t row0 = c0 / fanout;
  const int nrows = static_cast<int>((c0 + tile_channels - 1) / fanout - row0 + 1);
  const int my_row = active ? static_cast<int>(c / fanout - row0) : 0;

  float b[S][3];
  float a1 = 0.f, a2 = 0.f, gain = 1.f;
  float z1[S], z2[S];
  {
    const float* k = coefs + (active ? (c % fanout) : 0) * kCoefs;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      b[s][0] = k[3 * s];
      b[s][1] = k[3 * s + 1];
      b[s][2] = k[3 * s + 2];
      z1[s] = 0.f;
      z2[s] = 0.f;
    }
    a1 = k[12];
    a2 = k[13];
    gain = k[14];
  }

  auto issue = [&](int buf, int64_t t0) {
    for (int r = 0; r < nrows; ++r) {
      const float* src = x + (row0 + r) * T + t0;
      for (int j = lane; j < kChunk; j += kLanes) {
        if (t0 + j < T) __pipeline_memcpy_async(&in_s[buf][r][j], src + j, sizeof(float));
      }
    }
    __pipeline_commit();
  };

  issue(0, 0);
  int buf = 0;
  for (int64_t t0 = 0; t0 < T; t0 += kChunk, buf ^= 1) {
    if (t0 + kChunk < T) {
      issue(buf ^ 1, t0 + kChunk);  // the next tile's copy flies while this one is filtered
    } else {
      __pipeline_commit();  // an empty group keeps "all but the newest" meaning this tile
    }
    __pipeline_wait_prior(1);
    __syncwarp();
    const int n = static_cast<int>(T - t0 < kChunk ? T - t0 : kChunk);
    if (active) {
      const float* in_row = in_s[buf][my_row];
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float v = in_row[j];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float y = __fadd_rn(__fmul_rn(b[s][0], v), z1[s]);
          z1[s] = __fadd_rn(__fsub_rn(__fmul_rn(b[s][1], v), __fmul_rn(a1, y)), z2[s]);
          z2[s] = __fsub_rn(__fmul_rn(b[s][2], v), __fmul_rn(a2, y));
          v = y;
        }
        out_s[lane][j] = S == 4 ? __fdiv_rn(v, gain) : v;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int ch = 0; ch < tile_channels; ++ch) {
      float* dst = out + (c0 + ch) * T + t0;
#pragma unroll
      for (int q = 0; q < kChunk / kLanes; ++q) {
        const int j = q * kLanes + lane;
        if (j < n) dst[j] = out_s[ch][j];
      }
    }
    __syncwarp();  // every lane has read this tile's buffers before the next copy lands in them
  }
}

}  // namespace

// x: (rows, T) float32, contiguous; out: (rows * fanout, T) float32, channel
// c = row * fanout + k filtered with coefs[k] (fanout rows of 16 floats:
// b[s][0..2] at 3 s, a1 at 12, a2 at 13, gain at 14; a0 is 1). sections is
// 4 (a gammatone cascade, divided by the gain) or 1 (one biquad). Launches
// on `stream` and returns the launch's cudaError_t.
extern "C" int tm_biquad_bank(const void* x, void* out, const void* coefs, int64_t rows, int fanout, int64_t T,
                              int sections, void* stream) {
  if (rows < 0 || fanout < 1 || T < 0 || (sections != 1 && sections != 4)) return cudaErrorInvalidValue;
  const int64_t channels = rows * fanout;
  if (channels == 0 || T == 0) return cudaSuccess;
  const int64_t blocks = (channels + kLanes - 1) / kLanes;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const float* kf = static_cast<const float*>(coefs);
  if (sections == 4) {
    biquad_bank_kernel<4><<<static_cast<unsigned>(blocks), kLanes, 0, s>>>(xf, of, kf, channels, fanout, T);
  } else {
    biquad_bank_kernel<1><<<static_cast<unsigned>(blocks), kLanes, 0, s>>>(xf, of, kf, channels, fanout, T);
  }
  return cudaGetLastError();
}

extern "C" const char* tm_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
