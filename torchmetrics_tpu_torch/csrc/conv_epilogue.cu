// Conv epilogue kernels on Hopper (sm_90a): a pointwise conv as a GEMM with
// bias + ReLU in its epilogue (B2a), and bias + ReLU after a library conv (B2b).
//
// Replaces the TPU kernels of torchmetrics_tpu/_kernels/conv_epilogue.py:
//   B2a _pallas_matmul_bias_relu (body _mm_bias_relu_kernel): relu(X W + b),
//       X (M, K) = the (N*H*W, Cin) view of a channels_last activation,
//       W the 1x1 conv weight, f32 accumulation, one rounding to the output type;
//   B2b _pallas_bias_relu (body _bias_relu_kernel): relu(Y + b) over the
//       (N*H*W, Cout) view of a spatial conv's channels_last output.
// The TPU kernels pad every operand to (128, 128) tiles in device memory first;
// here the tiles are loaded with bounds checks, so tails in M, K and N cost
// nothing beyond the masked lanes, and no padded copy is ever written.
//
// Bound: device-memory bytes on the FID path. The GEMMs' arithmetic intensity
// is K*N/(K+N) flop/byte in bf16 (48 at K=192, N=64), far under the H100's
// ridge of ~295 (989 TFLOP/s over 3.35 TB/s), so what matters is that the
// activation is read once and the output written once: the epilogue adds the
// bias and applies ReLU to the accumulator before the single store, where an
// unfused graph would write the product, read it back for the bias, and again
// for the ReLU. B2b is one read and one write of the conv output, in place.
//
// Design, B2a:
//   bf16: block tile 128 x 64, K step 32, 8 warps each holding a 32 x 32
//         accumulator as 2 x 2 nvcuda::wmma 16x16x16 fragments in f32. Tiles go
//         through shared memory two stages deep, by 16-byte cp.async copies
//         when K and N are multiples of 8 (every FID shape), so the next K tile
//         streams in while the tensor cores work on this one; element loads for
//         any other shape. The epilogue stages the f32 accumulators in shared
//         memory (aliasing the operand tiles), then adds the bias, applies ReLU
//         and rounds once to bf16, stored 16 bytes at a time.
//   f32:  block tile 64 x 64, K step 16, 256 threads each holding a 4 x 4
//         register tile, plain FMA in f32 (no TF32), so a float32 trunk stays
//         true float32, the counterpart of precision="highest" on the TPU.
// Neither is at its bound yet (no wgmma, TMA or persistent schedule); that is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry points below with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ B2a, bf16

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kMmaThreads = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int kLdAB = kBK + 8;    // bf16 row pitch of the operand tiles: 80 bytes
constexpr int kLdC = kBN + 4;     // f32 row pitch of the staged accumulators

// shared memory: two stages of the operand tiles, aliased by the staged f32
// accumulators after the K loop.
//   a[m * kLdAB + k] = X(m0 + m, k0 + k); b[n * kLdAB + k] = W(n0 + n, k0 + k), B col-major
constexpr int kStageElems = (kBM + kBN) * kLdAB;
constexpr int kSmemAB = 2 * kStageElems * static_cast<int>(sizeof(bf16));
constexpr int kSmemC = kBM * kLdC * static_cast<int>(sizeof(float));
constexpr int kSmemBytes = kSmemAB > kSmemC ? kSmemAB : kSmemC;
static_assert(kSmemBytes <= 48 * 1024, "static shared memory");
static_assert((kBM * kLdAB * sizeof(bf16)) % 32 == 0 && (kStageElems * sizeof(bf16)) % 32 == 0,
              "wmma needs 32-byte aligned fragments");

// 16-byte asynchronous copy global -> shared; when `pred` is false nothing is
// read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// one operand tile (tile_rows x kBK) of src (rows x K, row-major) into dst
template <bool Vec>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src, int64_t rows, int64_t row0,
                                               int tile_rows, int64_t K, int64_t k0) {
  if constexpr (Vec) {
    // 8 bf16 (16 bytes) per chunk, 4 chunks per 32-wide tile row; K % 8 == 0,
    // so a chunk is wholly inside or wholly outside [0, K)
    for (int q = threadIdx.x; q < tile_rows * (kBK / 8); q += kMmaThreads) {
      const int r = q / (kBK / 8);
      const int kc = (q % (kBK / 8)) * 8;
      const int64_t gr = row0 + r;
      const int64_t gk = k0 + kc;
      const bool inside = gr < rows && gk < K;
      cp_async16(dst + r * kLdAB + kc, inside ? src + gr * K + gk : src, inside);
    }
  } else {
    for (int e = threadIdx.x; e < tile_rows * kBK; e += kMmaThreads) {
      const int r = e / kBK;
      const int kk = e % kBK;
      const int64_t gr = row0 + r;
      const int64_t gk = k0 + kk;
      dst[r * kLdAB + kk] = (gr < rows && gk < K) ? src[gr * K + gk] : __float2bfloat16(0.0f);
    }
  }
}

// Vec: K % 8 == 0, N % 8 == 0 and x, w, out 16-byte aligned: 16-byte
// asynchronous tile loads, two stages deep (the next K tile streams in while
// the tensor cores work on this one), and 16-byte stores. Otherwise element
// loads and stores, for any shape.
template <bool Vec>
__global__ void __launch_bounds__(kMmaThreads)
    mm_bias_relu_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, int64_t M, int64_t K, int64_t N, int64_t tiles_n) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* sc = reinterpret_cast<float*>(smem);
  const int64_t m0 = (static_cast<int64_t>(blockIdx.x) / tiles_n) * kBM;
  const int64_t n0 = (static_cast<int64_t>(blockIdx.x) % tiles_n) * kBN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;  // warp's row offset in the block tile
  const int wn = (warp % 2) * 32;  // warp's column offset

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int64_t k_tiles = (K + kBK - 1) / kBK;
  auto load_stage = [&](int64_t kt) {
    bf16* sa = stages + (kt % 2) * kStageElems;
    load_tile_bf16<Vec>(sa, x, M, m0, kBM, K, kt * kBK);
    load_tile_bf16<Vec>(sa + kBM * kLdAB, w, N, n0, kBN, K, kt * kBK);
    if constexpr (Vec) cp_async_commit();
  };
  load_stage(0);
  for (int64_t kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_stage(kt + 1);  // the other stage: its last readers passed the barrier that closed iteration kt - 1
      if constexpr (Vec) cp_async_wait<1>();
    } else {
      if constexpr (Vec) cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sa = stages + (kt % 2) * kStageElems;
    const bf16* sb = sa + kBM * kLdAB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], sa + (wm + 16 * i) * kLdAB + kk, kLdAB);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sb + (wn + 16 * j) * kLdAB + kk, kLdAB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next load into this stage, or the staged accumulators, may now overwrite it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wm + 16 * i) * kLdC + wn + 16 * j, acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: + bias, ReLU, one rounding to bf16; 8 neighbouring columns per
  // thread, neighbouring threads on neighbouring column groups of one row
  for (int e = threadIdx.x; e < kBM * (kBN / 8); e += kMmaThreads) {
    const int r = e / (kBN / 8);
    const int c = (e % (kBN / 8)) * 8;
    const int64_t gm = m0 + r;
    const int64_t gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    if constexpr (Vec) {
      uint4 packed;
      bf16* vals = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const float v = sc[r * kLdC + c + l] + __bfloat162float(bias[gn + l]);
        vals[l] = __float2bfloat16(fmaxf(v, 0.0f));
      }
      *reinterpret_cast<uint4*>(out + gm * N + gn) = packed;
    } else {
      for (int l = 0; l < 8 && gn + l < N; ++l) {
        const float v = sc[r * kLdC + c + l] + __bfloat162float(bias[gn + l]);
        out[gm * N + gn + l] = __float2bfloat16(fmaxf(v, 0.0f));
      }
    }
  }
}

// ------------------------------------------------------------- B2a, f32

constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
static_assert(kFBM == kFBN, "one loop loads both tiles");

__global__ void __launch_bounds__(kFThreads)
    mm_bias_relu_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                     float* __restrict__ out, int64_t M, int64_t K, int64_t N, int64_t tiles_n) {
  __shared__ float as[kFBK][kFBM + 4];  // as[k][m] = X(m0 + m, k0 + k)
  __shared__ float bs[kFBK][kFBN + 4];  // bs[k][n] = W(n0 + n, k0 + k)
  const int64_t m0 = (static_cast<int64_t>(blockIdx.x) / tiles_n) * kFBM;
  const int64_t n0 = (static_cast<int64_t>(blockIdx.x) % tiles_n) * kFBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < K; k0 += kFBK) {
    // 16 consecutive k of one row per 16 threads: 64-byte runs from each row
    for (int e = threadIdx.x; e < kFBM * kFBK; e += kFThreads) {
      const int r = e / kFBK;
      const int kk = e % kFBK;
      const int64_t gk = k0 + kk;
      const int64_t gm = m0 + r;
      const int64_t gn = n0 + r;
      as[kk][r] = (gm < M && gk < K) ? x[gm * K + gk] : 0.0f;
      bs[kk][r] = (gn < N && gk < K) ? w[gn * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t gn = n0 + tx + 16 * j;
      if (gn < N) out[gm * N + gn] = fmaxf(acc[i][j] + bias[gn], 0.0f);
    }
  }
}

// ------------------------------------------------------------------ B2b

constexpr int kEwThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// relu(y + b) in place, computed in f32 and rounded once. Vec: C is a multiple
// of the 16-byte vector width, so each vector lies within one row and its
// channels are consecutive.
template <typename T, bool Vec>
__global__ void __launch_bounds__(kEwThreads)
    bias_relu_inplace(T* __restrict__ y, const T* __restrict__ bias, int64_t total, int64_t C) {
  constexpr int kWidth = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (Vec) {
    for (int64_t v = start; v < total / kWidth; v += stride) {
      const int64_t e = v * kWidth;
      const int64_t c = e % C;
      uint4 packed = reinterpret_cast<const uint4*>(y)[v];
      T* vals = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int l = 0; l < kWidth; ++l) vals[l] = from_f32<T>(fmaxf(to_f32(vals[l]) + to_f32(bias[c + l]), 0.0f));
      reinterpret_cast<uint4*>(y)[v] = packed;
    }
  } else {
    for (int64_t e = start; e < total; e += stride) {
      y[e] = from_f32<T>(fmaxf(to_f32(y[e]) + to_f32(bias[e % C]), 0.0f));
    }
  }
}

template <typename T>
cudaError_t launch_bias_relu(void* y, const void* bias, int64_t rows, int64_t C, int vec, int64_t max_blocks,
                             cudaStream_t stream) {
  const int64_t total = rows * C;
  const int64_t items = vec ? total / (16 / sizeof(T)) : total;
  int64_t blocks = (items + kEwThreads - 1) / kEwThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (vec) {
    bias_relu_inplace<T, true><<<static_cast<unsigned>(blocks), kEwThreads, 0, stream>>>(
        static_cast<T*>(y), static_cast<const T*>(bias), total, C);
  } else {
    bias_relu_inplace<T, false><<<static_cast<unsigned>(blocks), kEwThreads, 0, stream>>>(
        static_cast<T*>(y), static_cast<const T*>(bias), total, C);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, w, bias and out alike.
// x (M, K) and w (N, K) row-major, bias (N,), out (M, N) row-major; all
// contiguous. vec (bf16 only): K % 8 == 0, N % 8 == 0 and x, w, out 16-byte aligned.
// Launches on `stream` and returns the launch's cudaError_t; no synchronise.
extern "C" int tm_mm_bias_relu(const void* x, const void* w, const void* bias, void* out, int64_t M, int64_t K,
                               int64_t N, int dtype, int vec, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int64_t tiles_n = (N + kBN - 1) / kBN;
    const int64_t blocks = ((M + kBM - 1) / kBM) * tiles_n;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const auto* xb = static_cast<const bf16*>(x);
    const auto* wb = static_cast<const bf16*>(w);
    const auto* bb = static_cast<const bf16*>(bias);
    auto* ob = static_cast<bf16*>(out);
    if (vec) {
      mm_bias_relu_bf16<true><<<static_cast<unsigned>(blocks), kMmaThreads, 0, s>>>(xb, wb, bb, ob, M, K, N, tiles_n);
    } else {
      mm_bias_relu_bf16<false><<<static_cast<unsigned>(blocks), kMmaThreads, 0, s>>>(xb, wb, bb, ob, M, K, N, tiles_n);
    }
    return cudaGetLastError();
  }
  if (dtype == 0) {
    const int64_t tiles_n = (N + kFBN - 1) / kFBN;
    const int64_t blocks = ((M + kFBM - 1) / kFBM) * tiles_n;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    mm_bias_relu_f32<<<static_cast<unsigned>(blocks), kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(out), M, K, N, tiles_n);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// y (rows, C) row-major, overwritten with relu(y + bias); bias (C,).
// vec: C is a multiple of 16 / sizeof(element) and y is 16-byte aligned.
extern "C" int tm_bias_relu(void* y, const void* bias, int64_t rows, int64_t C, int dtype, int vec,
                            int64_t max_blocks, void* stream) {
  if (rows <= 0 || C <= 0) return cudaSuccess;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bias_relu<float>(y, bias, rows, C, vec, max_blocks, s);
  if (dtype == 1) return launch_bias_relu<bf16>(y, bias, rows, C, vec, max_blocks, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* tm_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
