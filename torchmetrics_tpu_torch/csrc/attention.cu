// Masked self-attention of a BERT layer on Hopper (sm_90a): per (batch, head),
//   out = softmax(Q K^T / sqrt(d) + (1 - mask) * (-1e9)) V
// over (B, L, hidden) tensors in which head h owns the columns [h*d, (h+1)*d).
//
// Replaces the TPU kernel torchmetrics_tpu/_kernels/attention.py::_pallas_attention
// (body _attn_kernel). That kernel splits the heads with a transpose, pads L and d
// to 128 lanes in device memory, and holds one (batch, head)'s whole (Lp, Lp)
// score tile in VMEM. Here each head's columns are read in place through the row
// stride, nothing is padded or transposed in device memory, and the scores never
// reach it: a block of 128 threads owns 64 query rows of one (batch, head) and
// walks the keys in tiles of 32 staged through shared memory with an online
// softmax (running max, running sum, float32 accumulator), normalising once at
// the end (flash-style).
//
// Bound: at BERT-base's shapes (L = 128, d = 64) the work is 4 L^2 d flops per
// (batch, head) against 4 L d values moved, about 32 flops per byte in float32,
// above the ridge of float32 outside the tensor cores (67 TFLOP/s over 3.35 TB/s,
// 20 flops per byte): the FMA rate bounds it. The products are float32 FMAs, as
// the JAX oracle asks for precision "highest" (no TF32); bf16 inputs convert to
// float32 on load. To keep the FMA pipes, not shared memory, the limit, the
// tiles are register-blocked: thread (ty, tx) computes the 4 x 4 scores of rows
// 4ty.. and keys 4tx.. from two float4 loads per head dimension (8 FMAs a load),
// and the 4 x (d / 8) outputs of the same rows from one float4 of P and d / 32
// float4s of V per key; tiles are staged with 16-byte (float32) or 8-byte (bf16)
// loads, so d, the strides and the pointers must be multiples of 4 elements (the
// wrapper refuses other views). A row's softmax statistics are reduced over the 8
// threads that share it with shuffles. Tensor cores (mma.sync / wgmma) and TMA
// are later work.
//
// The mask is the oracle's additive (1 - m) * -1e9 in float32, added to the
// scaled score before the max and never skipped: a row whose keys are all masked
// gets the mean of V over the L keys, as _xla_attention gives.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point tm_attention with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;  // query rows per block: thread (ty = tid / 8) owns rows 4ty .. 4ty + 3
constexpr int kKeys = 32;  // keys per tile: thread (tx = tid % 8) owns keys 4tx .. 4tx + 3 of each tile
constexpr float kMaskBias = -1e9f;

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
// four consecutive elements in one 16-byte (float32) or 8-byte (bf16) load; p aligned to that size
__device__ __forceinline__ float4 load4_f32(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct View {  // element strides of a (B, L, hidden) tensor whose last dimension is contiguous
  int64_t batch, row;
};

template <int D>
constexpr int smem_floats() {  // q (D x kRows), k (D x kKeys), both dimension-major; v (kKeys x D); p (kKeys x kRows)
  return D * kRows + D * kKeys + kKeys * D + kKeys * kRows;
}

// Stage rows [r0, r0 + n) (n <= R) of one head's (rows, d) slice, stride `stride`, into
// dst[c * R + r] (dimension-major), zero past n and d, four dimensions a load;
// consecutive threads take consecutive rows of one group of dimensions, so the
// transposed shared-memory stores are conflict-free and the rows' other
// dimensions come from L1.
template <typename T, int D, int R>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src, int64_t stride, int r0, int n, int d) {
  for (int i = threadIdx.x; i < (D / 4) * R; i += kThreads) {
    const int c = 4 * (i / R), r = i % R;
    const float4 x = (r < n && c < d) ? load4_f32(src + static_cast<int64_t>(r0 + r) * stride + c)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[c * R + r] = x.x;
    dst[(c + 1) * R + r] = x.y;
    dst[(c + 2) * R + r] = x.z;
    dst[(c + 3) * R + r] = x.w;
  }
}

// grid: B * heads * q_tiles blocks, block x -> (query tile, head, batch); D: d padded to 32, 64 or 128.
// Thread (ty, tx) also owns output columns 32 g + 4 tx .. + 3, g < D / 32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, T* __restrict__ out, int L, int heads, int d, int q_tiles,
                     View qv, View kv, View vv, View ov, float inv_sqrt_d) {
  constexpr int G = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [D][kRows]
  float* ks = qs + D * kRows;     // [D][kKeys]
  float* vs = ks + D * kKeys;     // [kKeys][D]
  float* ps = vs + kKeys * D;     // [kKeys][kRows]
  __shared__ float bias[kKeys];

  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int tile = blockIdx.x % q_tiles;
  const int h = (blockIdx.x / q_tiles) % heads;
  const int64_t b = blockIdx.x / (static_cast<int64_t>(q_tiles) * heads);
  const int row0 = tile * kRows;
  const int64_t col0 = static_cast<int64_t>(h) * d;
  const T* q_base = q + b * qv.batch + col0;
  const T* k_base = k + b * kv.batch + col0;
  const T* v_base = v + b * vv.batch + col0;
  const float* mask_row = mask + b * L;

  stage_transposed<T, D, kRows>(qs, q_base, qv.row, row0, min(kRows, L - row0), d);

  float o[4][4 * G], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) o[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    const int nk = min(kKeys, L - k0);
    __syncthreads();  // the previous tile's k, v, p are consumed (and q is in place)
    stage_transposed<T, D, kKeys>(ks, k_base, kv.row, k0, nk, d);
    for (int i = tid; i < kKeys * (D / 4); i += kThreads) {  // key-major, 4 dimensions a load: coalesced along the row
      const int j = i / (D / 4), c = 4 * (i % (D / 4));
      *reinterpret_cast<float4*>(vs + j * D + c) =
          (j < nk && c < d) ? load4_f32(v_base + static_cast<int64_t>(k0 + j) * vv.row + c)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (tid < kKeys) bias[tid] = tid < nk ? (1.0f - mask_row[k0 + tid]) * kMaskBias : 0.0f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + c * kRows + 4 * ty);
      const float4 kb = *reinterpret_cast<const float4*>(ks + c * kKeys + 4 * tx);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kr[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float row_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = 4 * tx + j;
        s[i][j] = key < nk ? s[i][j] * inv_sqrt_d + bias[key] : -CUDART_INF_F;  // keys past L take no mass
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float correction = expf(m[i] - m_new);  // 0 on the first tile, where m is -inf
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * correction + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) o[i][c] *= correction;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(ps + (4 * tx + j) * kRows + 4 * ty) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + j * kRows + 4 * ty);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(vs + j * D + 32 * g + 4 * tx);
        const float vr[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][4 * g + c] = fmaf(pr[i], vr[c], o[i][4 * g + c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= L) continue;
    T* o_row = out + b * ov.batch + static_cast<int64_t>(row) * ov.row + col0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 32 * g + 4 * tx + c;
        if (col < d) store_f32(o_row + col, o[i][4 * g + c] / l[i]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask, void* out, int64_t B, int L,
                   int heads, int d, View qv, View kv, View vv, View ov, cudaStream_t stream) {
  const int q_tiles = (L + kRows - 1) / kRows;
  const int64_t blocks = B * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // 1 / sqrt(d) is exact where sqrt(d) is a power of two (d = 16, 64, 256: the oracle's
  // division, bit for bit); elsewhere the product is within one rounding of it
  attention_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, static_cast<T*>(out), L,
      heads, d, q_tiles, qv, kv, vv, ov, 1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_head_dim(const void* q, const void* k, const void* v, const float* mask, void* out, int64_t B,
                                int L, int heads, int d, View qv, View kv, View vv, View ov, cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, mask, out, B, L, heads, d, qv, kv, vv, ov, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, mask, out, B, L, heads, d, qv, kv, vv, ov, stream);
  return launch<T, 128>(q, k, v, mask, out, B, L, heads, d, qv, kv, vv, ov, stream);
}

}  // namespace

// q, k, v: (B, L, heads * d) with a contiguous last dimension and the given
// batch and row strides (in elements), all float32 (dtype 0) or all bfloat16
// (dtype 1); d, the strides and the pointers are multiples of 4 elements;
// mask: (B, L) float32, contiguous, 1 for a key to attend to;
// out: (B, L, heads * d) of q's dtype with its own strides. d <= 128.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int tm_attention(const void* q, const void* k, const void* v, const void* mask, void* out, int64_t B,
                            int64_t L, int64_t heads, int64_t d, int64_t q_batch, int64_t q_row, int64_t k_batch,
                            int64_t k_row, int64_t v_batch, int64_t v_row, int64_t o_batch, int64_t o_row,
                            int dtype, void* stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  if (heads <= 0 || d <= 0 || d > 128 || L > 0x7fffffffLL || heads > 0x7fffffffLL) return cudaErrorInvalidValue;
  const View qv{q_batch, q_row}, kv{k_batch, k_row}, vv{v_batch, v_row}, ov{o_batch, o_row};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto m = static_cast<const float*>(mask);
  const int li = static_cast<int>(L), hi = static_cast<int>(heads), di = static_cast<int>(d);
  if (dtype == 0) return launch_for_head_dim<float>(q, k, v, m, out, B, li, hi, di, qv, kv, vv, ov, s);
  if (dtype == 1) return launch_for_head_dim<__nv_bfloat16>(q, k, v, m, out, B, li, hi, di, qv, kv, vv, ov, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* tm_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
