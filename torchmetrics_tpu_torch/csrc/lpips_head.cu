// LPIPS head on Hopper (sm_90a): per batch row,
//   mean over pixels of  sum_c w_c * (f0_c / (||f0|| + 1e-10) - f1_c / (||f1|| + 1e-10))^2
// for two feature maps laid out (B, H*W, C), channels innermost, in float32 or
// bfloat16 (the trunk's own dtype: bf16 is widened to float32 in registers,
// which is exact, and all arithmetic is float32).
//
// Replaces the TPU kernel torchmetrics_tpu/_kernels/lpips_head.py::_pallas_lpips_head
// (body _head_kernel). That kernel pads C to 128 lanes and H*W to 256-row
// tiles in device memory and walks a row's pixel tiles as a sequential grid
// axis, carrying the row's sum in its output block. Here nothing is padded,
// and the sequential axis becomes a thread-block cluster per row.
//
// Bound: device-memory bytes, 2 * B * H * W * C * sizeof(T) read, B * 4
// written; the arithmetic (about 8 flops per element) is under the ridge. As
// on the TPU, neither the normalised maps, their difference nor the 1x1 conv
// output is ever written: each pixel is reduced to its scalar in registers.
//
// Design, from the host's launch plan (_kernels/lpips_head.py::head_plan):
// - Bytes in flight: a group of `lanes` lanes (a power of two) takes one
//   pixel; each lane loads K vectors of 16 bytes (8 bf16 or 4 float32) of
//   each map, vector k * lanes + lane, so a group reads its pixel's channels
//   as one contiguous run and neighbouring groups read neighbouring pixels.
//   K and the element type are template arguments, so the loads are
//   unrolled; at K <= 2 a group takes two pixels a step, and each warp keeps
//   the loads of its next step in flight while it computes the current one.
//   C not a multiple of the vector, or a base that is not 16-byte aligned,
//   takes the same kernel with one element a "vector". Up to 1024 channels
//   run in 16-byte vectors, 512 one element at a time.
// - Read once: a pixel's channels stay in registers from the two norms
//   (summed over the group with shuffles) to the weighted sum.
// - The oracle's x / (||x|| + eps), eps outside the root (no rsqrt): each
//   lane takes 1 / (||x|| + eps) once a pixel with an IEEE division and
//   multiplies its channels by it, one rounding more per channel than a
//   division (2^-24 relative, against the 1e-5 tolerance). An IEEE division
//   per channel, as the oracle spells it, left the kernel bound by that
//   division's instructions rather than by the bytes.
// - Weights: the head's weights are staged in shared memory once per block,
//   and each lane keeps its own channels' weights in registers (a lane's
//   channels are the same at every pixel). A lane holds at most 32 channels
//   of a pixel (K * E <= 32), so no instantiation spills.
// - Deterministic, one launch: a row's pixels are cut into `cluster` fixed
//   slices, one per block of a thread-block cluster (at most 8, the portable
//   size). Each block sums its lanes in a fixed order (warp shuffles, then the
//   warps in index order); after a cluster barrier, block 0 reads the blocks'
//   partials over distributed shared memory in rank order and writes
//   out[b] = sum / (H*W). No atomics, no scratch buffer, no fill or division
//   kernel: two calls on the same inputs give the same bits. (A last-block
//   ticket would need a counter that lives across calls and streams; the
//   cluster needs nothing outside the launch.)
// - Waves: the plan sizes the cluster so that B * cluster blocks are at least
//   twice the SMs where the row has the pixels for it (B = 50 at LPIPS's
//   taps: clusters of 8, 400 blocks).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry point tm_lpips_head with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmemWeights = 48 * 1024;
constexpr int kMaxLaneChannels = 32;  // a lane's channels of one pixel, held in registers
constexpr float kEps = 1e-10f;  // image/_lpips.py _normalize_tensor

struct Bf16 {  // storage only: bf16 bits, widened to float32 exactly by a shift
  uint16_t bits;
};

// The raw bits of E elements of type T: one 16-byte vector (E = 16 / sizeof(T))
// or one element (E = 1). Loaded as they are, widened to float when used.
template <typename T, int E>
struct Raw;
template <>
struct Raw<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = __ldcs(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ void widen(float (&x)[4]) const {
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <>
struct Raw<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldcs(p); }
  __device__ __forceinline__ void widen(float (&x)[1]) const { x[0] = v; }
};
template <>
struct Raw<Bf16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const Bf16* p) { v = __ldcs(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void widen(float (&x)[8]) const {
    const uint32_t word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: element 2i in the low half
      x[2 * i] = __uint_as_float(word[i] << 16);
      x[2 * i + 1] = __uint_as_float(word[i] & 0xffff0000u);
    }
  }
};
template <>
struct Raw<Bf16, 1> {
  unsigned short v;
  __device__ __forceinline__ void load(const Bf16* p) { v = __ldcs(reinterpret_cast<const unsigned short*>(p)); }
  __device__ __forceinline__ void widen(float (&x)[1]) const { x[0] = __uint_as_float(static_cast<uint32_t>(v) << 16); }
};

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int offset = lanes >> 1; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// One step of a warp: kPix pixels a group, K vectors a lane of each map, as raw bits.
template <typename T, int E, int K, int kPix>
struct Step {
  Raw<T, E> a[kPix][K], b[kPix][K];

  // the warp's pixels from `base`: pixel base + q * groups_per_warp + group (one
  // load instruction reads a warp's contiguous pixels); masked slots are zeros
  __device__ __forceinline__ void load(const T* a_row, const T* b_row, int64_t base, int64_t p_end, int C,
                                       int lanes, int sub, int group, int groups_per_warp, const bool (&on)[K]) {
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const int64_t p = base + q * groups_per_warp + group;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (p < p_end && on[k]) {
          const int64_t offset = p * C + static_cast<int64_t>(k * lanes + sub) * E;
          a[q][k].load(a_row + offset);
          b[q][k].load(b_row + offset);
        } else {
          a[q][k] = Raw<T, E>{};
          b[q][k] = Raw<T, E>{};
        }
      }
    }
  }

  // adds sum_c w_c (a_c / (||a|| + eps) - b_c / (||b|| + eps))^2 of each pixel to acc;
  // a masked slot adds 0 (0 / eps - 0 / eps)
  __device__ __forceinline__ void accumulate(const float (&wr)[K][E], int lanes, float& acc) const {
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      float sa = 0.0f, sb = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {  // the raw bits are widened twice: cheaper than holding floats
        float x[E], y[E];
        a[q][k].widen(x);
        b[q][k].widen(y);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sa = fmaf(x[e], x[e], sa);
          sb = fmaf(y[e], y[e], sb);
        }
      }
      // x / (||x|| + eps): eps outside the root, as in the oracle (no rsqrt); one
      // IEEE reciprocal a pixel, then a product a channel (see the note at the top)
      const float ia = 1.0f / (sqrtf(group_sum(sa, lanes)) + kEps);
      const float ib = 1.0f / (sqrtf(group_sum(sb, lanes)) + kEps);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float x[E], y[E];
        a[q][k].widen(x);
        b[q][k].widen(y);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = x[e] * ia - y[e] * ib;
          acc = fmaf(d * d, wr[k][e], acc);
        }
      }
    }
  }
};

// grid (B * cluster); cluster (cluster, 1, 1); one cluster per row. Block
// `rank` of a row takes pixels [rank * pixels_per_block, (rank + 1) * pixels_per_block);
// each warp walks its steps with the next step's loads in flight while it
// computes the current one.
template <typename T, int E, int K>
__global__ void __launch_bounds__(kThreads)
    lpips_head_kernel(const T* __restrict__ f0, const T* __restrict__ f1, const float* __restrict__ w, int64_t hw,
                      int C, int lanes, int64_t pixels_per_block, float* __restrict__ out) {
  constexpr int kPix = K <= 2 ? 2 : 1;  // pixels a group takes a step
  extern __shared__ float w_s[];
  __shared__ float warp_part[kWarps];
  __shared__ float block_part;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t row = blockIdx.x / cluster.num_blocks();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane % lanes;  // this lane's place in its pixel's group
  const int group = lane / lanes;
  const int groups_per_warp = 32 / lanes;
  const int vectors = C / E;
  bool on[K];
#pragma unroll
  for (int k = 0; k < K; ++k) on[k] = k * lanes + sub < vectors;

  const int64_t p_begin = static_cast<int64_t>(rank) * pixels_per_block;
  const int64_t p_end = p_begin + pixels_per_block < hw ? p_begin + pixels_per_block : hw;
  const int64_t warp_step = static_cast<int64_t>(groups_per_warp) * kPix;
  const T* a_row = f0 + row * hw * C;
  const T* b_row = f1 + row * hw * C;
  // the loop bound depends on the warp alone, so every lane reaches the shuffles
  const int64_t stride = kWarps * warp_step;
  int64_t base = p_begin + warp * warp_step;
  Step<T, E, K, kPix> next;  // the first step's loads go out before the weights are staged
  if (base < p_end) next.load(a_row, b_row, base, p_end, C, lanes, sub, group, groups_per_warp, on);

  for (int c = threadIdx.x; c < C; c += kThreads) w_s[c] = w[c];
  __syncthreads();
  float wr[K][E];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) wr[k][e] = on[k] ? w_s[(k * lanes + sub) * E + e] : 0.0f;
  }

  float acc = 0.0f;
  for (; base < p_end; base += stride) {
    const Step<T, E, K, kPix> current = next;
    if (base + stride < p_end) next.load(a_row, b_row, base + stride, p_end, C, lanes, sub, group, groups_per_warp, on);
    current.accumulate(wr, lanes, acc);
  }

  // fixed-order reductions: lanes by shuffles, warps in index order, blocks in rank order
  acc = group_sum(acc, 32);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kWarps; ++i) total += warp_part[i];
    block_part = total;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.0f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) total += *cluster.map_shared_rank(&block_part, r);
    out[row] = total / static_cast<float>(hw);
  }
  cluster.sync();  // no block leaves while block 0 may still read its shared memory
}

template <typename T, int E, int K>
cudaError_t launch(const void* f0, const void* f1, const void* w, void* out, int64_t B, int64_t hw, int C, int lanes,
                   int cluster, int64_t pixels_per_block, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B * cluster));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(C) * sizeof(float);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, lpips_head_kernel<T, E, K>, static_cast<const T*>(f0), static_cast<const T*>(f1),
                            static_cast<const float*>(w), hw, C, lanes, pixels_per_block, static_cast<float*>(out));
}

// K (vectors a lane per map) from the plan, instantiated where a lane holds
// at most kMaxLaneChannels channels of a pixel
template <typename T, int E, int K>
cudaError_t launch_if_held(const void* f0, const void* f1, const void* w, void* out, int64_t B, int64_t hw, int C,
                           int lanes, int cluster, int64_t pixels_per_block, cudaStream_t s) {
  if constexpr (K * E <= kMaxLaneChannels) {
    return launch<T, E, K>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, int E>
cudaError_t dispatch_k(int k, const void* f0, const void* f1, const void* w, void* out, int64_t B, int64_t hw, int C,
                       int lanes, int cluster, int64_t pixels_per_block, cudaStream_t s) {
  switch (k) {
    case 1: return launch_if_held<T, E, 1>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
    case 2: return launch_if_held<T, E, 2>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
    case 3: return launch_if_held<T, E, 3>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
    case 4: return launch_if_held<T, E, 4>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
    case 6: return launch_if_held<T, E, 6>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
    case 8: return launch_if_held<T, E, 8>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
    case 12: return launch_if_held<T, E, 12>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
    case 16: return launch_if_held<T, E, 16>(f0, f1, w, out, B, hw, C, lanes, cluster, pixels_per_block, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// f0, f1: (B, hw, C) contiguous, float32 (dtype 0) or bf16 (dtype 1); w: (C,)
// float32; out: (B,) float32, written (not accumulated) with each row's mean.
// vec_elems, lanes, k, cluster and pixels_per_block come from the host's
// head_plan; a plan the kernel cannot run is refused with cudaErrorInvalidValue.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int tm_lpips_head(const void* f0, const void* f1, const void* w, void* out, int64_t B, int64_t hw,
                             int64_t C, int dtype, int vec_elems, int lanes, int k, int cluster,
                             int64_t pixels_per_block, void* stream) {
  if (B <= 0 || hw <= 0) return cudaSuccess;
  const int vector = dtype == 0 ? 4 : 8;
  if (dtype < 0 || dtype > 1 || (vec_elems != 1 && vec_elems != vector) || C <= 0 || C % vec_elems != 0 ||
      C * static_cast<int64_t>(sizeof(float)) > kMaxSmemWeights || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || static_cast<int64_t>(k) * lanes * vec_elems < C || cluster < 1 ||
      cluster > kMaxCluster || pixels_per_block < 1 || pixels_per_block * cluster < hw || B * cluster > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(C);
  if (dtype == 0) {
    return vec_elems == 1 ? dispatch_k<float, 1>(k, f0, f1, w, out, B, hw, c, lanes, cluster, pixels_per_block, s)
                          : dispatch_k<float, 4>(k, f0, f1, w, out, B, hw, c, lanes, cluster, pixels_per_block, s);
  }
  return vec_elems == 1 ? dispatch_k<Bf16, 1>(k, f0, f1, w, out, B, hw, c, lanes, cluster, pixels_per_block, s)
                        : dispatch_k<Bf16, 8>(k, f0, f1, w, out, B, hw, c, lanes, cluster, pixels_per_block, s);
}

extern "C" const char* tm_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
