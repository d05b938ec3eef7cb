// Masked self-attention of a BERT layer on Hopper (sm_90a): per (batch, head),
//   out = softmax(Q K^T / sqrt(d) + (1 - mask) * (-1e9)) V
// over (B, L, hidden) tensors in which head h owns the columns [h*d, (h+1)*d).
//
// Replaces the TPU kernel torchmetrics_tpu/_kernels/attention.py::_pallas_attention
// (body _attn_kernel). That kernel splits the heads with a transpose, pads L and d
// to 128 lanes in device memory, and holds one (batch, head)'s whole (Lp, Lp)
// score tile in VMEM. Here each head's columns are read in place through the row
// stride, nothing is padded or transposed in device memory, and the scores never
// reach it: a block of 8 warps owns 128 query rows of one (batch, head), 16 a warp,
// and walks the keys in tiles of 32 with an online softmax (running max, running
// sum, float32 accumulator), normalising once at the end (flash-style).
//
// Bound: at BERT-base's shapes (L = 128, d = 64) the work is 4 L^2 d flops per
// (batch, head) against 4 L d values moved. On float32 FMAs (67 TFLOP/s) that is
// over the bytes, and an FMA kernel cannot pass 2.3 ms a launch at (2999, 128,
// 768)/12. Both products therefore run on the tensor cores with mma.sync, and the
// bound becomes the bytes (q, k, v read once, out written once: 1.41 ms there):
//   - float32 (the main path; the oracle asks for precision "highest"): 3xTF32.
//     Each operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
//     rounded to nearest (cvt.rna), and a product is lo*hi + hi*lo + hi*hi with
//     float32 accumulation (mma.sync m16n8k8 tf32): the operands keep 22 of their
//     24 bits, about 1e-6 of the output's scale, and three passes at 495 TFLOP/s
//     stay under the bytes. K and V are split once per block when staged, and
//     kept as (hi, lo) pairs so one 8-byte shared load feeds both; Q is split
//     once, P in registers. The C fragment of an m16n8 product holds keys 2t and
//     2t+1 in lane t of a quad, where the A fragment of the next m16n8k8 wants
//     keys t and t+4: V's rows are staged permuted within each group of 8 keys
//     (key 2i at row i, key 2i+1 at row i+4), so P stays in registers.
//     wgmma was not taken in this first tensor-core version: tf32 wgmma wants
//     both operands K-major, so V would need a transpose in shared memory and
//     P a pass through it; Q K^T alone on tf32 wgmma gained little. On the
//     card this kernel is bound by latency (loads one tile ahead, two blocks of
//     8 warps an SM at 128 registers a thread), not by bytes or by issue:
//     PERF.md keeps its time against the bound.
//   - bfloat16: mma.sync m16n8k16 bf16 with float32 accumulation; the bf16
//     products are exact in float32, so Q K^T needs one pass. P is split into
//     two bf16 parts for P V (hi + lo, 16 bits), so the output stays within one
//     bf16 rounding of the float32 oracle; V's B fragments come from
//     ldmatrix.trans of the key-major tile.
// The scale, the additive -1e9 of the mask and the softmax are float32 on the
// accumulators, after the products and outside the split. Each thread's row
// statistics are shared by the 4 lanes of a quad (shuffles over 1 and 2); the
// running sum is kept per lane and reduced once at the end.
//
// Pipeline: the next key tile's global loads are issued into registers before
// this tile's products, and staged (split) into shared memory after them, so a
// tile's load latency hides behind the previous tile's tensor-core work; two
// __syncthreads a tile. Tiles are staged with 16-byte (float32) or 8-byte (bf16)
// loads, so d, the strides and the pointers must be multiples of 4 elements
// (the wrapper refuses other views); d is zero-padded in shared memory to the
// instantiation's 32, 64 or 128, and keys past L take no mass.
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

constexpr int kThreads = 256;  // 8 warps, 16 query rows each
constexpr int kRows = 128;     // query rows per block: at L = 128, one block a (batch, head) stages K and V once
constexpr int kKeys = 32;      // keys per tile
constexpr float kMaskBias = -1e9f;

struct View {  // element strides of a (B, L, hidden) tensor whose last dimension is contiguous
  int64_t batch, row;
};

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ tensor cores

// c += a (16 x 8, row) * b (8 x 8, col), tf32 in, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// four 8 x 8 bf16 matrices, transposed: lanes 8i .. 8i + 7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const auto addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi), both rounded to nearest, ties away
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
__device__ __forceinline__ float2 split_tf32(float x) {
  const float hi = __uint_as_float(tf32_rna(x));
  return make_float2(hi, __uint_as_float(tf32_rna(x - hi)));
}
// x = hi + lo in two bf16 parts (16 significant bits)
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ------------------------------------------------------------------ shared

// the (query tile, head, batch) of this block; block x -> tile fastest, so the two
// query tiles of one head run side by side and read its keys from L2 the second time
struct Block {
  int row0;
  int64_t b, col0;
  __device__ Block(int q_tiles, int heads, int d) {
    const int tile = blockIdx.x % q_tiles;
    const int h = (blockIdx.x / q_tiles) % heads;
    b = blockIdx.x / (static_cast<int64_t>(q_tiles) * heads);
    row0 = tile * kRows;
    col0 = static_cast<int64_t>(h) * d;
  }
};

// The online softmax step on a warp's 16 x 32 score tile. s[j][e]: row g + 8 (e / 2),
// key 8 j + 2 t + (e % 2) of the tile (g = lane / 4, t = lane % 4). Scales, adds the
// mask bias, drops keys past L, updates the running max m and the lane's partial
// running sum l of each of its two rows, rescales the accumulator o, and leaves
// exp(s - m) in s.
template <int NB>
__device__ __forceinline__ void online_softmax(float (&s)[4][4], float (&o)[NB][4], float (&m)[2], float (&l)[2],
                                               const float* bias, int keys_left, float inv_sqrt_d) {
  const int t = threadIdx.x % 4;
  float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      s[j][e] = key < keys_left ? s[j][e] * inv_sqrt_d + bias[key] : -CUDART_INF_F;  // keys past L take no mass
      tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[j][e]);
    }
  }
  float correction[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float m_new = fmaxf(m[r], tile_max[r]);
    correction[r] = expf(m[r] - m_new);  // 0 on the first tile, where m is -inf
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * correction[r] + sum[r];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= correction[e >> 1];
  }
}

// o / l into rows row0 + 16 warp + g (+ 8) and columns 8 n + 2 t (+ 1) of one head's slice
template <typename T, int NB>
__device__ __forceinline__ void store_rows(T* out_base, int64_t row_stride, int row0, int L, int d,
                                           const float (&o)[NB][4], float (&l)[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + (threadIdx.x / 32) * 16 + g + 8 * r;
    if (row >= L) continue;
    T* dst = out_base + static_cast<int64_t>(row) * row_stride;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int col = 8 * n + 2 * t;  // d % 4 == 0: the pair is wholly inside or outside
      if (col >= d) continue;
      const float a = o[n][2 * r] / l[r], b = o[n][2 * r + 1] / l[r];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(dst + col) = make_float2(a, b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(a, b);
      }
    }
  }
}

// ----------------------------------------------------------- float32, 3xTF32

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// four consecutive float32 values as (hi, lo) pairs: two 16-byte shared stores
__device__ __forceinline__ void store_split4(float2* dst, float4 x) {
  const float2 a = split_tf32(x.x), b = split_tf32(x.y), c = split_tf32(x.z), d = split_tf32(x.w);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

template <int D>
__host__ __device__ constexpr int f32_pitch() { return D + 4; }  // float2s a row: lanes (g, t) of a fragment hit distinct banks
template <int D>
constexpr size_t f32_smem_bytes() {  // q (kRows x pitch), k and v (kKeys x pitch) as (hi, lo); the tile's mask bias
  return static_cast<size_t>(kRows + 2 * kKeys) * f32_pitch<D>() * sizeof(float2) + kKeys * sizeof(float);
}
// shared row of key j of a tile in the V stage: key 2i at row i, key 2i + 1 at row i + 4 of its group of 8
__device__ __forceinline__ int v_row(int j) { return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1); }

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    attention_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ out, int L, int heads, int d, int q_tiles,
                     View qv, View kv, View vv, View ov, float inv_sqrt_d) {
  constexpr int P = f32_pitch<D>();
  constexpr int NB = D / 8;                      // 8-dimension blocks: k steps of Q K^T, n blocks of P V
  constexpr int C = kKeys * (D / 4) / kThreads;  // float4 chunks of each of K and V a thread stages
  extern __shared__ __align__(16) float2 smem2[];
  float2* qs = smem2;
  float2* ks = qs + kRows * P;
  float2* vs = ks + kKeys * P;
  float* bias = reinterpret_cast<float*>(vs + kKeys * P);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const Block blk(q_tiles, heads, d);
  const float* k_base = k + blk.b * kv.batch + blk.col0;
  const float* v_base = v + blk.b * vv.batch + blk.col0;
  const float* mask_row = mask + blk.b * L;

  float4 k_next[C], v_next[C];
  float bias_next = 0.0f;
  auto fetch = [&](int k0) {  // the tile at k0 and its mask bias into registers, zero past L and d
    if (tid < kKeys) bias_next = k0 + tid < L ? (1.0f - mask_row[k0 + tid]) * kMaskBias : 0.0f;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int i = tid + u * kThreads, j = i / (D / 4), c = 4 * (i % (D / 4));
      const bool inside = k0 + j < L && c < d;
      k_next[u] = inside ? *reinterpret_cast<const float4*>(k_base + static_cast<int64_t>(k0 + j) * kv.row + c) : zero4();
      v_next[u] = inside ? *reinterpret_cast<const float4*>(v_base + static_cast<int64_t>(k0 + j) * vv.row + c) : zero4();
    }
  };

  float o[NB][4], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }
  const float2* qw = qs + warp * 16 * P;
  fetch(0);  // the first key tile is in flight while Q is staged
  {          // Q, split once; every load issued before the first store
    constexpr int QC = kRows * (D / 4) / kThreads;
    const float* q_base = q + blk.b * qv.batch + blk.col0;
    float4 x[QC];
#pragma unroll
    for (int u = 0; u < QC; ++u) {
      const int i = tid + u * kThreads, r = i / (D / 4), c = 4 * (i % (D / 4)), row = blk.row0 + r;
      x[u] = (row < L && c < d) ? *reinterpret_cast<const float4*>(q_base + row * qv.row + c) : zero4();
    }
#pragma unroll
    for (int u = 0; u < QC; ++u) {
      const int i = tid + u * kThreads;
      store_split4(qs + (i / (D / 4)) * P + 4 * (i % (D / 4)), x[u]);
    }
  }
  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int i = tid + u * kThreads, j = i / (D / 4), c = 4 * (i % (D / 4));
      store_split4(ks + j * P + c, k_next[u]);
      store_split4(vs + v_row(j) * P + c, v_next[u]);
    }
    if (tid < kKeys) bias[tid] = bias_next;
    __syncthreads();
    if (k0 + kKeys < L) fetch(k0 + kKeys);  // in flight during this tile's products

    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {  // S += Q[:, 8kk..] K[:, 8kk..]^T
      const float2 a0 = qw[g * P + 8 * kk + t], a1 = qw[(g + 8) * P + 8 * kk + t];
      const float2 a2 = qw[g * P + 8 * kk + t + 4], a3 = qw[(g + 8) * P + 8 * kk + t + 4];
      const uint32_t a_hi[4] = {__float_as_uint(a0.x), __float_as_uint(a1.x), __float_as_uint(a2.x), __float_as_uint(a3.x)};
      const uint32_t a_lo[4] = {__float_as_uint(a0.y), __float_as_uint(a1.y), __float_as_uint(a2.y), __float_as_uint(a3.y)};
      uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 b0 = ks[(8 * j + g) * P + 8 * kk + t], b1 = ks[(8 * j + g) * P + 8 * kk + t + 4];
        b_hi[j][0] = __float_as_uint(b0.x), b_hi[j][1] = __float_as_uint(b1.x);
        b_lo[j][0] = __float_as_uint(b0.y), b_lo[j][1] = __float_as_uint(b1.y);
      }
      // each pass runs over the four independent accumulators before the next pass needs them
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s[j], a_lo, b_hi[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s[j], a_hi, b_lo[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s[j], a_hi, b_hi[j]);
    }
    online_softmax<NB>(s, o, m, l, bias, L - k0, inv_sqrt_d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // O += P[:, 8j..] V[8j.., :]; k position t is key 2t, t + 4 is key 2t + 1
      const float2 p0 = split_tf32(s[j][0]), p1 = split_tf32(s[j][2]), p2 = split_tf32(s[j][1]), p3 = split_tf32(s[j][3]);
      const uint32_t a_hi[4] = {__float_as_uint(p0.x), __float_as_uint(p1.x), __float_as_uint(p2.x), __float_as_uint(p3.x)};
      const uint32_t a_lo[4] = {__float_as_uint(p0.y), __float_as_uint(p1.y), __float_as_uint(p2.y), __float_as_uint(p3.y)};
#pragma unroll
      for (int n0 = 0; n0 < NB; n0 += 4) {  // four output blocks at a time, as above
        uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 b0 = vs[(8 * j + t) * P + 8 * (n0 + u) + g], b1 = vs[(8 * j + t + 4) * P + 8 * (n0 + u) + g];
          b_hi[u][0] = __float_as_uint(b0.x), b_hi[u][1] = __float_as_uint(b1.x);
          b_lo[u][0] = __float_as_uint(b0.y), b_lo[u][1] = __float_as_uint(b1.y);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(o[n0 + u], a_lo, b_hi[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(o[n0 + u], a_hi, b_lo[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(o[n0 + u], a_hi, b_hi[u]);
      }
    }
  }
  store_rows<float, NB>(out + blk.b * ov.batch + blk.col0, ov.row, blk.row0, L, d, o, l);
}

// ------------------------------------------------------------------ bfloat16

template <int D>
__host__ __device__ constexpr int bf16_pitch() { return D + 8; }  // bf16s a row: 144 bytes at D = 64, conflict-free fragments and ldmatrix
template <int D>
constexpr size_t bf16_smem_bytes() {
  return static_cast<size_t>(kRows + 2 * kKeys) * bf16_pitch<D>() * sizeof(bf16) + kKeys * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ mask, bf16* __restrict__ out, int L, int heads, int d, int q_tiles,
                   View qv, View kv, View vv, View ov, float inv_sqrt_d) {
  static_assert(D % 16 == 0, "k steps of 16 dimensions, n blocks in pairs");
  constexpr int P = bf16_pitch<D>();
  constexpr int NB = D / 8;
  constexpr int C = kKeys * (D / 4) / kThreads;  // 8-byte chunks of each of K and V a thread stages
  extern __shared__ __align__(16) bf16 smem_h[];
  bf16* qs = smem_h;
  bf16* ks = qs + kRows * P;
  bf16* vs = ks + kKeys * P;  // key-major, as loaded; ldmatrix.trans gives P V's B fragments
  float* bias = reinterpret_cast<float*>(vs + kKeys * P);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const Block blk(q_tiles, heads, d);
  const bf16* k_base = k + blk.b * kv.batch + blk.col0;
  const bf16* v_base = v + blk.b * vv.batch + blk.col0;
  const float* mask_row = mask + blk.b * L;
  const uint2 zero = make_uint2(0u, 0u);

  uint2 k_next[C], v_next[C];
  float bias_next = 0.0f;
  auto fetch = [&](int k0) {
    if (tid < kKeys) bias_next = k0 + tid < L ? (1.0f - mask_row[k0 + tid]) * kMaskBias : 0.0f;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int i = tid + u * kThreads, j = i / (D / 4), c = 4 * (i % (D / 4));
      const bool inside = k0 + j < L && c < d;
      k_next[u] = inside ? *reinterpret_cast<const uint2*>(k_base + static_cast<int64_t>(k0 + j) * kv.row + c) : zero;
      v_next[u] = inside ? *reinterpret_cast<const uint2*>(v_base + static_cast<int64_t>(k0 + j) * vv.row + c) : zero;
    }
  };

  float o[NB][4], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }
  const bf16* qw = qs + warp * 16 * P;
  auto word = [](const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); };  // two bf16
  fetch(0);
  {
    constexpr int QC = kRows * (D / 4) / kThreads;
    const bf16* q_base = q + blk.b * qv.batch + blk.col0;
    uint2 x[QC];
#pragma unroll
    for (int u = 0; u < QC; ++u) {
      const int i = tid + u * kThreads, r = i / (D / 4), c = 4 * (i % (D / 4)), row = blk.row0 + r;
      x[u] = (row < L && c < d) ? *reinterpret_cast<const uint2*>(q_base + row * qv.row + c) : zero;
    }
#pragma unroll
    for (int u = 0; u < QC; ++u) {
      const int i = tid + u * kThreads;
      *reinterpret_cast<uint2*>(qs + (i / (D / 4)) * P + 4 * (i % (D / 4))) = x[u];
    }
  }
  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int i = tid + u * kThreads, j = i / (D / 4), c = 4 * (i % (D / 4));
      *reinterpret_cast<uint2*>(ks + j * P + c) = k_next[u];
      *reinterpret_cast<uint2*>(vs + j * P + c) = v_next[u];
    }
    if (tid < kKeys) bias[tid] = bias_next;
    __syncthreads();
    if (k0 + kKeys < L) fetch(k0 + kKeys);

    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 16 * kk + 2 * t;
      const uint32_t a[4] = {word(qw + g * P + c), word(qw + (g + 8) * P + c), word(qw + g * P + c + 8),
                             word(qw + (g + 8) * P + c + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b[2] = {word(ks + (8 * j + g) * P + c), word(ks + (8 * j + g) * P + c + 8)};
        mma_bf16(s[j], a, b);
      }
    }
    online_softmax<NB>(s, o, m, l, bias, L - k0, inv_sqrt_d);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // 16 keys a step: score blocks 2h and 2h + 1
      uint32_t a_hi[4], a_lo[4];
      split_bf16x2(s[2 * h][0], s[2 * h][1], a_hi[0], a_lo[0]);
      split_bf16x2(s[2 * h][2], s[2 * h][3], a_hi[1], a_lo[1]);
      split_bf16x2(s[2 * h + 1][0], s[2 * h + 1][1], a_hi[2], a_lo[2]);
      split_bf16x2(s[2 * h + 1][2], s[2 * h + 1][3], a_hi[3], a_lo[3]);
      const int key = 16 * h + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t b[NB][2];  // B fragments of all output blocks, two per ldmatrix
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + key * P + 8 * n + (lane >> 4) * 8);
        b[n][0] = r[0], b[n][1] = r[1], b[n + 1][0] = r[2], b[n + 1][1] = r[3];
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) mma_bf16(o[n], a_lo, b[n]);
#pragma unroll
      for (int n = 0; n < NB; ++n) mma_bf16(o[n], a_hi, b[n]);
    }
  }
  store_rows<bf16, NB>(out + blk.b * ov.batch + blk.col0, ov.row, blk.row0, L, d, o, l);
}

// ------------------------------------------------------------------ launch

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask, void* out, int64_t B, int L,
                   int heads, int d, View qv, View kv, View vv, View ov, cudaStream_t stream) {
  const int q_tiles = (L + kRows - 1) / kRows;
  const int64_t blocks = B * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr bool kF32 = sizeof(T) == 4;
  const auto kernel = [] {
    if constexpr (kF32) return attention_tf32x3<D>;
    else return attention_bf16<D>;
  }();
  constexpr size_t smem = kF32 ? f32_smem_bytes<D>() : bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // 1 / sqrt(d) is exact where sqrt(d) is a power of two (d = 16, 64, 256: the oracle's
  // division, bit for bit); elsewhere the product is within one rounding of it
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
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

// dynamic shared memory of the instantiation that takes head dimension d (dtype as tm_attention's), 0 if none
extern "C" int tm_attention_smem(int dtype, int d) {
  if (d <= 0 || d > 128 || (dtype != 0 && dtype != 1)) return 0;
  const int D = d <= 32 ? 32 : d <= 64 ? 64 : 128;
  if (dtype == 0) return static_cast<int>(D == 32 ? f32_smem_bytes<32>() : D == 64 ? f32_smem_bytes<64>() : f32_smem_bytes<128>());
  return static_cast<int>(D == 32 ? bf16_smem_bytes<32>() : D == 64 ? bf16_smem_bytes<64>() : bf16_smem_bytes<128>());
}
