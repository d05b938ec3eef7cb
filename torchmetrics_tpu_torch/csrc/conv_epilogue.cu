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
// here ragged tails in M, K and N are zero-filled on the way into shared memory
// (by TMA, or by masked loads), and no padded copy is ever written.
//
// Bound: device-memory bytes on the FID path. The GEMMs' arithmetic intensity
// is K*N/(K+N) flop/byte in bf16 (48 at K=192, N=64; ~280 at K=2048, N=448),
// under the H100's ridge of ~295 (989 TFLOP/s over 3.35 TB/s) at every shape of
// InceptionV3, so what matters is that the activation is read once and the
// output written once: the epilogue adds the bias and applies ReLU to the
// accumulator before the single store, where an unfused graph would write the
// product, read it back for the bias, and again for the ReLU. B2b is one read
// and one write of the conv output, in place.
//
// Design, B2a bf16 with K % 8 == 0, N % 8 == 0 and 16-byte aligned x, w, out
// (every FID shape), mm_bias_relu_tma: a persistent, warp-specialised kernel.
//   - One block per SM walks the 128-row output tiles. Warpgroup 0 is the
//     producer: one thread issues TMA loads of the X tile (128 x 64) and the W
//     tile (BN x 64) of each K step into a ring of 4-8 stages (as many as
//     200 KB of shared memory hold), with one mbarrier per stage for "full"
//     (TMA transaction bytes) and one for "empty" (both consumers released it).
//     The ring runs on across tiles, so the next tile's loads stream in while
//     the consumers run this tile's epilogue. TMA zero-fills boxes past M, N
//     and K, so ragged tails (K = 288, N = 80) need no masked loads.
//   - Warpgroups 1 and 2 are consumers, 64 rows each: per K step, four
//     wgmma.m64nBNk16 (bf16 in, f32 accumulators in registers) read both tiles
//     from shared memory in the 128-byte swizzle TMA wrote (K-major X and W:
//     the natural "TN" layout, no transpose). A stage is released once the
//     next stage's products are issued and the earlier group has retired
//     (wgmma.wait_group 1). setmaxnreg moves registers from the producer
//     (40 a thread) to the consumers (232), for BN = 256's 128 accumulators.
//   - BN in {64, 128, 192, 256} covers as much of N as registers allow, so the
//     activation, the large operand, is read once for N <= 256 and twice (the
//     second time from L2, by the neighbouring tile) for N = 320-448. Padded
//     columns are zero-filled by TMA and never stored: the GEMMs are bound by
//     bytes, so they cost little, and four instantiations keep the build short.
//   - Epilogue on the accumulator registers: + bias, ReLU, one rounding to
//     bf16; a 4 x 4 transpose by shuffles within each quad of lanes turns the
//     wgmma fragment (two columns a lane) into 16-byte stores of 8 columns.
//   The tensor maps are encoded on the host at every call (the pointers change
//   every forward) through cuTensorMapEncodeTiled, which is fetched with
//   cudaGetDriverEntryPoint, so the library needs no -lcuda.
// Design, B2a bf16 for any other shape, mm_bias_relu_bf16: block tile 128 x 64,
//   K step 32, 8 warps of nvcuda::wmma 16x16x16 fragments, element loads with
//   bounds checks through two shared-memory stages, accumulators staged in
//   shared memory for the epilogue.
// Design, B2a f32: block tile 64 x 64, K step 16, 256 threads each holding a
//   4 x 4 register tile, plain FMA in f32 (no TF32), so a float32 trunk stays
//   true float32, the counterpart of precision="highest" on the TPU.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C entry points below with ctypes. <cuda.h> is
// included for the tensor-map types only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------- B2a, bf16, element loads

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

// one operand tile (tile_rows x kBK) of src (rows x K, row-major) into dst, zero outside
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src, int64_t rows, int64_t row0,
                                               int tile_rows, int64_t K, int64_t k0) {
  for (int e = threadIdx.x; e < tile_rows * kBK; e += kMmaThreads) {
    const int r = e / kBK;
    const int kk = e % kBK;
    const int64_t gr = row0 + r;
    const int64_t gk = k0 + kk;
    dst[r * kLdAB + kk] = (gr < rows && gk < K) ? src[gr * K + gk] : __float2bfloat16(0.0f);
  }
}

// any shape: element loads and stores with bounds checks
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
    load_tile_bf16(sa, x, M, m0, kBM, K, kt * kBK);
    load_tile_bf16(sa + kBM * kLdAB, w, N, n0, kBN, K, kt * kBK);
  };
  load_stage(0);
  for (int64_t kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) load_stage(kt + 1);  // the other stage: its last readers passed the barrier closing kt - 1
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

  // epilogue: + bias, ReLU, one rounding to bf16
  for (int e = threadIdx.x; e < kBM * kBN; e += kMmaThreads) {
    const int r = e / kBN;
    const int c = e % kBN;
    const int64_t gm = m0 + r;
    const int64_t gn = n0 + c;
    if (gm < M && gn < N) out[gm * N + gn] = __float2bfloat16(fmaxf(sc[r * kLdC + c] + __bfloat162float(bias[gn]), 0.0f));
  }
}

// ------------------------------------------- B2a, bf16, TMA + wgmma (FID path)

constexpr int kTmaBM = 128;           // two consumer warpgroups x 64 rows
constexpr int kTmaBK = 64;            // 64 bf16 = 128 bytes: one row of the 128-byte swizzle
constexpr int kTmaThreads = 384;      // warpgroup 0 produces, warpgroups 1 and 2 consume
constexpr int kRingBytes = 200 * 1024;  // of the 227 KB a block may hold
constexpr int kRowBytes = kTmaBK * static_cast<int>(sizeof(bf16));

template <int BN>
struct TmaTile {
  static_assert(BN % 64 == 0 && BN <= 256, "wgmma n and the epilogue's 32-column groups");
  static constexpr int kStageBytes = (kTmaBM + BN) * kRowBytes;  // X tile, then W tile; a multiple of 1024
  static constexpr int kStages = kRingBytes / kStageBytes < 8 ? kRingBytes / kStageBytes : 8;
  // the ring, its 2 x kStages mbarriers, and slack to align the ring to the 1024-byte swizzle atom
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// the (c0 = k, c1 = row) box of a 2-D tensor map into shared memory; completion counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle, as TMA writes it:
// start address >> 4, leading byte offset 1 (unused by this swizzle), stride byte offset
// 1024 >> 4 (8 rows of 128 bytes), layout type 1 (128-byte swizzle) in bits 62-63. The tile
// starts on a 1024-byte boundary, so the base offset is 0; a K step of 16 bf16 (32 bytes)
// adds 2 to the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3ffff) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// keep the compiler from moving reads of the accumulators above a wait
template <int R>
__device__ __forceinline__ void fence_accumulators(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x BN, f32, registers) = A (64 x 16, bf16, smem) * B (BN x 16, bf16, smem)^T + scale_d * D
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lower address) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t select4(const uint32_t (&a)[4], int i) {  // registers, not local memory
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// relu(X W^T + b) over tiles of 128 x BN; x_map (M, K) and w_map (N, K), both bf16, K-major.
template <int BN>
__global__ void __launch_bounds__(kTmaThreads, 1)
    mm_bias_relu_tma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                     const bf16* __restrict__ bias, bf16* __restrict__ out, int64_t M, int64_t K, int64_t N,
                     int tiles_n, int tiles) {
  using Tile = TmaTile<BN>;
  constexpr int kStages = Tile::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * Tile::kStageBytes);
  uint64_t* empty = full + kStages;
  const int k_tiles = static_cast<int>((K + kTmaBK - 1) / kTmaBK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; TMA's bytes complete the phase
      mbar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kTmaBM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // a fresh barrier passes parity 1 at once
          unsigned char* st = ring + stage * Tile::kStageBytes;
          mbar_expect_tx(&full[stage], Tile::kStageBytes);  // whole boxes: TMA counts the zero fill too
          tma_load_2d(st, &x_map, &full[stage], kt * kTmaBK, m0);
          tma_load_2d(st + kTmaBM * kRowBytes, &w_map, &full[stage], kt * kTmaBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // ---- consumer warpgroups 1 and 2: rows 64 (wg - 1) .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg_row = (threadIdx.x / 128 - 1) * 64;
    const int lane = threadIdx.x % 32, quad = lane % 4;
    const int frag_row = wg_row + ((threadIdx.x % 128) / 32) * 16 + lane / 4;  // and frag_row + 8
    const bool leader = threadIdx.x % 128 == 0;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t m0 = static_cast<int64_t>(tile / tiles_n) * kTmaBM;
      const int64_t n0 = static_cast<int64_t>(tile % tiles_n) * BN;
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * Tile::kStageBytes;
        const uint64_t da = sw128_desc(st + wg_row * kRowBytes), db = sw128_desc(st + kTmaBM * kRowBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTmaBK / 16; ++kk) wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous K step's products have retired: its stage may be refilled
        if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_accumulators(acc);
      if (leader) mbar_arrive(&empty[prev]);

      // epilogue: + bias, ReLU, one rounding to bf16. Lane (row r, quad q) holds columns
      // 8j + 2q, 8j + 2q + 1 of rows r and r + 8 for every 8-column block j; four shuffle
      // rounds per 32 columns give lane q the 8 columns 32g + 8q .. + 7, one 16-byte store.
#pragma unroll
      for (int g = 0; g < BN / 32; ++g) {
        uint32_t packed[2][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * g + jj;
          const int64_t col = n0 + 8 * j + 2 * quad;
          const float b0 = col < N ? __bfloat162float(bias[col]) : 0.0f;
          const float b1 = col + 1 < N ? __bfloat162float(bias[col + 1]) : 0.0f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            packed[i][jj] = pack_bf16x2(fmaxf(acc[4 * j + 2 * i] + b0, 0.0f), fmaxf(acc[4 * j + 2 * i + 1] + b1, 0.0f));
          }
        }
        const int64_t col = n0 + 32 * g + 8 * quad;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t got[4];  // got[r]: from lane (quad + r) % 4 of this quad, its columns of block 4g + quad
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            got[r] = __shfl_sync(0xffffffffu, select4(packed[i], (quad - r) & 3), (lane & ~3) | ((quad + r) & 3));
          }
          const int64_t row = m0 + frag_row + 8 * i;
          if (row < M && col < N) {  // N % 8 == 0: a group of 8 columns is wholly inside or outside
            const uint4 v = make_uint4(select4(got, (0 - quad) & 3), select4(got, (1 - quad) & 3),
                                       select4(got, (2 - quad) & 3), select4(got, (3 - quad) & 3));
            *reinterpret_cast<uint4*>(out + row * N + col) = v;
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, fetched once through the runtime (no -lcuda); null if absent
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a (rows, K) bf16 row-major matrix as boxes of box_rows x 64 in the 128-byte swizzle, zero past its edges
bool make_map(CUtensorMap* map, const void* base, int64_t rows, int64_t K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kTmaBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_tma(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int64_t M, int64_t K, int64_t N,
                       int sms, cudaStream_t stream) {
  using Tile = TmaTile<BN>;
  CUtensorMap x_map, w_map;
  if (!make_map(&x_map, x, M, K, kTmaBM) || !make_map(&w_map, w, N, K, BN)) return cudaErrorInvalidValue;
  const int64_t tiles_n = (N + BN - 1) / BN;
  const int64_t tiles = ((M + kTmaBM - 1) / kTmaBM) * tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(mm_bias_relu_tma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t grid = tiles < sms ? tiles : sms;  // persistent: one block per SM walks the tiles
  mm_bias_relu_tma<BN><<<static_cast<unsigned>(grid), kTmaThreads, Tile::kSmemBytes, stream>>>(
      x_map, w_map, bias, out, M, K, N, static_cast<int>(tiles_n), static_cast<int>(tiles));
  return cudaGetLastError();
}

// BN: the narrowest of 64..256 that covers N in as few column tiles as BN <= 256 allows, so
// the activation is read once; then narrower while the tiles would leave SMs idle (8x8 at batch
// 200: 100 row tiles), where a second read of the activation from L2 costs less than idle SMs
cudaError_t launch_tma_for_n(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int64_t M, int64_t K,
                             int64_t N, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t tiles_n = (N + 255) / 256;
  const int64_t per_tile = (N + tiles_n - 1) / tiles_n;
  int bn = per_tile <= 64 ? 64 : per_tile <= 128 ? 128 : per_tile <= 192 ? 192 : 256;
  const int64_t tiles_m = (M + kTmaBM - 1) / kTmaBM;
  while (bn > 64 && tiles_m * ((N + bn - 1) / bn) < 2 * sms) bn -= 64;
  switch (bn) {
    case 64: return launch_tma<64>(x, w, bias, out, M, K, N, sms, stream);
    case 128: return launch_tma<128>(x, w, bias, out, M, K, N, sms, stream);
    case 192: return launch_tma<192>(x, w, bias, out, M, K, N, sms, stream);
    default: return launch_tma<256>(x, w, bias, out, M, K, N, sms, stream);
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
// contiguous. route (bf16 only): 1 = TMA + wgmma, which needs K % 8 == 0,
// N % 8 == 0, x, w and out 16-byte aligned and M, N < 2**31; 0 = element loads.
// Launches on `stream` and returns the launch's cudaError_t; no synchronise.
extern "C" int tm_mm_bias_relu(const void* x, const void* w, const void* bias, void* out, int64_t M, int64_t K,
                               int64_t N, int dtype, int route, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const auto* xb = static_cast<const bf16*>(x);
    const auto* wb = static_cast<const bf16*>(w);
    const auto* bb = static_cast<const bf16*>(bias);
    auto* ob = static_cast<bf16*>(out);
    if (route == 1) {
      if (K % 8 || N % 8 || M > 0x7fffffffLL || N > 0x7fffffffLL) return cudaErrorInvalidValue;
      return launch_tma_for_n(xb, wb, bb, ob, M, K, N, s);
    }
    const int64_t tiles_n = (N + kBN - 1) / kBN;
    const int64_t blocks = ((M + kBM - 1) / kBM) * tiles_n;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    mm_bias_relu_bf16<<<static_cast<unsigned>(blocks), kMmaThreads, 0, s>>>(xb, wb, bb, ob, M, K, N, tiles_n);
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

// dynamic shared memory of the TMA kernel's instantiation for a column tile of bn (0 if there is none)
extern "C" int tm_mm_bias_relu_tma_smem(int bn) {
  switch (bn) {
    case 64: return TmaTile<64>::kSmemBytes;
    case 128: return TmaTile<128>::kSmemBytes;
    case 192: return TmaTile<192>::kSmemBytes;
    case 256: return TmaTile<256>::kSmemBytes;
    default: return 0;
  }
}
