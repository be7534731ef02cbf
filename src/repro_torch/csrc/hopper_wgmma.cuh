// Hopper building blocks shared by csrc/flash_attention.cu (the forward's
// wgmma path), csrc/flash_attention_bwd.cu (the gradient's wgmma passes)
// and csrc/ssd_bwd.cu (the SSD gradient's wgmma path): mbarriers, TMA loads, shared-memory matrix descriptors of
// 128-byte-swizzled tiles, the wgmma wrappers, the packing of float
// accumulators into bf16 A fragments, and the driver entry point that
// encodes a tensor map.
//
// Tile layout (what TMA's SWIZZLE_128B writes and the descriptors say): a
// tile of R rows x D bf16 columns is D / 64 chunks of R rows x 128 bytes,
// one after the other, 1,024-aligned, 1,024 bytes between 8-row groups.
// The same tile serves as a K-major operand (rows are M or N, the 64
// columns of a chunk are K: Q, K in S = Q.K^T) and as an MN-major one
// (rows are K, columns N: V in O += P.V), the transpose bit set.
//
// Where the design met trouble:
//   - TMA from a ctypes library: cuTensorMapEncodeTiled is a driver call and
//     the build links no libcuda; the runtime's cudaGetDriverEntryPoint hands
//     it out.  The maps go to a kernel as __grid_constant__ parameters.
//   - The maps are 3-D over [B*H, rows, D]: a ragged last tile reads zeros
//     inside its own head, where a 2-D map over [B*H*rows, D] would read the
//     next head's rows.
//   - SWIZZLE_128B limits a box's inner extent to 128 bytes (64 bf16): a
//     D 128 tile is two 64-column chunks; a K-major product's k-steps walk
//     across both (+32 bytes per k-step inside a chunk, the chunk size
//     between them); an MN-major B spans both through the descriptor's
//     leading byte offset.
//   - The descriptor must say what TMA wrote: a mismatch gives wrong
//     numbers, not a fault, and the bf16 bars in chip_smoke.py catch it.
//   - wgmma's accumulator holds a row's values in the 4 lanes of a quad, in
//     registers 4i + {0,1} (row g) and 4i + {2,3} (row g + 8) of each
//     8-column block i; two blocks make one k-step's A fragment (pack_p).
//   - The compiler does not know that wgmma writes its registers late:
//     every read of an accumulator is fenced after wgmma.wait_group.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wg {

constexpr int CH = 64;          // bf16 columns per 128-byte swizzled chunk
constexpr int CHUNK_ROW = 128;  // bytes of one row of a chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory; completes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// float registers stay put across the asynchronous product (the compiler
// must not move them while wgmma reads or writes them)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the same for packed bf16 A fragments
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

// the threads' shared-memory writes become visible to wgmma's and TMA's
// (asynchronous) accesses
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of bf16 element (r, c), c < 64, in a 128-byte-swizzled chunk
// (the 16-byte group c / 8 XOR row mod 8; a row keeps its 128 bytes)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return uint32_t(r * CHUNK_ROW + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1));
}

// Shared-memory matrix descriptor of a tile stored in 128-byte-swizzled
// chunks: start address >> 4 in bits 0-13, leading byte offset >> 4 in
// 16-29, stride byte offset >> 4 in 32-45, the 128-byte swizzle (1) in bits
// 62-63.  The stride byte offset is 1,024: eight 128-byte rows.  K-major
// operands ignore the leading offset (it is set to 16 bytes); an MN-major B
// takes the distance between its 64-column chunks there.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead_bytes) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(lead_bytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ float ex2(float x) {    // 2^x (MUFU.EX2; 2^-inf = 0)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// d (+)= A[64 x 16] . B[16 x 64]: A and B from shared memory, both K-major;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[16 x 128]: A and B from shared memory, both
// K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[16 x 128], both from shared memory: A K-major (TA
// 0) or MN-major (1, one 64-column chunk wide), B K-major (TB 0) or
// MN-major (1, its two 64-column chunks the descriptor's leading byte
// offset apart); scale_d = 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_sst(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d += A[64 x 16] . B[16 x 64]: A from registers (bf16 pairs), B from
// shared memory MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A[64 x 16] . B[16 x 128], as above
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d = A[64 x D] . B[2N x D]^T (d holds N floats a thread): A and B K-major
// tiles, `a_chunk` / `b_chunk` bytes between their 64-column chunks.  D / 16
// k-steps, +32 bytes each inside a chunk.
template <int D, int N>
__device__ __forceinline__ void ss_product(float (&d)[N], uint64_t da, uint64_t db,
                                           int a_chunk, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(d, da + (kk / 4) * (a_chunk >> 4) + (kk % 4) * 2,
             db + (kk / 4) * (b_chunk >> 4) + (kk % 4) * 2, kk > 0);
}

// d += A[64 x K] . B[K x 2N] (d holds N floats a thread): A from registers
// (K / 16 k-steps of packed bf16), B an MN-major tile of K rows at `sb` whose
// 64-column chunks lie `b_chunk` bytes apart; 16 rows (2,048 bytes) a k-step
template <int K, int N>
__device__ __forceinline__ void rs_product(float (&d)[N], const uint32_t (&a)[K / 16][4],
                                           uint32_t sb, int b_chunk) {
  const uint64_t db = desc(sb, b_chunk);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs(d, a[kk], db + kk * (2048 >> 4));
}

// an accumulator of N columns rounded to bf16 as the A fragments of a
// product over those columns: 8-column blocks 2 kk and 2 kk + 1 make
// k-step kk
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 16][4], const float (&sc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    pa[kk][0] = pack_f(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_f(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_f(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_f(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call and the library links no
// libcuda: the runtime hands out the driver's entry point
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D map over a contiguous [heads, rows, d] bf16 tensor whose box is one
// 64-column chunk of `box_rows` rows of one head; rows past the end of a head
// read as zeros (a 2-D map over [heads * rows, d] would read the next head)
inline bool tensor_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int heads,
                       int rows, int d, int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(rows), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(rows) * d * 2};
  const cuuint32_t box[3] = {cuuint32_t(CH), cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
}  // namespace
