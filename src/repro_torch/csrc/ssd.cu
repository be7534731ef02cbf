// Mamba-2 SSD chunked scan for Hopper (sm_90a): the SSM layer's sequence mix.
//
// Replaces the JAX package's Pallas kernel kernels/ssd/kernel.py:ssd_scan
// (_ssd_kernel), at the call site of its XLA twin kernels/ssd/ops.py:
// ssd_chunked (models/mamba2.py:apply_mamba).  The recurrence
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// is computed chunk by chunk, with the [P, N] float32 state carried across
// chunks.  Per chunk of L = 64 steps:
//   cum   = inclusive scan of dt a                      (a < 0: log-decays)
//   M_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j  for j <= i, else 0
//   y_i   = sum_j M_ij x_j + exp(cum_i) (C_i . state^T)
//   state = state exp(cum_L) + sum_j B_j^T (x_j exp(cum_L - cum_j) dt_j)
// The mask is applied before the exponential: exp(cum_i - cum_j) for j > i
// overflows to inf once |sum dt a| passes ~88, and inf times a 0/1 mask is
// NaN.  Any S is tiled by L; the ragged tail reads dt = 0 and x = B = C = 0
// (TMA fills rows past S with zeros), an exact no-op on the state; the
// result is the reference's up to float32 rounding (its chunk is 128, or
// all of S).  y comes out in x's dtype and, on request, the final state
// (which the Pallas kernel keeps in scratch and the model's prefill stores).
// B and C are read per group of heads: row g of b/c [G, S, N] serves heads
// g*H .. g*H + H - 1 (the model's B and C are shared by a sequence's heads).
//
// What bounds the function: bytes.  At mamba2-780m's prefill (BH 192,
// S 8192, P 64, N 128, x in bf16) it moves ~449 MB (x and y in bf16, B and
// C per sequence, dt and the state in float32: 0.134 ms at 3.35 TB/s;
// ~432 MB and 0.129 ms with B and C in bf16) and needs 5.72e10 FLOP at the
// cheapest chunk, 0.058 ms at the bf16 tensor-core peak of 989 TFLOP/s.
// This kernel's own scheme costs more operations: three bf16 passes for
// an operand that holds float32 digits (0.17 ms at the cheapest chunk,
// 0.27 at L = 64), and a block recomputes its chunk's C.B^T for each
// slice of P (below), 1.4x-2x the least work.
//
// Design: one warpgroup (128 threads) a block, three things taking the
// previous design's limits away.
//   - The P split.  A head's state rows along P are independent: y[:, p]
//     needs only state[p, :] and x[:, p].  The grid is BH x (P / PS), each
//     block walking its head's chunks in order with its [PS, N] slice of
//     the state in registers (wgmma accumulators): mamba2-780m's 192 heads
//     make 384 blocks (PS = 32; 16 measured slower) instead of 192 (two
//     waves on 132 SMs, the second 60 SMs wide).
//   - The tensor cores with float32's digits.  Every product is a bf16
//     wgmma with float32 accumulation.  An operand v that holds float32
//     digits (M, the state, x o w, x in float32, and B and C when they come
//     as float32) is split into hi = bf16(v) and lo = bf16(v - hi), and a
//     product is hi.hi + hi.lo + lo.hi (~2^-16 relative; -fmad=false keeps
//     v - hi exact); an operand that is bf16 already (x in the bf16 forms, B
//     and C in the bf16 model) takes one pass.  Per chunk:
//       G     = C . B^T           m64n64, both K-major from shared memory
//       Yi    = C . state_s^T     m64nPS; exp(cum_i) scales its rows after
//       st^T += B^T . (x_s o w)   m64nPS per 64 state rows, B^T read
//                                 MN-major (the transpose bit): the state is
//                                 carried transposed, [N, PS], so that wgmma's
//                                 64-row M side is N; N < 64 (hymba's 16) is
//                                 padded to 64 zero columns of B and C
//       Y     = M . x_s           m64nPS, M from registers: G's accumulator
//                                 masked, times 2^((cum_i - cum_j) log2 e)
//                                 dt_j, split in place
//     y = Y + exp(cum) Yi.  The new state goes back to shared memory as bf16
//     hi/lo tiles for the next chunk's Yi (stmatrix, transposed).
//   - Off the chunk chain.  Two small kernels run first: ssd_split_bc
//     writes B and C once per call as bf16 planes [G, S, max(N, 64)] (hi,
//     and lo where float32), and ssd_chunk_vec each chunk's warp scan of
//     dt a and its exponentials.  TMA then loads a chunk's planes (straight
//     into the 128-byte-swizzled layout wgmma reads), its raw x slice and
//     its vectors into a ring, an mbarrier a stage, chunk c + STAGES issued
//     as chunk c is done: two stages where B and C come as float32 (one
//     block an SM), one where they come as bf16, so that three blocks share
//     an SM and hide each other's loads (measured faster than two stages
//     and two blocks).  The block itself only builds the x-side tiles, the
//     products and the state's tiles.
// What holds it now: each block's chain of chunks, one after the other.
// In a chunk the products are the largest part, and they run at shared
// memory's rate (every wgmma reads A and B from it); building M, the
// x-side and state tiles, and the barriers take the rest.  One block fits
// an SM where B and C come as float32, three where they come as bf16.  A
// second warpgroup running the state-free work (G, M, Y) a chunk ahead of
// the chain was tried and was no faster, so it was not kept.
//
// The previous design (replaced): one 256-thread block per head walked its
// chunks on the float32 FMA pipes, every product a 4x4 register patch per
// thread over padded shared-memory tiles, the cumulative sum one thread's
// loop, 133 KB of shared memory a block (one block an SM): 6.97 ms at
// mamba2-780m's prefill, 13 TFLOP/s.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 64;            // chunk length: one 64-row wgmma tile
constexpr int THREADS = 128;     // one warpgroup
constexpr int ROW = 128;         // bytes of a row of a 128-byte-swizzled tile
constexpr int PS = 32;           // columns of P a block (16 measured slower)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, for x of type TX, B/C split (SPLIT) or bf16,
// NW = max(N, 64) state rows.  Every tile is a run
// of 64-column (128-byte) chunks, 1,024-aligned, swizzled as TMA's
// SWIZZLE_128B writes.
template <typename TX, bool SPLIT, int NW>
struct Cfg {
  // stages of the TMA ring: with bf16 B/C a stage is small enough for
  // three blocks an SM with one stage (one wave at mamba2-780m's prefill),
  // which hides the loads better than two stages and two blocks; float32
  // B/C's planes leave room for one block, so it prefetches a chunk ahead
  static constexpr int STAGES = SPLIT ? 2 : 1;
  static constexpr bool X_F32 = sizeof(TX) == 4;
  static constexpr int NCH = NW / 64;             // 64-column chunks of a B/C row
  static constexpr int BC_TILE = L * NW * 2;      // a bf16 [L, NW] B or C plane
  static constexpr int NBC = SPLIT ? 4 : 2;       // B hi, C hi (, B lo, C lo)
  static constexpr int RAWX = L * PS * int(sizeof(TX));   // x[c0:c0+L, p0:p0+PS]
  static constexpr int VEC = 4 * L * 4;           // cum, dt, e^cum, w (ssd_chunk_vec)
  static constexpr int STAGE = NBC * BC_TILE + RAWX + VEC;
  static constexpr int XT = PS * ROW;             // a bf16 [PS, L] x-side tile
  static constexpr int NX = (X_F32 ? 2 : 1) + 2;  // x hi (, x lo), x o w hi, lo
  static constexpr int ST_TILE = PS * NW * 2;     // a bf16 [PS, NW] state tile
  static constexpr int OFF_X = STAGES * STAGE;
  static constexpr int OFF_ST = OFF_X + NX * XT;  // state hi, lo
  static constexpr int OFF_BAR = OFF_ST + 2 * ST_TILE;
  // 1,024 bytes of slack to align the tiles, the tiles, one mbarrier a stage
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * STAGES;
  static_assert(STAGE % 1024 == 0 && XT % 1024 == 0 && ST_TILE % 1024 == 0,
                "tiles must stay 1,024-aligned");
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// two floats rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a pair of floats split into bf16 hi = bf16(v) and lo = bf16(v - hi), `a`
// in the low halves
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float ex2(float x) {    // 2^x (MUFU.EX2)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of bf16 element (r, c), c < 64, in a tile of 128-byte rows
// under the 128-byte swizzle (16-byte group c / 8 XOR row mod 8)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return uint32_t(r * ROW + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
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

// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned) into shared
// memory; completes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// four 8x8 bf16 matrices from registers, each stored transposed: lane l
// gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_t4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// the threads' shared-memory writes become visible to wgmma's (async) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// float registers stay put across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

// Shared-memory matrix descriptor of a tile in 128-byte-swizzled chunks:
// start address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29,
// stride byte offset >> 4 (1,024: eight 128-byte rows) in 32-45, the
// 128-byte swizzle (1) in bits 62-63.  K-major operands ignore the leading
// offset; every MN-major operand here is one 64-column chunk wide.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major tile of `rows` rows: k-step kk (16 bf16 columns) is +32 bytes
// inside a 64-column chunk, one chunk (rows x 128 bytes) between chunks
__device__ __forceinline__ uint32_t kstep(uint32_t tile, int rows, int kk) {
  return tile + uint32_t((kk >> 2) * rows * ROW + (kk & 3) * 32);
}

// d (+)= A[64 x 16] . B[16 x 64], both from shared memory; B K-major, A
// K-major (TA = 0) or MN-major (TA = 1); scale_d = 0 overwrites d
template <int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// d (+)= A[64 x 16] . B[16 x 32], both from shared memory; B K-major, A
// K-major (TA = 0) or MN-major (TA = 1); scale_d = 0 overwrites d
template <int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// d (+)= A[64 x 16] . B[16 x 16], both from shared memory; B K-major, A
// K-major (TA = 0) or MN-major (TA = 1); scale_d = 0 overwrites d
template <int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// d (+)= A[64 x 16] . B[16 x 32]: A from registers (bf16 pairs), B from
// shared memory K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[16 x 16]: A from registers (bf16 pairs), B from
// shared memory K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The B and C planes the ring loads: [NPL, G, S, NW] bf16, plane 0 B hi, 1
// C hi, (2 B lo, 3 C lo when split), columns N .. NW - 1 zero.
template <typename TB>
__global__ void __launch_bounds__(256)
ssd_split_bc(const TB* __restrict__ b, const TB* __restrict__ c,
             __nv_bfloat16* __restrict__ out, long long rows, int n, int nw, int split) {
  const long long plane = rows * nw;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < plane;
       i += (long long)gridDim.x * 256) {
    const long long r = i / nw;
    const int col = int(i - r * nw);
    const float bv = col < n ? to_f(b[r * n + col]) : 0.f;
    const float cv = col < n ? to_f(c[r * n + col]) : 0.f;
    const __nv_bfloat16 bh = __float2bfloat16_rn(bv), ch = __float2bfloat16_rn(cv);
    out[i] = bh;
    out[plane + i] = ch;
    if (split) {
      out[2 * plane + i] = __float2bfloat16_rn(bv - __bfloat162float(bh));
      out[3 * plane + i] = __float2bfloat16_rn(cv - __bfloat162float(ch));
    }
  }
}

// Per (head, chunk), one warp: cum (the inclusive scan of dt a), dt, exp(cum)
// and exp(cum_L - cum) dt, 4 x L floats in vec [BH, chunks, 4, L]; steps
// past S have dt = 0.  Off the chunk chain, so the scan costs the chain
// nothing.
__global__ void __launch_bounds__(256)
ssd_chunk_vec(const float* __restrict__ dt, const float* __restrict__ a,
              float* __restrict__ vec, int bh, int s, int nchunks) {
  const long long wid = (blockIdx.x * 256ll + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)bh * nchunks) return;
  const int h = int(wid / nchunks), c0 = int(wid - (long long)h * nchunks) * L;
  const float* dtp = dt + (size_t)h * s;
  const float ah = a[h];
  const float d0 = c0 + lane < s ? dtp[c0 + lane] : 0.f;
  const float d1 = c0 + 32 + lane < s ? dtp[c0 + 32 + lane] : 0.f;
  float v0 = d0 * ah, v1 = d1 * ah;               // inclusive warp scans
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(FULL, v0, o), u1 = __shfl_up_sync(FULL, v1, o);
    if (lane >= o) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(FULL, v0, 31);
  const float total = __shfl_sync(FULL, v1, 31);
  float* o = vec + wid * 4 * L;
  o[lane] = v0;
  o[lane + 32] = v1;
  o[L + lane] = d0;
  o[L + lane + 32] = d1;
  o[2 * L + lane] = expf(v0);
  o[2 * L + lane + 32] = expf(v1);
  o[3 * L + lane] = expf(total - v0) * d0;
  o[3 * L + lane + 32] = expf(total - v1) * d1;
}

// Block (head h, columns p0 .. p0 + PS - 1 of P): walks the head's chunks.
template <typename TX, bool SPLIT, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_wgmma(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmbc,
          const float* __restrict__ vec, TX* __restrict__ y, float* __restrict__ state_out,
          int s, int p, int n, int heads_per_group, int groups) {
  constexpr int NW = N < 64 ? 64 : N, NK = N / 16;   // state rows, k-steps over N
  using C = Cfg<TX, SPLIT, NW>;
  constexpr int NCH = C::NCH, NP = PS / 2;        // floats of a m64nPS accumulator
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;    // 1,024-aligned tiles
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::OFF_BAR;
  const uint32_t xt = base + C::OFF_X;            // x hi, (x lo,) x o w hi, lo
  const uint32_t xw = xt + (C::X_F32 ? 2 : 1) * C::XT;
  const uint32_t sth = base + C::OFF_ST, stl = sth + C::ST_TILE;

  const int slices = p / PS;
  const int h = blockIdx.x / slices;
  const int p0 = (blockIdx.x - h * slices) * PS;
  const int g = h / heads_per_group;
  const int nchunks = (s + L - 1) / L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * C::ST_TILE / 16; i += THREADS)   // the state starts at 0
    reinterpret_cast<uint4*>(gbase + C::OFF_ST)[i] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  __syncthreads();

  // chunk c's B/C planes, raw x and vectors into stage c % C::STAGES
  auto load = [&](int c) {
    const uint32_t stage = base + (c % C::STAGES) * C::STAGE;
    const uint32_t bar = bars + 8 * (c % C::STAGES);
    mbar_expect_tx(bar, C::STAGE);
    for (int pl = 0; pl < C::NBC; ++pl)
      for (int ch = 0; ch < NCH; ++ch)
        tma_load(stage + pl * C::BC_TILE + ch * L * ROW, &tmbc, ch * 64, c * L,
                 pl * groups + g, bar);
    tma_load(stage + C::NBC * C::BC_TILE, &tmx, p0, c * L, h, bar);
    bulk_load(stage + C::NBC * C::BC_TILE + C::RAWX, vec + ((size_t)h * nchunks + c) * 4 * L,
              C::VEC, bar);
  };
  if (tid == 0)
    for (int c = 0; c < C::STAGES && c < nchunks; ++c) load(c);

  float st[NCH][NP];                              // state^T [NW, PS], as wgmma holds it
#pragma unroll
  for (int m = 0; m < NCH; ++m)
#pragma unroll
    for (int i = 0; i < NP; ++i) st[m][i] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * L;
    const uint32_t stage = base + (c % C::STAGES) * C::STAGE;
    const uint32_t bhi = stage, chi = stage + C::BC_TILE;
    const uint32_t blo = SPLIT ? stage + 2 * C::BC_TILE : 0, clo = blo + C::BC_TILE;
    const float* cum = reinterpret_cast<const float*>(gbase + (stage - base) +
                                                      C::NBC * C::BC_TILE + C::RAWX);
    const float* dts = cum + L;
    const float* ecum = dts + L;                  // exp(cum_i)
    const float* wv = ecum + L;                   // exp(cum_L - cum_j) dt_j
    mbar_wait(bars + 8 * (c % C::STAGES), uint32_t((c / C::STAGES) & 1));

    // the x-side tiles, K-major [PS, L]: x (hi, lo) and x o w (hi, lo),
    // eight steps j of one column p per 16-byte store
    {
      const TX* rx = reinterpret_cast<const TX*>(gbase + (stage - base) +
                                                 C::NBC * C::BC_TILE);
      for (int it = tid; it < PS * 8; it += THREADS) {
        const int pc = it % PS, j0 = (it / PS) * 8;
        float v[8], w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = to_f(rx[(j0 + e) * PS + pc]);
          w[e] = v[e] * wv[j0 + e];
        }
        const uint32_t off = swz(pc, j0);
        uint32_t hi[4], lo[4];
        if (C::X_F32) {
#pragma unroll
          for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], hi[e], lo[e]);
          *reinterpret_cast<uint4*>(gbase + (xt - base) + C::XT + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) hi[e] = pack_f(v[2 * e], v[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(gbase + (xt - base) + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) split2(w[2 * e], w[2 * e + 1], hi[e], lo[e]);
        *reinterpret_cast<uint4*>(gbase + (xw - base) + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(gbase + (xw - base) + C::XT + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    fence_async_smem();
    __syncthreads();

    // issue G = C.B^T and Yi = C.state^T (group 1), then the state update
    // (group 2), on the decayed state
    const float decay = expf(cum[L - 1]);
#pragma unroll
    for (int m = 0; m < NCH; ++m)
#pragma unroll
      for (int i = 0; i < NP; ++i) st[m][i] *= decay;
#pragma unroll
    for (int m = 0; m < NCH; ++m) fence_regs(st[m]);
    float gm[32], yi[NP], yv[NP];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint64_t dch = desc(kstep(chi, L, kk)), dbh = desc(kstep(bhi, L, kk));
      wgmma_ss<0>(gm, dch, dbh, kk > 0);
      if (SPLIT) {
        wgmma_ss<0>(gm, dch, desc(kstep(blo, L, kk)), 1);
        wgmma_ss<0>(gm, desc(kstep(clo, L, kk)), dbh, 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint64_t dch = desc(kstep(chi, L, kk)), dsh = desc(kstep(sth, PS, kk));
      wgmma_ss<0>(yi, dch, dsh, kk > 0);
      wgmma_ss<0>(yi, dch, desc(kstep(stl, PS, kk)), 1);
      if (SPLIT) wgmma_ss<0>(yi, desc(kstep(clo, L, kk)), dsh, 1);
    }
    wgmma_commit();
#pragma unroll
    for (int m = 0; m < NCH; ++m)
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk) {
        // B^T rows 64 m .. 64 m + 63, steps j = 16 kk ..: MN-major, 16 rows on
        const uint32_t ob = m * L * ROW + kk * 16 * ROW;
        const uint64_t dbt = desc(bhi + ob), dw = desc(xw + kk * 32);
        wgmma_ss<1>(st[m], dbt, dw, 1);
        wgmma_ss<1>(st[m], dbt, desc(xw + C::XT + kk * 32), 1);
        if (SPLIT) wgmma_ss<1>(st[m], desc(blo + ob), dw, 1);
      }
    wgmma_commit();

    // M from G: masked before the exponential, decayed, times dt_j, split
    wgmma_wait<1>();
    fence_regs(gm);
    uint32_t mh[L / 16][4], ml[L / 16][4];
    {
      const int r0 = warp * 16 + gq;
      const float cr[2] = {cum[r0], cum[r0 + 8]};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * tq + e;
          const float cc = cum[col], dc = dts[col];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& v = gm[4 * i + 2 * hh + e];
            v = col <= r0 + 8 * hh ? v * ex2((cr[hh] - cc) * LOG2E) * dc : 0.f;
          }
        }
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split2(gm[8 * kk + 2 * q], gm[8 * kk + 2 * q + 1], mh[kk][q], ml[kk][q]);
        }
    }

    // Y = M.x: (M hi + M lo) . x hi (+ M hi . x lo)
    fence_regs(mh);
    fence_regs(ml);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const uint64_t dx = desc(xt + kk * 32);
      wgmma_rs(yv, mh[kk], dx, kk > 0);
      wgmma_rs(yv, ml[kk], dx, 1);
      if (C::X_F32) wgmma_rs(yv, mh[kk], desc(xt + C::XT + kk * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yv);
    fence_regs(yi);
#pragma unroll
    for (int m = 0; m < NCH; ++m) fence_regs(st[m]);

    // y = Y + exp(cum_i) Yi, rows past S not written
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + gq + 8 * hh;
      if (c0 + r >= s) continue;
      const float e = ecum[r];
      TX* yp = y + ((size_t)h * s + c0 + r) * p + p0 + 2 * tq;
#pragma unroll
      for (int i = 0; i < PS / 8; ++i) {
        const float u = yv[4 * i + 2 * hh] + e * yi[4 * i + 2 * hh];
        const float v = yv[4 * i + 2 * hh + 1] + e * yi[4 * i + 2 * hh + 1];
        if (C::X_F32) {
          *reinterpret_cast<float2*>(yp + 8 * i) = make_float2(u, v);
        } else {
          *reinterpret_cast<uint32_t*>(yp + 8 * i) = pack_f(u, v);
        }
      }
    }

    // the new state's bf16 tiles (hi, lo), K-major [PS, NW], for the next
    // chunk's Yi: each 8 x 8 block (state rows n, columns p) of the
    // accumulator, split, stored transposed; lane l addresses row p = 8 i +
    // l % 8 of block l / 8
#pragma unroll
    for (int m = 0; m < NCH; ++m)
#pragma unroll
      for (int q4 = 0; q4 < PS / 16; ++q4) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {               // block q = 4 q4 + j: rows hh, columns i
          const int q = 4 * q4 + j, hh = q / (PS / 8), i = q % (PS / 8);
          split2(st[m][4 * i + 2 * hh], st[m][4 * i + 2 * hh + 1], hi[j], lo[j]);
        }
        const int q = 4 * q4 + (lane >> 3), hh = q / (PS / 8), i = q % (PS / 8);
        const uint32_t off = m * PS * ROW + swz(8 * i + (lane & 7), warp * 16 + 8 * hh);
        stmatrix_t4(sth + off, hi[0], hi[1], hi[2], hi[3]);
        stmatrix_t4(stl + off, lo[0], lo[1], lo[2], lo[3]);
      }
    fence_async_smem();
    __syncthreads();                              // the stage and the tiles are free
    if (tid == 0 && c + C::STAGES < nchunks) load(c + C::STAGES);
  }

  if (state_out != nullptr) {
    float* so = state_out + ((size_t)h * p + p0) * n;
#pragma unroll
    for (int m = 0; m < NCH; ++m)
#pragma unroll
      for (int i = 0; i < PS / 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int nn = 64 * m + warp * 16 + gq + 8 * hh;
            if (nn < n) so[(size_t)(8 * i + 2 * tq + e) * n + nn] = st[m][4 * i + 2 * hh + e];
          }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call and the library links no
// libcuda: the runtime hands out the driver's entry point
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 3-D map over a contiguous [outer, rows, cols] tensor, box [1, L, box_cols];
// rows past `rows` read as zeros (inside the same outer index)
bool tensor_map(CUtensorMap* map, EncodeTiled enc, CUtensorMapDataType type, int item,
                const void* ptr, long long outer, int rows, int cols, int box_cols,
                CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(outer)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * item, cuuint64_t(rows) * cols * item};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(L), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename TX, typename TB, int N>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
              void* y, void* state, void* planes, int bh, int s, int p, int n, int hpg,
              cudaStream_t stream) {
  constexpr bool SPLIT = sizeof(TB) == 4;
  constexpr int NW = N < 64 ? 64 : N;
  using C = Cfg<TX, SPLIT, NW>;
  const int groups = bh / hpg;
  const long long rows = (long long)groups * s;
  ssd_split_bc<TB><<<int(min(4096ll, (rows * NW + 255) / 256)), 256, 0, stream>>>(
      static_cast<const TB*>(b), static_cast<const TB*>(c),
      static_cast<__nv_bfloat16*>(planes), rows, n, NW, SPLIT);
  // the scratch: the B/C planes, then the chunk vectors
  const int nchunks = (s + L - 1) / L;
  float* vec = reinterpret_cast<float*>(static_cast<__nv_bfloat16*>(planes) +
                                        (size_t)C::NBC * rows * NW);
  ssd_chunk_vec<<<int(((long long)bh * nchunks * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a), vec, bh, s, nchunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tmx, tmbc;
  if (!tensor_map(&tmx, enc, tma_type<TX>(), int(sizeof(TX)), x, bh, s, p, PS,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&tmbc, enc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, planes,
                  (long long)C::NBC * groups, s, NW, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(ssd_wgmma<TX, SPLIT, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return int(e);
  ssd_wgmma<TX, SPLIT, N><<<bh * (p / PS), THREADS, C::SMEM, stream>>>(
      tmx, tmbc, vec, static_cast<TX*>(y), static_cast<float*>(state), s, p, n, hpg, groups);
  return int(cudaGetLastError());
}

template <typename TX, typename TB>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           void* y, void* state, void* planes, int bh, int s, int p, int n, int hpg,
           void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (hpg <= 0 || bh % hpg != 0 || p % PS != 0 || p > 128)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return launch_n<TX, TB, 16>(x, dt, a, b, c, y, state, planes, bh, s, p, n, hpg, st);
    case 32: return launch_n<TX, TB, 32>(x, dt, a, b, c, y, state, planes, bh, s, p, n, hpg, st);
    case 64: return launch_n<TX, TB, 64>(x, dt, a, b, c, y, state, planes, bh, s, p, n, hpg, st);
    case 128: return launch_n<TX, TB, 128>(x, dt, a, b, c, y, state, planes, bh, s, p, n, hpg, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TX>
int launch_x(const void* x, const void* dt, const void* a, const void* b, const void* c,
             void* y, void* state, void* planes, int bh, int s, int p, int n, int hpg,
             int bc_bf16, void* stream) {
  return bc_bf16 ? launch<TX, __nv_bfloat16>(x, dt, a, b, c, y, state, planes, bh, s, p, n,
                                             hpg, stream)
                 : launch<TX, float>(x, dt, a, b, c, y, state, planes, bh, s, p, n, hpg,
                                     stream);
}

template <typename TX, bool SPLIT>
int smem_of(int n) {
  return n <= 64 ? Cfg<TX, SPLIT, 64>::SMEM : Cfg<TX, SPLIT, 128>::SMEM;
}

}  // namespace

extern "C" {

// x/y [bh, s, p] (f32 or bf16), dt [bh, s] f32, a [bh] f32, b/c [bh / hpg, s, n]
// (f32, or bf16 where bc_bf16), state [bh, p, n] f32 or null, planes a
// 16-byte-aligned scratch of (bc_bf16 ? 2 : 4) x (bh / hpg) x s x max(n, 64)
// bf16 and then bh x ceil(s / 64) x 256 floats; all contiguous, x 16-byte
// aligned.
int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* b,
                 const void* c, void* y, void* state, void* planes, int bh, int s, int p,
                 int n, int heads_per_group, int bc_bf16, void* stream) {
  return launch_x<float>(x, dt, a, b, c, y, state, planes, bh, s, p, n, heads_per_group,
                         bc_bf16, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* b,
                  const void* c, void* y, void* state, void* planes, int bh, int s, int p,
                  int n, int heads_per_group, int bc_bf16, void* stream) {
  return launch_x<__nv_bfloat16>(x, dt, a, b, c, y, state, planes, bh, s, p, n,
                                 heads_per_group, bc_bf16, stream);
}

// the dynamic shared memory the kernel sets for x in bf16 (or f32), B/C in
// bf16 (or f32) and state dim n, for the wrapper's plan to be checked
// against
int ssd_scan_smem(int x_bf16, int bc_bf16, int n) {
  if (x_bf16)
    return bc_bf16 ? smem_of<__nv_bfloat16, false>(n) : smem_of<__nv_bfloat16, true>(n);
  return bc_bf16 ? smem_of<float, false>(n) : smem_of<float, true>(n);
}

}  // extern "C"
