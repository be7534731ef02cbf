// Protocol header parser for Hopper (sm_90a): tiles of rows streamed through
// shared memory.
//
// Replaces the JAX package's generated Pallas parser,
// kernels/parser/kernel.py:make_parser (its _kernel closure), which bakes a
// protocol's bit offsets into the kernel at trace time.  Here the same
// lowering (bake_slices: field -> pieces (word, lo, take, dst_shift)) travels
// with the launch as a __grid_constant__ parameter (Table below), so one
// compiled kernel serves every protocol and every thread reads the table
// from the constant bank, uniformly, with nothing staged before the first
// row.  The switch's own parse runs at ingress inside csrc/switch_loop.cu;
// this kernel is the batch parser of kernels/parser.
//
// Per header row b and field f:
//   v = OR over f's pieces of ((words[b, word] >> lo) & mask(take)) << dst_shift
// in 32-bit unsigned arithmetic, exactly the reference's uint32 sequence.
//
// What bounds it: bytes.  Each header is read once (W words) and each field
// written once (F words), 4 (W + F) bytes a row, against a handful of
// integer operations per piece.  One thread a row reading words[b * W + w]
// straight from device memory would make every warp-wide load span 32 rows
// of W words and every store 32 rows of F words.  Instead:
//   * a block's tile of R rows (R * W words, contiguous in device memory)
//     arrives in shared memory by one TMA bulk copy (cp.async.bulk,
//     completing on an mbarrier), STAGES_IN tiles ahead; the grid has at
//     most four blocks per SM, each walking its tiles, so the copies of its
//     next tiles are in flight while it extracts one; a batch too small to
//     fill the SMs is cut into smaller tiles, one pass of one tile a block;
//   * a thread extracts its rows' fields from shared memory (thread t reads
//     word w of row t at bank (t * W + w) mod 32: distinct banks for odd W,
//     as in every registry protocol; an even W costs a gcd(W, 32)-way
//     conflict, which a bulk copy cannot pad away) into an [R, F] output
//     tile, also in shared memory;
//   * the output tile leaves by one TMA bulk store (cp.async.bulk ...
//     bulk_group), two output tiles in flight.
// A tile whose bytes the bulk copy cannot take (a base pointer not 16-byte
// aligned, or a last tile whose R * W or R * F words are not a multiple of
// four) is copied by the block's threads instead, word by word, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PIECES = 256;
constexpr int STAGES_IN = 3;        // input tiles in flight, one mbarrier each
constexpr int STAGES_OUT = 2;
constexpr int BARRIER_BYTES = 64;
constexpr int LAST = 0x80;          // Piece.dst: the last piece of its field

// one piece of a field: ((word's value >> lo) & mask) << (dst & 31); the
// field's value is complete after its piece with LAST set
struct Piece {
  uint32_t mask;
  uint16_t word;
  uint8_t lo;
  uint8_t dst;
};

// the protocol's baked pieces, field after field, each field at least one
// (kernels/parser/kernel.py packs it and checks that a row has the words
// it reads)
struct Table {
  Piece piece[MAX_PIECES];
  int32_t n_fields;
  int32_t n_pieces;
  int32_t min_words;   // 1 + the largest word a piece reads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
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

// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned) into shared
// memory; completes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// `bytes` contiguous bytes of shared memory out to device memory, as one
// bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most one bulk store is still reading its shared memory
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the threads' shared-memory writes become visible to the bulk store's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS)
parse_kernel(const uint32_t* __restrict__ words,   // [B, W]
             uint32_t* __restrict__ out,           // [B, F]
             const __grid_constant__ Table tab, long long B, int W, int R,
             long long n_tiles, int aligned_in, int aligned_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint32_t* in_s = reinterpret_cast<uint32_t*>(smem + BARRIER_BYTES);  // [STAGES_IN][R * W]
  const int F = tab.n_fields, P = tab.n_pieces;
  uint32_t* out_s = in_s + STAGES_IN * R * W;                          // [STAGES_OUT][R * F]
  const int tid = threadIdx.x;
  const long long mine = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  // tile k of this block: rows R * t .. of global tile t
  auto tile_of = [&](long long k) { return blockIdx.x + k * (long long)gridDim.x; };
  auto rows_of = [&](long long t) { return (int)min((long long)R, B - t * R); };
  auto bulk_in = [&](long long t) { return aligned_in && (rows_of(t) * W) % 4 == 0; };
  auto issue = [&](long long k) {          // thread 0: tile k's copy into its stage
    const long long t = tile_of(k);
    const int s = (int)(k % STAGES_IN);
    const uint32_t bytes = (uint32_t)rows_of(t) * W * 4u;
    const uint32_t b = smem_u32(&bar[s]);
    mbar_expect_tx(b, bytes);
    bulk_load(smem_u32(in_s + s * R * W), words + t * R * W, bytes, b);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES_IN; ++s) mbar_init(smem_u32(&bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long k = 0; k < min((long long)STAGES_IN, mine); ++k)
      if (bulk_in(tile_of(k))) issue(k);
  }
  __syncthreads();

  for (long long k = 0; k < mine; ++k) {
    const long long t = tile_of(k);
    const int n = rows_of(t);
    const int s = (int)(k % STAGES_IN);
    uint32_t* tin = in_s + s * R * W;
    uint32_t* tout = out_s + (int)(k % STAGES_OUT) * R * F;
    const bool copied = bulk_in(t);
    if (!copied) {
      const uint32_t* src = words + t * R * W;
      for (int i = tid; i < n * W; i += THREADS) tin[i] = src[i];
    }
    if (tid == 0) bulk_wait_read_1();     // the store of tile k - 2 has left tout
    __syncthreads();
    if (copied) mbar_wait(smem_u32(&bar[s]), (uint32_t)((k / STAGES_IN) & 1));

    for (int r = tid; r < n; r += THREADS) {
      const uint32_t* row = tin + r * W;
      uint32_t* dst = tout + r * F;
      uint32_t v = 0u;
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        const Piece pc = tab.piece[p];
        v |= ((row[pc.word] >> pc.lo) & pc.mask) << (pc.dst & 31);
        if (pc.dst & LAST) {
          *dst++ = v;
          v = 0u;
        }
      }
    }
    fence_async_smem();
    __syncthreads();                      // tin read, tout written

    if (tid == 0 && k + STAGES_IN < mine && bulk_in(tile_of(k + STAGES_IN)))
      issue(k + STAGES_IN);
    uint32_t* gout = out + t * R * F;
    if (aligned_out && (n * F) % 4 == 0) {
      if (tid == 0) bulk_store(gout, smem_u32(tout), (uint32_t)n * F * 4u);
    } else {
      for (int i = tid; i < n * F; i += THREADS) gout[i] = tout[i];
    }
  }
  if (tid == 0) bulk_wait_all();
}

}  // namespace

extern "C" {

int parser_table_bytes() { return int(sizeof(Table)); }

// Parse B rows of W words into B rows of the table's fields on `stream`:
// tiles of R rows, `blocks` blocks (at most one per tile), `smem_bytes` of
// dynamic shared memory (kernels/parser/kernel.py's plan sizes them).
// `table` is a host pointer; its bytes become the launch's parameter.
// Returns the CUDA error code of the launch (0: launched).
int parse_headers_u32(const void* words, void* out, const void* table, long long B,
                      int W, int R, int blocks, int smem_bytes, void* stream) {
  if (B == 0) return 0;
  static int smem_set[64] = {};          // per device: the largest size allowed so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= 64 || smem_bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return int(err);
    if (dev < 64) smem_set[dev] = smem_bytes;
  }
  const Table& tab = *static_cast<const Table*>(table);
  const long long n_tiles = (B + R - 1) / R;
  const int aligned_in = (reinterpret_cast<uintptr_t>(words) % 16) == 0;
  const int aligned_out = (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  parse_kernel<<<blocks, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), tab, B, W, R,
      n_tiles, aligned_in, aligned_out);
  return int(cudaGetLastError());
}

}  // extern "C"
