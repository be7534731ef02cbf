// Protocol header parser for Hopper (sm_90a), one thread per packet header.
//
// Replaces the JAX package's generated Pallas parser,
// kernels/parser/kernel.py:make_parser (its _kernel closure), which bakes a
// protocol's bit offsets into the kernel at trace time.  Here the same
// lowering (bake_slices: field -> pieces (word, lo, take, dst_shift)) is
// passed in as a small int32 table instead, so one compiled kernel serves
// every protocol.  Generating a source specialised per protocol (the
// paper's compile-time template, with the shifts as immediates) is later
// work.
//
// Per header row b and field f:
//   v = OR over f's pieces of ((words[b, word] >> lo) & mask(take)) << dst_shift
// in 32-bit unsigned arithmetic, exactly the reference's uint32 sequence.
//
// What bounds it: bytes.  Each header is read once (W words) and each field
// written once (F words): 4 (W + F) bytes per row, a handful of integer
// operations per piece.  The design keeps the table in shared memory (read
// by every thread of the block) and gives each thread one row, so a warp
// reads 32 consecutive rows of W words; with W <= ~16 those reads fall in a
// few cache lines.  At B = 1 the launch latency is the floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PIECES = 512;   // (field, word, lo, take, dst_shift) rows

__global__ void __launch_bounds__(THREADS)
parse_kernel(const uint32_t* __restrict__ words,   // [B, W]
             const int32_t* __restrict__ table,    // [P, 5]
             const int32_t* __restrict__ first,    // [F + 1] piece offsets
             uint32_t* __restrict__ out,           // [B, F]
             long long B, int W, int F, int P) {
  __shared__ int32_t s_tab[MAX_PIECES * 5];
  __shared__ int32_t s_first[MAX_PIECES + 1];
  for (int i = threadIdx.x; i < P * 5; i += blockDim.x) s_tab[i] = table[i];
  for (int i = threadIdx.x; i <= F; i += blockDim.x) s_first[i] = first[i];
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t* row = words + b * W;
  for (int f = 0; f < F; ++f) {
    uint32_t v = 0u;
    for (int p = s_first[f]; p < s_first[f + 1]; ++p) {
      const int word = s_tab[p * 5 + 1];
      const int lo = s_tab[p * 5 + 2];
      const int take = s_tab[p * 5 + 3];
      const int dst_shift = s_tab[p * 5 + 4];
      const uint32_t mask = take >= 32 ? 0xFFFFFFFFu : ((1u << take) - 1u);
      v |= ((row[word] >> lo) & mask) << dst_shift;
    }
    out[b * F + f] = v;
  }
}

}  // namespace

extern "C" {

int parser_max_pieces() { return MAX_PIECES; }

int parse_headers_u32(const void* words, const void* table, const void* first,
                      void* out, long long B, int W, int F, int P,
                      void* stream) {
  if (B == 0) return 0;
  const long long blocks = (B + THREADS - 1) / THREADS;
  parse_kernel<<<(unsigned)blocks, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(first), static_cast<uint32_t*>(out), B, W,
      F, P);
  return int(cudaGetLastError());
}

}  // extern "C"
