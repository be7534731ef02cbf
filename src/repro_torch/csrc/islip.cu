// Batched iSLIP matching for Hopper (sm_90a), one warp per switch instance.
//
// Replaces the JAX package's Pallas tile kernels/islip/kernel.py
// (_islip_kernel, islip_schedule_padded), whose contract is the cycle-level
// switch's scheduler step (switch/scheduler.py:_islip) vmapped over a batch.
//
// Per instance: requests req[N_in, N_out] 0/1 (already masked by busy
// ports), grant pointers gptr[N_out], accept pointers aptr[N_in].  For each
// of `iters` rounds:
//   grant   every unmatched output picks, among the unmatched inputs that
//           request it, the first at or after its grant pointer (mod N);
//   accept  every input picks, among the outputs that granted it, the first
//           at or after its accept pointer (mod N);
//   the accepted pairs join the matching.
// Pointers move only on first-round accepts (McKeown's rule): an accepted
// output's pointer goes to one past its input, an accepting input's pointer
// one past its output.  Ports matched in round 1 take no part in later
// rounds, so later rounds see the unchanged pointers either way.
//
// What bounds it: operations, and at the switch's B = 1 the launch latency.
// Each instance reads N^2 + 2N int32 and writes as many; the work is a few
// dozen warp instructions per round.  The design keeps the whole matching in
// registers as bitmasks: lane p is input p for the accept step and output p
// for the grant step.  Column masks (who requests output p) are built with
// one __ballot_sync per output; the rotating-priority pick is a rotate of
// the candidate mask by the pointer and __ffs; an input learns its grants
// with one ballot per input, and an output learns whether it was accepted
// with one shuffle.  WARPS instances share a block.  N <= 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // instances per block, one warp each
constexpr unsigned FULL = 0xFFFFFFFFu;

// floor modulo: CUDA's % truncates toward zero, the reference's is floor
__device__ __forceinline__ int fmod_n(int x, int n) { return ((x % n) + n) % n; }

// first set bit of `mask` (bits 0..n-1) at or after `p`, cyclically; -1 if none
__device__ __forceinline__ int rot_pick(unsigned mask, int p, int n) {
  if (mask == 0u) return -1;
  const unsigned long long m = mask;
  const unsigned long long nmask = (1ull << n) - 1ull;   // n <= 32
  const unsigned rot = (unsigned)(((m >> p) | (m << (n - p))) & nmask);
  return (__ffs(rot) - 1 + p) % n;
}

__global__ void __launch_bounds__(WARPS * 32)
islip_kernel(const int32_t* __restrict__ req,    // [B, N, N]
             const int32_t* __restrict__ gptr,   // [B, N]
             const int32_t* __restrict__ aptr,   // [B, N]
             int32_t* __restrict__ match,        // [B, N, N]
             int32_t* __restrict__ gout,         // [B, N]
             int32_t* __restrict__ aout,         // [B, N]
             int B, int N, int iters) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                      // whole warps leave together
  const bool port = lane < N;
  const int32_t* r = req + b * N * N;

  // lane i: its request row as a mask over outputs
  unsigned row = 0u;
  if (port)
    for (int j = 0; j < N; ++j) row |= (r[lane * N + j] != 0 ? 1u : 0u) << j;
  // lane j: who requests output j, as a mask over inputs
  unsigned col = 0u;
  for (int j = 0; j < N; ++j) {
    const unsigned c = __ballot_sync(FULL, port && ((row >> j) & 1u));
    if (lane == j) col = c;
  }

  const int g0 = port ? fmod_n(gptr[b * N + lane], N) : 0;
  const int a0 = port ? fmod_n(aptr[b * N + lane], N) : 0;
  int g_new = port ? gptr[b * N + lane] : 0;
  int a_new = port ? aptr[b * N + lane] : 0;
  unsigned in_busy = 0u, out_busy = 0u;    // matched inputs / outputs
  unsigned my_match = 0u;                  // lane i: outputs it was matched to
  for (int it = 0; it < iters; ++it) {
    // grant: output lane picks a free requesting input
    const int grant = (port && !((out_busy >> lane) & 1u))
                          ? rot_pick(col & ~in_busy, g0, N) : -1;
    // accept: input lane gathers the outputs that granted it
    unsigned grants = 0u;
    for (int i = 0; i < N; ++i) {
      const unsigned g = __ballot_sync(FULL, grant == i);
      if (lane == i) grants = g;
    }
    const int acc = port ? rot_pick(grants, a0, N) : -1;
    // output lane: was my grant accepted?
    const int src = grant >= 0 ? grant : 0;
    const int back = __shfl_sync(FULL, acc, src);
    const bool out_acc = grant >= 0 && back == lane;
    if (acc >= 0) my_match |= 1u << acc;
    if (it == 0) {
      if (out_acc) g_new = (grant + 1) % N;
      if (acc >= 0) a_new = (acc + 1) % N;
    }
    in_busy |= __ballot_sync(FULL, acc >= 0);
    out_busy |= __ballot_sync(FULL, out_acc);
  }
  if (port) {
    int32_t* m = match + b * N * N + lane * N;
    for (int j = 0; j < N; ++j) m[j] = (my_match >> j) & 1u;
    gout[b * N + lane] = g_new;
    aout[b * N + lane] = a_new;
  }
}

}  // namespace

extern "C" {

int islip_schedule_i32(const void* req, const void* gptr, const void* aptr,
                       void* match, void* gout, void* aout, int B, int N,
                       int iters, void* stream) {
  if (B == 0) return 0;
  const int blocks = (B + WARPS - 1) / WARPS;
  islip_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(req), static_cast<const int32_t*>(gptr),
      static_cast<const int32_t*>(aptr), static_cast<int32_t*>(match),
      static_cast<int32_t*>(gout), static_cast<int32_t*>(aout), B, N, iters);
  return int(cudaGetLastError());
}

}  // extern "C"
