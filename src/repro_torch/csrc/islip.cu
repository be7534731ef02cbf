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
// with one shuffle.  The rounds live in islip_match.cuh, which the fused
// switch loop (switch_loop.cu) runs too.  WARPS instances share a block.
// N <= 32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "islip_match.cuh"

namespace {

constexpr int WARPS = 4;   // instances per block, one warp each

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
  const unsigned col = spac::transpose_rows(row, N, lane);

  const int g0 = port ? spac::fmod_n(gptr[b * N + lane], N) : 0;
  const int a0 = port ? spac::fmod_n(aptr[b * N + lane], N) : 0;
  int g_new = port ? gptr[b * N + lane] : 0;
  int a_new = port ? aptr[b * N + lane] : 0;
  int out_in;
  const unsigned my_match =
      spac::islip_rounds(col, g0, a0, iters, N, lane, g_new, a_new, out_in);
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
