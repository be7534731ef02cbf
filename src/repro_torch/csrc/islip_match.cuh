// Warp-level input/output matching shared by csrc/islip.cu (the batched
// iSLIP step) and csrc/switch_loop.cu (the cycle-level switch in one
// launch), so that the two run one algorithm.
//
// One warp per switch, lane p = port p, N <= 32 ports.  Lane j plays output
// j in the grant step and input j in the accept step.  Sets of ports are
// 32-bit masks: bit i of output j's `col` says that input i requests j.
// The rotating-priority pick is a rotate of the candidate mask by the
// pointer and __ffs.

#pragma once

#include <cuda_runtime.h>

namespace spac {

constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

// floor modulo: CUDA's % truncates toward zero, the reference's is floor
__device__ __forceinline__ int fmod_n(int x, int n) { return ((x % n) + n) % n; }

// first set bit of `mask` (bits 0..n-1) at or after `p`, cyclically; -1 if
// none.  0 <= p < n <= 32.
__device__ __forceinline__ int rot_pick(unsigned mask, int p, int n) {
  if (mask == 0u) return -1;
  const unsigned long long m = mask;
  const unsigned long long nmask = (1ull << n) - 1ull;   // n <= 32
  const unsigned rot = (unsigned)(((m >> p) | (m << (n - p))) & nmask);
  return (__ffs(rot) - 1 + p) % n;
}

// Lane j receives the mask of the lanes i < n whose `row` has bit j set:
// the transpose of the n x n bit matrix held one row per lane.
__device__ __forceinline__ unsigned transpose_rows(unsigned row, int n, int lane) {
  unsigned col = 0u;
  for (int j = 0; j < n; ++j) {
    const unsigned c = __ballot_sync(FULL_WARP, (row >> j) & 1u);
    if (lane == j) col = c;
  }
  return col;
}

// Lane i receives the mask of the lanes whose `target` is i (one ballot per
// port): the inputs an output chose, seen from the chosen input.
__device__ __forceinline__ unsigned gather_targets(int target, int n, int lane) {
  unsigned got = 0u;
  for (int i = 0; i < n; ++i) {
    const unsigned g = __ballot_sync(FULL_WARP, target == i);
    if (lane == i) got = g;
  }
  return got;
}

// One request/grant/accept round.  Output lane j (when `out_free`) grants
// the first input of `col` at or after its grant pointer `gp`; input lane i
// accepts the first granting output at or after its accept pointer `ap`.
// Returns the output input lane i accepted (-1: none); `grant` is output
// lane j's granted input (-1: none) and `out_acc` whether it was accepted.
// Pointers are in [0, n).
__device__ __forceinline__ int grant_accept(unsigned col, bool out_free, int gp,
                                            int ap, int n, int lane, int& grant,
                                            bool& out_acc) {
  const bool port = lane < n;
  grant = (port && out_free) ? rot_pick(col, gp, n) : -1;
  const unsigned grants = gather_targets(grant, n, lane);
  const int acc = port ? rot_pick(grants, ap, n) : -1;
  // output lane: was my grant accepted?
  const int back = __shfl_sync(FULL_WARP, acc, grant >= 0 ? grant : 0);
  out_acc = grant >= 0 && back == lane;
  return acc;
}

// `iters` iSLIP rounds on the request columns `col` (lane j: the inputs
// requesting output j).  Ports matched in a round take no part in later
// ones.  Pointers move only on first-round accepts (McKeown's rule): an
// accepted output's grant pointer to one past its input (`g_new`), an
// accepting input's accept pointer to one past its output (`a_new`); they
// keep their values otherwise.  `g0`/`a0` are the pointers in [0, n).
// Returns input lane i's matched outputs as a mask (at most one bit);
// `out_in` is output lane j's matched input (-1: none).
__device__ __forceinline__ unsigned islip_rounds(unsigned col, int g0, int a0,
                                                 int iters, int n, int lane,
                                                 int& g_new, int& a_new,
                                                 int& out_in) {
  unsigned in_busy = 0u, out_busy = 0u;    // matched inputs / outputs
  unsigned my_match = 0u;
  out_in = -1;
  for (int it = 0; it < iters; ++it) {
    int grant;
    bool out_acc;
    const int acc = grant_accept(col & ~in_busy, !((out_busy >> lane) & 1u), g0,
                                 a0, n, lane, grant, out_acc);
    if (acc >= 0) my_match |= 1u << acc;
    if (out_acc) out_in = grant;
    if (it == 0) {
      if (out_acc) g_new = (grant + 1) % n;
      if (acc >= 0) a_new = (acc + 1) % n;
    }
    in_busy |= __ballot_sync(FULL_WARP, acc >= 0);
    out_busy |= __ballot_sync(FULL_WARP, out_acc);
  }
  return my_match;
}

}  // namespace spac
