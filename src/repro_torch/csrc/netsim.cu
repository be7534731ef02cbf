// Admission-gated port replay for Hopper (sm_90a), one candidate row per
// warp, each row's port state in its lanes' registers.
//
// Replaces the JAX package's kernels/netsim family: the Pallas tile
// kernels/netsim/kernel.py (_netsim_kernel, netsim_replay_padded; float32
// slack form) and the float64 lax.scan twins stage 4 runs by default,
// kernels/netsim/ops.py:_round1_body (the ungated replay of round 1) and
// kernels/netsim/ref.py:netsim_replay_abs_ref (the gated replay of later
// rounds).
//
// Per event k of the shared, time-sorted timeline and per candidate row b:
//   ABSOLUTE (float64):  end = max(max(now_k + pipe[b], in[i]), out[j]) + svc[k, b]
//   slack    (float32):  every port slack <- max(slack - dnow_k, 0), then
//                        dep = max(max(in[i], out[j]), pipe[b]) + svc[k, b]
// and the result is written back to in[i] and out[j] only where admit[k, b]
// (GATED) or always (ungated, round 1's all-admitted speculation).  Both
// forms repeat the reference's add/max sequence exactly (build with
// -fmad=false), so the results are bitwise equal to the oracles.
//
// What bounds it: the dependent chain through one row's port state, not
// bandwidth (svc and admit are read once, the result written once:
// 17 bytes per row and event in float64).  Parallelism exists only across
// candidate rows, so the time is the chain's length times the latency of
// one link.  The design is xbar's (csrc/port_scan.cuh, shared by both
// kernels): the absolute forms run each 32-event group by levels of its
// dependency graph (in the gated form over the row's admitted events: a
// refused event writes no port, so nothing waits for it); the slack form
// runs one event a step with the port state in registers, the admission
// flag joining the select that writes a port.  now_k + pipe[b] does not
// depend on the chain.
//
// Tried (tests/torch_scan_ab.py on one H100; PERF.md, PR 18): the PR 11
// layout (port state in shared memory, three __syncwarp()s and a lane-0
// store on the chain) ran ~117-127 ns an event at hft's shape; one event a
// step in registers ~49-59 ns (the slack form's schedule); by levels ~28 ns.
// See csrc/xbar.cu for what was no faster.

#include <cuda_runtime.h>
#include <stdint.h>

#include "port_scan.cuh"

namespace {

using spac::vmax;

struct NetsimAbs {                 // float64 absolute times
  static constexpr bool DECAY = false;
  template <typename T>
  static __device__ __forceinline__ T dep(T a, T o, T tk, T pp, T s) {
    return vmax(vmax(tk + pp, a), o) + s;
  }
};

struct NetsimSlack {               // float32 slacks, every port decayed first
  static constexpr bool DECAY = true;
  template <typename T>
  static __device__ __forceinline__ T dep(T a, T o, T, T pp, T s) {
    return vmax(vmax(a, o), pp) + s;
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory one block of the float64 (dtype_bytes 8) or
// float32 form needs, for the wrapper's size check.
long long netsim_smem_bytes(int n_ports, int dtype_bytes) {
  return dtype_bytes == 8 ? (long long)spac::scan_smem_bytes<NetsimAbs, double>(n_ports)
                           : (long long)spac::scan_smem_bytes<NetsimSlack, float>(n_ports);
}

// Round 1: the all-admitted (ungated) float64 replay.
int netsim_replay_abs_f64(const void* now, const void* src, const void* dst,
                          const void* svc, const void* pipe, void* end, int m,
                          int B, int n_ports, void* stream) {
  return spac::scan_launch<NetsimAbs, double, false>(now, src, dst, svc, nullptr, pipe,
                                                     end, m, B, n_ports, stream);
}

// Rounds 2+: the admission-gated float64 replay.
int netsim_replay_gated_abs_f64(const void* now, const void* src,
                                const void* dst, const void* svc,
                                const void* admit, const void* pipe, void* end,
                                int m, int B, int n_ports, void* stream) {
  return spac::scan_launch<NetsimAbs, double, true>(now, src, dst, svc, admit, pipe, end,
                                                    m, B, n_ports, stream);
}

// The Pallas tile's contract: gated float32 slack replay, departure offsets.
int netsim_replay_gated_slack_f32(const void* dnow, const void* src,
                                  const void* dst, const void* svc,
                                  const void* admit, const void* pipe,
                                  void* dep, int m, int B, int n_ports,
                                  void* stream) {
  return spac::scan_launch<NetsimSlack, float, true>(dnow, src, dst, svc, admit, pipe,
                                                     dep, m, B, n_ports, stream);
}

// `steps` dependent steps of one form on one thread (io: x0, o, now, pipe,
// s in the form's dtype; io[0] gets the result): the latency of one step.
// form 1: the float64 absolute step; 0: the float32 slack step (its decay
// and its departure); 2: the slack step's decay alone.
int netsim_chain(int form, void* io, int steps, void* stream) {
  return form == 1 ? spac::chain_launch<NetsimAbs, double>(io, steps, true, stream)
                   : spac::chain_launch<NetsimSlack, float>(io, steps, form == 0, stream);
}

}  // extern "C"
