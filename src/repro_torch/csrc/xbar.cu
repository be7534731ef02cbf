// Greedy-crossbar contention scan for Hopper (sm_90a), one candidate row per
// warp, each row's port state in its lanes' registers.
//
// Replaces the JAX package's kernels/xbar family: the Pallas tile
// kernels/xbar/kernel.py (_xbar_kernel, xbar_contend_padded; float32 slack
// form) and the float64 lax.scan twin it sits beside,
// kernels/xbar/ref.py:xbar_contend_abs_ref (the form stage 2 runs).
//
// Per event k of the shared, time-sorted trace and per candidate row b:
//   ABSOLUTE (float64):  dep = max(max(in[i], out[j]), t_k) + svc[k, b]
//   slack    (float32):  every port slack <- max(slack - dt_k, 0), then
//                        dep = max(in[i], out[j]) + svc[k, b]
// and dep is written back to in[i] and out[j].  Both forms repeat the
// reference's add/max sequence exactly (build with -fmad=false): the results
// are bitwise equal to the oracles.  The per-step decay of every port is
// part of that contract; a lazy decay would round differently.
//
// What bounds it: the dependent chain through one row's port state, not
// bandwidth.  Each event reads svc and writes dep once (16 bytes per row
// and event in float64), far below the card's memory rate; parallelism
// exists only across candidate rows (B <= 480 on the DSE's path, one warp
// each).  So the time is the chain's length times the latency of one link.
// The design (csrc/port_scan.cuh, shared with csrc/netsim.cu) shortens both:
// the absolute form runs each 32-event group by levels of its dependency
// graph (an event waits only for the last writers of its two ports), so the
// chain is the timeline's depth L, not m; the slack form, whose per-event
// decay touches every port, runs one event a step with the port state in
// registers (lane p holds port p; two broadcast shuffles read it and a
// select writes it back).
//
// Tried (tests/torch_scan_ab.py on one H100; PERF.md, PR 18): the PR 11
// layout (port state in shared memory, read back after each event's store,
// three __syncwarp()s and a lane-0 store on the chain) ran 113-127 ns an
// event at hft's shape; the register layout one event a step, ~56 ns (the
// slack form's schedule, applied to the absolute form); by levels, ~28 ns.  No faster: fmax for the float64 maxima (slower: the compare and
// select it replaces is already the cheapest float64 max), a predicated
// store in place of the select, and broadcasting each event's timeline
// values by shuffle rather than from shared memory at one address.

#include <cuda_runtime.h>
#include <stdint.h>

#include "port_scan.cuh"

namespace {

using spac::vmax;

struct XbarAbs {                   // float64 absolute times
  static constexpr bool DECAY = false;
  template <typename T>
  static __device__ __forceinline__ T dep(T a, T o, T tk, T, T s) {
    return vmax(vmax(a, o), tk) + s;
  }
};

struct XbarSlack {                 // float32 slacks, every port decayed first
  static constexpr bool DECAY = true;
  template <typename T>
  static __device__ __forceinline__ T dep(T a, T o, T, T, T s) {
    return vmax(a, o) + s;
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory one block of the float64 (dtype_bytes 8) or
// float32 form needs, for the wrapper's size check.
long long xbar_smem_bytes(int n_ports, int dtype_bytes) {
  return dtype_bytes == 8 ? (long long)spac::scan_smem_bytes<XbarAbs, double>(n_ports)
                           : (long long)spac::scan_smem_bytes<XbarSlack, float>(n_ports);
}

int xbar_scan_abs_f64(const void* t, const void* src, const void* dst,
                      const void* svc, void* dep, int m, int B, int n_ports,
                      void* stream) {
  return spac::scan_launch<XbarAbs, double, false>(t, src, dst, svc, nullptr, nullptr,
                                                   dep, m, B, n_ports, stream);
}

int xbar_scan_slack_f32(const void* dt, const void* src, const void* dst,
                        const void* svc, void* dep, int m, int B, int n_ports,
                        void* stream) {
  return spac::scan_launch<XbarSlack, float, false>(dt, src, dst, svc, nullptr, nullptr,
                                                    dep, m, B, n_ports, stream);
}

// `steps` dependent steps of one form on one thread (io: x0, o, t, pipe, s
// in the form's dtype; io[0] gets the result): the latency of one step.
// form 1: the float64 absolute step; 0: the float32 slack step (its decay
// and its departure); 2: the slack step's decay alone.
int xbar_chain(int form, void* io, int steps, void* stream) {
  return form == 1 ? spac::chain_launch<XbarAbs, double>(io, steps, true, stream)
                   : spac::chain_launch<XbarSlack, float>(io, steps, form == 0, stream);
}

}  // extern "C"
