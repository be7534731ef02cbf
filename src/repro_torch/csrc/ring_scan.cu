// The ring-scan stage-4 engine for Hopper (sm_90a): the finite-VOQ admission
// scan, one candidate row per warp.
//
// Replaces the JAX package's sim/batched_netsim.py:_verify_engine_impl, the
// float64 lax.scan that use_kernel="off" selects (the reference wrote it in
// plain lax, not Pallas: an irregular gather/scatter state machine whose
// contract is float64 exactness).  Per event k of the shared, time-sorted
// timeline (t = now[k], i = src[k], j = dst[k], q = i * N + j) and per row b
// (s = svc[k, b]):
//
//   tq     = tail[q]                          admissions so far to VOQ q
//   oldest = ring[q, tq % mod[b]]             the depth-ago admission's end
//   full   = tq >= depth[b] && oldest > t
//   end    = max(max(t + pipe[b], in[i]), out[j]) + s
//   if !full: in[i] = out[j] = ring[q, tq % mod[b]] = end, tail[q] += 1
//
// in the reference's order (build with -fmad=false), so end and the
// admission flags are bitwise the reference's.  A slot never written
// reads 0.0 there (its ring starts zeroed); here it is read only once it
// has been written (tq >= mod), and 0.0 stands in before, so the ring
// needs no initialisation.
//
// Layout: lane p & 31 holds port p's in and out values (csrc/port_scan.cuh's
// PortLane: register slots up to 256 ports, shared-memory columns above);
// the row's admission counters tail[N^2] sit in shared memory while
// N^2 * 4 bytes fit beside them (TAIL_SMEM), else in a zeroed global array;
// the departure ring [N^2, d_max] float64 sits in global memory (at 32 ports
// and d_max 64 it is 512 KiB a row, more than an SM holds).  Every lane
// computes every event's step and every lane stores the same tail and ring
// values at the same address, so each lane reads back its own stores and
// no __syncwarp() sits on the chain.  The timeline and the row's svc
// column are loaded a 32-event group ahead and staged in shared memory,
// as in port_scan; a group's 32 end times and flags are written at once.
//
// What bounds it: the dependent chain, one event a step: the tail read,
// the ring read (global memory), the two maxima and the add, the writes.
// Parallelism is only across rows.  See chip_smoke.py's kernels phase for
// the measured step latency (ring_chain below) and the chain bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "port_scan.cuh"

namespace {

using spac::Event;
using spac::PortLane;
using spac::vmax;

constexpr int RING_WARPS = 1;     // one row per block: B blocks spread over SMs

// Dynamic shared memory: the port columns (SLOTS == 0) then the tail.
size_t ring_smem_bytes(int n_ports, bool tail_smem) {
  const size_t cols = spac::scan_slots(n_ports) == 0
                          ? size_t(2) * 32 * ((n_ports + 31) / 32) * sizeof(double)
                          : 0;
  return cols + (tail_smem ? size_t(n_ports) * n_ports * sizeof(int32_t) : 0);
}

template <int SLOTS, bool TAIL_SMEM>
__global__ void __launch_bounds__(RING_WARPS * 32)
ring_scan_kernel(const double* __restrict__ now, const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst, const double* __restrict__ svc,
                 const double* __restrict__ pipe, const int32_t* __restrict__ depth,
                 const int32_t* __restrict__ mod, double* __restrict__ ring,
                 int32_t* __restrict__ tail_g, double* __restrict__ end,
                 uint8_t* __restrict__ admit, int m, int B, int n_ports, int d_max,
                 int nslots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Event<double> stage[32];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  if (row >= B) return;
  const int qn = n_ports * n_ports;
  double* cols = reinterpret_cast<double*>(smem);
  const size_t ncols = SLOTS == 0 ? size_t(2) * 32 * nslots : 0;
  int32_t* tail = TAIL_SMEM ? reinterpret_cast<int32_t*>(cols + ncols)
                            : tail_g + size_t(row) * qn;
  if constexpr (TAIL_SMEM)
    for (int q = lane; q < qn; q += 32) tail[q] = 0;
  PortLane<double, SLOTS> in, outp;
  in.init(cols + lane, nslots);
  outp.init(cols + 32 * nslots + lane, nslots);
  __syncwarp();                           // the zeroed tail is visible
  const double pp = pipe[row];
  const int dep = depth[row], md = mod[row];
  double* rr = ring + size_t(row) * qn * d_max;

  Event<double> cur =
      spac::load_event<double, false>(now, src, dst, svc, nullptr, lane, m, B, row);
  for (int k0 = 0; k0 < m; k0 += 32) {
    Event<double> nxt{0.0, 0.0, 0, 0};
    if (k0 + 32 < m)                      // the next group's loads go out first
      nxt = spac::load_event<double, false>(now, src, dst, svc, nullptr, k0 + 32 + lane,
                                            m, B, row);
    __syncwarp();                         // the last group's events are read
    stage[lane] = cur;
    __syncwarp();
    double keep = 0.0;
    bool keep_a = false;
    const int kn = m - k0 < 32 ? m - k0 : 32;
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const Event<double> ev = stage[kk];  // the same address on every lane
      const int i = ev.ports & 0xFFFF, j = int(unsigned(ev.ports) >> 16);
      const int q = i * n_ports + j;
      const int tq = tail[q];
      const int slot = tq % md;
      double oldest = 0.0;                // a slot not yet written reads 0.0
      if (tq >= dep && tq >= md) oldest = rr[size_t(q) * d_max + slot];
      const bool ad = !(tq >= dep && oldest > ev.t);
      const double d = vmax(vmax(ev.t + pp, in.get(i)), outp.get(j)) + ev.s;
      in.set(i, d, ad, lane);
      outp.set(j, d, ad, lane);
      if (ad) {                           // every lane: the same values
        rr[size_t(q) * d_max + slot] = d;
        tail[q] = tq + 1;
      }
      keep = lane == kk ? d : keep;
      keep_a = lane == kk ? ad : keep_a;
    }
    if (k0 + lane < m) {
      end[size_t(row) * m + k0 + lane] = keep;
      admit[size_t(row) * m + k0 + lane] = keep_a ? 1 : 0;
    }
    cur = nxt;
  }
}

template <int SLOTS, bool TAIL_SMEM>
int launch(const void* now, const void* src, const void* dst, const void* svc,
           const void* pipe, const void* depth, const void* mod, void* ring,
           void* tail, void* end, void* admit, int m, int B, int n_ports, int d_max,
           void* stream) {
  auto kern = ring_scan_kernel<SLOTS, TAIL_SMEM>;
  const size_t smem = ring_smem_bytes(n_ports, TAIL_SMEM);
  if (smem > 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kern<<<B, RING_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(now), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<const double*>(svc),
      static_cast<const double*>(pipe), static_cast<const int32_t*>(depth),
      static_cast<const int32_t*>(mod), static_cast<double*>(ring),
      static_cast<int32_t*>(tail), static_cast<double*>(end),
      static_cast<uint8_t*>(admit), m, B, n_ports, d_max, (n_ports + 31) / 32);
  return int(cudaGetLastError());
}

template <bool TAIL_SMEM>
int launch_slots(const void* now, const void* src, const void* dst, const void* svc,
                 const void* pipe, const void* depth, const void* mod, void* ring,
                 void* tail, void* end, void* admit, int m, int B, int n_ports,
                 int d_max, void* stream) {
#define SPAC_RING_LAUNCH(S)                                                              \
  return launch<S, TAIL_SMEM>(now, src, dst, svc, pipe, depth, mod, ring, tail, end,    \
                              admit, m, B, n_ports, d_max, stream)
  switch (spac::scan_slots(n_ports)) {
    case 1: SPAC_RING_LAUNCH(1);
    case 2: SPAC_RING_LAUNCH(2);
    case 4: SPAC_RING_LAUNCH(4);
    case 8: SPAC_RING_LAUNCH(8);
    default: SPAC_RING_LAUNCH(0);
  }
#undef SPAC_RING_LAUNCH
}

// One thread through `steps` dependent steps of the scan's step, every
// event on one VOQ of a row whose ring holds `mod` slots: the tail read
// (shared memory), the ring read and write (global memory), the maxima and
// the add.  io[0..5]: x0 (the port value the chain carries), o (the other
// port), t, pipe, s, and t's increment per step (t grows, so the queue both
// drops and admits); io[0] gets the result, so the chain is not dead code.
__global__ void ring_chain_kernel(double* io, double* ring, int mod, int depth,
                                  int steps) {
  __shared__ int32_t tail[1];
  tail[0] = 0;
  double x = io[0], t = io[2];
  const double o = io[1], pp = io[3], s = io[4], dt = io[5];
  for (int k = 0; k < steps; ++k) {
    const int tq = tail[0];
    const int slot = tq % mod;
    double oldest = 0.0;
    if (tq >= depth && tq >= mod) oldest = ring[slot];
    const bool ad = !(tq >= depth && oldest > t);
    const double d = vmax(vmax(t + pp, x), o) + s;
    if (ad) {
      x = d;
      ring[slot] = d;
      tail[0] = tq + 1;
    }
    t += dt;
  }
  io[0] = x;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes at n_ports with the tail in shared
// memory (tail_smem 1) or in global memory (0), for the wrapper's plan.
long long ring_scan_smem_bytes(int n_ports, int tail_smem) {
  return (long long)ring_smem_bytes(n_ports, tail_smem != 0);
}

// now [m] float64, src/dst [m] int32, svc [m, B] float64 (event-major),
// pipe [B] float64, depth/mod [B] int32, ring [B, N^2, d_max] float64 (not
// initialised), tail [B, N^2] int32 zeroed (tail_smem 0) or null -> end
// [B, m] float64 and admit [B, m] uint8.
int ring_scan_f64(const void* now, const void* src, const void* dst, const void* svc,
                  const void* pipe, const void* depth, const void* mod, void* ring,
                  void* tail, void* end, void* admit, int m, int B, int n_ports,
                  int d_max, int tail_smem, void* stream) {
  if (tail_smem)
    return launch_slots<true>(now, src, dst, svc, pipe, depth, mod, ring, nullptr, end,
                              admit, m, B, n_ports, d_max, stream);
  return launch_slots<false>(now, src, dst, svc, pipe, depth, mod, ring, tail, end,
                             admit, m, B, n_ports, d_max, stream);
}

// `steps` dependent steps of the scan's step on one thread (see
// ring_chain_kernel; ring holds at least `mod` float64): the latency of one
// step, for the chain bound.
int ring_scan_chain(void* io, void* ring, int mod, int depth, int steps, void* stream) {
  ring_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(io), static_cast<double*>(ring), mod, depth, steps);
  return int(cudaGetLastError());
}

}  // extern "C"
