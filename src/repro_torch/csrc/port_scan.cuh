// The port-state scans shared by csrc/xbar.cu (the crossbar contention
// scan) and csrc/netsim.cu (the admission-gated replay): one warp per
// candidate row, a row's port state kept on chip, two schedules.
//
// Per event k of the shared, time-sorted timeline, with i = src[k],
// j = dst[k] and the row's s = svc[k, b], the departure is
// d = Step::dep(in[i], out[j], t_k, pipe_b, s) in the reference's order, and
// d goes back to in[i] and out[j] (only where admit[k, b] in the gated
// forms).  The slack forms first decay every port, x <- max(x - dt_k, 0),
// as the reference does each step.  Both schedules apply that step to the
// same operands, so the results are the reference's bits.
//
// port_scan, one event a step (the slack forms): lane p holds port p's in
// and out values in registers; the step reads in[i] and out[j] by two
// broadcast shuffles from the lanes that hold them, every lane computes d,
// and the two owning lanes take it by select.  On the dependent chain there
// is no shared-memory access, no __syncwarp and no branch.  Port p sits in
// lane p & 31, slot p >> 5: SLOTS (ceil(n_ports / 32) rounded up to 1, 2,
// 4 or 8) slots live in registers, picked by unrolled compares; SLOTS == 0
// keeps each lane's slots in its own column of shared memory (n_ports above
// 256), which only that lane reads or writes.  The decay of every port
// every event is on the chain: each port's value passes through m decays.
//
// port_scan_levels, a 32-event group by levels (the absolute forms, which
// have no decay): event k waits only for the last earlier admitted event
// with its source and the last with its destination, so the group runs as
// the levels of that graph, lane k holding event k0 + k (see the kernel).
//
// Off the chain in both: each lane loads one event of the next 32-event
// group (t, the row's svc and admit, the ports) while the current group
// runs.  port_scan stages the group in shared memory and reads each event
// at one address on every lane; port_scan_levels keeps each lane's own
// event.  A group's 32 departures are written at once, coalesced, into
// out[B, m].  In port_scan, events past m in the last group run with zeros;
// they come after every real event, so they change no result, and their
// departures are not stored.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spac {

constexpr int SCAN_WARPS = 4;     // candidate rows per block, one warp each
constexpr unsigned SCAN_FULL = 0xFFFFFFFFu;

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

// One lane's share of a row's port array (in or out).
template <typename T, int SLOTS>
struct PortLane {
  T r[SLOTS > 0 ? SLOTS : 1];
  T* col;                          // SLOTS == 0: this lane's column, stride 32

  __device__ __forceinline__ void init(T* smem_col, int nslots) {
#pragma unroll
    for (int s = 0; s < (SLOTS > 0 ? SLOTS : 1); ++s) r[s] = T(0);
    col = smem_col;
    if constexpr (SLOTS == 0)
      for (int s = 0; s < nslots; ++s) col[32 * s] = T(0);
  }

  // port p's value, broadcast to every lane
  __device__ __forceinline__ T get(int p) const {
    const int slot = p >> 5;
    T v = r[0];
    if constexpr (SLOTS == 0) {
      v = col[32 * slot];
    } else {
#pragma unroll
      for (int s = 1; s < SLOTS; ++s) v = slot == s ? r[s] : v;
    }
    return __shfl_sync(SCAN_FULL, v, p & 31);
  }

  // port p <- d where `on` (the same on every lane)
  __device__ __forceinline__ void set(int p, T d, bool on, int lane) {
    const bool own = on && lane == (p & 31);
    const int slot = p >> 5;
    if constexpr (SLOTS == 0) {
      if (own) col[32 * slot] = d;
    } else {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) r[s] = own && slot == s ? d : r[s];
    }
  }

  // every port x <- max(x - dt, 0)
  __device__ __forceinline__ void decay(T dt, int nslots) {
    if constexpr (SLOTS == 0) {
      for (int s = 0; s < nslots; ++s) col[32 * s] = vmax(col[32 * s] - dt, T(0));
    } else {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) r[s] = vmax(r[s] - dt, T(0));
    }
  }
};

// One lane's event of a 32-event group.
template <typename T>
struct Event {
  T t;          // t or now (absolute), dt or dnow (slack)
  T s;          // this row's service time
  int ports;    // src | dst << 16 (ports below 65,536)
  int admit;
};

template <typename T, bool GATED>
__device__ __forceinline__ Event<T> load_event(const T* __restrict__ tdt,
                                               const int32_t* __restrict__ src,
                                               const int32_t* __restrict__ dst,
                                               const T* __restrict__ svc,
                                               const uint8_t* __restrict__ admit, int k,
                                               int m, int B, int row) {
  Event<T> e{T(0), T(0), 0, 0};
  if (k < m) {
    const size_t g = size_t(k) * B + row;
    e.t = tdt[k];
    e.s = svc[g];
    e.ports = src[k] | (dst[k] << 16);
    e.admit = GATED ? int(admit[g]) : 1;
  }
  return e;
}

// The scan: Step gives the departure (Step::dep) and whether every port
// decays each event (Step::DECAY).  pipe may be null where Step ignores it.
template <class Step, typename T, bool GATED, int SLOTS>
__global__ void __launch_bounds__(SCAN_WARPS * 32)
port_scan(const T* __restrict__ tdt, const int32_t* __restrict__ src,
          const int32_t* __restrict__ dst, const T* __restrict__ svc,
          const uint8_t* __restrict__ admit, const T* __restrict__ pipe,
          T* __restrict__ out, int m, int B, int nslots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Event<T> stage[SCAN_WARPS][32];   // each warp's current group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * SCAN_WARPS + warp;
  if (row >= B) return;                 // no block-wide barrier follows
  T* cells = reinterpret_cast<T*>(smem) + size_t(warp) * 2 * 32 * nslots + lane;
  PortLane<T, SLOTS> in, outp;
  in.init(cells, nslots);
  outp.init(cells + 32 * nslots, nslots);
  const T pp = pipe != nullptr ? pipe[row] : T(0);

  Event<T> cur = load_event<T, GATED>(tdt, src, dst, svc, admit, lane, m, B, row);
  for (int k0 = 0; k0 < m; k0 += 32) {
    Event<T> nxt{T(0), T(0), 0, 0};
    if (k0 + 32 < m)                     // the next group's loads go out first
      nxt = load_event<T, GATED>(tdt, src, dst, svc, admit, k0 + 32 + lane, m, B, row);
    T keep = T(0);
    __syncwarp();                        // the last group's events are read
    stage[warp][lane] = cur;
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < 32; ++kk) {
      const Event<T> ev = stage[warp][kk];          // the same address on every lane
      const T tk = ev.t, s = ev.s;
      const int ports = ev.ports;
      const bool ad = GATED ? ev.admit != 0 : true;
      const int i = ports & 0xFFFF, j = int(unsigned(ports) >> 16);
      if constexpr (Step::DECAY) {
        in.decay(tk, nslots);
        outp.decay(tk, nslots);
      }
      const T d = Step::dep(in.get(i), outp.get(j), tk, pp, s);
      in.set(i, d, ad, lane);
      outp.set(j, d, ad, lane);
      keep = lane == kk ? d : keep;
    }
    if (k0 + lane < m) out[size_t(row) * m + k0 + lane] = keep;
    cur = nxt;
  }
}

// The forms without the decay (the absolute forms), by levels.  Event k
// waits only for the last earlier admitted event with its source and the
// last with its destination, so a 32-event group runs as its dependency
// graph's levels, not as 32 steps: lane k holds event k0 + k; lanes whose
// in-group writers are done compute their departure together, reading
// the writers' departures by shuffle (or the port state the group found,
// where the writer is in an earlier group); a ballot marks them done.  The
// step is the serial scan's, on the same operands, so the results are the
// same bits.  Each row's port state sits in shared memory (a flat array of
// n_ports per warp): gathered once by every lane at the start of a group,
// and written once at its end by the last admitted writer of each port.
template <class Step, typename T, bool GATED>
__global__ void __launch_bounds__(SCAN_WARPS * 32)
port_scan_levels(const T* __restrict__ tdt, const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst, const T* __restrict__ svc,
                 const uint8_t* __restrict__ admit, const T* __restrict__ pipe,
                 T* __restrict__ out, int m, int B, int n_ports) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * SCAN_WARPS + warp;
  if (row >= B) return;                 // no block-wide barrier follows
  T* in_f = reinterpret_cast<T*>(smem) + size_t(warp) * 2 * n_ports;
  T* out_f = in_f + n_ports;
  for (int p = lane; p < n_ports; p += 32) in_f[p] = out_f[p] = T(0);
  const T pp = pipe != nullptr ? pipe[row] : T(0);
  const unsigned before = (1u << lane) - 1u;                 // lanes below this one
  const unsigned after = lane == 31 ? 0u : ~0u << (lane + 1);

  Event<T> cur = load_event<T, GATED>(tdt, src, dst, svc, admit, lane, m, B, row);
  for (int k0 = 0; k0 < m; k0 += 32) {
    Event<T> nxt{T(0), T(0), 0, 0};
    if (k0 + 32 < m)                     // the next group's loads go out first
      nxt = load_event<T, GATED>(tdt, src, dst, svc, admit, k0 + 32 + lane, m, B, row);
    const bool valid = k0 + lane < m;
    // lanes past m match no port and count as done from the start
    const int i = valid ? cur.ports & 0xFFFF : -1 - lane;
    const int j = valid ? int(unsigned(cur.ports) >> 16) : -1 - lane;
    const bool ad = valid && cur.admit != 0;
    const unsigned adm = __ballot_sync(SCAN_FULL, ad);
    const unsigned wi = __match_any_sync(SCAN_FULL, i) & adm;   // admitted writers of in[i]
    const unsigned wj = __match_any_sync(SCAN_FULL, j) & adm;
    const int pin = 31 - __clz(wi & before);                      // -1: none in the group
    const int pout = 31 - __clz(wj & before);
    __syncwarp();                        // the last group's writes are visible
    const T a0 = valid ? in_f[i] : T(0);
    const T o0 = valid ? out_f[j] : T(0);
    unsigned done = ~__ballot_sync(SCAN_FULL, valid);
    T d = T(0);
    while (done != SCAN_FULL) {
      const T a = __shfl_sync(SCAN_FULL, d, pin < 0 ? lane : pin);
      const T o = __shfl_sync(SCAN_FULL, d, pout < 0 ? lane : pout);
      const bool ready = !(done >> lane & 1u) && (pin < 0 || (done >> pin & 1u)) &&
                         (pout < 0 || (done >> pout & 1u));
      const T dn = Step::dep(pin < 0 ? a0 : a, pout < 0 ? o0 : o, cur.t, pp, cur.s);
      d = ready ? dn : d;
      done |= __ballot_sync(SCAN_FULL, ready);
    }
    __syncwarp();                        // every lane has gathered
    if (ad && !(wi & after)) in_f[i] = d;
    if (ad && !(wj & after)) out_f[j] = d;
    if (valid) out[size_t(row) * m + k0 + lane] = d;
    cur = nxt;
  }
}

// Register slots for n_ports (0: shared-memory columns).
inline int scan_slots(int n_ports) {
  const int s = (n_ports + 31) / 32;
  return s <= 1 ? 1 : s <= 2 ? 2 : s <= 4 ? 4 : s <= 8 ? 8 : 0;
}

// Whether a form runs by levels: every form without the decay (the decay
// touches every port each event, so the slack forms stay serial).
template <class Step>
constexpr bool by_levels() { return !Step::DECAY; }

// Dynamic shared memory one block of a form takes at n_ports: the level
// schedule's port arrays, or the serial scan's slot columns past 256 ports.
template <class Step, typename T>
size_t scan_smem_bytes(int n_ports) {
  if (by_levels<Step>()) return size_t(SCAN_WARPS) * 2 * n_ports * sizeof(T);
  return scan_slots(n_ports) != 0
             ? 0
             : size_t(SCAN_WARPS) * 2 * 32 * ((n_ports + 31) / 32) * sizeof(T);
}

template <class Step, typename T, bool GATED, int SLOTS>
int scan_launch_slots(const void* tdt, const void* src, const void* dst, const void* svc,
                      const void* admit, const void* pipe, void* out, int m, int B,
                      int n_ports, void* stream) {
  auto kern = port_scan<Step, T, GATED, SLOTS>;
  const size_t smem = scan_smem_bytes<Step, T>(n_ports);
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int blocks = (B + SCAN_WARPS - 1) / SCAN_WARPS;
  kern<<<blocks, SCAN_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tdt), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<const T*>(svc),
      static_cast<const uint8_t*>(admit), static_cast<const T*>(pipe),
      static_cast<T*>(out), m, B, (n_ports + 31) / 32);
  return int(cudaGetLastError());
}

template <class Step, typename T, bool GATED>
int scan_launch(const void* tdt, const void* src, const void* dst, const void* svc,
                const void* admit, const void* pipe, void* out, int m, int B,
                int n_ports, void* stream) {
  if constexpr (by_levels<Step>()) {
    auto kern = port_scan_levels<Step, T, GATED>;
    const size_t smem = scan_smem_bytes<Step, T>(n_ports);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    const int blocks = (B + SCAN_WARPS - 1) / SCAN_WARPS;
    kern<<<blocks, SCAN_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(tdt), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(dst), static_cast<const T*>(svc),
        static_cast<const uint8_t*>(admit), static_cast<const T*>(pipe),
        static_cast<T*>(out), m, B, n_ports);
    return int(cudaGetLastError());
  } else {
    switch (scan_slots(n_ports)) {
      case 1:
        return scan_launch_slots<Step, T, GATED, 1>(tdt, src, dst, svc, admit, pipe, out,
                                                    m, B, n_ports, stream);
      case 2:
        return scan_launch_slots<Step, T, GATED, 2>(tdt, src, dst, svc, admit, pipe, out,
                                                    m, B, n_ports, stream);
      case 4:
        return scan_launch_slots<Step, T, GATED, 4>(tdt, src, dst, svc, admit, pipe, out,
                                                    m, B, n_ports, stream);
      case 8:
        return scan_launch_slots<Step, T, GATED, 8>(tdt, src, dst, svc, admit, pipe, out,
                                                    m, B, n_ports, stream);
      default:
        return scan_launch_slots<Step, T, GATED, 0>(tdt, src, dst, svc, admit, pipe, out,
                                                    m, B, n_ports, stream);
    }
  }
}

// One thread through `steps` dependent steps of Step (with the decay where
// Step has one; the decay alone where DEP is false), its operands in
// registers: the latency of one step, which chip_smoke.py multiplies by the
// timeline's dependency depth (and, for the decay, by m) for the chain
// bound.  io[0..4]: x0, o, t, pipe, s (dt for the decay is t); io[0] gets
// the result, so the chain is not dead code.
template <class Step, typename T, bool DEP>
__global__ void port_chain(T* io, int steps) {
  T x = io[0];
  const T o = io[1], tk = io[2], pp = io[3], s = io[4];
  for (int k = 0; k < steps; ++k) {
    if constexpr (Step::DECAY) x = vmax(x - tk, T(0));
    if constexpr (DEP) x = Step::dep(x, o, tk, pp, s);
  }
  io[0] = x;
}

template <class Step, typename T>
int chain_launch(void* io, int steps, bool dep, void* stream) {
  auto kern = port_chain<Step, T, true>;
  if constexpr (Step::DECAY) {
    if (!dep) kern = port_chain<Step, T, false>;
  }
  kern<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<T*>(io), steps);
  return int(cudaGetLastError());
}

}  // namespace spac
