// The cycle-level switch for Hopper (sm_90a): every cycle of a simulation
// in one launch, one warp per simulation, lane p = port p.
//
// Replaces the JAX package's jitted lax.scan over cycles
// (src/repro/switch/switch.py:214, simulate's cycle_step) together with the
// Pallas iSLIP tile it reaches (src/repro/kernels/islip/kernel.py:73,
// islip_schedule_padded).  The plain version is the eager PyTorch loop,
// repro_torch/kernels/switch_loop/ref.py, and this kernel is held to it bit
// for bit.
//
// One cycle, as the reference steps it: parse the arriving packets'
// headers (the routing and src keys, from the words their baked pieces
// name); the forward table learns src -> port (full lookup: the highest
// lane wins an address two lanes learn; multi-bank hash: in
// port order, so a later port sees an earlier port's insert) and looks up
// the output port (miss: broadcast to every port but the source); the VOQs
// enqueue (N x N: one copy per queue; Shared: one data slot per packet,
// admitted in port order until the central buffer is full); the scheduler
// matches inputs to outputs (RR: one round, pointers always advance; iSLIP:
// `iters` rounds, McKeown's pointer rule; EDRRM: held pairs first,
// exhaustive service); matched heads leave and hold their input and output
// busy for size_flits cycles; departure cycles, occupancy maxima and drops
// are recorded.
//
// What bounds it: the serial chain of T dependent cycles.  Each cycle's
// requests depend on the previous cycle's queues and busy counters, so the
// cycles cannot run in parallel; a cycle is a few dozen warp-synchronous
// steps, and the time is their latency times T.  The bytes a simulation
// must move (arr_pid, the header words holding its packets' keys and their
// sizes, the departure cycles and the occupancy trace) take well under a
// millisecond at 3.35 TB/s.  The eager loop issued 103-120 launches a
// cycle; this kernel issues one per simulation.
//
// Design.  State lives where one lane reaches it in a few clocks:
//   * registers: lane p holds port p's busy counters, grant/accept
//     pointers, EDRRM hold, and input p's row of the VOQ as two masks
//     (queues holding >= 1 and >= D packets); the counters (data slots,
//     drops, delivered copies, their maximum) are warp-uniform registers.
//   * shared memory: per-queue occupancy, ring head and occupancy maximum
//     ([N, N+1] each, padded against bank conflicts), the forward table
//     (2^addr_bits ports, or the hash banks' keys and ports) and the VOQ
//     ring [N, N, D] where they fit in the 227 KB a block may use
//     (kernel.plan in Python picks the placement); otherwise global memory.
//   * global memory: arr_pid, the header words, sizes, Shared-VOQ
//     refcounts and departure cycles.  The parse is at ingress, as in the
//     reference's cycle step and on the FPGA, but kept off the cycle's
//     dependent chain: a lane loads its port's arrivals three cycles ahead,
//     the header words that the keys' pieces name (one load a piece) two
//     cycles ahead, and extracts the keys one cycle ahead (a shift, a mask
//     and a shift a piece), so no load waits inside the cycle that uses
//     it.  The extraction still takes the warp's issue slots, so keys of
//     one piece each (SPLIT false: hft's and datacenter's headers) have an
//     instantiation that loads one word a key and shifts it once.  A
//     packet's queues all belong to its source port, so only the source's
//     lane touches its refcount and departure cycle: no atomics.
// Custom kernels (paper §III-B.5).  A user's hook runs between a cycle's
// lookup and its enqueue and is Python, which no kernel can call.  Its
// inputs (the arrivals, the lookup's port) depend on the arrivals alone:
// nothing of the VOQs, the scheduler or the busy counters flows back into
// the parse and the forward table.  So the cycle body is one template in
// three modes.  FUSED runs every stage of every cycle (no hook).  INGRESS
// runs the parse, the learn and the lookup of every cycle and writes the
// lookup's port per cycle and port (out [T, N]: the port, -2 broadcast, -1
// no packet); the host then steps the hooks once a cycle
// (kernels/switch_loop/hooks.py), and EGRESS runs the rest of every cycle
// on the hooked out and valid [T, N], which it prefetches three cycles
// ahead as FUSED prefetches the arrivals.  After a hook, out and valid are
// independent, so the enqueue takes voq.enqueue's rule in every mode: a
// valid lane goes to its port if out is one, to every other port if out is
// -2, and nowhere otherwise (no drop is counted for it); a valid lane with no packet (pid
// -1) is queued as pid -1, delivers nothing when it leaves and counts its
// copies on packet 0's refcount, as the plain version's clamp does, so
// EGRESS keeps the Shared-VOQ refcounts with atomics.
// Sets of ports are bit masks; the schedulers' rotating pick is a rotate
// and __ffs, and their request/grant/accept rounds are islip_match.cuh,
// which csrc/islip.cu runs too.  The Shared-VOQ admission is a prefix count
// of a ballot.  Integers only (int32 inside, the uint32 wrap for the hash
// product, int64 out), so the result is exact.  N <= 32, hash banks <= 32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "islip_match.cuh"

namespace {

using spac::FULL_WARP;

constexpr int FWD_FULL = 0, FWD_HASH = 1;
constexpr int VOQ_NXN = 0, VOQ_SHARED = 1;
constexpr int SCHED_RR = 0, SCHED_ISLIP = 1, SCHED_EDRRM = 2;
constexpr int BROADCAST = -2;
constexpr int FUSED = 0, INGRESS = 1, EGRESS = 2;

// the routing key's (0) and the src key's (1) baked pieces: a key of at
// most 32 bits spans at most two header words, so at most two pieces each;
// piece j of key f is ((header word `word[f][j]` >> lo) & mask) << dst, and
// a key of one piece has a second of mask 0, which reads no word
struct KeyPieces {
  int word[2][2], lo[2][2], dst[2][2];
  uint32_t mask[2][2];
};

struct Args {
  const int32_t* arr_pid;     // [T, N] arriving packet per cycle and port, -1 none
  const uint32_t* words;      // [npkt, W] packed header words
  const int32_t* size_flits;  // [npkt]
  const uint32_t* mults;      // [banks] hash multipliers
  int32_t* rem;               // [npkt] Shared VOQ: pending copies, zeros in
  int64_t* dep_cycle;         // [npkt] last copy's departure cycle, -1 in
  int64_t* occ_trace;         // [T] max queue occupancy after enqueue
  int64_t* occ_max;           // [N, N]
  int64_t* scalars;           // [3] delivered copies, drops, data slots max
  int32_t* gtable;            // forward table in global memory (or null)
  int32_t* gring;             // VOQ ring in global memory (or null)
  int32_t* hout;              // INGRESS: [T, N] the lookup's port per cycle
  const int32_t* hin;         // EGRESS: [T, N] the hooked port per cycle
  const uint8_t* hvalid;      // EGRESS: [T, N] the hooked valid per cycle
  KeyPieces kp;
  int W, T, N, D, fwd, voq, sched, iters, addr_bits, banks, depth;
  int table_shared, ring_shared;
};

// MODE: FUSED, INGRESS or EGRESS (the note above); SPLIT: some key has a
// second piece (a key across two header words)
template <int MODE, bool SPLIT>
__global__ void __launch_bounds__(32, 1) switch_loop_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x;
  const int N = a.N, D = a.D, S = N + 1, T = a.T;
  const bool port = lane < N;
  const unsigned all_ports = N == 32 ? FULL_WARP : (1u << N) - 1u;

  // INGRESS keeps no queue counters, EGRESS no forward table
  constexpr bool QUEUES = MODE != INGRESS, TABLE = MODE != EGRESS;
  int32_t* cnt = smem;              // [N, S] occupancy of queue (i, j)
  int32_t* hd = cnt + N * S;        // [N, S] ring slot of its head, in [0, D)
  int32_t* omax = hd + N * S;       // [N, S] occupancy maximum
  int32_t* next = QUEUES ? omax + N * S : smem;
  const int table_words = a.fwd == FWD_FULL ? (1 << a.addr_bits)
                                            : 2 * a.banks * a.depth;
  int32_t* table = a.table_shared ? next : a.gtable;
  if (TABLE && a.table_shared) next += table_words;
  int32_t* ring = a.ring_shared ? next : a.gring;
  int32_t* tkeys = table;                      // hash banks: [banks, depth] keys
  int32_t* tports = table + a.banks * a.depth; //             and ports
  const unsigned amask = (1u << a.addr_bits) - 1u;

  if (QUEUES)
    for (int x = lane; x < N * S; x += 32) cnt[x] = hd[x] = omax[x] = 0;
  if (!TABLE) {
  } else if (a.fwd == FWD_FULL) {
    for (int x = lane; x < table_words; x += 32) table[x] = -1;
  } else {
    for (int x = lane; x < a.banks * a.depth; x += 32) {
      tkeys[x] = 0;
      tports[x] = -1;
    }
  }
  __syncwarp();

  const unsigned mult = lane < a.banks ? a.mults[lane] : 0u;
  unsigned nonempty = 0u, full = 0u;  // input lane: queues with >= 1 / >= D packets
  int rowmax = 0;                     // input lane: its row's largest occupancy
  bool row_fell = false;              // a packet left the row since rowmax
  int busy_in = 0, busy_out = 0, gptr = 0, aptr = 0, held = -1;
  int data_slots = 0, drops = 0, delivered = 0, data_max = 0;   // warp-uniform

  auto arrival = [&](int k) -> int {
    return (port && k < T) ? a.arr_pid[(long long)k * N + lane] : -1;
  };
  // the header word of each key piece of packet pid (zeros for none)
  auto load_words = [&](int pid, uint32_t (&w)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (pid >= 0 && (SPLIT || i % 2 == 0) && a.kp.mask[i / 2][i % 2])
                 ? a.words[(long long)pid * a.W + a.kp.word[i / 2][i % 2]] : 0u;
  };
  auto extract = [&](const uint32_t (&w)[4]) -> uint2 {
    unsigned key[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      key[f] = ((w[2 * f] >> a.kp.lo[f][0]) & a.kp.mask[f][0]) << a.kp.dst[f][0];
      if (SPLIT)
        key[f] |= ((w[2 * f + 1] >> a.kp.lo[f][1]) & a.kp.mask[f][1]) << a.kp.dst[f][1];
    }
    return make_uint2(key[0], key[1]);
  };
  // EGRESS: the hooked port (.x) and valid (.y) of cycle k
  auto hooked = [&](int k) -> int2 {
    return (port && k < T) ? make_int2(a.hin[(long long)k * N + lane],
                                       a.hvalid[(long long)k * N + lane])
                           : make_int2(-1, 0);
  };
  // arrivals three cycles ahead, header words two, keys one (EGRESS: the
  // arrivals and the hooked port and valid three ahead)
  int pid_next = arrival(0), pid_after = arrival(1), pid_far = arrival(2);
  uint32_t raw[4];
  uint2 key_next = make_uint2(0u, 0u);
  int2 ho_next = make_int2(-1, 0), ho_after = ho_next, ho_far = ho_next;
  if constexpr (MODE == EGRESS) {
    ho_next = hooked(0);
    ho_after = hooked(1);
    ho_far = hooked(2);
  } else {
    load_words(pid_next, raw);
    key_next = extract(raw);
    load_words(pid_after, raw);
  }

  for (int k = 0; k < T; ++k) {
    const int pid = pid_next;
    bool valid;
    int out;
    if constexpr (MODE == EGRESS) {
      out = ho_next.x;
      valid = ho_next.y != 0;
      pid_next = pid_after;
      ho_next = ho_after;
      pid_after = pid_far;
      ho_after = ho_far;
      pid_far = arrival(k + 3);
      ho_far = hooked(k + 3);
    } else {
      const uint2 key = key_next;     // .x routing key, .y src key
      pid_next = pid_after;
      key_next = extract(raw);        // cycle k + 1's, from words loaded a cycle ago
      pid_after = pid_far;
      load_words(pid_after, raw);     // cycle k + 2's
      pid_far = arrival(k + 3);
      valid = pid >= 0;
      __syncwarp();

      // ---- forward table: learn src -> port, then look the routing key up
      if (a.fwd == FWD_FULL) {
        const unsigned idx = key.y & amask;
        // the highest valid lane of those learning one address writes it
        const unsigned same = __match_any_sync(FULL_WARP, valid ? idx : (0x80000000u | lane));
        if (valid && 31 - __clz(same) == lane) table[idx] = lane;
      } else {
        unsigned todo = __ballot_sync(FULL_WARP, valid);
        while (todo) {                // in port order, lane b probes bank b
          const int p = __ffs(todo) - 1;
          todo &= todo - 1u;
          const unsigned kp = __shfl_sync(FULL_WARP, key.y, p);
          int flat = 0;
          bool ok = false;
          if (lane < a.banks) {
            flat = lane * a.depth + (int)(((kp * mult) >> 16) % (unsigned)a.depth);
            ok = tports[flat] == -1 || (unsigned)tkeys[flat] == kp;
          }
          const unsigned okm = __ballot_sync(FULL_WARP, ok);
          const int bank = okm ? __ffs(okm) - 1 : 0;     // none free: evict bank 0
          if (lane == bank) {
            tkeys[flat] = (int32_t)kp;
            tports[flat] = p;
          }
          __syncwarp();
        }
      }
      __syncwarp();
      int found = -1;
      if (a.fwd == FWD_FULL) {
        if (valid) found = table[key.x & amask];
      } else {
        for (int b = 0; b < a.banks; ++b) {
          const unsigned mb = __shfl_sync(FULL_WARP, mult, b);
          if (valid && found == -1) {
            const int flat = b * a.depth + (int)(((key.x * mb) >> 16) % (unsigned)a.depth);
            if ((unsigned)tkeys[flat] == key.x && tports[flat] != -1) found = tports[flat];
          }
        }
      }
      out = !valid ? -1 : (found == -1 ? BROADCAST : found);
      if constexpr (MODE == INGRESS) {
        if (port) a.hout[(long long)k * N + lane] = out;
        continue;
      }
    }

    // ---- VOQ enqueue (voq.enqueue's rule, which a hooked out needs)
    unsigned fan = !valid ? 0u
                   : out == BROADCAST ? all_ports & ~(1u << lane)
                   : (unsigned)out < (unsigned)N ? 1u << out : 0u;
    if (a.voq == VOQ_SHARED) {
      // central buffer: whole packets admitted in port order until full
      const unsigned wants = __ballot_sync(FULL_WARP, fan != 0u);
      const int upto = __popc(wants & ((2u << lane) - 1u));
      const bool admit = fan != 0u && data_slots + upto <= N * D;
      drops += __popc(wants) - __popc(__ballot_sync(FULL_WARP, admit));
      if (!admit) fan = 0u;
    }
    const unsigned store = fan & ~full;
    drops += __reduce_add_sync(FULL_WARP, __popc(fan) - __popc(store));
    for (unsigned s = store; s; s &= s - 1u) {
      const int j = __ffs(s) - 1;
      const int q = lane * S + j;
      const int c = cnt[q] + 1;
      int slot = hd[q] + c - 1;
      if (slot >= D) slot -= D;
      ring[(lane * N + j) * D + slot] = pid;
      cnt[q] = c;
      if (c > omax[q]) omax[q] = c;
      if (c > rowmax) rowmax = c;
      nonempty |= 1u << j;
      if (c >= D) full |= 1u << j;
    }
    if (a.voq == VOQ_SHARED) {
      if constexpr (MODE == EGRESS) {
        // a valid lane with no packet counts on packet 0, as the clamp does
        if (store) atomicAdd(&a.rem[max(pid, 0)], __popc(store));
      } else if (store) {
        a.rem[pid] += __popc(store);
      }
      data_slots += __popc(__ballot_sync(FULL_WARP, store != 0u));
    } else {
      data_slots += __reduce_add_sync(FULL_WARP, __popc(store));
    }
    if (row_fell) {
      rowmax = 0;
      for (int j = 0; j < N; ++j) rowmax = max(rowmax, cnt[lane * S + j]);
      row_fell = false;
    }
    const int occ_peak = __reduce_max_sync(FULL_WARP, rowmax);
    if (lane == 0) a.occ_trace[k] = occ_peak;

    // ---- schedule: acc = input lane's matched output, out_in = output
    //      lane's matched input (-1: none)
    const unsigned busy_outs = __ballot_sync(FULL_WARP, busy_out > 0);
    const unsigned req = (port && busy_in == 0) ? nonempty & ~busy_outs : 0u;
    int acc, out_in;
    if (a.sched == SCHED_RR) {
      int grant;
      bool out_acc;
      acc = spac::grant_accept(spac::transpose_rows(req, N, lane), true, gptr, aptr,
                               N, lane, grant, out_acc);
      out_in = out_acc ? grant : -1;
      if (grant >= 0) gptr = (grant + 1) % N;      // RR: always advance
      if (acc >= 0) aptr = (acc + 1) % N;
    } else if (a.sched == SCHED_ISLIP) {
      int g_new = gptr, a_new = aptr;
      const unsigned m = spac::islip_rounds(spac::transpose_rows(req, N, lane), gptr,
                                            aptr, a.iters, N, lane, g_new, a_new,
                                            out_in);
      acc = m ? __ffs(m) - 1 : -1;
      gptr = g_new;
      aptr = a_new;
    } else {
      // EDRRM: one request per input, its held output first; each output
      // grants a held requester first, else the next requester in turn
      const bool hv = port && held >= 0 && ((req >> held) & 1u);
      const int req_out = hv ? held : (port ? spac::rot_pick(req, aptr, N) : -1);
      const unsigned col_all = spac::gather_targets(req_out, N, lane);
      const unsigned col_held = spac::gather_targets(hv ? req_out : -1, N, lane);
      const int gh = port ? spac::rot_pick(col_held, gptr, N) : -1;
      const int gn = (port && gh < 0) ? spac::rot_pick(col_all, gptr, N) : -1;
      const int grant = gh >= 0 ? gh : gn;
      if (gn >= 0) gptr = (gn + 1) % N;
      const int back = __shfl_sync(FULL_WARP, grant, req_out >= 0 ? req_out : 0);
      const bool matched = req_out >= 0 && back == lane;
      if (matched && !hv) aptr = (req_out + 1) % N;
      held = matched ? req_out : -1;
      acc = matched ? req_out : -1;
      out_in = grant;
    }

    // ---- dequeue the matched heads
    int hold = 0;
    bool freed = false;
    int dp = -1;
    if constexpr (MODE == EGRESS) {
      // this cycle's enqueue counts are in before any lane takes one away
      if (a.voq == VOQ_SHARED) __syncwarp();
    }
    if (acc >= 0) {
      const int q = lane * S + acc;
      const int h = hd[q];
      dp = ring[(lane * N + acc) * D + h];
      hd[q] = h + 1 == D ? 0 : h + 1;
      const int c = cnt[q] - 1;
      cnt[q] = c;
      if (c == 0) nonempty &= ~(1u << acc);
      full &= ~(1u << acc);
      row_fell = true;
      // EGRESS: a lane queued with no packet (pid -1) holds nothing
      const bool real = MODE != EGRESS || dp >= 0;
      const int sz = real ? a.size_flits[dp] : 1;
      hold = sz - 1;
      if (a.voq != VOQ_SHARED) {
        freed = true;
      } else if constexpr (MODE == EGRESS) {
        freed = atomicSub(&a.rem[max(dp, 0)], 1) <= 1;
      } else {
        const int r = a.rem[dp] - 1;   // the slot frees with the last copy
        a.rem[dp] = r;
        freed = r <= 0;
      }
      if (real) a.dep_cycle[dp] = (int64_t)k + sz;   // later copies leave later: the max
    }
    if constexpr (MODE == EGRESS) {
      // packet 0's count is shared with the lanes that hold no packet: two
      // lanes may take from it in one cycle, and each reads it after both,
      // as the plain version frees on the count after the whole dequeue
      if (a.voq == VOQ_SHARED &&
          __any_sync(FULL_WARP, acc >= 0 && dp <= 0)) {
        __syncwarp();
        if (acc >= 0) freed = atomicAdd(&a.rem[max(dp, 0)], 0) <= 0;
      }
    }
    data_slots -= __popc(__ballot_sync(FULL_WARP, freed));
    delivered += __popc(__ballot_sync(FULL_WARP, acc >= 0 && (MODE != EGRESS || dp >= 0)));
    if (a.sched == SCHED_EDRRM && held >= 0 && !((nonempty >> held) & 1u)) held = -1;

    // ---- a transfer holds its input and output for size_flits cycles
    const int out_hold = __shfl_sync(FULL_WARP, hold, out_in >= 0 ? out_in : 0);
    busy_out = out_in >= 0 ? out_hold : max(busy_out - 1, 0);
    busy_in = max(max(busy_in - 1, 0), hold);
    data_max = max(data_max, data_slots);
  }

  if constexpr (MODE == INGRESS) return;
  __syncwarp();
  for (int x = lane; x < N * N; x += 32) a.occ_max[x] = omax[(x / N) * S + x % N];
  if (lane == 0) {
    a.scalars[0] = delivered;
    a.scalars[1] = drops;
    a.scalars[2] = data_max;
  }
}

// `steps` of the least dependent step one cycle hands the next, on one
// warp: every cycle's schedule reads the busy outputs through a ballot, and
// the matched output's hold comes back through a shuffle into a maximum
// (busy_out above).  io[0..31]: each lane's value; io gets the result, so
// the chain is not dead code.  The cycle loop's chain bound is its cycles
// times this step's latency (chip_smoke.py's kernels phase).
__global__ void __launch_bounds__(32, 1) switch_chain_kernel(int32_t* io, int steps) {
  const int lane = threadIdx.x;
  int busy = io[lane];
  for (int k = 0; k < steps; ++k) {
    const unsigned outs = __ballot_sync(FULL_WARP, busy > 2);
    const int hold = __shfl_sync(FULL_WARP, busy, (lane + outs) & 31);
    busy = max(hold - 1, int(outs & 3u));
  }
  io[lane] = busy;
}

}  // namespace

extern "C" {

// `steps` dependent steps of switch_chain_kernel on `stream` (io: 32 int32).
int switch_loop_chain(void* io, int steps, void* stream) {
  switch_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(io), steps);
  return int(cudaGetLastError());
}

int switch_loop_key_pieces_bytes() { return int(sizeof(KeyPieces)); }

}  // extern "C"

namespace {

// Launch the MODE instantiation of `a` (EGRESS parses nothing: one form).
template <int MODE>
int launch(const Args& a, int smem_bytes, void* stream) {
  auto kernel = switch_loop_kernel<MODE, false>;
  if constexpr (MODE != EGRESS)
    if (a.kp.mask[0][1] || a.kp.mask[1][1]) kernel = switch_loop_kernel<MODE, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return int(err);
  kernel<<<1, 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one simulation on `stream`.  The caller allocates every buffer
// (kernels/switch_loop/kernel.py) and chooses the placement (`plan`):
// smem_bytes is the dynamic shared memory it sized; `kp` is a host pointer
// to the keys' pieces.  Returns the CUDA error code of the launch (0:
// launched).
int switch_loop_i32(const void* arr_pid, const void* words, const void* kp, int W,
                    const void* size_flits, const void* mults, void* rem,
                    void* dep_cycle, void* occ_trace,
                    void* occ_max, void* scalars, void* gtable, void* gring, int T,
                    int N, int D, int fwd, int voq, int sched, int iters,
                    int addr_bits, int banks, int depth, int table_shared,
                    int ring_shared, int smem_bytes, void* stream) {
  Args a;
  a.arr_pid = static_cast<const int32_t*>(arr_pid);
  a.words = static_cast<const uint32_t*>(words);
  a.kp = *static_cast<const KeyPieces*>(kp);
  a.W = W;
  a.size_flits = static_cast<const int32_t*>(size_flits);
  a.mults = static_cast<const uint32_t*>(mults);
  a.rem = static_cast<int32_t*>(rem);
  a.dep_cycle = static_cast<int64_t*>(dep_cycle);
  a.occ_trace = static_cast<int64_t*>(occ_trace);
  a.occ_max = static_cast<int64_t*>(occ_max);
  a.scalars = static_cast<int64_t*>(scalars);
  a.gtable = static_cast<int32_t*>(gtable);
  a.gring = static_cast<int32_t*>(gring);
  a.T = T;
  a.N = N;
  a.D = D;
  a.fwd = fwd;
  a.voq = voq;
  a.sched = sched;
  a.iters = iters;
  a.addr_bits = addr_bits;
  a.banks = banks;
  a.depth = depth;
  a.table_shared = table_shared;
  a.ring_shared = ring_shared;
  a.hout = nullptr;
  a.hin = nullptr;
  a.hvalid = nullptr;
  return launch<FUSED>(a, smem_bytes, stream);
}

// The ingress pass: the parse, the learn and the lookup of every cycle;
// writes out [T, N] (the port, -2 broadcast, -1 no packet).  Arguments as
// switch_loop_i32's; gtable only when the table is not in shared memory.
int switch_ingress_i32(const void* arr_pid, const void* words, const void* kp, int W,
                       const void* mults, void* out, void* gtable, int T, int N,
                       int fwd, int addr_bits, int banks, int depth, int table_shared,
                       int smem_bytes, void* stream) {
  Args a = {};
  a.arr_pid = static_cast<const int32_t*>(arr_pid);
  a.words = static_cast<const uint32_t*>(words);
  a.kp = *static_cast<const KeyPieces*>(kp);
  a.W = W;
  a.mults = static_cast<const uint32_t*>(mults);
  a.hout = static_cast<int32_t*>(out);
  a.gtable = static_cast<int32_t*>(gtable);
  a.T = T;
  a.N = N;
  a.D = 1;
  a.fwd = fwd;
  a.addr_bits = addr_bits;
  a.banks = banks;
  a.depth = depth;
  a.table_shared = table_shared;
  return launch<INGRESS>(a, smem_bytes, stream);
}

// The egress pass on the hooked out [T, N] int32 and valid [T, N] uint8:
// the enqueue, the schedule, the dequeue, the busy counters and the
// bookkeeping of every cycle, into switch_loop_i32's outputs.
int switch_egress_i32(const void* arr_pid, const void* out, const void* valid,
                      const void* size_flits, void* rem, void* dep_cycle,
                      void* occ_trace, void* occ_max, void* scalars, void* gring,
                      int T, int N, int D, int voq, int sched, int iters,
                      int ring_shared, int smem_bytes, void* stream) {
  Args a = {};
  a.arr_pid = static_cast<const int32_t*>(arr_pid);
  a.hin = static_cast<const int32_t*>(out);
  a.hvalid = static_cast<const uint8_t*>(valid);
  a.size_flits = static_cast<const int32_t*>(size_flits);
  a.rem = static_cast<int32_t*>(rem);
  a.dep_cycle = static_cast<int64_t*>(dep_cycle);
  a.occ_trace = static_cast<int64_t*>(occ_trace);
  a.occ_max = static_cast<int64_t*>(occ_max);
  a.scalars = static_cast<int64_t*>(scalars);
  a.gring = static_cast<int32_t*>(gring);
  a.T = T;
  a.N = N;
  a.D = D;
  a.voq = voq;
  a.sched = sched;
  a.iters = iters;
  a.ring_shared = ring_shared;
  return launch<EGRESS>(a, smem_bytes, stream);
}

}  // extern "C"
