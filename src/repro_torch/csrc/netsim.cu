// Admission-gated port replay for Hopper (sm_90a), one candidate row per warp.
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
// What bounds it: the m-step dependent chain through one row's port state,
// not bandwidth (svc and admit are read once, the result written once:
// 17 bytes per row and event in float64).  Parallelism exists only across
// candidate rows, so the chain of m shared-memory round trips sets the time.
// The layout is the xbar kernel's: WARPS rows per block, one warp each, port
// state in shared memory, the timeline and the block's svc/admit columns
// staged CHUNK events at a time, results written 32 events at a time,
// coalesced, into out[B, m].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;      // candidate rows per block, one warp each
constexpr int CHUNK = 256;    // events staged per pass (a multiple of 32)

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

template <typename T>
size_t smem_bytes(int n_ports) {
  return sizeof(T) * (size_t(CHUNK) + size_t(CHUNK) * WARPS
                      + size_t(WARPS) * 2 * n_ports)
         + sizeof(int32_t) * 2 * size_t(CHUNK) + size_t(CHUNK) * WARPS;
}

template <typename T, bool ABSOLUTE, bool GATED>
__global__ void __launch_bounds__(WARPS * 32)
netsim_replay_kernel(const T* __restrict__ tnow,      // [m] now (absolute) or dnow (slack)
                     const int32_t* __restrict__ src,  // [m]
                     const int32_t* __restrict__ dst,  // [m]
                     const T* __restrict__ svc,        // [m, B]
                     const uint8_t* __restrict__ admit,  // [m, B] (GATED only)
                     const T* __restrict__ pipe,       // [B]
                     T* __restrict__ out,              // [B, m]
                     int m, int B, int n_ports) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_t = reinterpret_cast<T*>(smem);
  T* s_svc = s_t + CHUNK;
  T* s_ports = s_svc + CHUNK * WARPS;
  int32_t* s_src = reinterpret_cast<int32_t*>(s_ports + WARPS * 2 * n_ports);
  int32_t* s_dst = s_src + CHUNK;
  uint8_t* s_adm = reinterpret_cast<uint8_t*>(s_dst + CHUNK);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * WARPS;
  const int row = row0 + warp;
  const bool live = row < B;
  T* in_f = s_ports + warp * 2 * n_ports;
  T* out_f = in_f + n_ports;
  for (int p = lane; p < n_ports; p += 32) {
    in_f[p] = T(0);
    out_f[p] = T(0);
  }
  const T pp = live ? pipe[row] : T(0);
  T keep = T(0);

  for (int k0 = 0; k0 < m; k0 += CHUNK) {
    const int len = min(CHUNK, m - k0);
    __syncthreads();                       // the previous chunk is consumed
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      s_t[e] = tnow[k0 + e];
      s_src[e] = src[k0 + e];
      s_dst[e] = dst[k0 + e];
    }
    for (int e = threadIdx.x; e < len * WARPS; e += blockDim.x) {
      const int kk = e / WARPS;
      const int r = row0 + e % WARPS;
      const size_t g = size_t(k0 + kk) * B + r;
      s_svc[e] = r < B ? svc[g] : T(0);
      if (GATED) s_adm[e] = r < B ? admit[g] : uint8_t(0);
    }
    __syncthreads();
    if (!live) continue;
    for (int kk = 0; kk < len; ++kk) {
      const T tk = s_t[kk];
      const int i = s_src[kk];
      const int j = s_dst[kk];
      const T s = s_svc[kk * WARPS + warp];
      const bool ad = GATED ? s_adm[kk * WARPS + warp] != 0 : true;
      if (!ABSOLUTE) {
        for (int p = lane; p < n_ports; p += 32) {
          in_f[p] = vmax(in_f[p] - tk, T(0));
          out_f[p] = vmax(out_f[p] - tk, T(0));
        }
        __syncwarp();
      }
      const T d = ABSOLUTE ? vmax(vmax(tk + pp, in_f[i]), out_f[j]) + s
                           : vmax(vmax(in_f[i], out_f[j]), pp) + s;
      __syncwarp();                        // every lane has read the ports
      if (lane == 0 && ad) {
        in_f[i] = d;
        out_f[j] = d;
      }
      __syncwarp();
      if ((kk & 31) == lane) keep = d;
      if ((kk & 31) == 31 || kk == len - 1) {
        const int base = k0 + (kk & ~31);
        if (base + lane <= k0 + kk) out[size_t(row) * m + base + lane] = keep;
      }
    }
  }
}

template <typename T, bool ABSOLUTE, bool GATED>
int launch(const void* tnow, const void* src, const void* dst, const void* svc,
           const void* admit, const void* pipe, void* out, int m, int B,
           int n_ports, void* stream) {
  const size_t smem = smem_bytes<T>(n_ports);
  auto kern = netsim_replay_kernel<T, ABSOLUTE, GATED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (B + WARPS - 1) / WARPS;
  kern<<<blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tnow), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<const T*>(svc),
      static_cast<const uint8_t*>(admit), static_cast<const T*>(pipe),
      static_cast<T*>(out), m, B, n_ports);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, for the wrapper's size check.
long long netsim_smem_bytes(int n_ports, int dtype_bytes) {
  return dtype_bytes == 8 ? (long long)smem_bytes<double>(n_ports)
                          : (long long)smem_bytes<float>(n_ports);
}

// Round 1: the all-admitted (ungated) float64 replay.
int netsim_replay_abs_f64(const void* now, const void* src, const void* dst,
                          const void* svc, const void* pipe, void* end, int m,
                          int B, int n_ports, void* stream) {
  return launch<double, true, false>(now, src, dst, svc, nullptr, pipe, end, m,
                                     B, n_ports, stream);
}

// Rounds 2+: the admission-gated float64 replay.
int netsim_replay_gated_abs_f64(const void* now, const void* src,
                                const void* dst, const void* svc,
                                const void* admit, const void* pipe, void* end,
                                int m, int B, int n_ports, void* stream) {
  return launch<double, true, true>(now, src, dst, svc, admit, pipe, end, m, B,
                                    n_ports, stream);
}

// The Pallas tile's contract: gated float32 slack replay, departure offsets.
int netsim_replay_gated_slack_f32(const void* dnow, const void* src,
                                  const void* dst, const void* svc,
                                  const void* admit, const void* pipe,
                                  void* dep, int m, int B, int n_ports,
                                  void* stream) {
  return launch<float, false, true>(dnow, src, dst, svc, admit, pipe, dep, m,
                                    B, n_ports, stream);
}

}  // extern "C"
