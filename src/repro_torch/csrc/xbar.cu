// Greedy-crossbar contention scan for Hopper (sm_90a), one candidate row per warp.
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
// What bounds it: the m-step dependent chain through one row's port state,
// not bandwidth.  Each event reads svc and writes dep once (16 bytes per row
// and event in float64), far below the card's memory rate; parallelism exists
// only across candidate rows (B <= 480 on the DSE's path), so the chain of m
// shared-memory round trips sets the time.  The design keeps everything the
// chain touches on chip: a block holds WARPS rows, one warp each; a row's
// port state lives in shared memory (lane p decays ports p, p+32, ...); the
// shared timeline (t or dt, src, dst) and the block's svc columns are staged
// through shared memory CHUNK events at a time; departures are buffered one
// per lane and written 32 events at a time, coalesced, into dep[B, m].

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
         + sizeof(int32_t) * 2 * size_t(CHUNK);
}

template <typename T, bool ABSOLUTE>
__global__ void __launch_bounds__(WARPS * 32)
xbar_scan_kernel(const T* __restrict__ tdt,       // [m] t (absolute) or dt (slack)
                 const int32_t* __restrict__ src,  // [m]
                 const int32_t* __restrict__ dst,  // [m]
                 const T* __restrict__ svc,        // [m, B]
                 T* __restrict__ dep,              // [B, m]
                 int m, int B, int n_ports) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_t = reinterpret_cast<T*>(smem);
  T* s_svc = s_t + CHUNK;
  T* s_ports = s_svc + CHUNK * WARPS;
  int32_t* s_src = reinterpret_cast<int32_t*>(s_ports + WARPS * 2 * n_ports);
  int32_t* s_dst = s_src + CHUNK;

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
  T keep = T(0);

  for (int k0 = 0; k0 < m; k0 += CHUNK) {
    const int len = min(CHUNK, m - k0);
    __syncthreads();                       // the previous chunk is consumed
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      s_t[e] = tdt[k0 + e];
      s_src[e] = src[k0 + e];
      s_dst[e] = dst[k0 + e];
    }
    for (int e = threadIdx.x; e < len * WARPS; e += blockDim.x) {
      const int kk = e / WARPS;
      const int r = row0 + e % WARPS;
      s_svc[e] = r < B ? svc[size_t(k0 + kk) * B + r] : T(0);
    }
    __syncthreads();
    if (!live) continue;
    for (int kk = 0; kk < len; ++kk) {
      const T tk = s_t[kk];
      const int i = s_src[kk];
      const int j = s_dst[kk];
      const T s = s_svc[kk * WARPS + warp];
      if (!ABSOLUTE) {
        for (int p = lane; p < n_ports; p += 32) {
          in_f[p] = vmax(in_f[p] - tk, T(0));
          out_f[p] = vmax(out_f[p] - tk, T(0));
        }
        __syncwarp();
      }
      const T wait = vmax(in_f[i], out_f[j]);
      const T d = ABSOLUTE ? vmax(wait, tk) + s : wait + s;
      __syncwarp();                        // every lane has read the ports
      if (lane == 0) {
        in_f[i] = d;
        out_f[j] = d;
      }
      __syncwarp();
      if ((kk & 31) == lane) keep = d;
      if ((kk & 31) == 31 || kk == len - 1) {
        const int base = k0 + (kk & ~31);
        if (base + lane <= k0 + kk) dep[size_t(row) * m + base + lane] = keep;
      }
    }
  }
}

template <typename T, bool ABSOLUTE>
int launch(const void* tdt, const void* src, const void* dst, const void* svc,
           void* dep, int m, int B, int n_ports, void* stream) {
  const size_t smem = smem_bytes<T>(n_ports);
  auto kern = xbar_scan_kernel<T, ABSOLUTE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (B + WARPS - 1) / WARPS;
  kern<<<blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tdt), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<const T*>(svc),
      static_cast<T*>(dep), m, B, n_ports);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, for the wrapper's size check.
long long xbar_smem_bytes(int n_ports, int dtype_bytes) {
  return dtype_bytes == 8 ? (long long)smem_bytes<double>(n_ports)
                          : (long long)smem_bytes<float>(n_ports);
}

int xbar_scan_abs_f64(const void* t, const void* src, const void* dst,
                      const void* svc, void* dep, int m, int B, int n_ports,
                      void* stream) {
  return launch<double, true>(t, src, dst, svc, dep, m, B, n_ports, stream);
}

int xbar_scan_slack_f32(const void* dt, const void* src, const void* dst,
                        const void* svc, void* dep, int m, int B, int n_ports,
                        void* stream) {
  return launch<float, false>(dt, src, dst, svc, dep, m, B, n_ports, stream);
}

}  // extern "C"
