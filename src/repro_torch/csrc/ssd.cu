// Mamba-2 SSD chunked scan for Hopper (sm_90a): the SSM layer's sequence mix.
//
// Replaces the JAX package's Pallas kernel kernels/ssd/kernel.py:ssd_scan
// (_ssd_kernel), at the call site of its XLA twin kernels/ssd/ops.py:
// ssd_chunked (models/mamba2.py:apply_mamba).  The recurrence
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// is computed chunk by chunk, with the [P, N] float32 state carried across
// chunks in shared memory.  Per chunk of L steps:
//   cum   = inclusive scan of dt a                      (a < 0: log-decays)
//   M_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j  for j <= i, else 0
//   y_i   = sum_j M_ij x_j + (C_i exp(cum_i)) . state^T
//   state = state exp(cum_L) + sum_j (x_j exp(cum_L - cum_j) dt_j) B_j^T
// The mask is applied before the exponential: exp(cum_i - cum_j) for j > i
// overflows to inf once |sum dt a| passes ~88, and inf times a 0/1 mask is
// NaN.  The kernel tiles any S by its own chunk L = 64 and pads the tail
// with dt = 0 and x = B = C = 0, an exact no-op on the state; the result is
// the reference's up to float32 rounding (its chunk is 128, or all of S).
// It returns y in x's dtype and, on request, the final state (which the
// Pallas kernel keeps in scratch and the model's prefill stores).
//
// B and C are read per group of heads: row g of b/c [G, S, N] serves heads
// g*H .. g*H + H - 1 (the model's B and C are shared by a sequence's heads;
// the reference broadcasts them H-fold in memory, the kernel indexes).
//
// What bounds it: at mamba2-780m's prefill (BH 192, S 8192, P 64, N 128) the
// work is ~1e11 FLOP against ~0.4 GB of inputs and outputs, and the
// recurrence over chunks is serial within a head.  One 256-thread block per
// head walks its chunks in order on the float32 FMA pipes; every product is
// a 4x4 (or 4x8) register patch per thread over padded shared-memory tiles.
// 192 heads fill 132 SMs in under two waves; splitting a head's chunk
// products across blocks, and the tensor cores, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 64;          // chunk length
constexpr int THREADS = 256;   // 16 x 16 thread grid: ty rows, tx columns

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(P) * (N + 1) + size_t(L) * (P + 1) +
                          2 * size_t(L) * (N + 1) + size_t(L) * (L + 1) + 4 * L);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a, const float* __restrict__ bm,
        const float* __restrict__ cm, T* __restrict__ y, float* __restrict__ state_out,
        int s, int heads_per_group) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  constexpr int NS = N + 1, PS = P + 1, MS = L + 1;
  constexpr int RL = L / 16;          // chunk rows per thread
  constexpr int RP = P / 16;          // head-dim columns per thread
  constexpr int RN = N / 16;          // state columns per thread
  extern __shared__ float smem[];
  float* st = smem;                   // [P][NS]  carried state
  float* xs = st + P * NS;            // [L][PS]
  float* bs = xs + L * PS;            // [L][NS]
  float* cs = bs + L * NS;            // [L][NS]
  float* ms = cs + L * NS;            // [L][MS]  intra-chunk weights
  float* cum = ms + L * MS;           // [L]
  float* dts = cum + L;               // [L]
  float* ecum = dts + L;              // [L]  exp(cum_i)
  float* wv = ecum + L;               // [L]  exp(cum_L - cum_j) dt_j

  const int h = blockIdx.x;
  const int g = h / heads_per_group;
  const float ah = a[h];
  const T* xp = x + (size_t)h * s * P;
  const float* dtp = dt + (size_t)h * s;
  const float* bp = bm + (size_t)g * s * N;
  const float* cp = cm + (size_t)g * s * N;
  T* yp = y + (size_t)h * s * P;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < P * NS; i += THREADS) st[i] = 0.f;

  for (int c0 = 0; c0 < s; c0 += L) {
    const int nv = min(L, s - c0);
    __syncthreads();                  // the last chunk's reads are done
    for (int i = tid; i < L * P; i += THREADS) {
      const int r = i / P, p = i - r * P;
      xs[r * PS + p] = r < nv ? to_f(xp[(size_t)(c0 + r) * P + p]) : 0.f;
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      const bool in = r < nv;
      bs[r * NS + n] = in ? bp[(size_t)(c0 + r) * N + n] : 0.f;
      cs[r * NS + n] = in ? cp[(size_t)(c0 + r) * N + n] : 0.f;
    }
    if (tid < L) dts[tid] = tid < nv ? dtp[c0 + tid] : 0.f;
    __syncthreads();
    if (tid == 0) {                   // the chunk's cumulative log-decay, in order
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run += dts[i] * ah;
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[L - 1];
    if (tid < L) {
      ecum[tid] = expf(cum[tid]);
      wv[tid] = expf(total - cum[tid]) * dts[tid];
    }

    // M = (C B^T) o decay o dt, masked before the exponential
    {
      float gm[RL][RL];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j) gm[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RL], bv[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = cs[(ty * RL + i) * NS + n];
#pragma unroll
        for (int j = 0; j < RL; ++j) bv[j] = bs[(tx * RL + j) * NS + n];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RL; ++j) gm[i][j] = fmaf(cv[i], bv[j], gm[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          const int r = ty * RL + i, c = tx * RL + j;
          ms[r * MS + c] = c <= r ? gm[i][j] * expf(cum[r] - cum[c]) * dts[c] : 0.f;
        }
    }
    __syncthreads();

    // y = M x + (C o exp(cum)) state^T, from the state before this chunk
    {
      float yi[RL][RP], ye[RL][RP];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int p = 0; p < RP; ++p) yi[i][p] = ye[i][p] = 0.f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        float mv[RL], xv[RP];
#pragma unroll
        for (int i = 0; i < RL; ++i) mv[i] = ms[(ty * RL + i) * MS + j];
#pragma unroll
        for (int p = 0; p < RP; ++p) xv[p] = xs[j * PS + tx * RP + p];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int p = 0; p < RP; ++p) yi[i][p] = fmaf(mv[i], xv[p], yi[i][p]);
      }
      float ec[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) ec[i] = ecum[ty * RL + i];
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RL], sv[RP];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = cs[(ty * RL + i) * NS + n] * ec[i];
#pragma unroll
        for (int p = 0; p < RP; ++p) sv[p] = st[(tx * RP + p) * NS + n];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int p = 0; p < RP; ++p) ye[i][p] = fmaf(cv[i], sv[p], ye[i][p]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int r = ty * RL + i;
        if (r >= nv) continue;
#pragma unroll
        for (int p = 0; p < RP; ++p)
          yp[(size_t)(c0 + r) * P + tx * RP + p] = from_f<T>(yi[i][p] + ye[i][p]);
      }
    }
    __syncthreads();                  // every read of the old state is done

    // state = state exp(total) + (x o w)^T B
    {
      const float decay = expf(total);
      float up[RP][RN];
#pragma unroll
      for (int p = 0; p < RP; ++p)
#pragma unroll
        for (int n = 0; n < RN; ++n) up[p][n] = 0.f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const float w = wv[j];
        float xv[RP], bv[RN];
#pragma unroll
        for (int p = 0; p < RP; ++p) xv[p] = xs[j * PS + ty * RP + p] * w;
#pragma unroll
        for (int n = 0; n < RN; ++n) bv[n] = bs[j * NS + tx * RN + n];
#pragma unroll
        for (int p = 0; p < RP; ++p)
#pragma unroll
          for (int n = 0; n < RN; ++n) up[p][n] = fmaf(xv[p], bv[n], up[p][n]);
      }
#pragma unroll
      for (int p = 0; p < RP; ++p)
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          float* sp = &st[(ty * RP + p) * NS + tx * RN + n];
          *sp = *sp * decay + up[p][n];
        }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + (size_t)h * P * N;
    for (int i = tid; i < P * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      so[i] = st[p * NS + n];
    }
  }
}

template <typename T, int P, int N>
int launch_pn(const void* x, const void* dt, const void* a, const void* b,
              const void* c, void* y, void* state, int bh, int s, int heads_per_group,
              cudaStream_t stream) {
  const size_t smem = smem_bytes<P, N>();
  cudaError_t e = cudaFuncSetAttribute(ssd_fwd<T, P, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  ssd_fwd<T, P, N><<<bh, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<T*>(y), static_cast<float*>(state), s,
      heads_per_group);
  return int(cudaGetLastError());
}

template <typename T, int P>
int launch_p(const void* x, const void* dt, const void* a, const void* b, const void* c,
             void* y, void* state, int bh, int s, int n, int hpg, cudaStream_t st) {
  switch (n) {
    case 16: return launch_pn<T, P, 16>(x, dt, a, b, c, y, state, bh, s, hpg, st);
    case 32: return launch_pn<T, P, 32>(x, dt, a, b, c, y, state, bh, s, hpg, st);
    case 64: return launch_pn<T, P, 64>(x, dt, a, b, c, y, state, bh, s, hpg, st);
    case 128: return launch_pn<T, P, 128>(x, dt, a, b, c, y, state, bh, s, hpg, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           void* y, void* state, int bh, int s, int p, int n, int hpg, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (hpg <= 0 || bh % hpg != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 32: return launch_p<T, 32>(x, dt, a, b, c, y, state, bh, s, n, hpg, st);
    case 64: return launch_p<T, 64>(x, dt, a, b, c, y, state, bh, s, n, hpg, st);
    case 128: return launch_p<T, 128>(x, dt, a, b, c, y, state, bh, s, n, hpg, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x/y [bh, s, p] (f32 or bf16), dt [bh, s] f32, a [bh] f32, b/c [bh / hpg, s, n]
// f32, state [bh, p, n] f32 or null; all contiguous.
int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* b,
                 const void* c, void* y, void* state, int bh, int s, int p, int n,
                 int heads_per_group, void* stream) {
  return launch<float>(x, dt, a, b, c, y, state, bh, s, p, n, heads_per_group, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* b,
                  const void* c, void* y, void* state, int bh, int s, int p, int n,
                  int heads_per_group, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, b, c, y, state, bh, s, p, n, heads_per_group,
                               stream);
}

}  // extern "C"
