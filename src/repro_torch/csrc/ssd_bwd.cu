// The gradient of the Mamba-2 SSD chunked scan, for Hopper (sm_90a): dx,
// d(dt), da, dB and dC of the training path's sequence mix.
//
// Replaces no Pallas kernel: the JAX package takes this gradient by autodiff
// of its XLA twin kernels/ssd/ops.py:ssd_chunked, and the port's forward
// kernel (csrc/ssd.cu) writes through raw pointers, so its output carries
// no autograd history.  kernels/ssd/ops.py's SSDScanFn launches the forward
// kernel and this one.  The function is the recurrence
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,   h_{-1} = 0
// (B and C per group of heads: row g of b/c [G, S, N] serves heads
// g*H .. g*H + H - 1).  With gy = dL/dy, chunks of L = 64 steps, cum the
// chunk's inclusive scan of dt a, total = cum_{L-1}, S_c the state entering
// chunk c and E_c = dL/dh at chunk c's last step from later chunks only
// (E_{NC-1} = 0, E_{c-1} = exp(total_c) E_c + sum_i exp(cum_i) gy_i C_i^T):
//   A_ij = (C_i . B_j) exp(cum_i - cum_j),  W_ij = exp(cum_i - cum_j) dt_j (gy_i . x_j)
//          for j <= i (else 0)
//   u_j  = sum_i A_ij gy_i + exp(total - cum_j) E_c B_j          [P]
//   dx_j = dt_j u_j,   d(dt)_j = x_j . u_j + a dlam_j
//   dB_j = sum_i W_ij C_i + dt_j exp(total - cum_j) x_j^T E_c    (summed over
//   dC_i = sum_j W_ij B_j + exp(cum_i) gy_i^T S_c                 the group)
//   dcum_i = sum_j Q_ij - sum_j Q_ji + T_i - U_i,  Q_ij = A_ij dt_j (gy_i . x_j),
//          T_i = exp(cum_i) C_i . (gy_i^T S_c),  U_j = B_j . (dB_j's E_c term),
//          and dcum_{L-1} += sum_j U_j + exp(total) sum(E_c o S_c)
//   dlam_k = sum_{i >= k} dcum_i  (the chunk's reverse scan),  da = sum_k dt_k dlam_k
// Every product is float32; outputs are rounded to their input's dtype once.
// The ragged tail reads dt = 0 and x = gy = B = C = 0: its terms are zero.
// a < 0 and dt >= 0, so every exponential taken is of a number <= 0.
//
// Four launches on the caller's stream:
//   ssd_bwd_states  grid (BH, P / 16, 2): z = 0 walks the chunks forward and
//                   stores each S_c, z = 1 walks them backward and stores
//                   each E_c, each block with a 16-row slice of its head's
//                   [P, N] state in registers (a head's rows are independent);
//   ssd_bwd_chunk   grid (NC, BH): every term above for one chunk of one head,
//                   from S_c and E_c, writing dx, d(dt), this head's own dB
//                   and dC (float32 scratch) and its part of da;
//   ssd_bwd_reduce  sums dB and dC over each group's heads and da over a
//                   head's chunks, in a fixed order (deterministic), and
//                   casts.
//
// What bounds the function: bytes, as the forward (x, y's gradient, dx in
// x's dtype; B, C, dB, dC per sequence; dt, d(dt) in float32), ~0.5 GB at
// mamba2-780m's training shape (B 1, 48 heads, S 8192, P 64, N 128).  This
// first kernel also moves its scratch (S_c and E_c, [BH, NC, P, N] float32
// each, and per-head dB and dC) and runs every product on the float32 FMA
// pipes from shared memory: a simple, correct kernel, with one block an SM
// (its tiles take ~180 KB of shared memory).

#include <algorithm>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 64;           // steps per chunk
constexpr int LX = L + 1;       // padded pitch of an L x L tile
constexpr int THREADS = 256;
constexpr int SLICE = 16;       // state rows a block of ssd_bwd_states holds
constexpr int N_MAX = 128;      // the largest state dim (16, 32, 64, 128 are taken)
constexpr unsigned FULL = 0xffffffffu;

// element i of a float32 or bfloat16 array (the dtype a runtime flag: one
// instantiation serves every dtype pair, which keeps nvcc's time down)
__device__ __forceinline__ float ld_f(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_f(void* p, int bf16, size_t i, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// the chunk's inclusive scan of dt a, in one fixed order (every kernel here
// takes the same values)
__device__ __forceinline__ void chunk_cum(float* cum, const float* dt, float a) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < L; ++i) {
      acc = acc + dt[i] * a;
      cum[i] = acc;
    }
  }
}

// rows t0 .. t0 + L - 1, columns c0 .. c0 + W - 1 of a [rows, ld] matrix
// starting at element `base` of src into dst[L][pitch] as float32 (zeros
// past `rows`)
__device__ __forceinline__ void load_rows(float* dst, int pitch, const void* src, int bf16,
                                          size_t base, int ld, int t0, int rows, int c0,
                                          int w) {
  for (int e = threadIdx.x; e < L * w; e += THREADS) {
    const int r = e / w, c = e - r * w;
    dst[r * pitch + c] =
        t0 + r < rows ? ld_f(src, bf16, base + (size_t)(t0 + r) * ld + c0 + c) : 0.f;
  }
}

// z = 0: S_c for every chunk (the state entering it); z = 1: E_c
template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_states(const void* __restrict__ x, const void* __restrict__ gy, int x_bf16,
               const float* __restrict__ dt, const float* __restrict__ a,
               const void* __restrict__ b, const void* __restrict__ c, int bc_bf16,
               float* __restrict__ states, float* __restrict__ carries, int s, int p,
               int hpg) {
  constexpr int EL = SLICE * N / THREADS;   // state elements a thread holds
  __shared__ float xs[L * SLICE];
  __shared__ float bs[L * N];
  __shared__ float vdt[L], vcum[L], w[L];
  const int h = blockIdx.x, p0 = blockIdx.y * SLICE, rev = blockIdx.z;
  const int g = h / hpg, nc = (s + L - 1) / L;
  const float ah = a[h];
  const void* xin = rev ? gy : x;
  const void* bin = rev ? c : b;
  float* out = rev ? carries : states;
  float st[EL];
#pragma unroll
  for (int k = 0; k < EL; ++k) st[k] = 0.f;
  for (int it = 0; it < nc; ++it) {
    const int ch = rev ? nc - 1 - it : it, t0 = ch * L;
    __syncthreads();                   // the last chunk's reads are done
    load_rows(xs, SLICE, xin, x_bf16, (size_t)h * s * p, p, t0, s, p0, SLICE);
    load_rows(bs, N, bin, bc_bf16, (size_t)g * s * N, N, t0, s, 0, N);
    for (int i = threadIdx.x; i < L; i += THREADS)
      vdt[i] = t0 + i < s ? dt[(size_t)h * s + t0 + i] : 0.f;
    __syncthreads();
    chunk_cum(vcum, vdt, ah);
    __syncthreads();
    const float total = vcum[L - 1];
    for (int i = threadIdx.x; i < L; i += THREADS)
      w[i] = rev ? expf(vcum[i]) : expf(total - vcum[i]) * vdt[i];
    __syncthreads();
    const float decay = expf(total);
    float* o = out + (((size_t)h * nc + ch) * p + p0) * N;
#pragma unroll
    for (int k = 0; k < EL; ++k) {
      const int e = threadIdx.x + k * THREADS, pl = e / N, n = e - pl * N;
      o[(size_t)pl * N + n] = st[k];
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(w[j] * xs[j * SLICE + pl], bs[j * N + n], acc);
      st[k] = decay * st[k] + acc;
    }
  }
}

// the chunk kernel's shared memory at head dim P and state dim n
__host__ __device__ constexpr int chunk_smem_floats(int P, int n) {
  return 2 * L * (P + 1) + 2 * L * (n + 1) + 3 * L * LX + 2 * (P < 32 ? P : 32) * (n + 1) +
         4 * L + 16;
}
static_assert(chunk_smem_floats(128, N_MAX) * 4 <= 232448, "shared memory");

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk(const void* __restrict__ x, const void* __restrict__ gy, int x_bf16,
              const float* __restrict__ dt, const float* __restrict__ a,
              const void* __restrict__ b, const void* __restrict__ c, int bc_bf16,
              const float* __restrict__ states, const float* __restrict__ carries,
              void* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbh,
              float* __restrict__ dch, float* __restrict__ da_part, int s, int hpg) {
  constexpr int PX = P + 1, NX = N + 1, PS = P < 32 ? P : 32;
  constexpr int NM = (N + 31) / 32;      // columns of N a lane takes
  constexpr int RW = L / (THREADS / 32); // rows a warp takes
  extern __shared__ float sm[];
  float* xs = sm;                        // [L][PX]
  float* gs = xs + L * PX;               // [L][PX]  gy
  float* bs = gs + L * PX;               // [L][NX]
  float* cs = bs + L * NX;               // [L][NX]
  float* m1 = cs + L * NX;               // [L][LX]  A
  float* m2 = m1 + L * LX;               // [L][LX]  W
  float* m3 = m2 + L * LX;               // [L][LX]  Q
  float* es = m3 + L * LX;               // [PS][NX] a slice of E_c
  float* ss = es + PS * NX;              // [PS][NX] a slice of S_c
  float* vdt = ss + PS * NX;             // [L]
  float* vcum = vdt + L;
  float* vdcum = vcum + L;
  float* vddt = vdcum + L;
  float* red = vddt + L;                 // [16]
  const int ch = blockIdx.x, h = blockIdx.y, g = h / hpg, t0 = ch * L;
  const int nc = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float ah = a[h];
  load_rows(xs, PX, x, x_bf16, (size_t)h * s * P, P, t0, s, 0, P);
  load_rows(gs, PX, gy, x_bf16, (size_t)h * s * P, P, t0, s, 0, P);
  load_rows(bs, NX, b, bc_bf16, (size_t)g * s * N, N, t0, s, 0, N);
  load_rows(cs, NX, c, bc_bf16, (size_t)g * s * N, N, t0, s, 0, N);
  for (int i = threadIdx.x; i < L; i += THREADS) {
    vdt[i] = t0 + i < s ? dt[(size_t)h * s + t0 + i] : 0.f;
    vddt[i] = 0.f;
  }
  __syncthreads();
  chunk_cum(vcum, vdt, ah);
  __syncthreads();
  const float total = vcum[L - 1];

  // A, W and Q, lower triangle
  for (int e = threadIdx.x; e < L * L; e += THREADS) {
    const int i = e / L, j = e - i * L;
    float va = 0.f, vw = 0.f, vq = 0.f;
    if (j <= i) {
      float cb = 0.f, gx = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) cb = fmaf(cs[i * NX + n], bs[j * NX + n], cb);
#pragma unroll 8
      for (int q = 0; q < P; ++q) gx = fmaf(gs[i * PX + q], xs[j * PX + q], gx);
      const float ex = expf(vcum[i] - vcum[j]);
      const float gd = vdt[j] * gx;
      va = cb * ex;
      vw = ex * gd;
      vq = va * gd;
    }
    m1[i * LX + j] = va;
    m2[i * LX + j] = vw;
    m3[i * LX + j] = vq;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += THREADS) {
    float rs = 0.f, cl = 0.f;
    for (int j = 0; j < L; ++j) {
      rs += m3[i * LX + j];
      cl += m3[j * LX + i];
    }
    vdcum[i] = rs - cl;
  }

  // the E_c and S_c terms, PS state rows at a time: u (dx, d(dt)), and the
  // E/S halves of dB and dC in registers (warp w owns rows w + 8 k, lane l
  // columns l + 32 m)
  const float* eg = carries + ((size_t)h * nc + ch) * P * N;
  const float* sg = states + ((size_t)h * nc + ch) * P * N;
  float accb[RW][NM], accc[RW][NM];
#pragma unroll
  for (int k = 0; k < RW; ++k)
#pragma unroll
    for (int m = 0; m < NM; ++m) accb[k][m] = accc[k][m] = 0.f;
  float es_dot = 0.f;
  for (int q0 = 0; q0 < P; q0 += PS) {
    __syncthreads();                     // the last slice's reads are done
    for (int e = threadIdx.x; e < PS * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      const float ev = eg[(size_t)(q0 + r) * N + n], sv = sg[(size_t)(q0 + r) * N + n];
      es[r * NX + n] = ev;
      ss[r * NX + n] = sv;
      es_dot = fmaf(ev, sv, es_dot);
    }
    __syncthreads();
    // u for rows j of this warp, columns q0 + lane (lane < PS)
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      const int j = warp + 8 * k;
      float part = 0.f;
      if (lane < PS) {
        const int q = q0 + lane;
        float u = 0.f;
        for (int i = j; i < L; ++i) u = fmaf(m1[i * LX + j], gs[i * PX + q], u);
        float eb = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) eb = fmaf(es[lane * NX + n], bs[j * NX + n], eb);
        u = fmaf(expf(total - vcum[j]), eb, u);
        if (t0 + j < s) st_f(dx, x_bf16, ((size_t)h * s + t0 + j) * P + q, vdt[j] * u);
        part = xs[j * PX + q] * u;
      }
      part = warp_sum(part);
      if (lane == 0) vddt[j] += part;
    }
    // x^T E and gy^T S over this slice's rows
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      const int j = warp + 8 * k;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int n = lane + 32 * m;
        if (n >= N) continue;
        float ab = accb[k][m], ac = accc[k][m];
        for (int r = 0; r < PS; ++r) {
          ab = fmaf(xs[j * PX + q0 + r], es[r * NX + n], ab);
          ac = fmaf(gs[j * PX + q0 + r], ss[r * NX + n], ac);
        }
        accb[k][m] = ab;
        accc[k][m] = ac;
      }
    }
  }

  // dB, dC (this head's), T - U into dcum
  float u_sum = 0.f;
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    const int j = warp + 8 * k;
    const float fb = vdt[j] * expf(total - vcum[j]), fc = expf(vcum[j]);
    float tu = 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int n = lane + 32 * m;
      if (n >= N) continue;
      const float eb = fb * accb[k][m], sc = fc * accc[k][m];
      float db = eb, dc = sc;
      for (int i = j; i < L; ++i) db = fmaf(m2[i * LX + j], cs[i * NX + n], db);
      for (int i = 0; i <= j; ++i) dc = fmaf(m2[j * LX + i], bs[i * NX + n], dc);
      if (t0 + j < s) {
        dbh[((size_t)h * s + t0 + j) * N + n] = db;
        dch[((size_t)h * s + t0 + j) * N + n] = dc;
      }
      tu += sc * cs[j * NX + n] - eb * bs[j * NX + n];
    }
    tu = warp_sum(tu);
    if (lane == 0) vdcum[j] += tu;
    // U_j again, alone: dtotal gains sum_j U_j
    float uj = 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int n = lane + 32 * m;
      if (n < N) uj += fb * accb[k][m] * bs[j * NX + n];
    }
    u_sum += warp_sum(uj);
  }
  es_dot = warp_sum(es_dot);
  if (lane == 0) {
    red[warp] = u_sum;
    red[8 + warp] = es_dot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float us = 0.f, esd = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) {
      us += red[w];
      esd += red[8 + w];
    }
    vdcum[L - 1] += us + expf(total) * esd;
    float lam = 0.f, dap = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      lam += vdcum[k];
      dap = fmaf(vdt[k], lam, dap);
      if (t0 + k < s) ddt[(size_t)h * s + t0 + k] = vddt[k] + ah * lam;
    }
    da_part[(size_t)h * nc + ch] = dap;
  }
}

// dB/dC [G, S, N] = sum over a group's heads, cast; da [BH] = sum over chunks
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ dbh, const float* __restrict__ dch,
               const float* __restrict__ da_part, void* __restrict__ db,
               void* __restrict__ dc, int bc_bf16, float* __restrict__ da,
               long long per_group, int groups, int hpg, int bh, int nc) {
  const long long total = per_group * groups;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const long long g = e / per_group, r = e - g * per_group;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < hpg; ++k) {
      const size_t at = (size_t)(g * hpg + k) * per_group + r;
      sb += dbh[at];
      sc += dch[at];
    }
    st_f(db, bc_bf16, e, sb);
    st_f(dc, bc_bf16, e, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < bh; h += THREADS) {
      float acc = 0.f;
      for (int k = 0; k < nc; ++k) acc += da_part[(size_t)h * nc + k];
      da[h] = acc;
    }
  }
}

struct Args {
  const void *x, *gy, *dt, *a, *b, *c;
  void *dx, *ddt, *da, *db, *dc, *scratch;
  int bh, s, hpg, x_bf16, bc_bf16;
};

template <int P, int N>
int launch_pn(const Args& g, cudaStream_t st) {
  const int bh = g.bh, s = g.s, hpg = g.hpg;
  const int nc = (s + L - 1) / L, groups = bh / hpg;
  const size_t state_elems = (size_t)bh * nc * P * N;
  float* states = static_cast<float*>(g.scratch);
  float* carries = states + state_elems;
  float* dbh = carries + state_elems;
  float* dch = dbh + (size_t)bh * s * N;
  float* da_part = dch + (size_t)bh * s * N;
  const float* DT = static_cast<const float*>(g.dt);
  const float* A = static_cast<const float*>(g.a);
  ssd_bwd_states<N><<<dim3(bh, P / SLICE, 2), THREADS, 0, st>>>(
      g.x, g.gy, g.x_bf16, DT, A, g.b, g.c, g.bc_bf16, states, carries, s, P, hpg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  constexpr int smem = chunk_smem_floats(P, N) * 4;
  e = cudaFuncSetAttribute(ssd_bwd_chunk<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return int(e);
  ssd_bwd_chunk<P, N><<<dim3(nc, bh), THREADS, smem, st>>>(
      g.x, g.gy, g.x_bf16, DT, A, g.b, g.c, g.bc_bf16, states, carries, g.dx,
      static_cast<float*>(g.ddt), dbh, dch, da_part, s, hpg);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  const long long per_group = (long long)s * N;
  const long long blocks = std::min<long long>((per_group * groups + THREADS - 1) / THREADS,
                                               4096);
  ssd_bwd_reduce<<<int(std::max<long long>(blocks, 1)), THREADS, 0, st>>>(
      dbh, dch, da_part, g.db, g.dc, g.bc_bf16, static_cast<float*>(g.da), per_group, groups,
      hpg, bh, nc);
  return int(cudaGetLastError());
}

template <int P>
int launch_p(const Args& g, int n, cudaStream_t st) {
  switch (n) {
    case 16: return launch_pn<P, 16>(g, st);
    case 32: return launch_pn<P, 32>(g, st);
    case 64: return launch_pn<P, 64>(g, st);
    case 128: return launch_pn<P, 128>(g, st);
    default: return int(cudaErrorInvalidValue);
  }
}

int launch(const Args& g, int p, int n, void* stream) {
  if (g.bh <= 0 || g.s <= 0) return 0;
  if (g.hpg <= 0 || g.bh % g.hpg != 0 || g.bh > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 32: return launch_p<32>(g, n, st);
    case 64: return launch_p<64>(g, n, st);
    case 128: return launch_p<128>(g, n, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x, gy, dx [bh, s, p] (f32 or bf16, by the suffix's first part); dt, ddt
// [bh, s] f32; a, da [bh] f32; b, c, db, dc [bh / hpg, s, n] (f32 or bf16, by
// its second part); scratch float32: 2 x bh x ceil(s / 64) x p x n (S_c, E_c),
// 2 x bh x s x n (per-head dB, dC), bh x ceil(s / 64) (da's parts); all
// contiguous.
#define SSD_BWD(name, X_BF16, BC_BF16)                                                \
  int name(const void* x, const void* gy, const void* dt, const void* a, const void* b,  \
           const void* c, void* dx, void* ddt, void* da, void* db, void* dc,             \
           void* scratch, int bh, int s, int p, int n, int hpg, void* stream) {          \
    const Args g{x, gy, dt, a, b, c, dx, ddt, da, db, dc, scratch, bh, s, hpg, X_BF16,    \
                 BC_BF16};                                                               \
    return launch(g, p, n, stream);                                                      \
  }
SSD_BWD(ssd_scan_bwd_f32_f32, 0, 0)
SSD_BWD(ssd_scan_bwd_f32_bf16, 0, 1)
SSD_BWD(ssd_scan_bwd_bf16_f32, 1, 0)
SSD_BWD(ssd_scan_bwd_bf16_bf16, 1, 1)
#undef SSD_BWD

}  // extern "C"
