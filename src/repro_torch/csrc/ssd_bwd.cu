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
// chunk's inclusive scan of dt a, total = cum_{L-1}, f_j = exp(total -
// cum_j), w_j = f_j dt_j, S_c the state entering chunk c and E_c = dL/dh at
// chunk c's last step from later chunks only:
//   S_{c+1} = exp(total_c) S_c + dS_c,      dS_c = (x o w)^T B
//   E_{c-1} = exp(total_c) E_c + dE_c,      dE_c = (gy o exp(cum))^T C
//   A_ij = (C_i . B_j) exp(cum_i - cum_j),  W_ij = exp(cum_i - cum_j) dt_j (gy_i . x_j)
//          for j <= i (else 0)
//   u_j  = sum_i A_ij gy_i + f_j E_c B_j                         [P]
//   dx_j = dt_j u_j,   d(dt)_j = x_j . u_j + a dlam_j
//   dB_j = sum_i W_ij C_i + w_j x_j^T E_c        (summed over the group)
//   dC_i = sum_j W_ij B_j + exp(cum_i) gy_i^T S_c
//   dcum_i = sum_j Q_ij - sum_j Q_ji + T_i - U_i,  Q_ij = A_ij dt_j (gy_i . x_j),
//          T_i = exp(cum_i) gy_i . (C_i S_c^T),  U_j = w_j x_j . (B_j E_c^T),
//          and dcum_{L-1} += sum_j U_j + exp(total) sum(E_c o S_c)
//   dlam_k = sum_{i >= k} dcum_i  (the chunk's reverse scan),  da = sum_k dt_k dlam_k
// Every exponential taken is of a number <= 0 (a < 0, dt >= 0): each L x L
// decay is masked before it is taken, never factored into exp(cum_i)
// exp(-cum_j) (a chunk's sum of dt a reaches -100 at mamba2-780m's init).
// The ragged tail reads dt = 0 and x = gy = B = C = 0: its terms are zero.
// Outputs are rounded to their input's dtype once.
//
// What bounds the function: bytes, as the forward (x, gy, dx in x's dtype;
// B, C, dB, dC per sequence; dt, d(dt) in float32): 0.0485 ms at
// mamba2-780m's training shape (B 1, 48 heads, S 8192, P 64, N 128, x, B
// and C in bf16), ~163 MB at 3.35 TB/s.  Two paths:
//
// The wgmma path (x, B and C in bf16, P 64, N 128: the training path's
// form; namespace wg below).  Four launches on the caller's stream:
//   ssd_bwd_delta  grid (NC, BH): each chunk's local dS_c and dE_c on
//                  wgmma (m64n128, k over the chunk's steps, x o w and
//                  gy o exp(cum) read MN-major), its cum and dt (a warp
//                  scan) into a vector for the later launches; dS_c and
//                  dE_c into scratch as bf16;
//   ssd_bwd_scan   the chains over chunks: one thread for 8 adjacent (p, n)
//                  of a head's S (forward) or E (backward), S_c and E_c
//                  written over dS_c and dE_c in place, bf16; bytes-bound,
//                  its loads batched ahead of the dependent FMAs;
//   ssd_bwd_chunk  grid (NC, G): a block per (chunk, group) computes C.B^T
//                  (and B.C^T) once, then walks the group's heads in order,
//                  their x, gy, S_c, E_c tiles and vectors TMA-fed through
//                  a two-stage ring, with dB and dC of the group in two
//                  m64n128 float32 accumulators (no per-head scratch, no
//                  atomics: deterministic).  A head's products, all bf16
//                  wgmma with float32 accumulation: gy.x^T and x.gy^T (W and
//                  W^T, A^T and both orientations of Q, so that both of
//                  dcum's Q sums are row sums of a quad), W.B and W^T.C,
//                  (x o w).E and (gy o exp(cum)).S into the accumulators,
//                  B.E^T (U, and u with A^T.gy added from registers), C.S^T
//                  (T); dcum's sums and the reverse scan stay float32 from
//                  the accumulators, the scan one warp's shuffles;
//   ssd_bwd_da     da = sum over a head's chunks, in order.
// Every operand that holds float32 digits is rounded to bf16 once: x o w,
// gy o exp(cum), A, W, dS_c, dE_c, S_c and E_c (2^-9 a term; the CPU
// emulation in tests/test_torch_ssd.py holds the scheme to the bf16 bars).
// Scratch: dS/S and dE/E [BH, NC, P, N] bf16, the vectors [BH, NC, 2, L]
// and da's parts [BH, NC] float32 (~192 MiB at the training shape).
//
// The FMA path (every other form: float32 x or B/C, P 32/128, N 16-64): the
// first kernel, three launches (1 ssd_bwd_states, 2 ssd_bwd_chunk, 4
// ssd_bwd_reduce), every product float32 on the FMA pipes:
//   ssd_bwd_states  grid (BH, P / 16, 2): z = 0 walks the chunks forward and
//                   stores each S_c, z = 1 walks them backward and stores
//                   each E_c, each block with a 16-row slice of its head's
//                   [P, N] state in registers;
//   ssd_bwd_chunk   grid (NC, BH): every term above for one chunk of one head,
//                   from S_c and E_c, writing dx, d(dt), this head's own dB
//                   and dC (float32 scratch) and its part of da;
//   ssd_bwd_reduce  sums dB and dC over each group's heads and da over a
//                   head's chunks, in a fixed order, and casts.
// Its scratch: S_c and E_c [BH, NC, P, N] float32, per-head dB and dC, da's
// parts; one block an SM (its tiles take ~180 KB of shared memory).

#include <algorithm>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

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

// ---------------------------------------------------------------------------
// The wgmma path: x, B and C in bf16, P 64, N 128 (see the note at the top)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int WL = 64;                 // steps per chunk: one 64-row tile
constexpr int WP = 64;                 // head dim P
constexpr int WN = 128;                // state dim N
constexpr int WT = 128;                // one warpgroup
constexpr int CHB = 64 * CHUNK_ROW;    // 8,192: one 64-row, 64-column swizzled chunk
constexpr int XT = WL * WP * 2;        // a bf16 [64, 64] tile (x, gy): one chunk
constexpr int NT = 64 * WN * 2;        // a bf16 [64, 128] tile (B, C, S_c, E_c): two chunks
constexpr int VEC = 2 * WL * 4;        // a chunk's cum[64] and dt[64]
constexpr int STATE = WP * WN;         // elements of a [P, N] state
constexpr int SCAN_BATCH = 8;          // chunks whose loads ssd_bwd_scan issues together

// ssd_bwd_delta's shared memory: x (then x o w), gy (then gy o exp(cum)),
// B, C, the vector, an mbarrier; 1,024 bytes to align the tiles
struct DeltaCfg {
  static constexpr int OFF_G = XT, OFF_B = 2 * XT, OFF_C = OFF_B + NT, OFF_VEC = OFF_C + NT;
  static constexpr int OFF_BAR = OFF_VEC + VEC;
  static constexpr int SMEM = 1024 + OFF_BAR + 8;
};

// ssd_bwd_chunk_wg's: the group's B and C, C.B^T and B.C^T (float32 in
// fragment order), the x o w and gy o exp(cum) tiles, the ring (x, gy, S_c,
// E_c a stage) and its vectors, the per-row sums, the mbarriers
struct ChunkCfg {
  static constexpr int STAGES = 2;
  static constexpr int STAGE = 2 * XT + 2 * NT;
  static constexpr int OFF_C = NT, OFF_CB = 2 * NT, OFF_BC = OFF_CB + WL * WL * 4;
  static constexpr int OFF_XW = OFF_BC + WL * WL * 4, OFF_GE = OFF_XW + XT;
  static constexpr int OFF_RING = OFF_GE + XT;
  static constexpr int OFF_VEC = OFF_RING + STAGES * STAGE;
  static constexpr int OFF_ROWS = OFF_VEC + STAGES * VEC;   // rq, cq, T, U, dd [64], red [8]
  static constexpr int OFF_BAR = OFF_ROWS + (5 * WL + 8) * 4;   // full[STAGES], resident
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (STAGES + 1);
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(OFF_RING % 1024 == 0 && STAGE % 1024 == 0 && OFF_XW % 1024 == 0,
                "tiles stay 1,024-aligned");
};

// 8 bf16 at src times m, rounded to bf16, into dst (16 bytes each)
__device__ __forceinline__ void scale8(const uint8_t* src, uint8_t* dst, float m) {
  uint4 v = *reinterpret_cast<const uint4*>(src);
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    w[k] = pack_f(f.x * m, f.y * m);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// x o w (rows j times w_j = exp(total - cum_j) dt_j) and gy o exp(cum) (rows
// i) from the swizzled x and gy tiles into xw and ge (which may be x and
// gy): the swizzle keeps each 128-byte row, and a 16-byte group holds 8
// values of one row
__device__ __forceinline__ void scaled_tiles(const uint8_t* x, const uint8_t* gy, uint8_t* xw,
                                             uint8_t* ge, const float* cum, const float* dtv) {
  const float total = cum[WL - 1];
  for (int e = threadIdx.x & (WT - 1); e < XT / 16; e += WT) {
    const int r = e >> 3;
    scale8(x + 16 * e, xw + 16 * e, ex2((total - cum[r]) * LOG2E) * dtv[r]);
    scale8(gy + 16 * e, ge + 16 * e, ex2(cum[r] * LOG2E));
  }
}

// the bf16 pair (r, c), (r, c + 1) of a swizzled 64-column tile, c even
__device__ __forceinline__ float2 pair_at(const uint8_t* tile, int r, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + swz(r, c)));
}

// an m64n128 accumulator (rows 0..63, 128 columns), rows r < n, into row
// row0 + r of a [.., 128] bf16 matrix
__device__ __forceinline__ void store_n128(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[64], size_t row0, int n) {
  const int tid = threadIdx.x & (WT - 1), warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= n) continue;
    __nv_bfloat16* op = out + (row0 + r) * WN + 2 * tq;
#pragma unroll
    for (int i = 0; i < WN / 8; ++i)
      *reinterpret_cast<uint32_t*>(op + 8 * i) = pack_f(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
  }
}

// Block (chunk c, head h): the chunk's cum and dt into vec; dS_c = (x o
// w)^T B and dE_c = (gy o exp(cum))^T C (m64n128: rows p, columns n; A
// MN-major from the scaled tile, B MN-major) into scratch as bf16.
__global__ void __launch_bounds__(WT)
ssd_bwd_delta(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmg,
              const __grid_constant__ CUtensorMap tmb, const __grid_constant__ CUtensorMap tmc,
              const float* __restrict__ dt, const float* __restrict__ a,
              float* __restrict__ vec, __nv_bfloat16* __restrict__ dstate,
              __nv_bfloat16* __restrict__ dcarry, int s, int hpg) {
  using C = DeltaCfg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* gb = smem_raw + (base - raw);
  const uint32_t bar = base + C::OFF_BAR;
  const int c = blockIdx.x, h = blockIdx.y, g = h / hpg, nc = gridDim.x, t0 = c * WL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* vcum = reinterpret_cast<float*>(gb + C::OFF_VEC);
  float* vdt = vcum + WL;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * XT + 2 * NT);
    tma_load(base, &tmx, 0, t0, h, bar);
    tma_load(base + C::OFF_G, &tmg, 0, t0, h, bar);
    for (int ch = 0; ch < 2; ++ch) {
      tma_load(base + C::OFF_B + ch * CHB, &tmb, ch * CH, t0, g, bar);
      tma_load(base + C::OFF_C + ch * CHB, &tmc, ch * CH, t0, g, bar);
    }
  }
  if (warp == 0) {                       // the chunk's inclusive scan of dt a
    const float* dtp = dt + (size_t)h * s;
    const float ah = a[h];
    const float d0 = t0 + lane < s ? dtp[t0 + lane] : 0.f;
    const float d1 = t0 + 32 + lane < s ? dtp[t0 + 32 + lane] : 0.f;
    float v0 = d0 * ah, v1 = d1 * ah;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u0 = __shfl_up_sync(FULL, v0, o), u1 = __shfl_up_sync(FULL, v1, o);
      if (lane >= o) {
        v0 += u0;
        v1 += u1;
      }
    }
    v1 += __shfl_sync(FULL, v0, 31);
    vcum[lane] = v0;
    vcum[lane + 32] = v1;
    vdt[lane] = d0;
    vdt[lane + 32] = d1;
    float* o = vec + ((size_t)h * nc + c) * 2 * WL;
    o[lane] = v0;
    o[lane + 32] = v1;
    o[WL + lane] = d0;
    o[WL + lane + 32] = d1;
  }
  __syncthreads();
  mbar_wait(bar, 0);
  scaled_tiles(gb, gb + C::OFF_G, gb, gb + C::OFF_G, vcum, vdt);
  fence_async_smem();
  __syncthreads();
  float acc[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WL / 16; ++kk)       // 16 steps j (2,048 bytes) a k-step
    wgmma_sst<1, 1>(acc, desc(base + kk * 2048, 16), desc(base + C::OFF_B + kk * 2048, CHB),
                    kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  store_n128(dstate, acc, ((size_t)h * nc + c) * WP, WP);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WL / 16; ++kk)
    wgmma_sst<1, 1>(acc, desc(base + C::OFF_G + kk * 2048, 16),
                    desc(base + C::OFF_C + kk * 2048, CHB), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  store_n128(dcarry, acc, ((size_t)h * nc + c) * WP, WP);
}

// One thread: 8 adjacent elements of a head's [P, N] state, y = 0 the
// forward chain (S_c over dS_c), y = 1 the backward one (E_c over dE_c), in
// place; SCAN_BATCH chunks' loads issued before their dependent FMAs
__global__ void __launch_bounds__(256)
ssd_bwd_scan(__nv_bfloat16* __restrict__ dstate, __nv_bfloat16* __restrict__ dcarry,
             const float* __restrict__ vec, int bh, int nc) {
  constexpr int PER = STATE / 8;         // threads a head
  const long long lane = blockIdx.x * 256ll + threadIdx.x;
  if (lane >= (long long)bh * PER) return;
  const int h = int(lane / PER), rev = blockIdx.y;
  uint4* p = reinterpret_cast<uint4*>((rev ? dcarry : dstate) + (size_t)h * nc * STATE) +
             (lane - (long long)h * PER);
  const float* tot = vec + (size_t)h * nc * 2 * WL + WL - 1;   // chunk c's at c * 2 WL
  float st[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) st[e] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += SCAN_BATCH) {
    uint4 d[SCAN_BATCH];
    float dec[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k) {
      const int it = c0 + k, ch = rev ? nc - 1 - it : it;
      if (it < nc) {
        d[k] = p[(size_t)ch * PER];
        dec[k] = expf(tot[(size_t)ch * 2 * WL]);
      }
    }
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k) {
      const int it = c0 + k, ch = rev ? nc - 1 - it : it;
      if (it >= nc) break;
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
      const uint32_t* dw = reinterpret_cast<const uint32_t*>(&d[k]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ow[e] = pack_f(st[2 * e], st[2 * e + 1]);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[e]));
        st[2 * e] = fmaf(dec[k], st[2 * e], f.x);
        st[2 * e + 1] = fmaf(dec[k], st[2 * e + 1], f.y);
      }
      p[(size_t)ch * PER] = o;
    }
  }
}

// Block (chunk c, group g): C.B^T once, then the group's heads in order,
// dB and dC of the group in registers; each head's dx, d(dt) and part of da.
__global__ void __launch_bounds__(WT, 1)
ssd_bwd_chunk_wg(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmg,
                 const __grid_constant__ CUtensorMap tmb, const __grid_constant__ CUtensorMap tmc,
                 const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tme,
                 const float* __restrict__ vec, const float* __restrict__ a,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ da_part, __nv_bfloat16* __restrict__ db,
                 __nv_bfloat16* __restrict__ dc, int s, int hpg) {
  using C = ChunkCfg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* gb = smem_raw + (base - raw);
  const uint32_t sb = base, sc = base + C::OFF_C, sxw = base + C::OFF_XW, sge = base + C::OFF_GE;
  const uint32_t bars = base + C::OFF_BAR, res = bars + 8 * C::STAGES;
  float* cbf = reinterpret_cast<float*>(gb + C::OFF_CB);   // C.B^T, value k of thread t at k * WT + t
  float* bcf = reinterpret_cast<float*>(gb + C::OFF_BC);   // B.C^T
  float* rq = reinterpret_cast<float*>(gb + C::OFF_ROWS);  // sum_j Q_ij
  float* cq = rq + WL;                                     // sum_j Q_ji
  float* tr = cq + WL;                                     // T_i
  float* ur = tr + WL;                                     // U_j
  float* dd = ur + WL;                                     // x_j . u_j
  float* red = dd + WL;                                    // sum(E o S), a warp's part
  const int c = blockIdx.x, g = blockIdx.y, nc = gridDim.x, t0 = c * WL, h0 = g * hpg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r[2] = {warp * 16 + gq, warp * 16 + gq + 8};   // this thread's accumulator rows

  if (tid == 0) {
    for (int i = 0; i <= C::STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // head n's x, gy, S_c, E_c and vector into stage n % STAGES
  auto load = [&](int n) {
    const int h = h0 + n;
    const uint32_t st = base + C::OFF_RING + (n % C::STAGES) * C::STAGE;
    const uint32_t bar = bars + 8 * (n % C::STAGES);
    mbar_expect_tx(bar, C::STAGE + VEC);
    tma_load(st, &tmx, 0, t0, h, bar);
    tma_load(st + XT, &tmg, 0, t0, h, bar);
    for (int ch = 0; ch < 2; ++ch) {
      tma_load(st + 2 * XT + ch * CHB, &tms, ch * CH, 0, h * nc + c, bar);
      tma_load(st + 2 * XT + NT + ch * CHB, &tme, ch * CH, 0, h * nc + c, bar);
    }
    bulk_load(base + C::OFF_VEC + (n % C::STAGES) * VEC, vec + ((size_t)h * nc + c) * 2 * WL,
              VEC, bar);
  };
  if (tid == 0) {
    mbar_expect_tx(res, 2 * NT);
    for (int ch = 0; ch < 2; ++ch) {
      tma_load(sb + ch * CHB, &tmb, ch * CH, t0, g, res);
      tma_load(sc + ch * CHB, &tmc, ch * CH, t0, g, res);
    }
    for (int n = 0; n < C::STAGES && n < hpg; ++n) load(n);
  }
  mbar_wait(res, 0);
  {                                      // C.B^T (rows i) and B.C^T (rows j)
    float m[32];
    wgmma_fence();
    ss_product<WN>(m, desc(sc, 16), desc(sb, 16), CHB, CHB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(m);
#pragma unroll
    for (int k = 0; k < 32; ++k) cbf[k * WT + tid] = m[k];
    wgmma_fence();
    ss_product<WN>(m, desc(sb, 16), desc(sc, 16), CHB, CHB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(m);
#pragma unroll
    for (int k = 0; k < 32; ++k) bcf[k * WT + tid] = m[k];
  }
  float accb[64], accc[64];              // dB (rows j) and dC (rows i) of the group
#pragma unroll
  for (int i = 0; i < 64; ++i) accb[i] = accc[i] = 0.f;

  for (int n = 0; n < hpg; ++n) {
    const int h = h0 + n, stg = n % C::STAGES;
    const uint32_t sx = base + C::OFF_RING + stg * C::STAGE, sg = sx + XT, ss = sg + XT,
                   se = ss + NT;
    const uint8_t* xg8 = gb + (sx - base);
    const uint8_t* gy8 = gb + (sg - base);
    const float* cum = reinterpret_cast<const float*>(gb + C::OFF_VEC + stg * VEC);
    const float* dtv = cum + WL;
    mbar_wait(bars + 8 * stg, uint32_t((n / C::STAGES) & 1));
    scaled_tiles(xg8, gy8, gb + C::OFF_XW, gb + C::OFF_GE, cum, dtv);
    fence_async_smem();
    __syncthreads();
    const float total = cum[WL - 1];

    // gy.x^T (rows i, columns j) and x.gy^T (rows j, columns i)
    float gxm[32], xgm[32];
    wgmma_fence();
    ss_product<WP>(gxm, desc(sg, 16), desc(sx, 16), CHB, CHB);
    ss_product<WP>(xgm, desc(sx, 16), desc(sg, 16), CHB, CHB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gxm);
    fence_regs(xgm);

    // rows i: W (bf16, the A operand of W.B) and sum_j Q_ij, Q = (C.B^T) o W;
    // rows j: W^T (of W^T.C), A^T (of A^T.gy) and sum_i Q_ij.  Masked before
    // the exponential; an 8-column block 2 kk (+1) and row half hh make
    // fragment register [kk][2 (blk & 1) + hh]
    uint32_t wa[4][4], wt[4][4], at[4][4];
    {
      const float ci[2] = {cum[r[0]], cum[r[1]]}, di[2] = {dtv[r[0]], dtv[r[1]]};
      float qi[2] = {0.f, 0.f}, qj[2] = {0.f, 0.f};
#pragma unroll
      for (int blk = 0; blk < WL / 8; ++blk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float vw[2], vt[2], va[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * blk + 2 * tq + e, idx = 4 * blk + 2 * hh + e;
            const float cc = cum[col];
            vw[e] = vt[e] = va[e] = 0.f;
            if (col <= r[hh]) {          // rows i = r, columns j = col
              const float w = ex2((ci[hh] - cc) * LOG2E) * dtv[col] * gxm[idx];
              qi[hh] = fmaf(cbf[idx * WT + tid], w, qi[hh]);
              vw[e] = w;
            }
            if (col >= r[hh]) {          // rows j = r, columns i = col
              const float ex = ex2((cc - ci[hh]) * LOG2E), bcv = bcf[idx * WT + tid];
              const float w = ex * di[hh] * xgm[idx];
              qj[hh] = fmaf(bcv, w, qj[hh]);
              vt[e] = w;
              va[e] = bcv * ex;
            }
          }
          const int kk = blk >> 1, q = 2 * (blk & 1) + hh;
          wa[kk][q] = pack_f(vw[0], vw[1]);
          wt[kk][q] = pack_f(vt[0], vt[1]);
          at[kk][q] = pack_f(va[0], va[1]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        qi[hh] = quad_sum(qi[hh]);
        qj[hh] = quad_sum(qj[hh]);
        if (tq == 0) {
          rq[r[hh]] = qi[hh];
          cq[r[hh]] = qj[hh];
        }
      }
    }

    // dC += W.B + (gy o exp(cum)).S, dB += W^T.C + (x o w).E, and B.E^T
    // (rows j, columns p)
    float ue[32];
    fence_regs(wa);
    fence_regs(wt);
    fence_regs(at);
    fence_regs(accb);
    fence_regs(accc);
    wgmma_fence();
    rs_product<WL>(accc, wa, sb, CHB);
    rs_product<WL>(accb, wt, sc, CHB);
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      wgmma_sst<0, 1>(accb, desc(sxw + kk * 32, 16), desc(se + kk * 2048, CHB), 1);
      wgmma_sst<0, 1>(accc, desc(sge + kk * 32, 16), desc(ss + kk * 2048, CHB), 1);
    }
    ss_product<WN>(ue, desc(sb, 16), desc(se, 16), CHB, CHB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(accb);
    fence_regs(accc);
    fence_regs(ue);

    // U_j = w_j x_j . (B E^T)_j, then u_j = f_j (B E^T)_j + (A^T gy)_j
    float xu[2] = {0.f, 0.f}, fj[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) fj[hh] = ex2((total - cum[r[hh]]) * LOG2E);
#pragma unroll
    for (int blk = 0; blk < WP / 8; ++blk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 xv = pair_at(xg8, r[hh], 8 * blk + 2 * tq);
        float& u0 = ue[4 * blk + 2 * hh];
        float& u1 = ue[4 * blk + 2 * hh + 1];
        xu[hh] = fmaf(xv.x, u0, fmaf(xv.y, u1, xu[hh]));
        u0 *= fj[hh];
        u1 *= fj[hh];
      }
    float csm[32];                       // C.S^T (rows i, columns p)
    fence_regs(ue);
    wgmma_fence();
    rs_product<WL>(ue, at, sg, CHB);
    ss_product<WN>(csm, desc(sc, 16), desc(ss, 16), CHB, CHB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ue);
    fence_regs(csm);

    // dx, x_j . u_j, and T_i = exp(cum_i) gy_i . (C S^T)_i
    float du[2] = {0.f, 0.f}, tt[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = r[hh];
      const bool in = t0 + j < s;
      const float dj = dtv[j];
      __nv_bfloat16* dxp = dx + ((size_t)h * s + t0 + j) * WP + 2 * tq;
#pragma unroll
      for (int blk = 0; blk < WP / 8; ++blk) {
        const float u0 = ue[4 * blk + 2 * hh], u1 = ue[4 * blk + 2 * hh + 1];
        const float2 xv = pair_at(xg8, j, 8 * blk + 2 * tq);
        const float2 gv = pair_at(gy8, j, 8 * blk + 2 * tq);
        du[hh] = fmaf(xv.x, u0, fmaf(xv.y, u1, du[hh]));
        tt[hh] = fmaf(gv.x, csm[4 * blk + 2 * hh], fmaf(gv.y, csm[4 * blk + 2 * hh + 1], tt[hh]));
        if (in) *reinterpret_cast<uint32_t*>(dxp + 8 * blk) = pack_f(dj * u0, dj * u1);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float x2 = quad_sum(xu[hh]), d2 = quad_sum(du[hh]), t2 = quad_sum(tt[hh]);
      if (tq == 0) {
        const int j = r[hh];
        ur[j] = dtv[j] * fj[hh] * x2;
        dd[j] = d2;
        tr[j] = ex2(cum[j] * LOG2E) * t2;
      }
    }
    // sum(E o S): the two tiles share one swizzled layout, element for element
    {
      const uint8_t* s8 = gb + (ss - base);
      const uint8_t* e8 = gb + (se - base);
      float es = 0.f;
      for (int e = tid; e < NT / 16; e += WT) {
        const uint4 sv = *reinterpret_cast<const uint4*>(s8 + 16 * e);
        const uint4 ev = *reinterpret_cast<const uint4*>(e8 + 16 * e);
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(&sv);
        const uint32_t* ew = reinterpret_cast<const uint32_t*>(&ev);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 a2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sw[k]));
          const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ew[k]));
          es = fmaf(a2.x, b2.x, fmaf(a2.y, b2.y, es));
        }
      }
      es = warp_sum(es);
      if (lane == 0) red[warp] = es;
    }
    __syncthreads();
    if (warp == 0) {                     // dcum, its reverse scan, d(dt) and da's part
      const float ah = a[h];
      float d0 = rq[lane] - cq[lane] + tr[lane] - ur[lane];
      float d1 = rq[lane + 32] - cq[lane + 32] + tr[lane + 32] - ur[lane + 32];
      const float usum = warp_sum(ur[lane] + ur[lane + 32]);
      const float esum = red[0] + red[1] + red[2] + red[3];
      if (lane == 31) d1 += usum + ex2(total * LOG2E) * esum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {   // suffix sums: dlam_k = sum_{i >= k} dcum_i
        const float v0 = __shfl_down_sync(FULL, d0, o), v1 = __shfl_down_sync(FULL, d1, o);
        if (lane + o < 32) {
          d0 += v0;
          d1 += v1;
        }
      }
      d0 += __shfl_sync(FULL, d1, 0);
      if (t0 + lane < s) ddt[(size_t)h * s + t0 + lane] = dd[lane] + ah * d0;
      if (t0 + lane + 32 < s) ddt[(size_t)h * s + t0 + lane + 32] = dd[lane + 32] + ah * d1;
      const float dap = warp_sum(fmaf(dtv[lane], d0, dtv[lane + 32] * d1));
      if (lane == 0) da_part[(size_t)h * nc + c] = dap;
    }
    fence_async_smem();
    __syncthreads();                     // the stage, the scaled tiles, the row sums are free
    if (tid == 0 && n + C::STAGES < hpg) load(n + C::STAGES);
  }
  const int rows = min(WL, s - t0);
  store_n128(db, accb, (size_t)g * s + t0, rows);
  store_n128(dc, accc, (size_t)g * s + t0, rows);
}

// da [BH] = sum of a head's chunk parts, in order
__global__ void __launch_bounds__(256)
ssd_bwd_da(const float* __restrict__ part, float* __restrict__ da, int bh, int nc) {
  const int h = blockIdx.x * 256 + threadIdx.x;
  if (h >= bh) return;
  float acc = 0.f;
  for (int k = 0; k < nc; ++k) acc += part[(size_t)h * nc + k];
  da[h] = acc;
}

}  // namespace wg

struct Args {
  const void *x, *gy, *dt, *a, *b, *c;
  void *dx, *ddt, *da, *db, *dc, *scratch;
  int bh, s, hpg, x_bf16, bc_bf16, passes;
};

// the FMA path at P, N; `passes` bits 1 (states), 2 (chunk), 4 (reduce)
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
  cudaError_t e;
  if (g.passes & 1) {
    ssd_bwd_states<N><<<dim3(bh, P / SLICE, 2), THREADS, 0, st>>>(
        g.x, g.gy, g.x_bf16, DT, A, g.b, g.c, g.bc_bf16, states, carries, s, P, hpg);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (g.passes & 2) {
    constexpr int smem = chunk_smem_floats(P, N) * 4;
    e = cudaFuncSetAttribute(ssd_bwd_chunk<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return int(e);
    ssd_bwd_chunk<P, N><<<dim3(nc, bh), THREADS, smem, st>>>(
        g.x, g.gy, g.x_bf16, DT, A, g.b, g.c, g.bc_bf16, states, carries, g.dx,
        static_cast<float*>(g.ddt), dbh, dch, da_part, s, hpg);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (g.passes & 4) {
    const long long per_group = (long long)s * N;
    const long long blocks =
        std::min<long long>((per_group * groups + THREADS - 1) / THREADS, 4096);
    ssd_bwd_reduce<<<int(std::max<long long>(blocks, 1)), THREADS, 0, st>>>(
        dbh, dch, da_part, g.db, g.dc, g.bc_bf16, static_cast<float*>(g.da), per_group,
        groups, hpg, bh, nc);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
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

namespace wg {

// the wgmma path; `passes` bits 1 (delta), 2 (scan), 4 (chunk), 8 (da)
int launch(const Args& g, cudaStream_t st) {
  const int bh = g.bh, s = g.s, hpg = g.hpg, nc = (s + WL - 1) / WL, groups = bh / hpg;
  __nv_bfloat16* dstate = static_cast<__nv_bfloat16*>(g.scratch);
  __nv_bfloat16* dcarry = dstate + (size_t)bh * nc * STATE;
  float* vec = reinterpret_cast<float*>(dcarry + (size_t)bh * nc * STATE);
  float* part = vec + (size_t)bh * nc * 2 * WL;
  const float* DT = static_cast<const float*>(g.dt);
  const float* A = static_cast<const float*>(g.a);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tmx, tmg, tmb, tmc, tms, tme;
  if (!tensor_map(&tmx, enc, g.x, bh, s, WP, WL) || !tensor_map(&tmg, enc, g.gy, bh, s, WP, WL) ||
      !tensor_map(&tmb, enc, g.b, groups, s, WN, WL) ||
      !tensor_map(&tmc, enc, g.c, groups, s, WN, WL) ||
      !tensor_map(&tms, enc, dstate, bh * nc, WP, WN, WL) ||
      !tensor_map(&tme, enc, dcarry, bh * nc, WP, WN, WL))
    return int(cudaErrorInvalidValue);
  cudaError_t e;
  if (g.passes & 1) {
    if ((e = cudaFuncSetAttribute(ssd_bwd_delta, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DeltaCfg::SMEM)) != cudaSuccess)
      return int(e);
    ssd_bwd_delta<<<dim3(nc, bh), WT, DeltaCfg::SMEM, st>>>(tmx, tmg, tmb, tmc, DT, A, vec,
                                                            dstate, dcarry, s, hpg);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (g.passes & 2) {
    const long long threads = (long long)bh * (STATE / 8);
    ssd_bwd_scan<<<dim3(unsigned((threads + 255) / 256), 2), 256, 0, st>>>(dstate, dcarry, vec,
                                                                           bh, nc);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (g.passes & 4) {
    if ((e = cudaFuncSetAttribute(ssd_bwd_chunk_wg, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ChunkCfg::SMEM)) != cudaSuccess)
      return int(e);
    ssd_bwd_chunk_wg<<<dim3(nc, groups), WT, ChunkCfg::SMEM, st>>>(
        tmx, tmg, tmb, tmc, tms, tme, vec, A, static_cast<__nv_bfloat16*>(g.dx),
        static_cast<float*>(g.ddt), part, static_cast<__nv_bfloat16*>(g.db),
        static_cast<__nv_bfloat16*>(g.dc), s, hpg);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (g.passes & 8) {
    ssd_bwd_da<<<(bh + 255) / 256, 256, 0, st>>>(part, static_cast<float*>(g.da), bh, nc);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

}  // namespace wg

int launch(const Args& g, int p, int n, void* stream, int* wgmma) {
  *wgmma = 0;
  if (g.bh <= 0 || g.s <= 0) return 0;
  if (g.hpg <= 0 || g.bh % g.hpg != 0 || g.bh > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.x_bf16 && g.bc_bf16 && p == wg::WP && n == wg::WN) {
    *wgmma = 1;
    return wg::launch(g, st);
  }
  switch (p) {
    case 32: return launch_p<32>(g, n, st);
    case 64: return launch_p<64>(g, n, st);
    case 128: return launch_p<128>(g, n, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x, gy, dx [bh, s, p] (f32 or bf16, by the suffix's first part, 16-byte
// aligned); dt, ddt [bh, s] f32; a, da [bh] f32; b, c, db, dc [bh / hpg, s,
// n] (f32 or bf16, by its second part, 16-byte aligned); all contiguous.
// scratch (16-byte aligned) on the wgmma path (bf16 x, B and C, p 64, n
// 128): 2 x bh x ceil(s / 64) x p x n bf16 (dS/S, dE/E), then float32 bh x
// ceil(s / 64) x 128 (each chunk's cum and dt) and bh x ceil(s / 64) (da's
// parts); on the FMA path float32 2 x bh x ceil(s / 64) x p x n (S_c, E_c),
// 2 x bh x s x n (per-head dB, dC), bh x ceil(s / 64) (da's parts).
// `passes` picks launches, in order (the wgmma path 1 delta, 2 scan, 4
// chunk, 8 da; the FMA path 1 states, 2 chunk, 4 reduce; 15 or 7 the
// gradient: the others time one launch alone).  *wgmma is set to 1 where
// the wgmma path runs.
#define SSD_BWD(name, X_BF16, BC_BF16)                                                  \
  int name(const void* x, const void* gy, const void* dt, const void* a, const void* b,  \
           const void* c, void* dx, void* ddt, void* da, void* db, void* dc,             \
           void* scratch, int bh, int s, int p, int n, int hpg, int passes, void* stream, \
           int* wgmma) {                                                                 \
    const Args g{x,  gy,      dt, a,   b,       c,       dx,    ddt, da,                   \
                 db, dc,      scratch, bh, s, hpg, X_BF16, BC_BF16, passes};              \
    return launch(g, p, n, stream, wgmma);                                               \
  }
SSD_BWD(ssd_scan_bwd_f32_f32, 0, 0)
SSD_BWD(ssd_scan_bwd_f32_bf16, 0, 1)
SSD_BWD(ssd_scan_bwd_bf16_f32, 1, 0)
SSD_BWD(ssd_scan_bwd_bf16_bf16, 1, 1)
#undef SSD_BWD

// the wgmma path's dynamic shared memory: 0 ssd_bwd_delta, 1 the chunk
// kernel, for the wrapper's plan_bwd to be checked against
int ssd_scan_bwd_wgmma_smem(int which) {
  return which == 0 ? wg::DeltaCfg::SMEM : wg::ChunkCfg::SMEM;
}

}  // extern "C"
