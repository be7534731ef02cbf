// The Mamba-2 mixer's elementwise glue around the SSD scan, fused, for
// Hopper (sm_90a): two functions of models/mamba2.py apply_mamba, each with
// its gradient.
//
// Replaces no Pallas kernel: the JAX package leaves this glue to XLA's
// fusion (models/mamba2.py apply_mamba, _causal_conv, _gated_norm).  The
// port's plain code runs it as about twenty full-size PyTorch passes a layer,
// most of them in float32; these kernels are the port's own, added because
// that glue took most of a mamba2-780m training step.
//
//   conv_silu_heads  xh[b·H + h, t, p] = rnd(silu(sum_j xi[b, t - j, c] · w[c, j]
//                    + bias[c])), c = h·P + p: the K-tap causal depthwise conv
//                    in float32, taps summed j = K-1 down to 0 as _causal_conv
//                    sums them (from a zero row before the sequence), the bias
//                    (where the mixer has one) added after them, SiLU in
//                    float32, one rounding to the activation dtype, written
//                    straight into the SSD scan's [B·H, S, P] layout.
//   skip_gate_norm   v = (y + xh · D[h]) · silu(z),
//                    out[b, t, c] = rnd((v · rsqrt(mean_{c in G}(v²) + eps)) · g[c]),
//                    the mean over c's group G of di / groups channels (one
//                    group: the whole row), in float32 with one rounding, in
//                    token order [B, S, di] for the out-projection; each row's
//                    and group's rsqrt is kept (float32).
//
// The gradients recompute each forward in registers from the saved inputs
// (and the rows' rsqrt): the conv's writes dxi = sum_j dpre[t + j] · w[j]
// with dpre = dxh · silu'(pre), dw[c, j] = sum_{b,t} dpre[t] · xi[t - j] and
// dbias[c] = sum_{b,t} dpre[t];
// the gate norm's writes dy (the scan's incoming gradient, in its dtype),
// xh's skip term du · D, dz, and the sums dD[h] and dg[c].  The sums over rows
// go to per-block partials in fixed places and a second launch
// (mamba_glue_colsum) adds them in a fixed order: no atomics, so two calls on
// the same inputs give the same bits.  Every operation rounds once in
// float32 (built with -fmad=false; SiLU as PyTorch's float kernel forms it,
// x / (1 + exp(-x)), with the accurate expf and an IEEE division), and the
// outputs round to the activation dtype once, where the plain code rounds.
//
// What bounds it: bytes, and how many of them a thread keeps in flight.  A
// gate-norm thread takes 8 channels (16 bytes of bf16), a conv thread 4 (its
// windows, taps and sums then leave registers for more threads), always
// inside one head (P is a multiple of 8), so a warp reads 512 or 256
// contiguous bytes of a token-order row, or 128-byte rows of the head layout.
// The conv walks a tile of rows with the K-1 rows before it (its halo) in
// registers, reading each row once and fetching two rows ahead; its gradient
// walks K-1 rows past its tile.  The gate norm takes one token row at a time
// across a block (the mean is a sum over the group's warps: a warp butterfly,
// then those warps in order); its gradient accumulates dg and dD for its rows in registers and
// fetches the next row before the current row's block sum.

// Each launcher returns 0, a CUDA error, or REFUSED (-1) for a form the
// kernels do not take, having launched nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int VEC = 8;               // channels a gate-norm thread takes (a group)
constexpr int CONV_VEC = 4;          // channels a conv thread takes
constexpr int MAX_TAPS = 4;          // the widest conv the kernels take
constexpr int CONV_THREADS = 128;
constexpr int CONV_ROWS = 32;        // rows a conv forward block walks
constexpr int CONV_BWD_ROWS = 128;   // rows a conv gradient block walks (one dw partial)
constexpr int NORM_ROWS = 8;         // token rows a gate-norm forward block walks
constexpr int NORM_BWD_ROWS = 64;    // token rows a gate-norm gradient block walks
constexpr int NORM_MAX_THREADS = 512;
constexpr int SUM_COLS = 32;         // mamba_glue_colsum: columns a block sums,
constexpr int SUM_LANES = 8;         // and the lanes that split its rows
constexpr unsigned FULL = 0xffffffffu;

// V values of T as loaded (V = 8: 16 bytes of bf16, 32 of float32; V = 4:
// 8 and 16)
template <typename T, int V> struct Pack;
template <> struct Pack<__nv_bfloat16, 8> { uint4 q; };
template <> struct Pack<__nv_bfloat16, 4> { uint2 q; };
template <> struct Pack<float, 8> { float4 a, b; };
template <> struct Pack<float, 4> { float4 a; };

template <int V, typename T>
__device__ __forceinline__ Pack<T, V> fetch(const T* p) {
  Pack<T, V> r;
  if constexpr (std::is_same<T, float>::value) {
    r.a = reinterpret_cast<const float4*>(p)[0];
    if constexpr (V == 8) r.b = reinterpret_cast<const float4*>(p)[1];
  } else if constexpr (V == 8) {
    r.q = *reinterpret_cast<const uint4*>(p);
  } else {
    r.q = *reinterpret_cast<const uint2*>(p);
  }
  return r;
}

// bf16 -> float32 is exact: the 16 bits moved up
__device__ __forceinline__ void unpack2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

template <int V>
__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16, V>& r, float* v) {
  unpack2(r.q.x, v);
  unpack2(r.q.y, v + 2);
  if constexpr (V == 8) {
    unpack2(r.q.z, v + 4);
    unpack2(r.q.w, v + 6);
  }
}

template <int V>
__device__ __forceinline__ void unpack(const Pack<float, V>& r, float* v) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  if constexpr (V == 8) {
    v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
  }
}

template <int V, typename T>
__device__ __forceinline__ void load(const T* p, float* v) { unpack(fetch<V>(p), v); }

// round to nearest even, element 0 at the lower address
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
       | (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                              pack2(v[4], v[5]), pack2(v[6], v[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  if constexpr (V == 8) q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// PyTorch's float SiLU and its gradient, operation for operation
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float silu_grad(float dy, float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return dy * s * (1.0f + x * (1.0f - s));
}

// the taps of channels c0..c0+V-1: wk[j][e] = w[c0 + e, j]
template <int K, int V>
__device__ __forceinline__ void load_taps(const float* __restrict__ w, int c0,
                                          float (&wk)[K][V]) {
#pragma unroll
  for (int e = 0; e < V; ++e)
#pragma unroll
    for (int j = 0; j < K; ++j) wk[j][e] = w[(size_t)(c0 + e) * K + j];
}

// the conv's pre-activation of one row from its window (win[j] = row t - j),
// in _causal_conv's order: tap K-1 first, then K-2 down to 0
template <typename T, int K, int V>
__device__ __forceinline__ void conv_row(const Pack<T, V> (&win)[K], const float (&wk)[K][V],
                                         float* acc) {
  float x[V];
  unpack(win[K - 1], x);
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = x[e] * wk[K - 1][e];
#pragma unroll
  for (int j = K - 2; j >= 0; --j) {
    unpack(win[j], x);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = acc[e] + x[e] * wk[j][e];
  }
}

// grid (ceil(di / (V·CONV_THREADS)), ceil(S / CONV_ROWS), B): a thread
// takes V channels of one sequence over its block's rows; BIAS: the conv
// adds bias[c] (float32) after its taps
template <typename T, int K, int V, bool BIAS>
__global__ void __launch_bounds__(CONV_THREADS)
mamba_conv_silu_fwd(const T* __restrict__ xi, const float* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ xh, int s, int di, int p) {
  const int c0 = (blockIdx.x * CONV_THREADS + threadIdx.x) * V;
  if (c0 >= di) return;
  const int b = blockIdx.z, h = c0 / p, heads = di / p;
  const int t0 = blockIdx.y * CONV_ROWS, t1 = min(t0 + CONV_ROWS, s);
  float wk[K][V];
  load_taps<K, V>(w, c0, wk);
  float bk[V];
  if constexpr (BIAS) {
#pragma unroll
    for (int e = 0; e < V; ++e) bk[e] = bias[c0 + e];
  }
  const T* src = xi + (size_t)b * s * di + c0;
  T* dst = xh + (size_t)(b * heads + h) * s * p + (c0 - h * p);
  using P = Pack<T, V>;
  P win[K];                                        // win[j]: row t - j (zero before row 0)
#pragma unroll
  for (int j = 1; j < K; ++j)
    win[j] = t0 - j >= 0 ? fetch<V>(src + (size_t)(t0 - j) * di) : P{};
  // two rows fetched ahead
  P next0 = t0 < t1 ? fetch<V>(src + (size_t)t0 * di) : P{};
  P next1 = t0 + 1 < t1 ? fetch<V>(src + (size_t)(t0 + 1) * di) : P{};
  for (int t = t0; t < t1; ++t) {
    win[0] = next0;
    next0 = next1;
    if (t + 2 < t1) next1 = fetch<V>(src + (size_t)(t + 2) * di);
    float acc[V];
    conv_row<T, K, V>(win, wk, acc);
    if constexpr (BIAS) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = acc[e] + bk[e];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = silu(acc[e]);
    store<V>(dst + (size_t)t * p, acc);
#pragma unroll
    for (int j = K - 1; j > 0; --j) win[j] = win[j - 1];
  }
}

// grid (ceil(di / (V·CONV_THREADS)), ceil(S / CONV_BWD_ROWS), B): rows
// t0..t1-1 of dxi and this block's dw partial, part[(b·gridDim.y + y), c, j],
// j < K; BIAS: the forward's bias and dbias's partial at j = K
template <typename T, int K, int V, bool BIAS>
__global__ void __launch_bounds__(CONV_THREADS)
mamba_conv_silu_bwd(const T* __restrict__ xi, const float* __restrict__ w,
                    const float* __restrict__ bias, const T* __restrict__ dxh,
                    T* __restrict__ dxi, float* __restrict__ part, int s, int di, int p) {
  constexpr int KS = K + (BIAS ? 1 : 0);           // partials a channel
  const int c0 = (blockIdx.x * CONV_THREADS + threadIdx.x) * V;
  if (c0 >= di) return;
  const int b = blockIdx.z, h = c0 / p, heads = di / p;
  const int t0 = blockIdx.y * CONV_BWD_ROWS, t1 = min(t0 + CONV_BWD_ROWS, s);
  const int u1 = min(t1 + K - 1, s);               // rows whose dpre the tile reads
  float wk[K][V];
  load_taps<K, V>(w, c0, wk);
  const T* src = xi + (size_t)b * s * di + c0;
  const T* gsrc = dxh + (size_t)(b * heads + h) * s * p + (c0 - h * p);
  T* dst = dxi + (size_t)b * s * di + c0;
  using P = Pack<T, V>;
  P win[K];
#pragma unroll
  for (int j = 1; j < K; ++j)
    win[j] = t0 - j >= 0 ? fetch<V>(src + (size_t)(t0 - j) * di) : P{};
  float bk[V], db[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    bk[e] = BIAS ? bias[c0 + e] : 0.0f;
    db[e] = 0.0f;
  }
  float dp[K][V];                                  // dp[i]: dpre of row u - i
  float dw[K][V];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) dp[j][e] = dw[j][e] = 0.0f;
  P nx = t0 < u1 ? fetch<V>(src + (size_t)t0 * di) : P{};
  P ng = t0 < u1 ? fetch<V>(gsrc + (size_t)t0 * p) : P{};
  for (int u = t0; u < t1 + K - 1; ++u) {
#pragma unroll
    for (int i = K - 1; i > 0; --i)
#pragma unroll
      for (int e = 0; e < V; ++e) dp[i][e] = dp[i - 1][e];
    if (u < u1) {
      win[0] = nx;
      const P gr = ng;
      if (u + 1 < u1) {
        nx = fetch<V>(src + (size_t)(u + 1) * di);
        ng = fetch<V>(gsrc + (size_t)(u + 1) * p);
      }
      float pre[V], g[V];
      conv_row<T, K, V>(win, wk, pre);
      if constexpr (BIAS) {
#pragma unroll
        for (int e = 0; e < V; ++e) pre[e] = pre[e] + bk[e];
      }
      unpack(gr, g);
#pragma unroll
      for (int e = 0; e < V; ++e) dp[0][e] = silu_grad(g[e], pre[e]);
      if (u < t1) {                                // the tile's own rows feed dw
        if constexpr (BIAS) {
#pragma unroll
          for (int e = 0; e < V; ++e) db[e] = db[e] + dp[0][e];
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float x[V];
          unpack(win[j], x);
#pragma unroll
          for (int e = 0; e < V; ++e) dw[j][e] = dw[j][e] + dp[0][e] * x[e];
        }
      }
#pragma unroll
      for (int j = K - 1; j > 0; --j) win[j] = win[j - 1];
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dp[0][e] = 0.0f;    // past the sequence's end
    }
    const int t = u - (K - 1);
    if (t >= t0) {                                 // dxi[t] = sum_j dpre[t + j] w[j]
      float out[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float a = dp[K - 1][e] * wk[0][e];
#pragma unroll
        for (int j = 1; j < K; ++j) a = a + dp[K - 1 - j][e] * wk[j][e];
        out[e] = a;
      }
      store<V>(dst + (size_t)t * di, out);
    }
  }
  float* q = part + ((size_t)(b * gridDim.y + blockIdx.y) * di + c0) * KS;
#pragma unroll
  for (int e = 0; e < V; ++e) {
#pragma unroll
    for (int j = 0; j < K; ++j) q[e * KS + j] = dw[j][e];
    if constexpr (BIAS) q[e * KS + K] = db[e];
  }
}

// the sum of x over the nw warps from warp w0 on (a thread's group), the
// same bits in every thread of them: a butterfly in each warp, then the
// warps' sums in order (red: 32 floats, alternated between calls so that one
// barrier a call suffices)
__device__ __forceinline__ float group_sum(float x, float* red, int w0, int nw) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(FULL, x, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = red[w0];
  for (int i = 1; i < nw; ++i) s += red[w0 + i];
  return s;
}

// a gate-norm thread's group of channels, its first warp and its warps: one
// group (GROUPED false, the form compiled as before groups) takes the whole
// block; more take gs / VEC threads each, whole warps
template <bool GROUPED>
struct NormGroup {
  int g, w0, nw;
  __device__ NormGroup(int c, int gs, int groups) {
    if constexpr (GROUPED) {
      nw = gs / (VEC * 32);
      g = min(c / gs, groups - 1);
      w0 = g * nw;
    } else {
      nw = (int)(blockDim.x >> 5);
      g = 0;
      w0 = 0;
    }
  }
  // where the row's rsqrt for this group lies, and whether this thread writes it
  __device__ size_t at(int r, int groups) const {
    return GROUPED ? (size_t)r * groups + g : (size_t)r;
  }
  __device__ bool writes(int c, int gs) const { return GROUPED ? c == g * gs : threadIdx.x == 0; }
};

// grid ceil(B·S / NORM_ROWS), blockDim ceil(di / VEC) rounded up to a warp:
// thread i takes channels c = VEC·i .. c + VEC - 1 of each of its rows, in
// group c / gs of gs = di / groups channels (rstd[row·groups + group])
template <typename T, bool GROUPED>
__global__ void __launch_bounds__(NORM_MAX_THREADS)
mamba_gate_norm_fwd(const T* __restrict__ y, const T* __restrict__ xh, const T* __restrict__ z,
                    const float* __restrict__ dskip, const float* __restrict__ g,
                    T* __restrict__ out, float* __restrict__ rstd,
                    int rows, int s, int di, int p, int groups, float inv_gs, float eps) {
  __shared__ float red[2][32];
  const int heads = di / p, c = threadIdx.x * VEC, gs = GROUPED ? di / groups : di;
  const NormGroup<GROUPED> grp(c, gs, groups);
  const bool on = c < di;                          // lanes past di add 0 to the sums
  const int h = on ? c / p : 0, hp = c - h * p;
  float gk[VEC], dk = 0.0f;
  if (on) {
    load<VEC>(g + c, gk);
    dk = dskip[h];
  }
  const int r0 = blockIdx.x * NORM_ROWS, r1 = min(r0 + NORM_ROWS, rows);
  for (int r = r0; r < r1; ++r) {
    const int b = r / s, t = r - b * s;
    float v[VEC];
    float ss = 0.0f;
    if (on) {
      const size_t hoff = ((size_t)(b * heads + h) * s + t) * p + hp;
      float yv[VEC], xv[VEC], zv[VEC];
      load<VEC>(y + hoff, yv);
      load<VEC>(xh + hoff, xv);
      load<VEC>(z + (size_t)r * di + c, zv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[e] = (yv[e] + xv[e] * dk) * silu(zv[e]);
        ss = ss + v[e] * v[e];
      }
    }
    ss = group_sum(ss, red[(r - r0) & 1], grp.w0, grp.nw);
    const float rs = rsqrtf(ss * inv_gs + eps);
    if (grp.writes(c, gs)) rstd[grp.at(r, groups)] = rs;
    if (on) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = (v[e] * rs) * gk[e];
      store<VEC>(out + (size_t)r * di + c, v);
    }
  }
}

// grid ceil(B·S / NORM_BWD_ROWS), threads as the forward's: dy, the skip term
// of dxh, dz for the block's rows; its partials pg[block, c] of dg and
// pd[block, c / VEC] of dD
template <typename T, bool GROUPED>
__global__ void __launch_bounds__(NORM_MAX_THREADS)
mamba_gate_norm_bwd(const T* __restrict__ dout, const T* __restrict__ y,
                    const T* __restrict__ xh, const T* __restrict__ z,
                    const float* __restrict__ dskip, const float* __restrict__ g,
                    const float* __restrict__ rstd, T* __restrict__ dy, T* __restrict__ dxh,
                    T* __restrict__ dz, float* __restrict__ pg, float* __restrict__ pd,
                    int rows, int s, int di, int p, int groups) {
  __shared__ float red[2][32];
  const int heads = di / p, c = threadIdx.x * VEC, gs = GROUPED ? di / groups : di;
  const NormGroup<GROUPED> grp(c, gs, groups);
  const bool on = c < di;
  const int h = on ? c / p : 0, hp = c - h * p;
  const float gs_f = (float)gs;
  float gk[VEC], ag[VEC], dk = 0.0f, ad = 0.0f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) ag[e] = 0.0f;
  if (on) {
    load<VEC>(g + c, gk);
    dk = dskip[h];
  }
  const int r0 = blockIdx.x * NORM_BWD_ROWS, r1 = min(r0 + NORM_BWD_ROWS, rows);
  // a row's inputs stay packed across its block sum and are unpacked twice;
  // the next row's are fetched before this row's sum, so that two rows are
  // in flight
  using P = Pack<T, VEC>;
  P py, px, pz, po, ny, nx, nz, no;
  auto fetch_row = [&](int r) {
    const int b = r / s, t = r - b * s;
    const size_t hoff = ((size_t)(b * heads + h) * s + t) * p + hp;
    const size_t toff = (size_t)r * di + c;
    ny = fetch<VEC>(y + hoff);
    nx = fetch<VEC>(xh + hoff);
    nz = fetch<VEC>(z + toff);
    no = fetch<VEC>(dout + toff);
  };
  if (on && r0 < r1) fetch_row(r0);
  for (int r = r0; r < r1; ++r) {
    const int b = r / s, t = r - b * s;
    const float rs = rstd[grp.at(r, groups)];
    py = ny; px = nx; pz = nz; po = no;
    if (on && r + 1 < r1) fetch_row(r + 1);
    // silu(z) = z / den and its gradient's s = 1 / den, as PyTorch forms them
    float sz[VEC], den[VEC];
    float dot = 0.0f;
    if (on) {
      float yv[VEC], xv[VEC], zv[VEC], ov[VEC];
      unpack(py, yv); unpack(px, xv); unpack(pz, zv); unpack(po, ov);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        den[e] = 1.0f + expf(-zv[e]);
        sz[e] = zv[e] / den[e];
        const float v = (yv[e] + xv[e] * dk) * sz[e];
        dot = dot + (ov[e] * gk[e]) * v;
      }
    }
    dot = group_sum(dot, red[(r - r0) & 1], grp.w0, grp.nw);
    if (!on) continue;
    // rsqrt's gradient -0.5·grad·r³, the mean's 1/gs, v·v's two terms
    const float cm = ((-0.5f * dot) * (rs * rs * rs)) / gs_f;
    const size_t hoff = ((size_t)(b * heads + h) * s + t) * p + hp;
    const size_t toff = (size_t)r * di + c;
    float yv[VEC], xv[VEC], zv[VEC], ov[VEC], gy[VEC], gx[VEC], gz[VEC];
    unpack(py, yv); unpack(px, xv); unpack(pz, zv); unpack(po, ov);
    float sd = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float u = yv[e] + xv[e] * dk;
      const float v = u * sz[e];
      ag[e] = ag[e] + ov[e] * (v * rs);
      const float dv = (ov[e] * gk[e]) * rs + (cm * v + cm * v);
      const float du = dv * sz[e];
      const float sg = 1.0f / den[e];
      gz[e] = ((dv * u) * sg) * (1.0f + zv[e] * (1.0f - sg));
      gy[e] = du;
      gx[e] = du * dk;
      sd = sd + du * xv[e];
    }
    ad = ad + sd;
    store<VEC>(dy + hoff, gy);
    store<VEC>(dxh + hoff, gx);
    store<VEC>(dz + toff, gz);
  }
  if (on) {
    store<VEC>(pg + (size_t)blockIdx.x * di + c, ag);
    pd[(size_t)blockIdx.x * (di / VEC) + c / VEC] = ad;
  }
}

// out[i] = sum_{r < rows} sum_{q < inner} part[(r·n + i)·inner + q], in a
// fixed order: lane l of a column adds rows l, l + SUM_LANES, ..., then
// lane 0 adds the lanes' sums in order.  blockDim (SUM_COLS, SUM_LANES)
__global__ void __launch_bounds__(SUM_COLS * SUM_LANES)
mamba_glue_colsum(const float* __restrict__ part, float* __restrict__ out,
                  int rows, int n, int inner) {
  __shared__ float red[SUM_LANES][SUM_COLS];
  const int i = blockIdx.x * SUM_COLS + threadIdx.x;
  float acc = 0.0f;
  if (i < n) {
    for (int r = threadIdx.y; r < rows; r += SUM_LANES) {
      const float* q = part + ((size_t)r * n + i) * inner;
      for (int k = 0; k < inner; ++k) acc += q[k];
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float sum = red[0][threadIdx.x];
#pragma unroll
    for (int l = 1; l < SUM_LANES; ++l) sum += red[l][threadIdx.x];
    out[i] = sum;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// what a launcher returns for a form the kernels do not take, before any
// launch: P not a multiple of VEC, more than MAX_TAPS taps, di past
// NORM_MAX_THREADS·VEC, groups of channels that are not whole warps of the
// gate norm's threads, or a grid past its limits
constexpr int REFUSED = -1;

bool form_ok(int b, int s, int di, int p) {
  return b > 0 && s > 0 && p > 0 && p % VEC == 0 && di % p == 0 && b <= 65535
      && (long long)b * s <= 0x7fffffffLL;
}

int colsum(const float* part, float* out, int rows, int n, int inner, cudaStream_t st) {
  mamba_glue_colsum<<<cdiv(n, SUM_COLS), dim3(SUM_COLS, SUM_LANES), 0, st>>>(
      part, out, rows, n, inner);
  return int(cudaGetLastError());
}

template <typename T, bool BIAS>
void conv_fwd_launch(int k, dim3 grid, cudaStream_t st, const T* x, const float* wf,
                     const float* bf, T* o, int s, int di, int p) {
  constexpr int V = CONV_VEC;
  switch (k) {
    case 1: mamba_conv_silu_fwd<T, 1, V, BIAS><<<grid, CONV_THREADS, 0, st>>>(x, wf, bf, o, s, di, p); break;
    case 2: mamba_conv_silu_fwd<T, 2, V, BIAS><<<grid, CONV_THREADS, 0, st>>>(x, wf, bf, o, s, di, p); break;
    case 3: mamba_conv_silu_fwd<T, 3, V, BIAS><<<grid, CONV_THREADS, 0, st>>>(x, wf, bf, o, s, di, p); break;
    default: mamba_conv_silu_fwd<T, 4, V, BIAS><<<grid, CONV_THREADS, 0, st>>>(x, wf, bf, o, s, di, p); break;
  }
}

template <typename T>
int conv_fwd(const void* xi, const void* w, const void* bias, void* xh, int b, int s, int di,
             int p, int k, cudaStream_t st) {
  constexpr int V = CONV_VEC;
  if (!form_ok(b, s, di, p) || k < 1 || k > MAX_TAPS || s > 65535 * CONV_ROWS) return REFUSED;
  const dim3 grid(cdiv(di, V * CONV_THREADS), cdiv(s, CONV_ROWS), b);
  const T* x = static_cast<const T*>(xi);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  T* o = static_cast<T*>(xh);
  if (bf) conv_fwd_launch<T, true>(k, grid, st, x, wf, bf, o, s, di, p);
  else conv_fwd_launch<T, false>(k, grid, st, x, wf, bf, o, s, di, p);
  return int(cudaGetLastError());
}

template <typename T, bool BIAS>
void conv_bwd_launch(int k, dim3 grid, cudaStream_t st, const T* x, const float* wf,
                     const float* bf, const T* g, T* o, float* pt, int s, int di, int p) {
  constexpr int V = CONV_VEC;
  switch (k) {
    case 1: mamba_conv_silu_bwd<T, 1, V, BIAS><<<grid, CONV_THREADS, 0, st>>>(x, wf, bf, g, o, pt, s, di, p); break;
    case 2: mamba_conv_silu_bwd<T, 2, V, BIAS><<<grid, CONV_THREADS, 0, st>>>(x, wf, bf, g, o, pt, s, di, p); break;
    case 3: mamba_conv_silu_bwd<T, 3, V, BIAS><<<grid, CONV_THREADS, 0, st>>>(x, wf, bf, g, o, pt, s, di, p); break;
    default: mamba_conv_silu_bwd<T, 4, V, BIAS><<<grid, CONV_THREADS, 0, st>>>(x, wf, bf, g, o, pt, s, di, p); break;
  }
}

// dw: [di, K] float32, or with a bias [di, K + 1], dbias in the last column
template <typename T>
int conv_bwd(const void* xi, const void* w, const void* bias, const void* dxh, void* dxi,
             void* dw, void* part, int b, int s, int di, int p, int k, cudaStream_t st) {
  constexpr int V = CONV_VEC;
  if (!form_ok(b, s, di, p) || k < 1 || k > MAX_TAPS || s > 65535 * CONV_BWD_ROWS) {
    return REFUSED;
  }
  const dim3 grid(cdiv(di, V * CONV_THREADS), cdiv(s, CONV_BWD_ROWS), b);
  const T* x = static_cast<const T*>(xi);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  const T* g = static_cast<const T*>(dxh);
  T* o = static_cast<T*>(dxi);
  float* pt = static_cast<float*>(part);
  if (bf) conv_bwd_launch<T, true>(k, grid, st, x, wf, bf, g, o, pt, s, di, p);
  else conv_bwd_launch<T, false>(k, grid, st, x, wf, bf, g, o, pt, s, di, p);
  const int code = int(cudaGetLastError());
  if (code) return code;
  return colsum(pt, static_cast<float*>(dw), b * grid.y, di * (k + (bf ? 1 : 0)), 1, st);
}

// a gate-norm block's threads: one a group of VEC channels, whole warps
int norm_threads(int di) { return (di / VEC + 31) / 32 * 32; }

// one group, or groups of whole warps of threads
bool groups_ok(int di, int groups) {
  return groups == 1 || (groups > 1 && di % groups == 0 && (di / groups) % (VEC * 32) == 0);
}

template <typename T>
int norm_fwd(const void* y, const void* xh, const void* z, const void* dskip, const void* g,
             void* out, void* rstd, int b, int s, int di, int p, int groups, float eps,
             cudaStream_t st) {
  const int threads = norm_threads(di);
  if (!form_ok(b, s, di, p) || threads > NORM_MAX_THREADS || !groups_ok(di, groups)) {
    return REFUSED;
  }
  const int rows = b * s;
  const float inv_gs = 1.0f / (float)(di / groups);
  auto kernel = groups > 1 ? mamba_gate_norm_fwd<T, true> : mamba_gate_norm_fwd<T, false>;
  kernel<<<cdiv(rows, NORM_ROWS), threads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(xh), static_cast<const T*>(z),
      static_cast<const float*>(dskip), static_cast<const float*>(g), static_cast<T*>(out),
      static_cast<float*>(rstd), rows, s, di, p, groups, inv_gs, eps);
  return int(cudaGetLastError());
}

template <typename T>
int norm_bwd(const void* dout, const void* y, const void* xh, const void* z, const void* dskip,
             const void* g, const void* rstd, void* dy, void* dxh, void* dz, void* ddskip,
             void* dg, void* part, int b, int s, int di, int p, int groups, cudaStream_t st) {
  const int threads = norm_threads(di);
  if (!form_ok(b, s, di, p) || threads > NORM_MAX_THREADS || !groups_ok(di, groups)) {
    return REFUSED;
  }
  const int rows = b * s, blocks = cdiv(rows, NORM_BWD_ROWS);
  float* pg = static_cast<float*>(part);
  float* pd = pg + (size_t)blocks * di;
  auto kernel = groups > 1 ? mamba_gate_norm_bwd<T, true> : mamba_gate_norm_bwd<T, false>;
  kernel<<<blocks, threads, 0, st>>>(
      static_cast<const T*>(dout), static_cast<const T*>(y), static_cast<const T*>(xh),
      static_cast<const T*>(z), static_cast<const float*>(dskip), static_cast<const float*>(g),
      static_cast<const float*>(rstd), static_cast<T*>(dy), static_cast<T*>(dxh),
      static_cast<T*>(dz), pg, pd, rows, s, di, p, groups);
  int code = int(cudaGetLastError());
  if (code) return code;
  code = colsum(pg, static_cast<float*>(dg), blocks, di, 1, st);
  if (code) return code;
  return colsum(pd, static_cast<float*>(ddskip), blocks, di / p, p / VEC, st);
}

}  // namespace

extern "C" {

// float32 words of the partials the two gradients sum: the conv's, one [di,
// ks] a sequence and tile of CONV_BWD_ROWS rows (ks: K, or K + 1 with a
// bias); the gate norm's, dnorm_g's [di] and dD's [di / VEC] a block of
// NORM_BWD_ROWS token rows
long long mamba_conv_silu_bwd_scratch(int b, int s, int di, int ks) {
  return (long long)b * cdiv(s, CONV_BWD_ROWS) * di * ks;
}

long long mamba_gate_norm_bwd_scratch(int b, int s, int di) {
  return (long long)cdiv((long long)b * s, NORM_BWD_ROWS) * (di + di / VEC);
}

// xi [B, S, di], w [di, K] float32, bias [di] float32 or null -> xh [B·H, S, P]
// (H = di / P)
int mamba_conv_silu_fwd_bf16(const void* xi, const void* w, const void* bias, void* xh, int b,
                             int s, int di, int p, int k, void* stream) {
  return conv_fwd<__nv_bfloat16>(xi, w, bias, xh, b, s, di, p, k,
                                 static_cast<cudaStream_t>(stream));
}

int mamba_conv_silu_fwd_f32(const void* xi, const void* w, const void* bias, void* xh, int b,
                            int s, int di, int p, int k, void* stream) {
  return conv_fwd<float>(xi, w, bias, xh, b, s, di, p, k, static_cast<cudaStream_t>(stream));
}

// + dxh [B·H, S, P] -> dxi [B, S, di], dw [di, K] float32 ([di, K + 1] with a
// bias, dbias last); part: mamba_conv_silu_bwd_scratch floats
int mamba_conv_silu_bwd_bf16(const void* xi, const void* w, const void* bias, const void* dxh,
                             void* dxi, void* dw, void* part, int b, int s, int di, int p, int k,
                             void* stream) {
  return conv_bwd<__nv_bfloat16>(xi, w, bias, dxh, dxi, dw, part, b, s, di, p, k,
                                 static_cast<cudaStream_t>(stream));
}

int mamba_conv_silu_bwd_f32(const void* xi, const void* w, const void* bias, const void* dxh,
                            void* dxi, void* dw, void* part, int b, int s, int di, int p, int k,
                            void* stream) {
  return conv_bwd<float>(xi, w, bias, dxh, dxi, dw, part, b, s, di, p, k,
                         static_cast<cudaStream_t>(stream));
}

// y, xh [B·H, S, P], z [B, S, di], dskip [H], g [di] float32 -> out [B, S, di],
// rstd [B·S·groups] float32
int mamba_gate_norm_fwd_bf16(const void* y, const void* xh, const void* z, const void* dskip,
                             const void* g, void* out, void* rstd, int b, int s, int di, int p,
                             int groups, float eps, void* stream) {
  return norm_fwd<__nv_bfloat16>(y, xh, z, dskip, g, out, rstd, b, s, di, p, groups, eps,
                                 static_cast<cudaStream_t>(stream));
}

int mamba_gate_norm_fwd_f32(const void* y, const void* xh, const void* z, const void* dskip,
                            const void* g, void* out, void* rstd, int b, int s, int di, int p,
                            int groups, float eps, void* stream) {
  return norm_fwd<float>(y, xh, z, dskip, g, out, rstd, b, s, di, p, groups, eps,
                         static_cast<cudaStream_t>(stream));
}

// + dout [B, S, di] -> dy, dxh [B·H, S, P], dz [B, S, di], ddskip [H], dg [di]
// float32; part: mamba_gate_norm_bwd_scratch floats
int mamba_gate_norm_bwd_bf16(const void* dout, const void* y, const void* xh, const void* z,
                             const void* dskip, const void* g, const void* rstd, void* dy,
                             void* dxh, void* dz, void* ddskip, void* dg, void* part, int b,
                             int s, int di, int p, int groups, void* stream) {
  return norm_bwd<__nv_bfloat16>(dout, y, xh, z, dskip, g, rstd, dy, dxh, dz, ddskip, dg, part,
                                 b, s, di, p, groups, static_cast<cudaStream_t>(stream));
}

int mamba_gate_norm_bwd_f32(const void* dout, const void* y, const void* xh, const void* z,
                            const void* dskip, const void* g, const void* rstd, void* dy,
                            void* dxh, void* dz, void* ddskip, void* dg, void* part, int b,
                            int s, int di, int p, int groups, void* stream) {
  return norm_bwd<float>(dout, y, xh, z, dskip, g, rstd, dy, dxh, dz, ddskip, dg, part,
                         b, s, di, p, groups, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
