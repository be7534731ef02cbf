// The gradient of causal (optionally windowed) GQA attention, for Hopper
// (sm_90a): dQ, dK and dV of the training path's attention.
//
// Replaces no Pallas kernel: the JAX package takes this gradient by autodiff
// of its XLA twin models/attention.py:blockwise_attention, and the port's
// forward kernel (csrc/flash_attention.cu) writes through raw pointers, so
// its output carries no autograd history.  kernels/flash_attention/ops.py's
// FlashAttentionFn launches the forward kernel and this one.  It computes
// the gradient of what blockwise_attention computes, from q, k, v, the
// forward's output o and the incoming gradient do (FlashAttention-2's
// scheme, on the FMA pipes):
//   s_ij   = (q_i . k_j) * scale,   visible: j <= row_i (causal) and
//            row_i - j < window (window > 0),  row_i = i + (T - S)
//   lse_i  = log sum_j visible exp(s_ij)                     (pre-pass)
//   D_i    = do_i . o_i                                      (pre-pass)
//   p_ij   = exp(s_ij - lse_i) where visible, else 0
//   dp_ij  = do_i . v_j,    ds_ij = p_ij (dp_ij - D_i)
//   dV_j   = sum_i p_ij do_i,   dK_j = scale sum_i ds_ij q_i,
//   dQ_i   = scale sum_j ds_ij k_j
// with dK and dV summed over the Hq / Hkv query heads that share a KV head.
// Every product is float32 (inputs in bf16 are widened), and each output is
// rounded to the input dtype once, as the plain version's autograd rounds
// its float32 gradients at the casts (its P is rounded to the input dtype
// before P.V; its gradient passes that cast straight through, so dV here
// takes p unrounded, ~2^-9 relative apart per term in bf16).  Three
// kernels, in this order on the caller's stream:
//   bwd_pre  one block per (b, query head, 64-row tile): lse over the
//            visible key tiles (an online max and sum), and D;
//   bwd_kv   one block per (b, KV head, 64-key tile): walks every query
//            head of its group and every query tile that can see its keys,
//            recomputing p, with dK and dV in registers;
//   bwd_q    one block per (b, query head, 64-row tile): walks the visible
//            key tiles, recomputing p and ds, with dQ in registers (a
//            second pass instead of atomics: dQ is deterministic).
// Tiles that the mask removes wholly are skipped.  Every row must see a key
// (S = T, as in training; the wrapper checks it).
//
// What bounds the function: operations.  At llama3.2-1b's training shape
// (B 1, Hq 32, Hkv 8, S 8192, D 64, causal) the gradient needs ~2.5x the
// forward's work, ~0.69 TFLOP, against ~0.2 GB moved.  This first kernel
// runs all of it on the float32 FMA pipes (67 TFLOP/s at most) and spends
// four products (bwd_kv), three (bwd_q) and one (bwd_pre) per visible tile
// pair where the least is five: a simple, correct kernel.  A Hopper design
// would run the products on wgmma from TMA-fed shared memory, as the
// forward does.
//
// Layout: each tile sits in shared memory as float32, transposed ([D][64],
// pitch 65), so that a thread reads 16 consecutive columns of a tile and
// the 16 lanes of a half-warp fall on 16 banks; a thread (ty, tx) of 16 x 16
// owns rows ty + 16 r and columns tx + 16 r' of a 64 x 64 score tile, and
// columns tx + 16 c of its rows of a gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // query rows and keys per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int PITCH = TILE + 1;
constexpr unsigned FULL = 0xffffffffu;

// element i of a float32 or bfloat16 array (the dtype a runtime flag: one
// instantiation serves both, which keeps nvcc's time down)
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

__device__ __forceinline__ float half_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

struct Mask {
  int s, t, off, causal, window;
  __device__ __forceinline__ bool visible(int i, int j) const {
    const int row = i + off;
    return i < s && j < t && (!causal || j <= row) && (window <= 0 || row - j < window);
  }
  // key tiles [lo, hi] that rows q0 .. q0 + TILE - 1 can see
  __device__ __forceinline__ void key_tiles(int q0, int* lo, int* hi) const {
    const int r0 = q0 + off, r1 = min(q0 + TILE, s) - 1 + off;
    int a = 0, b = t - 1;
    if (causal) b = min(b, r1);
    if (window > 0) a = max(0, r0 - window + 1);
    *lo = a / TILE;
    *hi = b / TILE;
  }
  // query tiles [lo, hi] whose rows can see keys k0 .. k0 + TILE - 1
  __device__ __forceinline__ void query_tiles(int k0, int* lo, int* hi) const {
    const int k1 = min(k0 + TILE, t) - 1;
    int a = 0, b = s - 1;
    if (causal) a = max(0, k0 - off);
    if (window > 0) b = min(b, k1 + window - 1 - off);
    *lo = a / TILE;
    *hi = b < a ? -1 : b / TILE;
  }
};

// rows r0 .. r0 + TILE - 1 of a [rows, D] matrix starting at element `base`
// of src, transposed into dst[D][PITCH] (zeros past `rows`)
template <int D>
__device__ __forceinline__ void load_t(float* dst, const void* src, int bf16, size_t base,
                                       int r0, int rows) {
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, d = e - r * D;
    dst[d * PITCH + r] = r0 + r < rows ? ld_f(src, bf16, base + (size_t)(r0 + r) * D + d) : 0.f;
  }
}

// acc[r][r'] = sum_d a[d][ty + 16 r] * b[d][tx + 16 r']
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      av[r] = a[d * PITCH + ty + 16 * r];
      bv[r] = b[d * PITCH + tx + 16 * r];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// lse and D for one (b, query head, row tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_pre(const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ o,
        const void* __restrict__ dout, int bf16, float* __restrict__ lse,
        float* __restrict__ delta, int hq, int hkv, float scale, Mask mk) {
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][PITCH]
  float* kt = qt + D * PITCH;        // [D][PITCH]
  const int bh = blockIdx.y, b = bh / hq, h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int q0 = blockIdx.x * TILE;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_t<D>(qt, q, bf16, (size_t)bh * mk.s * D, q0, mk.s);

  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  int jlo, jhi;
  mk.key_tiles(q0, &jlo, &jhi);
  for (int jt = jlo; jt <= jhi; ++jt) {
    const int k0 = jt * TILE;
    __syncthreads();
    load_t<D>(kt, k, bf16, (size_t)kvh * mk.t * D, k0, mk.t);
    __syncthreads();
    float sc[4][4];
    tile_dot<D>(sc, qt, kt, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool vis = mk.visible(i, k0 + tx + 16 * c);
        sc[r][c] = vis ? sc[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
      // every lane of the half-warp shuffles; a row with nothing visible
      // yet (mn still -inf) keeps m and l
      const float mn = fmaxf(m[r], half_max(mx));
      const bool seen = mn != -INFINITY;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) ps += seen ? expf(sc[r][c] - mn) : 0.f;
      const float tot = half_sum(ps);
      if (seen) {
        l[r] = l[r] * expf(m[r] - mn) + tot;
        m[r] = mn;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      if (i < mk.s) lse[(size_t)bh * mk.s + i] = m[r] + logf(l[r]);
    }
  }
  // D_i = do_i . o_i: a warp per row, lanes over D
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const int i = q0 + r;
    if (i >= mk.s) break;
    const size_t base = ((size_t)bh * mk.s + i) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(ld_f(dout, bf16, base + d), ld_f(o, bf16, base + d), acc);
    for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(FULL, acc, w);
    if (lane == 0) delta[(size_t)bh * mk.s + i] = acc;
  }
}

// dK and dV for one (b, KV head, key tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_kv(const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
       const void* __restrict__ dout, int bf16, const float* __restrict__ lse,
       const float* __restrict__ delta, void* __restrict__ dk, void* __restrict__ dv, int hq,
       int hkv, float scale, Mask mk) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* kt = smem;                  // [D][PITCH]
  float* vt = kt + D * PITCH;
  float* qt = vt + D * PITCH;
  float* dot_ = qt + D * PITCH;      // do, transposed
  float* pt = dot_ + D * PITCH;      // [key][PITCH]: p^T
  float* dst = pt + TILE * PITCH;    // [key][PITCH]: ds^T
  float* ls = dst + TILE * PITCH;    // [TILE] lse
  float* ds_ = ls + TILE;            // [TILE] D
  const int bkv = blockIdx.y, b = bkv / hkv, kh = bkv - b * hkv;
  const int rep = hq / hkv;
  const int k0 = blockIdx.x * TILE;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_t<D>(kt, k, bf16, (size_t)bkv * mk.t * D, k0, mk.t);
  load_t<D>(vt, v, bf16, (size_t)bkv * mk.t * D, k0, mk.t);

  float ak[4][DC], av[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) ak[r][c] = av[r][c] = 0.f;

  int ilo, ihi;
  mk.query_tiles(k0, &ilo, &ihi);
  for (int g = 0; g < rep; ++g) {
    const int bh = b * hq + kh * rep + g;
    for (int it = ilo; it <= ihi; ++it) {
      const int q0 = it * TILE;
      __syncthreads();                 // the last tile's reads are done
      load_t<D>(qt, q, bf16, (size_t)bh * mk.s * D, q0, mk.s);
      load_t<D>(dot_, dout, bf16, (size_t)bh * mk.s * D, q0, mk.s);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        const bool in = q0 + r < mk.s;
        ls[r] = in ? lse[(size_t)bh * mk.s + q0 + r] : 0.f;
        ds_[r] = in ? delta[(size_t)bh * mk.s + q0 + r] : 0.f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4];        // [key ty + 16 r][query tx + 16 c]
      tile_dot<D>(sc, kt, qt, ty, tx);
      tile_dot<D>(dp, vt, dot_, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = ty + 16 * r, i = tx + 16 * c;
          const bool vis = mk.visible(q0 + i, k0 + j);
          const float p = vis ? expf(sc[r][c] * scale - ls[i]) : 0.f;
          pt[j * PITCH + i] = p;
          dst[j * PITCH + i] = p * (dp[r][c] - ds_[i]);
        }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < TILE; ++i) {
        float pj[4], sj[4], dov[DC], qv[DC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pj[r] = pt[(ty + 16 * r) * PITCH + i];
          sj[r] = dst[(ty + 16 * r) * PITCH + i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = dot_[(tx + 16 * c) * PITCH + i];
          qv[c] = qt[(tx + 16 * c) * PITCH + i];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            av[r][c] = fmaf(pj[r], dov[c], av[r][c]);
            ak[r][c] = fmaf(sj[r], qv[c], ak[r][c]);
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= mk.t) continue;
    const size_t base = ((size_t)bkv * mk.t + j) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      st_f(dk, bf16, base + tx + 16 * c, ak[r][c] * scale);
      st_f(dv, bf16, base + tx + 16 * c, av[r][c]);
    }
  }
}

// dQ for one (b, query head, row tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_q(const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
      const void* __restrict__ dout, int bf16, const float* __restrict__ lse,
      const float* __restrict__ delta, void* __restrict__ dq, int hq, int hkv, float scale,
      Mask mk) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][PITCH]
  float* dot_ = qt + D * PITCH;
  float* kt = dot_ + D * PITCH;
  float* vt = kt + D * PITCH;
  float* dsm = vt + D * PITCH;       // [query][PITCH]: ds
  float* ls = dsm + TILE * PITCH;
  float* ds_ = ls + TILE;
  const int bh = blockIdx.y, b = bh / hq, h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int q0 = blockIdx.x * TILE;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_t<D>(qt, q, bf16, (size_t)bh * mk.s * D, q0, mk.s);
  load_t<D>(dot_, dout, bf16, (size_t)bh * mk.s * D, q0, mk.s);
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const bool in = q0 + r < mk.s;
    ls[r] = in ? lse[(size_t)bh * mk.s + q0 + r] : 0.f;
    ds_[r] = in ? delta[(size_t)bh * mk.s + q0 + r] : 0.f;
  }

  float aq[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) aq[r][c] = 0.f;

  int jlo, jhi;
  mk.key_tiles(q0, &jlo, &jhi);
  for (int jt = jlo; jt <= jhi; ++jt) {
    const int k0 = jt * TILE;
    __syncthreads();
    load_t<D>(kt, k, bf16, (size_t)kvh * mk.t * D, k0, mk.t);
    load_t<D>(vt, v, bf16, (size_t)kvh * mk.t * D, k0, mk.t);
    __syncthreads();
    float sc[4][4], dp[4][4];          // [query ty + 16 r][key tx + 16 c]
    tile_dot<D>(sc, qt, kt, ty, tx);
    tile_dot<D>(dp, dot_, vt, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * r, j = tx + 16 * c;
        const bool vis = mk.visible(q0 + i, k0 + j);
        const float p = vis ? expf(sc[r][c] * scale - ls[i]) : 0.f;
        dsm[i * PITCH + j] = p * (dp[r][c] - ds_[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float si[4], kv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) si[r] = dsm[(ty + 16 * r) * PITCH + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = kt[(tx + 16 * c) * PITCH + j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) aq[r][c] = fmaf(si[r], kv[c], aq[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= mk.s) continue;
    const size_t base = ((size_t)bh * mk.s + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) st_f(dq, bf16, base + tx + 16 * c, aq[r][c] * scale);
  }
}

template <int D>
constexpr int smem_pre() { return int(sizeof(float)) * 2 * D * PITCH; }
template <int D>
constexpr int smem_kv() {
  return int(sizeof(float)) * (4 * D * PITCH + 2 * TILE * PITCH + 2 * TILE);
}
template <int D>
constexpr int smem_q() {
  return int(sizeof(float)) * (4 * D * PITCH + TILE * PITCH + 2 * TILE);
}
static_assert(smem_kv<128>() <= 232448 && smem_q<128>() <= 232448, "shared memory");

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
             void* dq, void* dk, void* dv, int bf16, float* lse, float* delta, int b, int hq,
             int hkv, int s, int t, float scale, int causal, int window, cudaStream_t st) {
  const Mask mk{s, t, t - s, causal, window};
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bwd_pre<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_pre<D>())) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_kv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_kv<D>())) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_q<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_q<D>())) != cudaSuccess)
    return int(e);
  const dim3 rows((s + TILE - 1) / TILE, b * hq), keys((t + TILE - 1) / TILE, b * hkv);
  bwd_pre<D><<<rows, THREADS, smem_pre<D>(), st>>>(q, k, o, dout, bf16, lse, delta, hq, hkv,
                                                  scale, mk);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  bwd_kv<D><<<keys, THREADS, smem_kv<D>(), st>>>(q, k, v, dout, bf16, lse, delta, dk, dv, hq,
                                                hkv, scale, mk);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  bwd_q<D><<<rows, THREADS, smem_q<D>(), st>>>(q, k, v, dout, bf16, lse, delta, dq, hq, hkv,
                                              scale, mk);
  return int(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, void* scratch, int bf16, int b, int hq, int hkv,
           int s, int t, int d, float scale, int causal, int window, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535 || s != t) return int(cudaErrorInvalidValue);
  float* lse = static_cast<float*>(scratch);
  float* delta = lse + (size_t)b * hq * s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_d<32>(q, k, v, o, dout, dq, dk, dv, bf16, lse, delta, b, hq, hkv, s, t,
                          scale, causal, window, st);
    case 64:
      return launch_d<64>(q, k, v, o, dout, dq, dk, dv, bf16, lse, delta, b, hq, hkv, s, t,
                          scale, causal, window, st);
    case 128:
      return launch_d<128>(q, k, v, o, dout, dq, dk, dv, bf16, lse, delta, b, hq, hkv, s, t,
                           scale, causal, window, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq [b, hq, s, d]; k, v, dk, dv [b, hkv, t, d] (t == s); all
// contiguous, of one dtype; scratch 2 x b x hq x s floats (lse and D).
int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, void* dq, void* dk, void* dv, void* scratch,
                            int b, int hq, int hkv, int s, int t, int d, float scale,
                            int causal, int window, void* stream) {
  return launch(q, k, v, o, dout, dq, dk, dv, scratch, 0, b, hq, hkv, s, t, d, scale, causal,
                window, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, void* dq, void* dk, void* dv, void* scratch,
                             int b, int hq, int hkv, int s, int t, int d, float scale,
                             int causal, int window, void* stream) {
  return launch(q, k, v, o, dout, dq, dk, dv, scratch, 1, b, hq, hkv, s, t, d, scale, causal,
                window, stream);
}

}  // extern "C"
