// The gradient of causal (optionally windowed) GQA attention, for Hopper
// (sm_90a): dQ, dK and dV of the training path's attention.
//
// Replaces no Pallas kernel: the JAX package takes this gradient by autodiff
// of its XLA twin models/attention.py:blockwise_attention, and the port's
// forward kernel (csrc/flash_attention.cu) writes through raw pointers, so
// its output carries no autograd history.  kernels/flash_attention/ops.py's
// FlashAttentionFn launches the forward kernel, which also writes each
// row's log-sum-exp, and this one.  It computes the gradient of what
// blockwise_attention computes, from q, k, v, the forward's output o and
// log-sum-exp lse, and the incoming gradient do (FlashAttention-2's scheme):
//   s_ij   = (q_i . k_j) * scale,   visible: j <= row_i (causal) and
//            row_i - j < window (window > 0),  row_i = i + (T - S)
//   D_i    = do_i . o_i                                      (pre-pass)
//   p_ij   = exp(s_ij - lse_i) where visible, else 0
//   dp_ij  = do_i . v_j,    ds_ij = p_ij (dp_ij - D_i)
//   dV_j   = sum_i p_ij do_i,   dK_j = scale sum_i ds_ij q_i,
//   dQ_i   = scale sum_j ds_ij k_j
// with dK and dV summed over the Hq / Hkv query heads that share a KV head,
// in order (no atomics), and dQ in a pass of its own (deterministic).  p is
// formed as 2^(q.k c - lse2) with c = scale log2(e) and lse2 = lse log2(e).
// Each output is rounded to the input dtype once.  Three launches, in this
// order on the caller's stream:
//   bwd_pre  D, and lse2 (lse log2(e)), into rows padded to LSE_ALIGN
//            (padding: lse2 = +inf, so p = 0, and D = 0); bytes-bound: a
//            thread a 16-byte piece of a row, the row's pieces summed across
//            lanes;
//   kv pass  one block per (b, KV head, key block), issued heaviest first
//            (key block 0 sees every query tile under the causal mask): walks
//            every query head of its group and every query tile that can
//            see its keys, with dK and dV in registers;
//   q pass   one block per (b, query head, query block), heaviest (last)
//            first: walks the visible key tiles, with dQ in registers.
// Tiles that the mask removes wholly are skipped; only tiles that cross
// the diagonal, a window's edge or the end of the sequence are masked.
// Every row must see a key (S = T, as in training; the wrapper checks it).
//
// What bounds the function: operations.  At llama3.2-1b's training shape
// (B 1, Hq 32, Hkv 8, S 8192, D 64, causal) the gradient needs ~2.5x the
// forward's work (five products a visible pair), ~0.69 TFLOP, against ~0.2
// GB moved.  Two paths, as the forward's plan() splits them:
//   - bf16 with D 64 or 128 runs both passes on wgmma (namespace wg below),
//     their tiles fed by TMA through the forward's mbarrier ring
//     (csrc/hopper_wgmma.cuh): the kv pass runs four products a visible
//     pair (S^T, dP^T, dV, dK), the q pass three (S, dP, dQ): seven where
//     five are the least, the price of a deterministic dQ;
//   - float32, and D 32, run on the float32 FMA pipes (bwd_kv, bwd_q), one
//     64 x 64 tile pair at a time: float32 products on the tensor cores
//     (TF32) would not keep float32's digits.
// The wgmma passes round P and dS to bf16 as the A operands of dV += P^T dO,
// dK += dS^T Q and dQ += dS K (2^-9 relative a term, summed in float32),
// where the FMA passes keep them in float32 (tests/test_torch_attention.py
// holds the scheme against the bars on the CPU).
//
// Where the time goes (PERF.md; llama3.2-1b's training shape, one H100 at
// 700 W, each launch alone): ~3.05 ms a call, 4.4x the bound, of it the
// dK/dV pass ~1.84 ms, the dQ pass ~1.20 ms, the pre-pass ~0.03 ms; the
// passes run their products at ~300 (dK/dV) and ~345 (dQ) TFLOP/s.
//
// Layout of the FMA passes: each tile sits in shared memory as float32,
// transposed ([D][64], pitch 65), so that a thread reads 16 consecutive
// columns of a tile and the 16 lanes of a half-warp fall on 16 banks; a
// thread (ty, tx) of 16 x 16 owns rows ty + 16 r and columns tx + 16 r' of a
// 64 x 64 score tile, and columns tx + 16 c of its rows of a gradient.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int TILE = 64;        // query rows and keys per tile (FMA passes)
constexpr int THREADS = 256;    // 16 x 16
constexpr int PITCH = TILE + 1;
constexpr unsigned FULL = 0xffffffffu;
// lse2 and delta rows per head are padded to a multiple of this (every
// pass's tile divides it): the wgmma passes copy them without a bound check
constexpr int LSE_ALIGN = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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


// D_i = do_i . o_i and lse2_i = lse_i log2(e) for every row of the padded
// [B*Hq, pitch] layout: a thread per 16-byte piece of a row, the row's
// D / VEC pieces summed across neighbouring lanes
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_pre(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ lse2, float* __restrict__ delta, int s, int pitch, int rows) {
  constexpr int VEC = 16 / int(sizeof(T)), LANES = D / VEC;
  static_assert(LANES <= 32 && 32 % LANES == 0, "a row's pieces within one warp");
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int r = gt / LANES, part = gt - r * LANES;    // r over B*Hq*pitch rows
  const int bh = r / pitch, i = r - bh * pitch;
  const bool in = r < rows && i < s;
  float acc = 0.f;
  if (in) {
    const size_t base = ((size_t)bh * s + i) * D + part * VEC;
    const uint4 a = *reinterpret_cast<const uint4*>(o + base);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + base);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc = fmaf(to_f(gv[e]), to_f(av[e]), acc);
  }
#pragma unroll
  for (int w = LANES / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(FULL, acc, w);
  if (part == 0 && r < rows) {
    delta[r] = acc;
    lse2[r] = in ? lse[(size_t)bh * s + i] * wg::LOG2E : INFINITY;
  }
}

// dK and dV for one (b, KV head, key tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_kv(const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
       const void* __restrict__ dout, int bf16, const float* __restrict__ lse2,
       const float* __restrict__ delta, void* __restrict__ dk, void* __restrict__ dv, int hq,
       int hkv, float scale, int pitch, Mask mk) {
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
  const float c2 = scale * wg::LOG2E;
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
      for (int r = threadIdx.x; r < TILE; r += THREADS) {   // padded to the pitch
        ls[r] = lse2[(size_t)bh * pitch + q0 + r];
        ds_[r] = delta[(size_t)bh * pitch + q0 + r];
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
          const float p = vis ? exp2f(fmaf(sc[r][c], c2, -ls[i])) : 0.f;
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
      const void* __restrict__ dout, int bf16, const float* __restrict__ lse2,
      const float* __restrict__ delta, void* __restrict__ dq, int hq, int hkv, float scale,
      int pitch, Mask mk) {
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
  const float c2 = scale * wg::LOG2E;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_t<D>(qt, q, bf16, (size_t)bh * mk.s * D, q0, mk.s);
  load_t<D>(dot_, dout, bf16, (size_t)bh * mk.s * D, q0, mk.s);
  for (int r = threadIdx.x; r < TILE; r += THREADS) {       // padded to the pitch
    ls[r] = lse2[(size_t)bh * pitch + q0 + r];
    ds_[r] = delta[(size_t)bh * pitch + q0 + r];
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
        const float p = vis ? exp2f(fmaf(sc[r][c], c2, -ls[i])) : 0.f;
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
constexpr int smem_kv() {
  return int(sizeof(float)) * (4 * D * PITCH + 2 * TILE * PITCH + 2 * TILE);
}
template <int D>
constexpr int smem_q() {
  return int(sizeof(float)) * (4 * D * PITCH + TILE * PITCH + 2 * TILE);
}
static_assert(smem_kv<128>() <= 232448 && smem_q<128>() <= 232448, "shared memory");

// ---------------------------------------------------------------------------
// bf16 with D 64 or 128 on wgmma (the kv and q passes).
//
// A block holds NWG = 2 consumer warpgroups of 64 rows each (keys in the kv
// pass, query rows in the q pass) and one producer warpgroup, as the
// forward's wgmma path does.  One thread of the producer loads the block's
// resident operands once (K and V, or Q and dO: 64 rows a warpgroup) and
// then streams 64-row tiles (Q and dO with their rows' lse2 and D, or K
// and V) through a ring of NS stages, each with a full barrier (TMA's
// transaction count) and an empty one (an arrival from each consumer warp).
// The loop holds no __syncthreads, and setmaxnreg gives the producer's
// registers to the consumers.
//
// kv pass, per streamed tile (64 query rows i of one query head), per
// consumer warpgroup (its 64 keys j):
//   S^T  = K.Q^T and dP^T = V.dO^T   SS wgmma m64n64, K / V in Q's place of
//                                    the forward's S = Q.K^T (K-major)
//   P^T  = 2^(S^T c - lse2_i), dS^T = P^T (dP^T - D_i), in float32
//          registers; the columns are query rows, so each thread reads the
//          lse2 and D of its columns from the stage (staged beside the tile)
//   dV  += P^T.dO and dK += dS^T.Q   RS wgmma m64nD, P^T and dS^T packed to
//                                    bf16 by pack_p, dO and Q MN-major as V
//                                    is in the forward's O += P.V
// dK and dV stay in registers across the group's query heads, and are
// rounded once on the way out, dK times scale.
// q pass, per streamed tile (64 keys), per consumer warpgroup (its 64 query
// rows, with their lse2 and D in registers):
//   S = Q.K^T and dP = dO.V^T (SS), dS = P (dP - D), dQ += dS.K (RS, K
//   MN-major); dQ times scale on the way out.
// Each product is waited for before the next step (S^T and dP^T, then the
// softmax terms, then the two accumulations), so that the score tiles and
// the packed operands are never live beside the next tile's scores; the
// two consumer warpgroups run free of each other, and one's softmax terms
// overlap the other's products.  At D 128 the kv pass holds dK and dV (128
// floats a thread) and S^T and dP^T (64) in its 240 registers.
//
// Tried and measured slower at llama3.2-1b's training shape (one H100 at
// 700 W, tests/torch_scan_ab.py --parts flash_bwd, in turns with this
// design's 3.01-3.08 ms kernel alone): the forward's turn-taking between
// the consumer warpgroups (named barriers, each warpgroup issuing in turn)
// 4.20 ms, both passes slower; streamed tiles of 128 rows at D 64 (S^T and
// dP^T of 64 floats a thread) 3.55-3.59 ms, the dK/dV pass 1.84 -> 2.34 ms.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int ROWS = 64;        // rows of a warpgroup's tile and of a streamed tile

template <int D_, int NS_>
struct BwdCfg {
  static constexpr int D = D_, NS = NS_, NWG = 2;
  static constexpr int NCH = D / CH;                    // chunks per row
  static constexpr int BLOCK = ROWS * NWG;              // keys or query rows per block
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int CHUNK = ROWS * CHUNK_ROW;        // 64 rows of one chunk
  static constexpr int TILE_BYTES = NCH * CHUNK;        // 64 rows x D
  static constexpr int RES_BYTES = NWG * TILE_BYTES;    // one resident operand
  static constexpr int STAGE = 2 * TILE_BYTES;          // two streamed tiles
  static constexpr int VEC = 2 * ROWS * 4;              // a stage's lse2 and D (kv pass)
  // 1,024 bytes of slack to align the tiles for the swizzle, two resident
  // operands, the ring, its lse2/D vectors, 2 * NS + 1 mbarriers
  static constexpr int SMEM = 1024 + 2 * RES_BYTES + NS * (STAGE + VEC) + 8 * (2 * NS + 1);
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static_assert(128 * (PRODUCER_REGS + NWG * CONSUMER_REGS) <= 65536, "registers");
  static_assert(LSE_ALIGN % ROWS == 0 && LSE_ALIGN % BLOCK == 0, "padded rows");
};

// D 64: a 4-stage ring (101 KB); D 128: 3 stages (166 KB)
using Bwd64 = BwdCfg<64, 4>;
using Bwd128 = BwdCfg<128, 3>;
static_assert(Bwd64::SMEM <= 232448 && Bwd128::SMEM <= 232448, "shared memory");

// shared memory of a block: resident operands, ring, vectors, barriers
template <class C>
struct Smem {
  uint32_t res, ring, vec, bars;
  __device__ explicit Smem(const uint8_t* raw) {
    res = (smem_u32(raw) + 1023) & ~1023u;                   // 1,024-aligned tiles
    ring = res + 2 * C::RES_BYTES;
    vec = ring + C::NS * C::STAGE;
    bars = vec + C::NS * C::VEC;                             // full[NS], empty[NS], res
  }
  __device__ uint32_t full(int n) const { return bars + 8 * (n % C::NS); }
  __device__ uint32_t empty(int n) const { return bars + 8 * (C::NS + n % C::NS); }
  __device__ uint32_t resident() const { return bars + 16 * C::NS; }
  __device__ uint32_t stage(int n) const { return ring + (n % C::NS) * C::STAGE; }
  // stage n's lse2 (64 floats) then D (64), as a pointer into `raw`
  __device__ const float* vec_of(const uint8_t* raw, int n) const {
    return reinterpret_cast<const float*>(raw + (vec - smem_u32(raw)) + (n % C::NS) * C::VEC);
  }
  static __device__ uint32_t parity(int n) { return uint32_t((n / C::NS) & 1); }
};

template <class C>
__device__ __forceinline__ void init_bars(const Smem<C>& sm) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::NS; ++i) {
      mbar_init(sm.bars + 8 * i, 1);
      mbar_init(sm.bars + 8 * (C::NS + i), 4 * C::NWG);   // one arrival per consumer warp
    }
    mbar_init(sm.resident(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the producer: rows r0 .. of head `head` of two maps into the resident
// operands, one 64-row box per warpgroup that has rows (rows < `rows`)
template <class C>
__device__ __forceinline__ void load_resident(const Smem<C>& sm, const CUtensorMap* a,
                                              const CUtensorMap* b, int r0, int rows,
                                              int head) {
  const int nw = min(C::NWG, (rows - r0 + ROWS - 1) / ROWS);
  mbar_expect_tx(sm.resident(), 2 * nw * C::TILE_BYTES);
  for (int w = 0; w < nw; ++w)
    for (int ch = 0; ch < C::NCH; ++ch) {
      const uint32_t off = w * C::TILE_BYTES + ch * C::CHUNK;
      tma_load(sm.res + off, a, ch * CH, r0 + w * ROWS, head, sm.resident());
      tma_load(sm.res + C::RES_BYTES + off, b, ch * CH, r0 + w * ROWS, head, sm.resident());
    }
}

// the producer: stage n <- rows r0 .. r0 + 63 of head `head` of two maps
// (and, with lse2 != null, 64 floats of lse2 and of delta from padded row
// `vec_row`); waits for the stage to be free
template <class C>
__device__ __forceinline__ void load_stage(const Smem<C>& sm, int n, const CUtensorMap* a,
                                           const CUtensorMap* b, int r0, int head,
                                           const float* lse2, const float* delta,
                                           size_t vec_row) {
  mbar_wait(sm.empty(n), Smem<C>::parity(n) ^ 1);
  const uint32_t full = sm.full(n), st = sm.stage(n);
  mbar_expect_tx(full, C::STAGE + (lse2 != nullptr ? C::VEC : 0));
  for (int ch = 0; ch < C::NCH; ++ch) {
    tma_load(st + ch * C::CHUNK, a, ch * CH, r0, head, full);
    tma_load(st + C::TILE_BYTES + ch * C::CHUNK, b, ch * CH, r0, head, full);
  }
  if (lse2 != nullptr) {
    const uint32_t v = sm.vec + (n % C::NS) * C::VEC;
    bulk_load(v, lse2 + vec_row, C::VEC / 2, full);
    bulk_load(v + C::VEC / 2, delta + vec_row, C::VEC / 2, full);
  }
}

// a warp is done with a stage once its own wgmma.wait_group has passed; one
// lane arrives for it
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// rows (keys or query rows) `row0 + 16 warp + g + 8 h` of a warpgroup's
// accumulator, times `mul`, rounded to bf16 into out[rows, D] (rows < n)
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[D / 2], size_t head_row,
                                           int row0, int n, float mul) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + g + 8 * h;
    if (r >= n) continue;
    __nv_bfloat16* op = out + (head_row + r) * D + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(op + 8 * i) =
          pack_f(acc[4 * i + 2 * h] * mul, acc[4 * i + 2 * h + 1] * mul);
  }
}

// dK and dV of one (b, KV head, key block)
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
bwd_kv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int bhkv,
             int hq, int hkv, int s, int pitch, float c, float scale, int causal,
             int window) {
  constexpr int D = C::D;
  extern __shared__ uint8_t smem_raw[];
  const Smem<C> sm(smem_raw);
  const int kb = blockIdx.x / bhkv, bkv = blockIdx.x - kb * bhkv;   // heaviest first
  const int b = bkv / hkv, kh = bkv - b * hkv, rep = hq / hkv;
  const int k0 = kb * C::BLOCK, kend = min(k0 + C::BLOCK, s);
  // the query tiles whose rows can see a key of the block
  const int ilo = causal ? k0 / ROWS : 0;
  const int ihi = (window > 0 ? min(s - 1, kend - 1 + window - 1) : s - 1) / ROWS;
  init_bars(sm);

  const int w = threadIdx.x / 128;
  if (w == 0) {                                     // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    load_resident(sm, &tk, &tv, k0, s, bkv);
    int n = 0;
    for (int g = 0; g < rep; ++g) {
      const int bh = b * hq + kh * rep + g;
      for (int it = ilo; it <= ihi; ++it, ++n)
        load_stage(sm, n, &tq, &tdo, it * ROWS, bh, lse2, delta,
                   (size_t)bh * pitch + it * ROWS);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
  const int cw = w - 1, tid = threadIdx.x & 127, warp = tid >> 5;
  const int g = (tid & 31) >> 2, tq4 = tid & 3;
  const int kw0 = k0 + cw * ROWS;                   // this warpgroup's first key
  const int key[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
  float acc_k[D / 2], acc_v[D / 2], st[ROWS / 2], dp[ROWS / 2];
  uint32_t pa[ROWS / 16][4], da[ROWS / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t sk = sm.res + cw * C::TILE_BYTES, sv = sk + C::RES_BYTES;
  const uint64_t dka = desc(sk, 16), dva = desc(sv, 16);
  mbar_wait(sm.resident(), 0);
  int n = 0;
  for (int gi = 0; gi < rep; ++gi)
    for (int it = ilo; it <= ihi; ++it, ++n) {
      const int q0 = it * ROWS;
      mbar_wait(sm.full(n), Smem<C>::parity(n));
      // no visible pair of this warpgroup's keys in the tile: nothing to add
      const bool skip = kw0 >= s || (causal && q0 + ROWS - 1 < kw0) ||
                        (window > 0 && q0 > min(kw0 + ROWS, s) - 1 + window - 1);
      if (!skip) {
        const uint32_t sq = sm.stage(n), sdo = sq + C::TILE_BYTES;
        wgmma_fence();
        ss_product<D>(st, dka, desc(sq, 16), C::CHUNK, C::CHUNK);
        ss_product<D>(dp, dva, desc(sdo, 16), C::CHUNK, C::CHUNK);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);
        // masks only where the tile crosses the end, the diagonal or the
        // window's edge; column 8 i + e of this thread's pairs against
        // limits relative to its first column
        const bool mask = q0 + ROWS > s || (causal && q0 < kw0 + ROWS - 1) ||
                          (window > 0 && q0 + ROWS - 1 - kw0 >= window);
        const int base = q0 + 2 * tq4;
        const float* vl = sm.vec_of(smem_raw, n);
#pragma unroll
        for (int i = 0; i < ROWS / 8; ++i) {
          const float2 l2 = *reinterpret_cast<const float2*>(vl + 8 * i + 2 * tq4);
          const float2 dd = *reinterpret_cast<const float2*>(vl + ROWS + 8 * i + 2 * tq4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * i + e;
              float x = st[4 * i + 2 * h + e];
              if (mask && (col >= s - base || (causal && col < key[h] - base) ||
                           (window > 0 && col > key[h] + window - 1 - base)))
                x = -INFINITY;                        // p = 0 exactly
              const float p = ex2(fmaf(x, c, -(e ? l2.y : l2.x)));
              st[4 * i + 2 * h + e] = p;
              dp[4 * i + 2 * h + e] = p * (dp[4 * i + 2 * h + e] - (e ? dd.y : dd.x));
            }
        }
        pack_p<ROWS>(pa, st);
        pack_p<ROWS>(da, dp);
        fence_regs(acc_v);
        fence_regs(acc_k);
        wgmma_fence();
        rs_product<ROWS>(acc_v, pa, sdo, C::CHUNK);
        rs_product<ROWS>(acc_k, da, sq, C::CHUNK);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
      }
      release(sm.empty(n));
    }
  store_rows<D>(dk, acc_k, (size_t)bkv * s, kw0, s, scale);
  store_rows<D>(dv, acc_v, (size_t)bkv * s, kw0, s, 1.f);
}

// dQ of one (b, query head, query block)
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
bwd_q_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse2, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, int bhq, int hq, int hkv, int s, int pitch,
            float c, float scale, int causal, int window) {
  constexpr int D = C::D;
  extern __shared__ uint8_t smem_raw[];
  const Smem<C> sm(smem_raw);
  const int nqb = gridDim.x / bhq;
  const int qb = nqb - 1 - int(blockIdx.x) / bhq;   // heaviest (last) first
  const int bh = blockIdx.x % bhq;
  const int b = bh / hq, h = bh - b * hq, kvh = b * hkv + h / (hq / hkv);
  const int q0 = qb * C::BLOCK, qend = min(q0 + C::BLOCK, s);
  // the key tiles that a row of the block can see
  const int jlo = window > 0 ? max(0, q0 - window + 1) / ROWS : 0;
  const int jhi = (causal ? qend - 1 : s - 1) / ROWS;
  init_bars(sm);

  const int w = threadIdx.x / 128;
  if (w == 0) {                                     // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    load_resident(sm, &tq, &tdo, q0, s, bh);
    for (int j = jlo, n = 0; j <= jhi; ++j, ++n)
      load_stage(sm, n, &tk, &tv, j * ROWS, kvh, nullptr, nullptr, 0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
  const int cw = w - 1, tid = threadIdx.x & 127, warp = tid >> 5;
  const int g = (tid & 31) >> 2, tq4 = tid & 3;
  const int r0 = q0 + cw * ROWS;                    // this warpgroup's first query row
  const int rlast = min(r0 + ROWS, s) - 1;
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  // the rows' lse2 and D (padded rows: lse2 = +inf, so p = 0)
  float l2[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l2[hh] = lse2[(size_t)bh * pitch + row[hh]];
    dd[hh] = delta[(size_t)bh * pitch + row[hh]];
  }
  float acc[D / 2], sc[ROWS / 2], dp[ROWS / 2];
  uint32_t da[ROWS / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t sq = sm.res + cw * C::TILE_BYTES, sdo = sq + C::RES_BYTES;
  const uint64_t dqa = desc(sq, 16), doa = desc(sdo, 16);
  mbar_wait(sm.resident(), 0);
  for (int j = jlo, n = 0; j <= jhi; ++j, ++n) {
    const int c0 = j * ROWS;
    mbar_wait(sm.full(n), Smem<C>::parity(n));
    const bool skip = r0 >= s || (causal && c0 > rlast) ||
                      (window > 0 && c0 + ROWS - 1 < r0 - window + 1);
    if (!skip) {
      const uint32_t skt = sm.stage(n), svt = skt + C::TILE_BYTES;
      wgmma_fence();
      ss_product<D>(sc, dqa, desc(skt, 16), C::CHUNK, C::CHUNK);
      ss_product<D>(dp, doa, desc(svt, 16), C::CHUNK, C::CHUNK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool mask = c0 + ROWS > s || (causal && c0 + ROWS - 1 > r0) ||
                        (window > 0 && rlast - c0 >= window);
      const int base = c0 + 2 * tq4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int hi = causal ? row[hh] - base : INT_MAX;                 // last key seen
        const int lo = window > 0 ? row[hh] - window + 1 - base : INT_MIN;  // first
#pragma unroll
        for (int i = 0; i < ROWS / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + e;
            float x = sc[4 * i + 2 * hh + e];
            if (mask && (col >= s - base || col > hi || col < lo)) x = -INFINITY;
            const float p = ex2(fmaf(x, c, -l2[hh]));
            dp[4 * i + 2 * hh + e] = p * (dp[4 * i + 2 * hh + e] - dd[hh]);
          }
      }
      pack_p<ROWS>(da, dp);
      fence_regs(acc);
      wgmma_fence();
      rs_product<ROWS>(acc, da, skt, C::CHUNK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    release(sm.empty(n));
  }
  store_rows<D>(dq, acc, (size_t)bh * s, r0, s, scale);
}

// the two passes at head dim C::D; `passes` bits 2 (kv) and 4 (q)
template <class C>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse2,
           const float* delta, void* dq, void* dk, void* dv, int b, int hq, int hkv, int s,
           int pitch, float scale, int causal, int window, int passes, cudaStream_t st) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, enc, q, b * hq, s, C::D, ROWS) ||
      !tensor_map(&tk, enc, k, b * hkv, s, C::D, ROWS) ||
      !tensor_map(&tv, enc, v, b * hkv, s, C::D, ROWS) ||
      !tensor_map(&tdo, enc, dout, b * hq, s, C::D, ROWS))
    return int(cudaErrorInvalidValue);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bwd_kv_wgmma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                C::SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_q_wgmma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                C::SMEM)) != cudaSuccess)
    return int(e);
  const int nb = (s + C::BLOCK - 1) / C::BLOCK;
  const float c = scale * LOG2E;
  if (passes & 2) {
    bwd_kv_wgmma<C><<<nb * b * hkv, C::THREADS, C::SMEM, st>>>(
        tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), b * hkv, hq, hkv, s, pitch, c, scale, causal, window);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (passes & 4) {
    bwd_q_wgmma<C><<<nb * b * hq, C::THREADS, C::SMEM, st>>>(
        tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), b * hq, hq, hkv, s,
        pitch, c, scale, causal, window);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

}  // namespace wg

// the FMA passes at head dim D; `passes` bits 2 (kv) and 4 (q)
template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* dout, int bf16,
               const float* lse2, const float* delta, void* dq, void* dk, void* dv, int b,
               int hq, int hkv, int s, int pitch, float scale, int causal, int window,
               int passes, cudaStream_t st) {
  const Mask mk{s, s, 0, causal, window};
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bwd_kv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_kv<D>())) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_q<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_q<D>())) != cudaSuccess)
    return int(e);
  const dim3 rows((s + TILE - 1) / TILE, b * hq), keys((s + TILE - 1) / TILE, b * hkv);
  if (passes & 2) {
    bwd_kv<D><<<keys, THREADS, smem_kv<D>(), st>>>(q, k, v, dout, bf16, lse2, delta, dk, dv,
                                                  hq, hkv, scale, pitch, mk);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (passes & 4) {
    bwd_q<D><<<rows, THREADS, smem_q<D>(), st>>>(q, k, v, dout, bf16, lse2, delta, dq, hq,
                                                hkv, scale, pitch, mk);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

template <typename T, int D>
int launch_pre(const void* o, const void* dout, const float* lse, float* lse2, float* delta,
               int bhq, int s, int pitch, cudaStream_t st) {
  constexpr int LANES = D / (16 / int(sizeof(T)));
  const long threads = long(bhq) * pitch * LANES;
  bwd_pre<T, D><<<unsigned((threads + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, lse2, delta, s, pitch,
      bhq * pitch);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, void* scratch, int b, int hq,
           int hkv, int s, int t, int d, float scale, int causal, int window, int pitch,
           int passes, void* stream, int* wgmma) {
  constexpr int bf16 = sizeof(T) == 2;
  *wgmma = 0;
  if (b <= 0 || s <= 0 || t <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535 || s != t || pitch % LSE_ALIGN != 0 ||
      pitch < s || (d != 32 && d != 64 && d != 128))
    return int(cudaErrorInvalidValue);
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + (size_t)b * hq * pitch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (passes & 1) {
    const int e = d == 32    ? launch_pre<T, 32>(o, dout, lse, lse2, delta, b * hq, s, pitch, st)
                  : d == 64 ? launch_pre<T, 64>(o, dout, lse, lse2, delta, b * hq, s, pitch, st)
                            : launch_pre<T, 128>(o, dout, lse, lse2, delta, b * hq, s, pitch, st);
    if (e != 0) return e;
  }
  if (bf16 && d == 64) {
    *wgmma = 1;
    return wg::launch<wg::Bwd64>(q, k, v, dout, lse2, delta, dq, dk, dv, b, hq, hkv, s, pitch,
                                 scale, causal, window, passes, st);
  }
  if (bf16 && d == 128) {
    *wgmma = 1;
    return wg::launch<wg::Bwd128>(q, k, v, dout, lse2, delta, dq, dk, dv, b, hq, hkv, s,
                                  pitch, scale, causal, window, passes, st);
  }
  switch (d) {
    case 32:
      return launch_fma<32>(q, k, v, dout, bf16, lse2, delta, dq, dk, dv, b, hq, hkv, s, pitch,
                            scale, causal, window, passes, st);
    case 64:
      return launch_fma<64>(q, k, v, dout, bf16, lse2, delta, dq, dk, dv, b, hq, hkv, s, pitch,
                            scale, causal, window, passes, st);
    default:
      return launch_fma<128>(q, k, v, dout, bf16, lse2, delta, dq, dk, dv, b, hq, hkv, s,
                             pitch, scale, causal, window, passes, st);
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq [b, hq, s, d]; k, v, dk, dv [b, hkv, t, d] (t == s); all
// contiguous, of one dtype, starting on 16-byte boundaries; lse [b, hq, s]
// float32 (the forward's); scratch 2 x b x hq x pitch floats (lse2 and D),
// pitch a multiple of 128 and at least s.  `passes` picks the launches (1
// the pre-pass, 2 the kv pass, 4 the q pass; 7 for the gradient: the others
// time one launch alone).  *wgmma is set to 1 where the wgmma passes run.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, void* dq, void* dk, void* dv,
                            void* scratch, int b, int hq, int hkv, int s, int t, int d,
                            float scale, int causal, int window, int pitch, int passes,
                            void* stream, int* wgmma) {
  return launch<float>(q, k, v, o, dout, lse, dq, dk, dv, scratch, b, hq, hkv, s, t, d, scale,
                       causal, window, pitch, passes, stream, wgmma);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, void* dq, void* dk, void* dv,
                             void* scratch, int b, int hq, int hkv, int s, int t, int d,
                             float scale, int causal, int window, int pitch, int passes,
                             void* stream, int* wgmma) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, scratch, b, hq, hkv, s, t,
                               d, scale, causal, window, pitch, passes, stream, wgmma);
}

// dynamic shared memory of the wgmma passes at head dim d (0: no such
// path), for the wrapper's plan_bwd to be checked against
int flash_attention_bwd_wgmma_smem(int d) {
  return d == 64 ? wg::Bwd64::SMEM : d == 128 ? wg::Bwd128::SMEM : 0;
}

}  // extern "C"
