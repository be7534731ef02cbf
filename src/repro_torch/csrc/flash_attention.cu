// Causal (optionally windowed) GQA attention with an online softmax over key
// tiles, for Hopper (sm_90a): the prefill's sequence mix.
//
// Replaces the JAX package's Pallas kernel
// kernels/flash_attention/kernel.py:flash_attention_bhsd (_attn_kernel), at
// the call site of its XLA twin models/attention.py:blockwise_attention
// (which apply_attention selects for impl == "blockwise", or "auto" at
// S >= 8192).  It computes what blockwise_attention computes:
//   s_ij  = (q_i . k_j) * (1 / sqrt(D))                        (float32)
//   s_ij  = -1e30 where causal and row_i < j, or window and row_i - j >= window,
//           row_i = i + (T - S)                               (finite sentinel)
//   m     = running max, l = l * exp(m_old - m) + sum_j exp(s_ij - m)
//   acc   = acc * exp(m_old - m) + round_to(dtype, exp(s_ij - m)) . v_j
//   o_i   = round_to(dtype, acc / max(l, 1e-30))
//   lse_i = m + ln l  (m of scaled scores; float32, where the caller passes a
//           buffer: the gradient kernel's input, which leaves o as it is)
// P is rounded to the input dtype before the PV product and accumulated in
// float32, as the reference's `p.astype(q.dtype)` does.  Query head h reads
// key/value head h / (Hq / Hkv): no key or value is repeated in memory.
//
// Tiles that the mask removes wholly are skipped.  That is exact: a valid
// tile after skipped ones would reset them anyway (alpha = exp(-1e30 - m)
// underflows to 0).  Where a row can see no key at all (causal with S > T),
// the block skips nothing, so such rows average every value as the
// reference's do.  Keys past T (the ragged last tile) get p = 0 exactly.
//
// What bounds it: operations.  At llama3.2-1b's prefill (B 4, Hq 32, S 8192,
// D 64) the causal work is ~1.1 TFLOP against ~0.34 GB of q/k/v/o.  Two
// paths, both issued heaviest (longest causal row) first:
//   - bf16 with D 64 or 128 (the prefill's path) runs on wgmma with TMA
//     loads and a warp-specialised mbarrier ring (flash_wgmma, namespace wg
//     below): 192 (D 64) or 128 (D 128) query rows per block, 128-key
//     tiles;
//   - float32, and D 32, run on the float32 FMA pipes (flash_fwd), one block
//     per 64-query tile: q/k/v tiles staged in shared memory as float32, each
//     of 256 threads owning a 4x4 patch of the score tile and a 4x(D/16)
//     patch of the output, the row max and sum reduced across the 16 lanes
//     that share a row.  float32 products on the tensor cores (TF32) would
//     not keep float32's digits.
//
// The wgmma path's softmax works in base 2: with c = scale * log2(e) held in
// float32, p = 2^(x c - m c) is one explicit fmaf and one MUFU.EX2 per score
// (-fmad=false leaves explicit fmaf alone), m the running max of the raw
// scores.  The masks are applied only on tiles that cross the padding, the
// causal diagonal or the window's edge; full tiles take no compare.  While a
// row has seen only masked keys (m still -1e30) its p is 1 for each masked
// key, exp(-1e30 - -1e30), as the reference's is; 2^(x c - m c) would leave
// the rounding error of m c (~1e22) in the exponent there.
//
// The first query rows (the first wgmma block's worth: 192 at D 64, 128 at
// D 128) run on the FMA path instead, at the wgmma path's 128-key tiles
// (flash_fwd<bf16, D, 128>, a launch before the wgmma one).  A row that
// sees few keys has a small l, so one P rounded to the other bf16 neighbour
// moves its output by up to ~2^-8 |v| / l, more than the bar allows: a
// one-ulp difference in one float32 score (wgmma sums a row's products in
// another order than a sequential float32 sum) is enough where p lies on a
// bf16 rounding tie (gqa_d128 seed 17, row 30: the row max one ulp lower,
// p = 0.798828125 + 1 ulp instead of the tie, found by dumping that row's
// intermediates tile by tile beside the plain version's).
// The FMA path sums each score over D in order with fmaf, which is what the
// plain version's float32 product gives (the dump found no score of 10.5
// million that differs), and forms p = expf(x * scale - m), as the plain
// version does, so those rows' P are the plain version's bit for bit.  Past
// the first block l is large enough that a flipped P stays inside the bar
// (the seed sweep's worst share 0.66-0.78 with this, 0.94-1.06 without).
// It costs ~0.08 ms a call at llama3.2-1b's prefill (2.68-2.69 -> 2.77-2.78
// ms on one H100, tests/torch_scan_ab.py against the tree before it).
//
// Where the design met trouble (TMA maps, the swizzle, descriptors and
// accumulator fragments: csrc/hopper_wgmma.cuh, which the gradient's wgmma
// passes share):
//   - Registers: a mask path that worked out each element's absolute
//     column spilled ~1 KB a thread at 128-key tiles; comparing the tile's
//     column offsets with per-row limits does not.  S (64 floats), P (32
//     words) and O (32 or 64 floats) live together only if tile j + 1's S
//     is issued before tile j's P.V is done, so the loop does not: with
//     three consumer warpgroups a consumer has 160 registers.

#include <algorithm>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile (the float32 and D 32 paths)
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx KT/16 keys / D/16 columns
constexpr int QS = BQ + 4;      // padded strides (float4-aligned)
constexpr int PS = BQ + 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (the reference's p.astype(q.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int D, int KT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(D) * QS + size_t(D) * (KT + 4) + size_t(KT) * D +
                          size_t(KT) * PS);
}

// KT keys per tile: BK on the float32 and D 32 paths, the wgmma path's 128
// for its first query rows (below)
template <typename T, int D, int KT>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int hq, int hkv, int s, int t,
          float scale, int causal, int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;                      // output columns per thread
  constexpr int KPT = KT / 16;                    // keys per thread
  constexpr int KS = KT + 4;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);    // [D][QS]  q transposed
  float* kt = qt + D * QS;                        // [D][KS]  k transposed
  float* vs = kt + D * KS;                        // [KT][D]
  float* pt = vs + KT * D;                        // [KT][PS] p transposed

  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const T* qp = q + (size_t)bh * s * D;
  const T* kp = k + (size_t)kvh * t * D;
  const T* vp = v + (size_t)kvh * t * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    qt[d * QS + r] = (q0 + r < s) ? to_f(qp[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // the key tiles this block must visit
  const int off = t - s;
  const int row_lo = q0 + off;                       // absolute row of the first query
  const int row_hi = min(q0 + BQ, s) - 1 + off;
  int j_lo = 0, j_hi = (t + KT - 1) / KT - 1;
  if (row_lo >= 0) {                                 // every row sees some key
    if (causal) j_hi = min(j_hi, row_hi / KT);
    if (window > 0 && row_lo - window + 1 > 0) j_lo = (row_lo - window + 1) / KT;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int c0 = j * KT;
    __syncthreads();                                 // the last tile's reads are done
    for (int i = tid; i < KT * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const bool in = c0 + c < t;
      kt[d * KS + c] = in ? to_f(kp[(size_t)(c0 + c) * D + d]) : 0.f;
      vs[c * D + d] = in ? to_f(vp[(size_t)(c0 + c) * D + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * QS + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[KPT];
#pragma unroll
      for (int v4 = 0; v4 < KPT / 4; ++v4) {
        const float4 bb = *reinterpret_cast<const float4*>(&kt[d * KS + tx * KPT + 4 * v4]);
        bv[4 * v4] = bb.x;
        bv[4 * v4 + 1] = bb.y;
        bv[4 * v4 + 2] = bb.z;
        bv[4 * v4 + 3] = bb.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) sc[i][jj] = fmaf(av[i], bv[jj], sc[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const int col = c0 + tx * KPT + jj;
        float x = sc[i][jj] * scale;
        if (col >= t) {
          x = -INFINITY;                             // padding: p = 0 exactly
        } else {
          if (causal && row < col) x = NEG;
          if (window > 0 && row - col >= window) x = NEG;
        }
        sc[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        ps += p;
        pt[(tx * KPT + jj) * PS + ty * 4 + i] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[kk * PS + ty * 4 + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * D + tx * DC + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* op = o + ((size_t)bh * s + r) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) op[c] = from_f<T>(acc[i][c] / den);
    // the row's log-sum-exp of scaled scores (m is of scaled scores here)
    if (lse != nullptr && tx == 0) lse[(size_t)bh * s + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16 with D 64 or 128 on Hopper's warpgroup tensor cores (flash_wgmma).
//
// A block holds NWG consumer warpgroups of 64 query rows each and one
// producer warpgroup.  One thread of the producer loads Q once and then the
// K/V tiles of the block's key range with TMA (cp.async.bulk.tensor, 3-D maps
// over [B*H, rows, D], 128-byte swizzle) into a ring of NS stages; each stage
// has a full barrier (TMA's transaction count) and an empty barrier (one
// arrival from each consumer warp once its products have read the stage).
// The key loop holds no __syncthreads.  setmaxnreg gives the producer's
// registers to the consumers.  Per key tile a consumer warpgroup runs
//   S = Q.K^T   wgmma m64nBKk16, Q and K from shared memory (K-major)
//   online softmax on S's accumulator fragments (a row's values live in the
//     4 lanes of a quad, as with mma.sync, in other registers)
//   O += P.V    wgmma m64nDk16, P from registers as bf16 (the reference's
//     p.astype(q.dtype)), V from shared memory with the transpose bit set,
//     so V is never transposed in memory
// and the consumer warpgroups issue their products in turn (named
// barriers), so that one's softmax runs while the others' products take
// the tensor cores.  A consumer writes its rows of O from registers at the
// end.
//
// What holds it back (PERF.md, llama3.2-1b's prefill, 2.7 ms): without the
// products it takes 2.20 ms, without the softmax 1.44, without both 0.74
// and without the loads too 0.56.  The softmax (its MUFU.EX2 alone needs
// ~1.2 ms at the card's 16 a clock an SM) and the per-tile bookkeeping
// beneath it are most of the time.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int ROWS = 64;        // query rows per consumer warpgroup

template <int D_, int NS_, int NWG_>
struct Cfg {
  static constexpr int D = D_, BK = 128, NWG = NWG_, NS = NS_;     // see below
  static constexpr int NCH = D / CH;                         // chunks per row
  static constexpr int BQ = ROWS * NWG;                      // query rows per block
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int Q_CHUNK = ROWS * CHUNK_ROW;           // 64 rows of one chunk
  static constexpr int Q_BYTES = NWG * NCH * Q_CHUNK;
  static constexpr int KV_CHUNK = BK * CHUNK_ROW;            // BK rows of one chunk
  static constexpr int KV_BYTES = NCH * KV_CHUNK;            // a K or a V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  // 1,024 bytes of slack to align the tiles for the swizzle, then Q, the
  // ring, and 2 * NS + 1 mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + NS * STAGE + 8 * (2 * NS + 1);
  // registers: the producer keeps 24 of the launch's share, the consumers
  // take the rest (the SM's 65,536 registers in all)
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;
  static_assert(128 * (PRODUCER_REGS + NWG * CONSUMER_REGS) <= 65536, "registers");
};

// 128-key tiles; D 64 with 3 consumer warpgroups (192 query rows) and a
// 3-stage ring (121 KiB), D 128 with 2 (128 rows) and 2 stages (161 KiB).
// Both fit MAX_SMEM_BYTES (232,448).  Chosen by measurement at
// llama3.2-1b's prefill (PERF.md): 64- and 96-key tiles were slower, and
// 4 consumer warpgroups cannot get their registers (setmaxnreg.inc waits
// for registers the producer does not free).
using Cfg64 = Cfg<64, 3, 3>;
using Cfg128 = Cfg<128, 2, 2>;
static_assert(Cfg64::SMEM <= 232448 && Cfg128::SMEM <= 232448, "shared memory");

// the key tiles [lo, hi] that rows row_lo..row_hi (absolute, offset T - S
// included) must visit; where some row sees no key (row_lo < 0 under the
// causal mask) every tile is visited, so such rows average every value
__device__ __forceinline__ void tile_range(int row_lo, int row_hi, int t, int bk,
                                           int causal, int window, int& lo, int& hi) {
  lo = 0;
  hi = (t + bk - 1) / bk - 1;
  if (row_lo >= 0) {
    if (causal) hi = min(hi, row_hi / bk);
    if (window > 0 && row_lo - window + 1 > 0) lo = (row_lo - window + 1) / bk;
  }
}

// S = Q.K^T for one key tile
template <class C>
__device__ __forceinline__ void issue_scores(float (&sc)[C::BK / 2], uint64_t dq,
                                             uint32_t sk) {
  ss_product<C::D>(sc, dq, desc(sk, 16), C::Q_CHUNK, C::KV_CHUNK);
}

// O += P.V for one key tile: BK / 16 k-steps of 16 keys
template <class C>
__device__ __forceinline__ void issue_pv(float (&acc)[C::D / 2],
                                         const uint32_t (&pa)[C::BK / 16][4], uint32_t sv) {
  rs_product<C::BK>(acc, pa, sv, C::KV_CHUNK);
}

// the online softmax of one tile, in place: raw scores in, p out; m and l
// advance, alpha[h] rescales row h's accumulator
template <class C>
__device__ __forceinline__ void softmax(float (&sc)[C::BK / 2], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], const int (&row)[2], int c0,
                                        int tq, int t, float c, int causal, int window,
                                        bool mask) {
  constexpr int NB = C::BK / 8;                    // 8-column blocks of the tile
  if (mask) {
    // column 8 i + e of this thread's pairs, against limits relative to its
    // first column
    const int base = c0 + 2 * tq, pad = t - base;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int hi = causal ? row[h] - base : INT_MAX;            // last key seen
      const int lo = window > 0 ? row[h] - window + 1 - base : INT_MIN;  // first
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + e;
          float& x = sc[4 * i + 2 * h + e];
          if (col >= pad)
            x = -INFINITY;                         // padding: p = 0 exactly
          else if (col > hi || col < lo)
            x = NEG;
        }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]));
    const float m_new = fmaxf(m[h], quad_max(mx));
    float ps = 0.f;
    alpha[h] = ex2((m[h] - m_new) * c);
    // p = exp(x * scale - m * scale) as 2^(x * c - m * c), c = scale * log2 e
    const float mc = m_new * c;
    if (m_new == NEG) {                            // no key seen yet: exp(NEG - NEG) = 1
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * i + 2 * h + e];
          x = x == -INFINITY ? 0.f : 1.f;
          ps += x;
        }
    } else {
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * i + 2 * h + e];
          x = ex2(fmaf(x, c, -mc));
          ps += x;
        }
    }
    m[h] = m_new;
    l[h] = l[h] * alpha[h] + ps;                   // this thread's share of the row
  }
}

template <int ON>
__device__ __forceinline__ void rescale(float (&acc)[ON], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < ON / 4; ++i) {
    acc[4 * i + 0] *= alpha[0];
    acc[4 * i + 1] *= alpha[0];
    acc[4 * i + 2] *= alpha[1];
    acc[4 * i + 3] *= alpha[1];
  }
}

// the consumer warpgroup `w` of a block: rows q0 + 64 w .. of head bh.
// Every consumer warpgroup takes every tile of the block's key range
// [jlo, jhi], so that they take turns at the tensor cores (below); a tile
// that the mask removes wholly for this warpgroup's rows changes nothing
// (p = 0 once a key was seen; before that, whatever it adds is reset by
// alpha = 0 at the first key seen).  Per tile: S = Q.K^T, the softmax, then
// O += P.V, each product waited for before the next step, so that S and P
// are never live together (a pipelined loop that issued tile j + 1's S with
// tile j's P.V spilled at D 128 and could not run three warpgroups).
template <class C>
__device__ __forceinline__ void consume(uint32_t sq, uint32_t skv, uint32_t bars,
                                        __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int bh, int q0,
                                        int w, int s, int t, float c, float scale,
                                        int causal, int window, int jlo, int jhi) {
  constexpr int D = C::D, BK = C::BK, NS = C::NS, NWG = C::NWG;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int off = t - s;
  const int r0 = q0 + w * ROWS;                    // first query row of this warpgroup
  const int row_lo = r0 + off, row_hi = min(r0 + ROWS, s) - 1 + off;
  const int row[2] = {r0 + warp * 16 + g + off, r0 + warp * 16 + g + 8 + off};
  auto full = [&](int n) { return bars + 8 * (n % NS); };
  auto empty = [&](int n) { return bars + 8 * (NS + n % NS); };
  auto stage = [&](int n) { return skv + (n % NS) * C::STAGE; };
  auto parity = [&](int n) { return uint32_t((n / NS) & 1); };
  // a warp is done with a stage once its own wgmma.wait_group has passed;
  // one lane arrives for it
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // The warpgroups issue their products in turn (named barrier 1 + w: this
  // warpgroup waits on it, the one before arrives), so that one's softmax
  // runs while the others' products take the tensor cores.  Each issues the
  // same number of times, 2 (jhi - jlo + 1); the last one skips its last
  // hand-over, which nobody would wait for.
  auto turn = [&]() { named_sync(1 + w); };
  auto pass = [&](bool final) {
    if (!(final && w == NWG - 1)) named_arrive(1 + (w + 1) % NWG);
  };
  // masks only where the tile crosses the padding, the diagonal or the
  // window's edge
  auto mask = [&](int j) {
    const int c0 = j * BK;
    return c0 + BK > t || (causal && c0 + BK - 1 > row_lo) ||
           (window > 0 && row_hi - c0 >= window);
  };

  float acc[D / 2], sc[BK / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (w == NWG - 1) named_arrive(1);               // warpgroup 0 goes first
  mbar_wait(bars + 16 * NS, 0);                    // Q
  const uint64_t dq = desc(sq + w * C::NCH * C::Q_CHUNK, 16);
  int n = 0;                                       // stages taken: tile jlo + n
  for (int j = jlo; j <= jhi; ++j, ++n) {
    mbar_wait(full(n), parity(n));
    turn();
    wgmma_fence();
    issue_scores<C>(sc, dq, stage(n));
    wgmma_commit();
    pass(false);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax<C>(sc, m, l, alpha, row, j * BK, tq, t, c, causal, window, mask(j));
    rescale(acc, alpha);
    pack_p<BK>(pa, sc);
    fence_regs(acc);
    turn();
    wgmma_fence();
    issue_pv<C>(acc, pa, stage(n) + C::KV_BYTES);
    wgmma_commit();
    pass(j == jhi);
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty(n));
  }
  if (r0 >= s) return;                             // rows past S: nothing to write

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + g + 8 * h;
    const float lsum = quad_sum(l[h]);
    const float den = fmaxf(lsum, 1e-30f);
    if (r >= s) continue;
    // the row's log-sum-exp: m is the running max of raw scores here, and
    // l sums 2^(x c - m c) = exp(x scale - m scale)
    if (lse != nullptr && tq == 0) lse[(size_t)bh * s + r] = m[h] * scale + logf(lsum);
    __nv_bfloat16* op = o + ((size_t)bh * s + r) * D + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(op + 8 * i) =
          pack_f(acc[4 * i + 2 * h] / den, acc[4 * i + 2 * h + 1] / den);
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
            float* __restrict__ lse, int hq, int hkv, int s, int t, float c, float scale,
            int causal, int window, int q_base) {
  constexpr int NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;   // 1,024-aligned tiles
  const uint32_t skv = sq + C::Q_BYTES;
  const uint32_t bars = skv + NS * C::STAGE;        // full[NS], empty[NS], Q
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int q0 = q_base + (gridDim.x - 1 - blockIdx.x) * C::BQ;   // heaviest first
  int jlo, jhi;                                     // the block's key tiles
  tile_range(q0 + t - s, min(q0 + C::BQ, s) - 1 + t - s, t, C::BK, causal, window, jlo,
             jhi);

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (NS + i), 4 * C::NWG);    // one arrival per consumer warp
    }
    mbar_init(bars + 16 * NS, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128;
  if (w == 0) {                                     // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    const int qrows = (min(q0 + C::BQ, s) - q0 + ROWS - 1) / ROWS;   // warpgroups with rows
    const uint32_t qbar = bars + 16 * NS;
    mbar_expect_tx(qbar, qrows * C::NCH * C::Q_CHUNK);
    for (int r = 0; r < qrows; ++r)
      for (int ch = 0; ch < C::NCH; ++ch)
        tma_load(sq + (r * C::NCH + ch) * C::Q_CHUNK, &tq, ch * CH, q0 + r * ROWS, bh,
                 qbar);
    for (int j = jlo, n = 0; j <= jhi; ++j, ++n) {
      const int st = n % NS;
      mbar_wait(bars + 8 * (NS + st), ((n / NS) & 1) ^ 1);    // the stage is free
      const uint32_t full = bars + 8 * st, sk = skv + st * C::STAGE;
      mbar_expect_tx(full, C::STAGE);
      for (int ch = 0; ch < C::NCH; ++ch) {
        tma_load(sk + ch * C::KV_CHUNK, &tk, ch * CH, j * C::BK, kvh, full);
        tma_load(sk + C::KV_BYTES + ch * C::KV_CHUNK, &tv, ch * CH, j * C::BK, kvh, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
    consume<C>(sq, skv, bars, o, lse, bh, q0, w - 1, s, t, c, scale, causal, window, jlo,
               jhi);
  }
}

// query rows q_base .. s - 1 (rows before q_base are the FMA path's)
template <class C>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int hq,
           int hkv, int s, int t, float scale, int causal, int window, int q_base,
           cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, enc, q, b * hq, s, C::D, ROWS) ||
      !tensor_map(&tk, enc, k, b * hkv, t, C::D, C::BK) ||
      !tensor_map(&tv, enc, v, b * hkv, t, C::D, C::BK))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(flash_wgmma<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::SMEM);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((s - q_base + C::BQ - 1) / C::BQ, b * hq);
  flash_wgmma<C><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, hq, hkv, s, t, scale * LOG2E, scale,
      causal, window, q_base);
  return int(cudaGetLastError());
}

}  // namespace wg

// query rows 0 .. rows - 1 on the FMA pipes, KT keys per tile
template <typename T, int D, int KT = BK>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int b,
             int hq, int hkv, int s, int t, float scale, int causal, int window,
             cudaStream_t stream, int rows) {
  const size_t smem = smem_bytes<D, KT>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd<T, D, KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((rows + BQ - 1) / BQ, b * hq);
  flash_fwd<T, D, KT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, hq, hkv, s, t, scale, causal, window);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int hq,
           int hkv, int s, int t, int d, float scale, int causal, int window,
           void* stream) {
  if (b <= 0 || s <= 0 || t <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, lse, b, hq, hkv, s, t, scale, causal, window, st,
                             s);
    case 64:
      return launch_d<T, 64>(q, k, v, o, lse, b, hq, hkv, s, t, scale, causal, window, st,
                             s);
    case 128:
      return launch_d<T, 128>(q, k, v, o, lse, b, hq, hkv, s, t, scale, causal, window, st,
                              s);
    default: return int(cudaErrorInvalidValue);
  }
}

// bf16 at D 64 or 128: the first wgmma block's rows on the FMA pipes at the
// wgmma path's key tile (see the note at the top; kernel.py's plan() names
// them fma_rows), the rest on wgmma
template <class C>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                int hq, int hkv, int s, int t, float scale, int causal, int window,
                cudaStream_t st, int* wgmma) {
  const int head = std::min(s, int(C::BQ));
  if (head > 0) {
    const int e = launch_d<__nv_bfloat16, C::D, C::BK>(q, k, v, o, lse, b, hq, hkv, s, t,
                                                       scale, causal, window, st, head);
    if (e != 0 || head == s) return e;
  }
  const int e =
      wg::launch<C>(q, k, v, o, lse, b, hq, hkv, s, t, scale, causal, window, head, st);
  *wgmma = e == 0;
  return e;
}

}  // namespace

extern "C" {

// q [b, hq, s, d], k/v [b, hkv, t, d], o [b, hq, s, d], all contiguous; lse
// [b, hq, s] float32, or null: each row's log-sum-exp of its scaled scores
// (the gradient's input), which changes nothing in o.
// *wgmma is set to 1 where the wgmma kernel was launched, else to 0.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                        int b, int hq, int hkv, int s, int t, int d, float scale,
                        int causal, int window, void* stream, int* wgmma) {
  *wgmma = 0;
  return launch<float>(q, k, v, o, lse, b, hq, hkv, s, t, d, scale, causal, window, stream);
}

// D 64 and 128 take the wgmma path; D 32 the FMA path.  q, k and v must
// start on 16-byte boundaries (TMA's rule for a map's base).
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                         int b, int hq, int hkv, int s, int t, int d, float scale,
                         int causal, int window, void* stream, int* wgmma) {
  *wgmma = 0;
  if (b > 0 && s > 0 && t > 0 && hkv > 0 && hq % hkv == 0 && b * hq <= 65535 &&
      (d == 64 || d == 128)) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return d == 64 ? launch_bf16<wg::Cfg64>(q, k, v, o, lse, b, hq, hkv, s, t, scale,
                                            causal, window, st, wgmma)
                   : launch_bf16<wg::Cfg128>(q, k, v, o, lse, b, hq, hkv, s, t, scale,
                                             causal, window, st, wgmma);
  }
  return launch<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, s, t, d, scale, causal, window,
                               stream);
}

// dynamic shared memory of the wgmma path at head dim d (0: no such path),
// for the wrapper's launch plan to be checked against
int flash_attention_wgmma_smem(int d) {
  return d == 64 ? wg::Cfg64::SMEM : d == 128 ? wg::Cfg128::SMEM : 0;
}

}  // extern "C"
