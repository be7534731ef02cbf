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
// paths, both one block per 64-query tile, issued heaviest (longest causal
// row) first:
//   - bf16 with D 64 or 128 runs on the tensor cores with mma.sync (bf16 in,
//     float32 accumulate; flash_mma below), the prefill's path, with K/V
//     tiles double-buffered through cp.async;
//   - float32, and D 32, run on the float32 FMA pipes (flash_fwd): q/k/v
//     tiles staged in shared memory as float32, each of 256 threads owning a
//     4x4 patch of the score tile and a 4x(D/16) patch of the output, the row
//     max and sum reduced across the 16 lanes that share a row.  float32
//     products on the tensor cores (TF32) would not keep float32's digits.
// Neither uses wgmma or TMA, nor splits the softmax from the products across
// warps: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys / D/16 columns
constexpr int QS = BQ + 4;      // padded strides (float4-aligned)
constexpr int KS = BK + 4;
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(D) * QS + size_t(D) * KS + size_t(BK) * D + size_t(BK) * PS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int hq, int hkv, int s, int t, float scale,
          int causal, int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;                      // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);    // [D][QS]  q transposed
  float* kt = qt + D * QS;                        // [D][KS]  k transposed
  float* vs = kt + D * KS;                        // [BK][D]
  float* pt = vs + BK * D;                        // [BK][PS] p transposed

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
  int j_lo = 0, j_hi = (t + BK - 1) / BK - 1;
  if (row_lo >= 0) {                                 // every row sees some key
    if (causal) j_hi = min(j_hi, row_hi / BK);
    if (window > 0 && row_lo - window + 1 > 0) j_lo = (row_lo - window + 1) / BK;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int c0 = j * BK;
    __syncthreads();                                 // the last tile's reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const bool in = c0 + c < t;
      kt[d * KS + c] = in ? to_f(kp[(size_t)(c0 + c) * D + d]) : 0.f;
      vs[c * D + d] = in ? to_f(vp[(size_t)(c0 + c) * D + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * QS + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&kt[d * KS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(av[i], bv[jj], sc[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = c0 + tx * 4 + jj;
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
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        ps += p;
        pt[(tx * 4 + jj) * PS + ty * 4 + i] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
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
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16 (bf16 in, float32 accumulate).
// One 128-thread block per 64-query tile, each warp owning 16 query rows
// (FlashAttention-2's split): the warp keeps its Q fragments in registers,
// computes its 16 x 64 score tile with 32 mma per key tile, runs the online
// softmax on the accumulator fragments (a row's 16 values live in the 4
// lanes of a quad), and feeds P back as A fragments (rounded to bf16, as the
// reference rounds p) to the PV product without a trip through shared
// memory.  K and V tiles are staged in shared memory by cp.async, double
// buffered (the next tile loads while this one is used), and read into
// fragments with ldmatrix (.trans for V).
// ---------------------------------------------------------------------------

constexpr int MQ = 64;          // query rows per block (4 warps x 16)
constexpr int MK = 64;          // keys per tile
constexpr int MT = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ uint32_t pack_h(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

template <int D>
constexpr size_t mma_smem_bytes() {       // Q, and K and V double-buffered
  return sizeof(__nv_bfloat16) * size_t(MQ + 4 * MK) * (D + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// rows [0, rows) of a row-major [*, D] bf16 tile into shared memory (row
// stride DP) with 16-byte cp.async copies; rows at or past `valid` are
// zero-filled (a copy of 0 source bytes)
template <int D, int DP>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      int rows, int valid, int tid) {
  constexpr int V = D / 8;                            // 16-byte vectors per row
  for (int i = tid; i < rows * V; i += MT) {
    const int r = i / V, c = i - r * V;
    const bool in = r < valid;
    const __nv_bfloat16* g = src + (in ? (size_t)r * D + c * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst + r * DP + c * 8)), "l"(g), "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <int D>
__global__ void __launch_bounds__(MT)
flash_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int hq,
          int hkv, int s, int t, float scale, int causal, int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 8;                           // padded row, in elements
  constexpr int KD = D / 16, NT = MK / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [MQ][DP]
  __nv_bfloat16* kbuf = qs + MQ * DP;                            // 2 x [MK][DP]
  __nv_bfloat16* vbuf = kbuf + 2 * MK * DP;                      // 2 x [MK][DP]

  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MQ;   // heaviest tiles first
  const __nv_bfloat16* kp = k + (size_t)kvh * t * D;
  const __nv_bfloat16* vp = v + (size_t)kvh * t * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;

  stage<D, DP>(qs, q + ((size_t)bh * s + q0) * D, MQ, s - q0, tid);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* qr = qs + (r0 + g) * DP + kk * 16 + 2 * tq;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * DP);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * DP + 8);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int off = t - s;
  const int row_lo = q0 + off;
  const int row_hi = min(q0 + MQ, s) - 1 + off;
  int j_lo = 0, j_hi = (t + MK - 1) / MK - 1;
  if (row_lo >= 0) {
    if (causal) j_hi = min(j_hi, row_hi / MK);
    if (window > 0 && row_lo - window + 1 > 0) j_lo = (row_lo - window + 1) / MK;
  }

  // K/V tiles double-buffered: tile j + 1 is in flight while j is used
  const int li = lane >> 3, lr = lane & 7;            // ldmatrix: matrix, row
  if (j_lo <= j_hi) {
    stage<D, DP>(kbuf, kp + (size_t)j_lo * MK * D, MK, t - j_lo * MK, tid);
    stage<D, DP>(vbuf, vp + (size_t)j_lo * MK * D, MK, t - j_lo * MK, tid);
  }
  for (int j = j_lo; j <= j_hi; ++j) {
    const int c0 = j * MK;
    const int cur = (j - j_lo) & 1;
    const __nv_bfloat16* ks = kbuf + cur * MK * DP;
    const __nv_bfloat16* vs = vbuf + cur * MK * DP;
    if (j < j_hi) {
      const int c1 = c0 + MK;
      stage<D, DP>(kbuf + (cur ^ 1) * MK * DP, kp + (size_t)c1 * D, MK, t - c1, tid);
      stage<D, DP>(vbuf + (cur ^ 1) * MK * DP, vp + (size_t)c1 * D, MK, t - c1, tid);
      cp_async_wait<2>();                             // this tile's K and V landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; kk += 2) {            // K^T fragments of k-steps kk, kk+1
        uint32_t kb[4];
        ldsm_x4(kb, ks + (n * 8 + lr) * DP + kk * 16 + li * 8);
        mma_bf16(sc[n], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[n], qa[kk + 1], kb[2], kb[3]);
      }
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {                  // rows g and g + 8
      const int row = q0 + r0 + g + 8 * hf + off;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + n * 8 + 2 * tq + e;
          float x = sc[n][2 * hf + e] * scale;
          if (col >= t) {
            x = -INFINITY;                            // padding: p = 0 exactly
          } else {
            if (causal && row < col) x = NEG;
            if (window > 0 && row - col >= window) x = NEG;
          }
          sc[n][2 * hf + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hf], quad_max(mx));
      const float alpha = expf(m[hf] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sc[n][2 * hf + e] - m_new);
          ps += p;
          sc[n][2 * hf + e] = p;
        }
      l[hf] = l[hf] * alpha + quad_sum(ps);
      m[hf] = m_new;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * hf] *= alpha;
        acc[d][2 * hf + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t pa[4] = {pack_f(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_f(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_f(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_f(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; d += 2) {               // V fragments of dim tiles d, d+1
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (kk * 16 + (li & 1) * 8 + lr) * DP + (d + (li >> 1)) * 8);
        mma_bf16(acc[d], pa, vb[0], vb[1]);
        mma_bf16(acc[d + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                                  // done with this buffer
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + r0 + g + 8 * hf;
    if (r >= s) continue;
    const float den = fmaxf(l[hf], 1e-30f);
    __nv_bfloat16* op = o + ((size_t)bh * s + r) * D + 2 * tq;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(op + d * 8) =
          pack_f(acc[d][2 * hf] / den, acc[d][2 * hf + 1] / den);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b, int hq,
               int hkv, int s, int t, float scale, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_mma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((s + MQ - 1) / MQ, b * hq);
  flash_mma<D><<<grid, MT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), hq, hkv, s,
      t, scale, causal, window);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b, int hq,
             int hkv, int s, int t, float scale, int causal, int window,
             cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((s + BQ - 1) / BQ, b * hq);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, s, t, scale, causal, window);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
           int hkv, int s, int t, int d, float scale, int causal, int window,
           void* stream) {
  if (b <= 0 || s <= 0 || t <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_d<T, 32>(q, k, v, o, b, hq, hkv, s, t, scale, causal, window, st);
    case 64: return launch_d<T, 64>(q, k, v, o, b, hq, hkv, s, t, scale, causal, window, st);
    case 128: return launch_d<T, 128>(q, k, v, o, b, hq, hkv, s, t, scale, causal, window, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [b, hq, s, d], k/v [b, hkv, t, d], o [b, hq, s, d], all contiguous.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int b,
                        int hq, int hkv, int s, int t, int d, float scale,
                        int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, b, hq, hkv, s, t, d, scale, causal, window, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int b,
                         int hq, int hkv, int s, int t, int d, float scale,
                         int causal, int window, void* stream) {
  if (b > 0 && s > 0 && t > 0 && hkv > 0 && hq % hkv == 0 && b * hq <= 65535) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d == 64) return launch_mma<64>(q, k, v, o, b, hq, hkv, s, t, scale, causal, window, st);
    if (d == 128) return launch_mma<128>(q, k, v, o, b, hq, hkv, s, t, scale, causal, window, st);
  }
  return launch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, t, d, scale, causal, window,
                               stream);
}

}  // extern "C"
