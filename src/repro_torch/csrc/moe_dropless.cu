// The dropless expert layer's moves between token order and the sorted
// buffer of (token, expert) pairs, for Hopper (sm_90a): models/moe.py
// apply_dropless on the card.
//
// Replaces no Pallas kernel: the JAX package has no dropless layer (its MoE
// packs capacity buffers).  The plain version (kernels/moe_dropless/ref.py)
// works on every row of the T·k buffer; the rows past the held experts'
// last offset are masked there.  Here every kernel reads that offset
// (`count`, an int32 on the device) and touches the held experts' rows
// alone, so a step moves the bytes of the pairs routed to this device and
// not of all T·k, and nothing waits on the host.
//
//   moe_gather     dst[r] = src[idx[r]] (· scale[r]), r < count: the tokens
//                  into the buffer, and in the combine's gradient the
//                  incoming gradient back into it, times each row's gate
//   moe_token_sum  out[t] = sum_j w[t, j] · rows[pos[t, j]] over the token's
//                  k pairs with pos < count, in the order j = 0, 1, ...,
//                  in float32, one rounding: the combine (w the gates) and
//                  the gather's gradient (no w)
//   moe_pair_dot   dg[t, j] = sum_c dout[t, c] · rows[pos[t, j], c] (0 for a
//                  pair past count): the gates' gradient
//
// One warp takes one row, token or pair, with 16-byte loads along d; its
// sums are lane-local then a butterfly, in a fixed order, so two calls give
// the same bits and no atomics are used.  Products and sums round once each
// in float32 (built with -fmad=false), as the plain version's.
//
// Each launcher returns 0, a CUDA error, or REFUSED (-1) for a form the
// kernels do not take (d not a multiple of a 16-byte vector, k past
// MAX_K, an empty grid), having launched nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;           // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 16;              // pairs a token
constexpr int MAX_BLOCKS = 132 * 16;   // the grid-stride loops' blocks
constexpr unsigned FULL = 0xffffffffu;
constexpr int REFUSED = -1;

// 16 bytes of T as floats: 8 of bf16, 4 of float32
template <typename T> struct V { static constexpr int N = 8; };
template <> struct V<float> { static constexpr int N = 4; };

template <typename T>
__device__ __forceinline__ void load(const T* p, float* v) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
       | (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <typename T>
__device__ __forceinline__ void store(T* p, const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                              pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
}

__device__ __forceinline__ int warp_id() { return (blockIdx.x * THREADS + threadIdx.x) >> 5; }
__device__ __forceinline__ int warps() { return (gridDim.x * THREADS) >> 5; }

template <typename T, bool SCALE>
__global__ void __launch_bounds__(THREADS)
moe_gather(const T* __restrict__ src, const int64_t* __restrict__ idx,
           const float* __restrict__ scale, const int* __restrict__ count,
           T* __restrict__ dst, int d) {
  constexpr int N = V<T>::N;
  const int n = *count, lane = threadIdx.x & 31;
  for (int r = warp_id(); r < n; r += warps()) {
    const T* s = src + idx[r] * (int64_t)d;
    T* o = dst + (int64_t)r * d;
    const float sc = SCALE ? scale[r] : 1.0f;
    for (int c = lane * N; c < d; c += 32 * N) {
      float v[N];
      load(s + c, v);
      if constexpr (SCALE) {
#pragma unroll
        for (int e = 0; e < N; ++e) v[e] = v[e] * sc;
      }
      store(o + c, v);
    }
  }
}

template <typename T, bool W>
__global__ void __launch_bounds__(THREADS)
moe_token_sum(const T* __restrict__ rows, const int64_t* __restrict__ pos,
              const float* __restrict__ w, const int* __restrict__ count,
              T* __restrict__ out, int tokens, int k, int d) {
  constexpr int N = V<T>::N;
  const int n = *count, lane = threadIdx.x & 31;
  for (int t = warp_id(); t < tokens; t += warps()) {
    int64_t p[MAX_K];
    float g[MAX_K];
    for (int j = 0; j < k; ++j) {
      p[j] = pos[(int64_t)t * k + j];
      g[j] = W ? w[(int64_t)t * k + j] : 1.0f;
    }
    for (int c = lane * N; c < d; c += 32 * N) {
      float acc[N];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = 0.0f;
      for (int j = 0; j < k; ++j) {
        if (p[j] >= n) continue;
        float v[N];
        load(rows + p[j] * d + c, v);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = acc[e] + (W ? v[e] * g[j] : v[e]);
      }
      store(out + (int64_t)t * d + c, acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
moe_pair_dot(const T* __restrict__ dout, const T* __restrict__ rows,
             const int64_t* __restrict__ pos, const int* __restrict__ count,
             float* __restrict__ dg, int pairs, int k, int d) {
  constexpr int N = V<T>::N;
  const int n = *count, lane = threadIdx.x & 31;
  for (int q = warp_id(); q < pairs; q += warps()) {
    const int64_t p = pos[q];
    float s = 0.0f;
    if (p < n) {
      const T* a = dout + (int64_t)(q / k) * d;
      const T* b = rows + p * d;
      for (int c = lane * N; c < d; c += 32 * N) {
        float x[N], y[N];
        load(a + c, x);
        load(b + c, y);
#pragma unroll
        for (int e = 0; e < N; ++e) s = s + x[e] * y[e];
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(FULL, s, m);
    if (lane == 0) dg[q] = s;
  }
}

int blocks(long long items) {
  const long long b = (items + WARPS - 1) / WARPS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename T>
bool form_ok(int d) { return d > 0 && d % V<T>::N == 0; }

template <typename T>
int gather(const void* src, const void* idx, const void* scale, const void* count, void* dst,
           int rows, int d, cudaStream_t st) {
  if (!form_ok<T>(d) || rows <= 0) return REFUSED;
  const T* s = static_cast<const T*>(src);
  const int64_t* i = static_cast<const int64_t*>(idx);
  const float* sc = static_cast<const float*>(scale);
  const int* n = static_cast<const int*>(count);
  T* o = static_cast<T*>(dst);
  if (sc) moe_gather<T, true><<<blocks(rows), THREADS, 0, st>>>(s, i, sc, n, o, d);
  else moe_gather<T, false><<<blocks(rows), THREADS, 0, st>>>(s, i, sc, n, o, d);
  return int(cudaGetLastError());
}

template <typename T>
int token_sum(const void* rows, const void* pos, const void* w, const void* count, void* out,
              int tokens, int k, int d, cudaStream_t st) {
  if (!form_ok<T>(d) || tokens <= 0 || k < 1 || k > MAX_K) return REFUSED;
  const T* r = static_cast<const T*>(rows);
  const int64_t* p = static_cast<const int64_t*>(pos);
  const float* g = static_cast<const float*>(w);
  const int* n = static_cast<const int*>(count);
  T* o = static_cast<T*>(out);
  if (g) moe_token_sum<T, true><<<blocks(tokens), THREADS, 0, st>>>(r, p, g, n, o, tokens, k, d);
  else moe_token_sum<T, false><<<blocks(tokens), THREADS, 0, st>>>(r, p, g, n, o, tokens, k, d);
  return int(cudaGetLastError());
}

template <typename T>
int pair_dot(const void* dout, const void* rows, const void* pos, const void* count, void* dg,
             int tokens, int k, int d, cudaStream_t st) {
  if (!form_ok<T>(d) || tokens <= 0 || k < 1 || k > MAX_K) return REFUSED;
  const long long pairs = (long long)tokens * k;
  moe_pair_dot<T><<<blocks(pairs), THREADS, 0, st>>>(
      static_cast<const T*>(dout), static_cast<const T*>(rows), static_cast<const int64_t*>(pos),
      static_cast<const int*>(count), static_cast<float*>(dg), (int)pairs, k, d);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// src [*, d], idx int64 [rows], scale float32 [rows] or null, count int32 [1]
// -> dst [rows, d], rows < count written
int moe_gather_bf16(const void* src, const void* idx, const void* scale, const void* count,
                    void* dst, int rows, int d, void* stream) {
  return gather<__nv_bfloat16>(src, idx, scale, count, dst, rows, d,
                               static_cast<cudaStream_t>(stream));
}

int moe_gather_f32(const void* src, const void* idx, const void* scale, const void* count,
                   void* dst, int rows, int d, void* stream) {
  return gather<float>(src, idx, scale, count, dst, rows, d, static_cast<cudaStream_t>(stream));
}

// rows [*, d], pos int64 [tokens, k], w float32 [tokens, k] or null, count
// int32 [1] -> out [tokens, d]
int moe_token_sum_bf16(const void* rows, const void* pos, const void* w, const void* count,
                       void* out, int tokens, int k, int d, void* stream) {
  return token_sum<__nv_bfloat16>(rows, pos, w, count, out, tokens, k, d,
                                  static_cast<cudaStream_t>(stream));
}

int moe_token_sum_f32(const void* rows, const void* pos, const void* w, const void* count,
                      void* out, int tokens, int k, int d, void* stream) {
  return token_sum<float>(rows, pos, w, count, out, tokens, k, d,
                          static_cast<cudaStream_t>(stream));
}

// dout [tokens, d], rows [*, d], pos int64 [tokens, k], count int32 [1]
// -> dg float32 [tokens, k]
int moe_pair_dot_bf16(const void* dout, const void* rows, const void* pos, const void* count,
                      void* dg, int tokens, int k, int d, void* stream) {
  return pair_dot<__nv_bfloat16>(dout, rows, pos, count, dg, tokens, k, d,
                                 static_cast<cudaStream_t>(stream));
}

int moe_pair_dot_f32(const void* dout, const void* rows, const void* pos, const void* count,
                     void* dg, int tokens, int k, int d, void* stream) {
  return pair_dot<float>(dout, rows, pos, count, dg, tokens, k, d,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
