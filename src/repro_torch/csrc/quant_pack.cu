// Per-group int8 quantize and dequantize for Hopper (sm_90a): the payload
// protocol of the MoE dispatch fabric (int8 + one float32 scale per
// 128-element group).
//
// Replaces the JAX package's Pallas kernels
// kernels/quant_pack/kernel.py:quantize (_quant_kernel) and
// kernels/quant_pack/kernel.py:dequantize (_dequant_kernel); the reference's
// fabric (models/moe.py:_fabric) calls the same math through
// kernels/quant_pack/ref.py.
//
// The contract is the compiled one (XLA rewrites "/ 127.0" into a multiply
// by the float32 reciprocal):
//   scale = max(max|x_g|, 1e-30f) * (1.0f / 127.0f)
//   q     = clamp(rint(x / scale), -127, 127)       (IEEE division, ties to even)
//   x'    = round_to(out_dtype, float(q) * scale)   (bf16: round to nearest even)
// Built with -fmad=false and no fast math, so each operation rounds once
// as the reference's does, and results are bitwise equal to
// repro_torch/kernels/quant_pack/ref.py.
//
// What bounds it: bytes.  Quantize reads each input once (4 or 2 bytes per
// element) and writes 1 byte per element plus 4 bytes per group; the work
// is a max, a division and a rounding per element.  The design gives one
// warp to one 128-element group, 4 consecutive elements per lane: the input
// is one 16-byte (f32) or 8-byte (bf16) load per lane, coalesced across the
// warp into 512 or 256 contiguous bytes; the group's absmax is a 5-step
// __shfl_xor_sync butterfly (max is order-free, so it is exact whatever the
// order); the int8 codes leave as one 4-byte store per lane and lane 0
// writes the scale.  Dequantize is the same walk in reverse.  No shared
// memory, no block-level synchronisation: every warp is independent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// float32(1e-30) and float32(1 / 127), spelled exactly
constexpr float TINY = 0x1.4484c0p-100f;
constexpr float INV127 = 0x1.020408p-7f;

// one lane's 4 elements as float32 (bf16 -> f32 is exact: a 16-bit shift)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 t;
  t.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  t.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ signed char code(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return (signed char)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x,        // [G * 128]
                int8_t* __restrict__ q,         // [G * 128]
                float* __restrict__ s,          // [G]
                long long n_groups) {
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= n_groups) return;                    // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const long long base = g * GROUP + lane * 4;
  float v[4];
  load4(x + base, v);
  float m = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                  fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  const float scale = __fmul_rn(fmaxf(m, TINY), INV127);
  char4 c;
  c.x = code(v[0], scale);
  c.y = code(v[1], scale);
  c.z = code(v[2], scale);
  c.w = code(v[3], scale);
  *reinterpret_cast<char4*>(q + base) = c;
  if (lane == 0) s[g] = scale;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q,  // [G * 128]
                  const float* __restrict__ s,   // [G]
                  T* __restrict__ out,           // [G * 128]
                  long long n_groups) {
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= n_groups) return;
  const int lane = threadIdx.x & 31;
  const long long base = g * GROUP + lane * 4;
  const float scale = s[g];
  const char4 c = *reinterpret_cast<const char4*>(q + base);
  float v[4];
  v[0] = __fmul_rn((float)c.x, scale);
  v[1] = __fmul_rn((float)c.y, scale);
  v[2] = __fmul_rn((float)c.z, scale);
  v[3] = __fmul_rn((float)c.w, scale);
  store4(out + base, v);
}

inline long long blocks_for(long long n_groups) {
  return (n_groups + WARPS - 1) / WARPS;
}

constexpr long long MAX_BLOCKS = 2147483647LL;

}  // namespace

extern "C" {

int quant_pack_group() { return GROUP; }

// x [G*128] f32 -> q [G*128] int8, s [G] f32
int quantize_f32(const void* x, void* q, void* s, long long n_groups,
                 void* stream) {
  if (n_groups == 0) return 0;
  if (blocks_for(n_groups) > MAX_BLOCKS) return int(cudaErrorInvalidValue);
  quantize_kernel<float><<<(unsigned)blocks_for(n_groups), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), n_groups);
  return int(cudaGetLastError());
}

// x [G*128] bf16 -> q [G*128] int8, s [G] f32
int quantize_bf16(const void* x, void* q, void* s, long long n_groups,
                  void* stream) {
  if (n_groups == 0) return 0;
  if (blocks_for(n_groups) > MAX_BLOCKS) return int(cudaErrorInvalidValue);
  quantize_kernel<__nv_bfloat16><<<(unsigned)blocks_for(n_groups), THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), n_groups);
  return int(cudaGetLastError());
}

// q [G*128] int8, s [G] f32 -> out [G*128] f32
int dequantize_f32(const void* q, const void* s, void* out, long long n_groups,
                   void* stream) {
  if (n_groups == 0) return 0;
  if (blocks_for(n_groups) > MAX_BLOCKS) return int(cudaErrorInvalidValue);
  dequantize_kernel<float><<<(unsigned)blocks_for(n_groups), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), n_groups);
  return int(cudaGetLastError());
}

// q [G*128] int8, s [G] f32 -> out [G*128] bf16
int dequantize_bf16(const void* q, const void* s, void* out,
                    long long n_groups, void* stream) {
  if (n_groups == 0) return 0;
  if (blocks_for(n_groups) > MAX_BLOCKS) return int(cudaErrorInvalidValue);
  dequantize_kernel<__nv_bfloat16><<<(unsigned)blocks_for(n_groups), THREADS,
                                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<__nv_bfloat16*>(out), n_groups);
  return int(cudaGetLastError());
}

}  // extern "C"
