// Device helpers shared by every kernel source: warp reductions, activation
// loads and stores in f32 or bf16, the epilogue activations, and the exact
// int8 -> f32 conversion. Everything has internal linkage, so each .cu file
// that includes this compiles its own copy.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {
namespace {

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use on sm_90

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float load_act(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_act(void* p, int bf16, size_t i, float v) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// f32 rounded to the element type T and back (bf16: one rounding; f32: none).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) { return round_bf16(v); }

__device__ __forceinline__ void store_elt(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elt(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of a row to f32: 4 floats or 8 bf16 values.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const unsigned words[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                             static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// erf by Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7), the polynomial
// of rten_tpu/kernels/matmul_pallas.py _erf_poly and activations.py.
__device__ __forceinline__ float erf_poly(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + p * ax);
  const float y = 1.f - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t * expf(-ax * ax);
  return sign * y;
}

// Epilogue activation by code (activations.py ACTIVATION_CODES).
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return 0.5f * v * (1.f + erf_poly(v * 0.7071067811865475f));
  if (act == 2) return fmaxf(v, 0.f);
  return v;
}

// 16 int8 weights (one int4) to f32 without the quarter-rate int-to-float
// instruction: each byte, offset to unsigned by the XOR, becomes the low
// mantissa byte of 2^23 (one byte permute), and one subtraction removes
// 2^23 + 128. Exact for every int8.
__device__ __forceinline__ void unpack16(const int4& w, float (&f)[16]) {
  const unsigned words[4] = {static_cast<unsigned>(w.x), static_cast<unsigned>(w.y),
                             static_cast<unsigned>(w.z), static_cast<unsigned>(w.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = words[i] ^ 0x80808080u;
    f[4 * i + 0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    f[4 * i + 1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    f[4 * i + 2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    f[4 * i + 3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  }
}

// Raise a kernel's dynamic shared-memory limit to MAX_SMEM the first time a
// launch needs more than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool& done) {
  if (smem <= 48 * 1024 || done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace
}  // namespace rt
