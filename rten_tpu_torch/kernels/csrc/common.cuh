// Device helpers shared by every kernel source: warp and block reductions,
// activation loads and stores in f32 or bf16, the W8A8 row quantization, the
// epilogue activations, the exact int8 -> f32 conversion, and ldmatrix
// (plain and transposed).
// Everything has internal linkage, so each .cu file that includes this
// compiles its own copy.
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

__device__ __forceinline__ int warp_sum(int v) {  // exact
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// W8A8 activation quantization, per row (the TPU's _act_quantize,
// rten_tpu/kernels/quant_matmul.py:124): scale = absmax / 127 by IEEE
// division (1 for an all-zero row), code = rint(x / scale), half to even,
// clipped to +-127. No --use_fast_math, so `/` is the IEEE division.
__device__ __forceinline__ float row_scale(float absmax) { return absmax == 0.f ? 1.f : absmax / 127.f; }

__device__ __forceinline__ unsigned quantize_code(float x, float scale) {
  return static_cast<unsigned>(static_cast<int>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f))) & 0xffu;
}

// Four codes as one 32-bit word, element i in byte i (the order __dp4a
// pairs them with four int8 weights).
__device__ __forceinline__ unsigned quantize4(const float4& x, float scale) {
  return quantize_code(x.x, scale) | (quantize_code(x.y, scale) << 8) | (quantize_code(x.z, scale) << 16) |
         (quantize_code(x.w, scale) << 24);
}

__device__ __forceinline__ float absmax4(const float4& x) {
  return fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w)));
}

__device__ __forceinline__ float hsum4(const float4& v) { return v.x + v.y + v.z + v.w; }

// The row norm's arithmetic, shared by the GEMV prologues (gemv.cuh,
// decode_block.cu). First pass: four values' share of the row total, the
// sum of x (layernorm) or of x^2 (rmsnorm).
__device__ __forceinline__ float norm_part4(const float4& x, int norm) {
  const float4 sq = make_float4(x.x * x.x, x.y * x.y, x.z * x.z, x.w * x.w);
  return norm == 2 ? hsum4(sq) : hsum4(x);
}

__device__ __forceinline__ float norm_inv(float tot, float kf, float eps) { return rsqrtf(tot / kf + eps); }

// The mean and 1 / sqrt(var + eps) from the first pass's total; rmsnorm's
// inv is final (from the mean square), layernorm's is replaced by norm_inv
// of the centred sum of squares.
__device__ __forceinline__ void norm_stats(int norm, float tot, float kf, float eps, float& mean, float& inv) {
  mean = norm == 1 ? tot / kf : 0.f;
  inv = norm_inv(tot, kf, eps);
}

// Layernorm's second pass: four values' centred sum of squares.
__device__ __forceinline__ float centred_sq4(const float4& x, float mean) {
  const float dx = x.x - mean, dy = x.y - mean, dz = x.z - mean, dw = x.w - mean;
  return dx * dx + dy * dy + dz * dz + dw * dw;
}

// The normalise step: (x - mean) * inv * scale + bias.
__device__ __forceinline__ float4 normalize4(float4 x, float mean, float inv, const float4& ns, const float4& nb) {
  x.x = (x.x - mean) * inv * ns.x + nb.x;
  x.y = (x.y - mean) * inv * ns.y + nb.y;
  x.z = (x.z - mean) * inv * ns.z + nb.z;
  x.w = (x.w - mean) * inv * ns.w + nb.w;
  return x;
}

// Block-wide sum (or max) of one value per thread of a block of WARPS
// warps; every thread gets the same result, combined in a fixed order. Ends
// on a barrier, so `red` ([WARPS] floats of shared memory) can be reused at
// once.
template <bool MAX, int WARPS>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) t = MAX ? fmaxf(t, red[w]) : t + red[w];
  __syncthreads();
  return t;
}

// One row's W8A8 quantization by a block of THREADS threads: load(v) gives
// float4 v (< nv) of the row, read twice (absmax, then codes), thread t
// taking v = t, t + THREADS, ...; writes the row's codes, four to a word,
// and returns its scale. The absmax is a block max, so exact in any order.
template <int THREADS, typename Load>
__device__ __forceinline__ float quantize_row(const Load& load, int nv, unsigned* codes, float* red) {
  float amax = 0.f;
  for (int v = threadIdx.x; v < nv; v += THREADS) amax = fmaxf(amax, absmax4(load(v)));
  const float scale = row_scale(block_reduce<true, THREADS / 32>(amax, red));
  for (int v = threadIdx.x; v < nv; v += THREADS) codes[v] = quantize4(load(v), scale);
  return scale;
}

// Four consecutive activations (i % 4 == 0) as f32, one 8- or 16-byte load:
// through the read-only path (__ldg), or, COHERENT, from L2 (__ldcg) for
// data that other blocks of the same launch wrote (the MLP's rows in
// gemv.cuh, read after a grid sync).
template <bool COHERENT = false>
__device__ __forceinline__ float4 load_act4(const void* p, int bf16, size_t i) {
  if (bf16) {
    const uint2* q = reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
    const uint2 v = COHERENT ? __ldcg(q) : __ldg(q);
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
  const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  return COHERENT ? __ldcg(q) : __ldg(q);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices (8 rows of 16 bytes each) from shared memory;
// lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same four matrices transposed: from 8 x 8 tiles stored k-major (row
// = k, 8 contiguous columns), lane i gets the pair of k of column i / 4 that
// an mma.sync B ("col") fragment holds.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Store two neighbouring outputs (row, col) and (row, col + 1) of an
// [m, n] f32 or bf16 matrix; the ragged edges are masked.
__device__ __forceinline__ void store_out_pair(void* p, int bf16, int m, int n, int row, int col, float v0,
                                               float v1) {
  if (row >= m || col >= n) return;
  const size_t o = (size_t)row * n + col;
  const bool pair = col + 1 < n && (n & 1) == 0;  // o even: an aligned pair
  if (bf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p);
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
    } else {
      out[o] = __float2bfloat16(v0);
      if (col + 1 < n) out[o + 1] = __float2bfloat16(v1);
    }
  } else {
    float* out = static_cast<float*>(p);
    if (pair) {
      *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
    } else {
      out[o] = v0;
      if (col + 1 < n) out[o + 1] = v1;
    }
  }
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

// silu, sigmoid and tanh, in f32 as the TPU's _ACTIVATIONS (jax.nn.silu =
// x * sigmoid(x), sigmoid = 1 / (1 + exp(-x))). Not inlined: inlined into
// every kernel's epilogue, their code cost the prefill matmuls 5-15% of
// their time whatever the activation (registers and code size; measured
// on the H100, PERF.md); out of line they cost a call per output element,
// and only when selected.
__device__ __noinline__ float activate_exp(float v, int act) {
  if (act == 3) return v * (1.f / (1.f + expf(-v)));
  if (act == 4) return 1.f / (1.f + expf(-v));
  return tanhf(v);
}

// Epilogue activation by code (activations.py ACTIVATION_CODES): 1 gelu
// (erf polynomial), 2 relu, 3 silu, 4 sigmoid, 5 tanh.
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return 0.5f * v * (1.f + erf_poly(v * 0.7071067811865475f));
  if (act == 2) return fmaxf(v, 0.f);
  if (act >= 3) return activate_exp(v, act);
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
