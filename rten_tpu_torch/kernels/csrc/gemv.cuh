// Decode GEMV for M <= 8 rows against an int8 weight matrix with
// per-output-channel f32 scales, with a fused row-norm prologue and a
// scale / bias / activation / residual epilogue, or a fused greedy argmax.
//
//     out = activation((norm(x) @ W) * scale + bias) + residual
//
// Shared by the three decode kernels: quant_gemv.cu launches it once (twice
// with the argmax), quant_mlp.cu three times (up, down, next qkv) and
// decode_attention.cu once for the output projection. Everything here has
// internal linkage, so every .cu file instantiates its own copy.
//
// Replaces the TPU's rten_tpu/kernels/quant_matmul.py _gemv_kernel /
// _gemv_epilogue (and the dots of _mlp_kernel).
//
// Bound on the H100: bytes. At M = 1 each int8 weight is read once and used
// for M multiply-adds, far below the card's ~295 operations per byte, so
// the time is the weight stream over the 3.35 TB/s memory rate.
//
// Design against that bound:
// - The weights are stored transposed, [N, K] with K contiguous. One warp
//   owns CPW output columns at a time; each lane reads 16 contiguous bytes
//   of a column per step (__ldg, read-only path), so a warp's load of one
//   column is 512 contiguous bytes and every byte fetched is used.
// - The activation rows (at most 8 x K floats) sit in shared memory,
//   normalised once per block, stored permuted so that the 32 lanes' float4
//   reads of their 16 activations hit consecutive addresses (no bank
//   conflicts).
// - CPW = 4 columns per warp for wide matrices (the lm_head) keeps four
//   16-byte loads in flight per lane; narrow matrices use CPW = 1 so that
//   the grid still covers the SMs. Blocks stride over column groups, at
//   most 8 blocks per SM, so each block's prologue is amortised.
// - On the TPU the norm is computed once, on stripe 0, into scratch that
//   later grid steps read. Blocks here run in no order, so every block
//   recomputes the row statistics (K <= 3072 floats per row, cheap next to
//   its share of the weight stream).
// - The argmax cannot carry a running (max, index) across blocks: each
//   block writes one partial per row and argmax_reduce_kernel picks the
//   maximum, the lowest column index among equal maxima (the TPU rule,
//   where an earlier stripe wins a tie).
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {
namespace {

constexpr int GEMV_THREADS = 128;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int MAXM = 8;
constexpr int BLOCKS_PER_SM = 8;
constexpr float ARGMAX_MASK = -3.389e38f;  // value of masked columns (the TPU kernel's)

struct GemvArgs {
  const void* x;          // [m, k] activations, f32 or bf16 (x_bf16), 16-byte aligned
  int x_bf16;
  int m;
  const int8_t* w;        // [n, k] int8, k % 16 == 0, 16-byte aligned
  const float* scale;     // [n]
  int n, k;
  const float* bias;      // [n] or null
  const float* norm_scale;  // [k] or null
  const float* norm_bias;   // [k] or null
  int norm;               // 0 none, 1 layernorm, 2 rmsnorm
  float eps;
  int dot_bf16;           // round the normalised rows to bf16 before the dot
  int act;                // 0 none, 1 gelu (erf polynomial), 2 relu
  const void* residual;   // [m, n] of the output dtype, or null
  void* out;              // [m, n] f32 or bf16 (out_bf16), or null
  int out_bf16;
  float* out_f32;         // [m, n] f32 copy of the output, or null
  int argmax_n;           // > 0: greedy argmax over columns < argmax_n
  float* part_max;        // [m, grid] partials (argmax mode)
  int* part_idx;
  int* argmax_out;        // [m] int32 (argmax mode)
};

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

// (value, index) pair order for the argmax: larger value first, then the
// lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
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

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return 0.5f * v * (1.f + erf_poly(v * 0.7071067811865475f));
  if (act == 2) return fmaxf(v, 0.f);
  return v;
}

// Shared-memory position of natural column e of a row of k = 16 * kc
// floats: element t of float4 q of 16-byte chunk c sits at float4 q*kc + c,
// so lane c's four float4 reads of chunk c are conflict-free across lanes.
// Four consecutive columns (e % 4 == 0) stay one float4.
__device__ __forceinline__ int perm_index(int e, int kc) {
  const int c = e >> 4, q = (e >> 2) & 3, t = e & 3;
  return ((q * kc + c) << 2) | t;
}

// Four consecutive activations (i % 4 == 0) as f32, one 8- or 16-byte load.
__device__ __forceinline__ float4 load_act4(const void* p, int bf16, size_t i) {
  if (bf16) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i));
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
}

__device__ __forceinline__ float hsum4(const float4& v) { return v.x + v.y + v.z + v.w; }

// Block-wide sums of each row's per-thread partials (rows < m), into tot.
template <int MR>
__device__ __forceinline__ void block_row_sums(const float (&part)[MR], int m,
                                               float (*red)[GEMV_WARPS], float (&tot)[MR]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r < m) {
      const float v = warp_sum(part[r]);
      if (lane == 0) red[r][warp] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    tot[r] = 0.f;
    if (r < m) {
#pragma unroll
      for (int w = 0; w < GEMV_WARPS; ++w) tot[r] += red[r][w];
    }
  }
}

constexpr int PRO_BATCH = 4;  // float4 loads a thread keeps in flight in the prologue

// The dot operand rows [m, k] into shared memory (permuted, f32). Every
// thread takes part in each pass, four columns at a time, with its global
// loads batched PRO_BATCH deep: (1) load x and sum each
// row; (2) layernorm's centred sum of squares, from shared memory; (3)
// normalise with the norm's scale and bias, and round to bf16 for a bf16
// dot. On the TPU one grid step computed this once into scratch; here every
// block recomputes it (a few KB from L2).
template <int MR>
__device__ void gemv_prologue(const GemvArgs& a, float* xs) {
  __shared__ float red[2][MR][GEMV_WARPS];
  const int tid = threadIdx.x;
  const int kc = a.k >> 4, nv = a.k >> 2;  // 16-byte chunks and float4 vectors per row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float part[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    part[r] = 0.f;
    if (r >= a.m) continue;
    float4* row = reinterpret_cast<float4*>(xs + r * a.k);
    for (int v0 = tid; v0 < nv; v0 += GEMV_THREADS * PRO_BATCH) {
      float4 val[PRO_BATCH];
#pragma unroll
      for (int i = 0; i < PRO_BATCH; ++i) {
        const int v = v0 + i * GEMV_THREADS;
        val[i] = v < nv ? load_act4(a.x, a.x_bf16, (size_t)r * a.k + 4 * v) : zero;
      }
#pragma unroll
      for (int i = 0; i < PRO_BATCH; ++i) {
        const int v = v0 + i * GEMV_THREADS;
        if (v < nv) {
          row[perm_index(4 * v, kc) >> 2] = val[i];
          const float4 sq = make_float4(val[i].x * val[i].x, val[i].y * val[i].y,
                                        val[i].z * val[i].z, val[i].w * val[i].w);
          part[r] += a.norm == 2 ? hsum4(sq) : hsum4(val[i]);
        }
      }
    }
  }
  float mean[MR], inv[MR];
  if (a.norm) {
    const float kf = (float)a.k;
    float tot[MR];
    block_row_sums<MR>(part, a.m, red[0], tot);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      mean[r] = a.norm == 1 ? tot[r] / kf : 0.f;
      inv[r] = rsqrtf(tot[r] / kf + a.eps);  // rmsnorm: from the mean square
    }
    if (a.norm == 1) {  // layernorm: the variance, from the centred values
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        part[r] = 0.f;
        if (r >= a.m) continue;
        const float4* row = reinterpret_cast<const float4*>(xs + r * a.k);
        for (int v = tid; v < nv; v += GEMV_THREADS) {
          const float4 x = row[perm_index(4 * v, kc) >> 2];
          const float dx = x.x - mean[r], dy = x.y - mean[r], dz = x.z - mean[r], dw = x.w - mean[r];
          part[r] += dx * dx + dy * dy + dz * dz + dw * dw;
        }
      }
      block_row_sums<MR>(part, a.m, red[1], tot);
#pragma unroll
      for (int r = 0; r < MR; ++r) inv[r] = rsqrtf(tot[r] / kf + a.eps);
    }
  }
  if (a.norm || a.dot_bf16) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= a.m) continue;
      float4* row = reinterpret_cast<float4*>(xs + r * a.k);
      for (int v0 = tid; v0 < nv; v0 += GEMV_THREADS * PRO_BATCH) {
        float4 ns[PRO_BATCH], nb[PRO_BATCH];
        if (a.norm) {
#pragma unroll
          for (int i = 0; i < PRO_BATCH; ++i) {
            const int v = v0 + i * GEMV_THREADS;
            ns[i] = v < nv ? __ldg(reinterpret_cast<const float4*>(a.norm_scale) + v) : zero;
            nb[i] = v < nv && a.norm_bias ? __ldg(reinterpret_cast<const float4*>(a.norm_bias) + v)
                                           : zero;
          }
        }
#pragma unroll
        for (int i = 0; i < PRO_BATCH; ++i) {
          const int v = v0 + i * GEMV_THREADS;
          if (v >= nv) break;
          float4 x = row[perm_index(4 * v, kc) >> 2];
          if (a.norm) {
            x.x = (x.x - mean[r]) * inv[r] * ns[i].x + nb[i].x;
            x.y = (x.y - mean[r]) * inv[r] * ns[i].y + nb[i].y;
            x.z = (x.z - mean[r]) * inv[r] * ns[i].z + nb[i].z;
            x.w = (x.w - mean[r]) * inv[r] * ns[i].w + nb[i].w;
          }
          if (a.dot_bf16) {
            x = make_float4(round_bf16(x.x), round_bf16(x.y), round_bf16(x.z), round_bf16(x.w));
          }
          row[perm_index(4 * v, kc) >> 2] = x;
        }
      }
    }
  }
  __syncthreads();
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

// MR: rows the kernel is compiled for (m <= MR; 1 on the batch-1 decode
// path, so the unrolled row loops stay short). CPW: columns per warp.
template <int MR, int CPW>
__device__ void gemv_body(const GemvArgs& a, const float* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = a.k >> 4;
  const int groups = (a.n + CPW - 1) / CPW;
  float best[MR];
  int best_i[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    best[r] = -INFINITY;
    best_i[r] = INT_MAX;
  }
  for (int g = blockIdx.x * GEMV_WARPS + warp; g < groups; g += gridDim.x * GEMV_WARPS) {
    const int n0 = g * CPW;
    const int4* wrow[CPW];
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      // A column past n reads column n-1 again; its sums are discarded.
      wrow[j] = reinterpret_cast<const int4*>(a.w + (size_t)min(n0 + j, a.n - 1) * a.k);
    }
    // Lane j's epilogue operands for column n0 + j, loaded with the weights
    // rather than after the reduction (one dependent round trip fewer).
    const int my_col = min(n0 + (lane < CPW ? lane : 0), a.n - 1);
    const float sc = __ldg(a.scale + my_col);
    const float bb = a.bias ? __ldg(a.bias + my_col) : 0.f;
    float res[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      res[r] = (a.residual && r < a.m) ? load_act(a.residual, a.out_bf16, (size_t)r * a.n + my_col) : 0.f;
    }
    float acc[CPW][MR];
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
#pragma unroll
      for (int r = 0; r < MR; ++r) acc[j][r] = 0.f;
    }
    // U chunks per lane in flight: all loads of a step issue before its math.
    constexpr int U = CPW == 1 ? 4 : 2;
    for (int c0 = lane; c0 < kc; c0 += 32 * U) {
      int4 wv[U][CPW];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + 32 * u;
#pragma unroll
        for (int j = 0; j < CPW; ++j) wv[u][j] = c < kc ? __ldg(wrow[j] + c) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + 32 * u;
        if (c >= kc) break;
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r < a.m) {
            const float4* xr = reinterpret_cast<const float4*>(xs + r * a.k);
            const float4 x0 = xr[c], x1 = xr[kc + c], x2 = xr[2 * kc + c], x3 = xr[3 * kc + c];
            const float xv[16] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w,
                                  x2.x, x2.y, x2.z, x2.w, x3.x, x3.y, x3.z, x3.w};
#pragma unroll
            for (int j = 0; j < CPW; ++j) {
              float wf[16];
              unpack16(wv[u][j], wf);
              float sum = acc[j][r];
#pragma unroll
              for (int e = 0; e < 16; ++e) sum += wf[e] * xv[e];
              acc[j][r] = sum;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < a.m) acc[j][r] = warp_sum(acc[j][r]);
      }
    }
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const int col = n0 + j;
      if (lane != j || col >= a.n) continue;
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= a.m) continue;
        float v = acc[j][r] * sc;
        if (a.bias) v = v + bb;
        v = activate(v, a.act);
        const size_t o = (size_t)r * a.n + col;
        if (a.residual) v = v + res[r];
        if (a.argmax_n > 0) {
          if (col >= a.argmax_n) v = ARGMAX_MASK;
          if (better(v, col, best[r], best_i[r])) {
            best[r] = v;
            best_i[r] = col;
          }
        } else {
          if (a.out) store_act(a.out, a.out_bf16, o, v);
          if (a.out_f32) a.out_f32[o] = v;
        }
      }
    }
  }
  if (a.argmax_n > 0) {
    __shared__ float s_best[GEMV_WARPS][MR];
    __shared__ int s_idx[GEMV_WARPS][MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      float v = best[r];
      int i = best_i[r];
      warp_argmax(v, i);
      if (lane == 0) {
        s_best[warp][r] = v;
        s_idx[warp][r] = i;
      }
    }
    __syncthreads();
    if (threadIdx.x < a.m) {
      const int r = threadIdx.x;
      float v = s_best[0][r];
      int i = s_idx[0][r];
      for (int w = 1; w < GEMV_WARPS; ++w) {
        if (better(s_best[w][r], s_idx[w][r], v, i)) {
          v = s_best[w][r];
          i = s_idx[w][r];
        }
      }
      a.part_max[(size_t)r * gridDim.x + blockIdx.x] = v;
      a.part_idx[(size_t)r * gridDim.x + blockIdx.x] = i;
    }
  }
}

template <int MR, int CPW>
__global__ void __launch_bounds__(GEMV_THREADS) gemv_kernel(GemvArgs a) {
  extern __shared__ float4 gemv_smem[];
  float* xs = reinterpret_cast<float*>(gemv_smem);
  gemv_prologue<MR>(a, xs);
  gemv_body<MR, CPW>(a, xs);
}

// Second pass of the argmax: one block per row over the per-block partials.
__global__ void __launch_bounds__(256) argmax_reduce_kernel(
    const float* part_max, const int* part_idx, int n_parts, int* out) {
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = -INFINITY;
  int i = INT_MAX;
  for (int p = tid; p < n_parts; p += blockDim.x) {
    const float pv = part_max[(size_t)r * n_parts + p];
    const int pi = part_idx[(size_t)r * n_parts + p];
    if (better(pv, pi, v, i)) {
      v = pv;
      i = pi;
    }
  }
  warp_argmax(v, i);
  __shared__ float s_v[8];
  __shared__ int s_i[8];
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      if (better(s_v[w], s_i[w], v, i)) {
        v = s_v[w];
        i = s_i[w];
      }
    }
    out[r] = i;
  }
}

// Most blocks a GEMV launch uses: BLOCKS_PER_SM per SM of the current device.
int max_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return BLOCKS_PER_SM * 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0) {
      sms = 132;
    }
    cached[dev] = BLOCKS_PER_SM * sms;
  }
  return cached[dev];
}

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use on sm_90

template <int MR, int CPW>
cudaError_t launch_gemv_t(const GemvArgs& a, int grid, size_t smem, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<MR, CPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (e != cudaSuccess) return e;
    smem_set = MAX_SMEM;
  }
  gemv_kernel<MR, CPW><<<grid, GEMV_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MR>
cudaError_t launch_gemv_rows(const GemvArgs& a, int cpw, int grid, size_t smem, cudaStream_t stream) {
  return cpw == 4 ? launch_gemv_t<MR, 4>(a, grid, smem, stream)
                  : launch_gemv_t<MR, 1>(a, grid, smem, stream);
}

cudaError_t launch_gemv(const GemvArgs& a, cudaStream_t stream) {
  if (a.m < 1 || a.m > MAXM || a.k % 16 || a.n < 1 ||
      (reinterpret_cast<uintptr_t>(a.w) & 15) || (reinterpret_cast<uintptr_t>(a.x) & 15) ||
      (a.norm && (reinterpret_cast<uintptr_t>(a.norm_scale) & 15)) ||
      (a.norm_bias && (reinterpret_cast<uintptr_t>(a.norm_bias) & 15))) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)a.m * a.k * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int cpw = a.n >= 8192 ? 4 : 1;
  const int groups = (a.n + cpw - 1) / cpw;
  int grid = (groups + GEMV_WARPS - 1) / GEMV_WARPS;
  grid = grid < max_blocks() ? grid : max_blocks();
  cudaError_t e;
  if (a.m == 1) {
    e = launch_gemv_rows<1>(a, cpw, grid, smem, stream);
  } else if (a.m == 2) {
    e = launch_gemv_rows<2>(a, cpw, grid, smem, stream);
  } else if (a.m <= 4) {
    e = launch_gemv_rows<4>(a, cpw, grid, smem, stream);
  } else {
    e = launch_gemv_rows<8>(a, cpw, grid, smem, stream);
  }
  if (e != cudaSuccess || a.argmax_n <= 0) return e;
  argmax_reduce_kernel<<<a.m, 256, 0, stream>>>(a.part_max, a.part_idx, grid, a.argmax_out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt
