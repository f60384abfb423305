// The GEMV device functions of decode_block.cu's four GEMV phases (wo, up,
// down, next qkv at batch 1): the engine the decode GEMV had before it was
// redesigned for Hopper (gemv.cuh), kept as it was so that decode_block's
// numbers do not change. Each phase: every block that owns columns
// normalises the row into shared memory (gemv_prologue), then its warps
// stride over output columns by the grid (gemv_body).
//
// - The weights are [N, K] with K contiguous. One warp owns CPW output
//   columns at a time; each lane reads 16 contiguous bytes of a column per
//   step (__ldg), so a warp's load of one column is 512 contiguous bytes.
// - The activation rows sit in shared memory as f32, permuted so that the
//   32 lanes' float4 reads of their 16 activations hit consecutive
//   addresses, rounded to bf16 first for a bf16 dot.
// - The dot runs on the CUDA cores: each weight byte is unpacked to f32
//   (unpack16) and multiplied into the lane's running sum, the lanes'
//   sums then added across the warp.
#pragma once

#include "common.cuh"

namespace rt {
namespace {

constexpr int GEMV_THREADS = 128;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;

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
  int act;                // activations.py ACTIVATION_CODES (common.cuh activate)
  const void* residual;   // [m, n] of the output dtype (f32 with res_f32), or null
  int res_f32;            // the residual is f32 whatever the output dtype
  void* out;              // [m, n] f32 or bf16 (out_bf16), or null
  int out_bf16;
  float* out_f32;         // [m, n] f32 copy of the output, or null
};

// Shared-memory position of natural column e of a row of k = 16 * kc
// floats: element t of float4 q of 16-byte chunk c sits at float4 q*kc + c,
// so lane c's four float4 reads of chunk c are conflict-free across lanes.
// Four consecutive columns (e % 4 == 0) stay one float4.
__device__ __forceinline__ int perm_index(int e, int kc) {
  const int c = e >> 4, q = (e >> 2) & 3, t = e & 3;
  return ((q * kc + c) << 2) | t;
}

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
// block recomputes it (a few KB from L2). COHERENT: x was written by other
// blocks of the same launch (decode_block.cu), so it is read from L2, not
// through the read-only path.
template <int MR, bool COHERENT = false>
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
        val[i] = v < nv ? load_act4<COHERENT>(a.x, a.x_bf16, (size_t)r * a.k + 4 * v) : zero;
      }
#pragma unroll
      for (int i = 0; i < PRO_BATCH; ++i) {
        const int v = v0 + i * GEMV_THREADS;
        if (v < nv) {
          row[perm_index(4 * v, kc) >> 2] = val[i];
          part[r] += norm_part4(val[i], a.norm);
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
    for (int r = 0; r < MR; ++r) norm_stats(a.norm, tot[r], kf, a.eps, mean[r], inv[r]);
    if (a.norm == 1) {  // layernorm: the variance, from the centred values
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        part[r] = 0.f;
        if (r >= a.m) continue;
        const float4* row = reinterpret_cast<const float4*>(xs + r * a.k);
        for (int v = tid; v < nv; v += GEMV_THREADS) part[r] += centred_sq4(row[perm_index(4 * v, kc) >> 2], mean[r]);
      }
      block_row_sums<MR>(part, a.m, red[1], tot);
#pragma unroll
      for (int r = 0; r < MR; ++r) inv[r] = norm_inv(tot[r], kf, a.eps);
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
          if (a.norm) x = normalize4(x, mean[r], inv[r], ns[i], nb[i]);
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

// MR: rows (m <= MR). CPW: columns per warp. Blocks stride over column
// groups by gridDim.x.
template <int MR, int CPW>
__device__ void gemv_body(const GemvArgs& a, const float* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = a.k >> 4;
  const int groups = (a.n + CPW - 1) / CPW;
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
      res[r] = (a.residual && r < a.m)
                   ? load_act(a.residual, a.res_f32 ? 0 : a.out_bf16, (size_t)r * a.n + my_col) : 0.f;
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
          if (r >= a.m) continue;
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
        if (a.out) store_act(a.out, a.out_bf16, o, v);
        if (a.out_f32) a.out_f32[o] = v;
      }
    }
  }
}

}  // namespace
}  // namespace rt
