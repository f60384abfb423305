// matmul_fused: a dense matmul with the bias and the activation applied
// once, in the epilogue, after the whole K sum:
//
//     out = activation(x @ w + bias)
//
// x [M, K] and w [K, N] both bf16 or both f32 (row-major), bias [N] f32,
// any M, N, K; out [M, N] bf16 or f32.
//
// Replaces rten_tpu/kernels/matmul_pallas.py matmul_fused (:102; Pallas
// kernel _matmul_kernel :58), which pads every operand to its 512-blocks and
// carries an f32 accumulator across the sequential K grid axis.
//
// Bound on the H100: operations for the large products it exists for (2 M N
// K flops against 2 (M K + K N) bytes: ~300 bf16 operations per byte from M
// = N = K ~ 900), bytes below that.
//
// Design, on tile_mma.cuh's 64 x 128 tile of 256 threads (the prefill
// int8 matmul's loops):
// - bf16: bf16_tile_loop on the tensor cores (mma.sync.m16n8k16, f32
//   accumulation), two buffers. w is stored [K, N], N contiguous, so its
//   tile is staged k-major ([32 k][128 columns]) and read with
//   ldmatrix.trans: no transposed copy of the weights.
// - f32: f32_tile_loop, f32 fmaf on the CUDA cores. Not TF32, whose 10-bit
//   mantissa would move results ~1e-3 from the f32 reference.
// - The edges are masked, not padded: a thread stages 16 bytes of a row at
//   once where the rows allow it (the row width a multiple of 16 bytes, the
//   base 16-byte aligned: vec_x / vec_w), element by element otherwise, and
//   zeros past M, N and K; the epilogue stores only rows < M, columns < N.
// - Epilogue from the registers: acc + bias, activation (common.cuh
//   activate), one rounding to the output dtype.

#include "tile_mma.cuh"

namespace rt {
namespace {

struct MfArgs {
  const void* x;      // [m, k] f32 or bf16
  const void* w;      // [k, n], the dtype of x
  const float* bias;  // [n] or null
  int m, n, k;
  int act;            // activations.py ACTIVATION_CODES
  void* out;          // [m, n] f32 or bf16 (out_bf16)
  int out_bf16;
  int vec_x, vec_w;   // rows of x / w may be read as aligned 16-byte pieces
};

// Eight bf16 of row `row` from column c (as one int4), zeros past the row's
// `cols` or where the row is past `rows`.
__device__ __forceinline__ int4 load8_bf16(const __nv_bfloat16* p, int row, int rows, int c, int cols,
                                           size_t ld, bool vec) {
  if (row >= rows || c >= cols) return make_int4(0, 0, 0, 0);
  const __nv_bfloat16* src = p + (size_t)row * ld + c;
  if (vec) return __ldg(reinterpret_cast<const int4*>(src));  // whole: cols % 8 == 0
  unsigned h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = c + e < cols ? __ldg(reinterpret_cast<const unsigned short*>(src) + e) : 0u;
  const uint4 v = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  return *reinterpret_cast<const int4*>(&v);
}

// Four f32 of row `row` from column c, as load8_bf16.
__device__ __forceinline__ float4 load4_f32(const float* p, int row, int rows, int c, int cols, size_t ld,
                                            bool vec) {
  if (row >= rows || c >= cols) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = p + (size_t)row * ld + c;
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));  // whole: cols % 4 == 0
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = c + e < cols ? __ldg(src + e) : 0.f;
  return make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ float bias_at(const MfArgs& a, int col) {
  return (a.bias && col < a.n) ? __ldg(a.bias + col) : 0.f;
}

__global__ void __launch_bounds__(TILE_THREADS) mf_bf16_kernel(MfArgs a) {
  __shared__ __align__(16) Bf16Tiles<true> s;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TILE_BM, n0 = blockIdx.x * TILE_BN;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  // Staging: thread tid loads 8 bf16 of x row xr, and 8 bf16 of w rows wr
  // and wr + 16 (32 k x 128 columns: 16 pieces of 8 a row).
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 4, wc = (tid & 15) * 8;
  int4 xv, wv0, wv1;
  auto load = [&](int kt) {
    const int k0 = kt * TILE_BK;
    xv = load8_bf16(x, m0 + xr, a.m, k0 + xc, a.k, a.k, a.vec_x);
    wv0 = load8_bf16(w, k0 + wr, a.k, n0 + wc, a.n, a.n, a.vec_w);
    wv1 = load8_bf16(w, k0 + wr + 16, a.k, n0 + wc, a.n, a.n, a.vec_w);
  };
  auto store = [&](int buf) {
    *reinterpret_cast<int4*>(&s.a[buf][xr][xc]) = xv;
    *reinterpret_cast<int4*>(&s.b[buf][wr][wc]) = wv0;
    *reinterpret_cast<int4*>(&s.b[buf][wr + 16][wc]) = wv1;
  };
  float acc[2][4][4];
  bf16_tile_loop<true>((a.k + TILE_BK - 1) / TILE_BK, load, store, s, acc);

  float b0, b1;
  bf16_tile_epilogue(
      acc, m0, n0,
      [&](int col) {
        b0 = bias_at(a, col);
        b1 = bias_at(a, col + 1);
      },
      [&](int row, int col, float v0, float v1) {
        store_out_pair(a.out, a.out_bf16, a.m, a.n, row, col, activate(v0 + b0, a.act), activate(v1 + b1, a.act));
      });
}

__global__ void __launch_bounds__(TILE_THREADS) mf_f32_kernel(MfArgs a) {
  __shared__ __align__(16) F32Tiles s;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * TILE_BM, n0 = blockIdx.x * TILE_BN;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  auto stage = [&](int k0) {
    {  // x: 64 rows x 16 k, four k of one row a thread, stored transposed
      const int r = tid >> 2, kq = (tid & 3) * 4;
      const float4 v = load4_f32(x, m0 + r, a.m, k0 + kq, a.k, a.k, a.vec_x);
      s.a[kq][r] = v.x;
      s.a[kq + 1][r] = v.y;
      s.a[kq + 2][r] = v.z;
      s.a[kq + 3][r] = v.w;
    }
#pragma unroll
    for (int i = 0; i < SIMT_BK * TILE_BN / 4 / TILE_THREADS; ++i) {  // w: 16 k x 128 columns
      const int p = tid + i * TILE_THREADS, kr = p >> 5, nc = (p & 31) * 4;
      *reinterpret_cast<float4*>(&s.b[kr][nc]) = load4_f32(w, k0 + kr, a.k, n0 + nc, a.n, a.n, a.vec_w);
    }
  };
  float acc[4][8];
  f32_tile_loop(a.k, stage, s, acc);

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= a.n) continue;
    const float b = bias_at(a, col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < a.m) store_act(a.out, a.out_bf16, (size_t)row * a.n + col, activate(acc[i][j] + b, a.act));
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
}  // namespace rt

extern "C" int rt_matmul_fused(
    const void* x, const void* w, const float* bias, int bf16, int m, int n, int k,
    int act, void* out, int out_bf16,
    void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + rt::TILE_BM - 1) / rt::TILE_BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per16 = bf16 ? 8 : 4;  // elements in 16 bytes
  rt::MfArgs a{x, w, bias, m, n, k, act, out, out_bf16,
               k % per16 == 0 && rt::aligned16(x), n % per16 == 0 && rt::aligned16(w)};
  const dim3 grid((n + rt::TILE_BN - 1) / rt::TILE_BN, (m + rt::TILE_BM - 1) / rt::TILE_BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    rt::mf_bf16_kernel<<<grid, rt::TILE_THREADS, 0, st>>>(a);
  } else {
    rt::mf_f32_kernel<<<grid, rt::TILE_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
