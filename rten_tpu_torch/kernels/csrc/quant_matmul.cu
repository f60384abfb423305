// quant_matmul_int8: the prefill matmul, M > 8 rows of activations against
// an int8 weight matrix with per-output-channel f32 scales, and the scale /
// bias / activation epilogue applied once, after the whole K sum:
//
//     out = activation((x @ W) * scale + bias)
//
// Replaces rten_tpu/kernels/quant_matmul.py quant_matmul_int8 (:590; Pallas
// kernel _q_kernel :556, epilogue _q_epilogue :532). On the prefill path it
// computes every layer's qkv, wo, up (+ GELU) and down projection, and the
// lm_head when all logits are asked for.
//
// Bound on the H100: the weights alone carry 2 * M operations per byte, so
// from M ~ 150 rows on (more for a narrow N, where the activations' bytes
// weigh too) the products outrun the ~295 bf16 operations per byte that
// memory can feed, and the tensor cores bound it; at M = 64 the weight
// stream (1 byte per weight) does.
//
// Design (a simple tensor-core kernel first; wgmma, TMA and warp
// specialisation are later work), on tile_mma.cuh's 64 x 128 tile:
// - One block of 256 threads per 64 x 128 output tile; a loop over K inside
//   the block takes the place of the TPU's sequential K grid axis, and the
//   f32 accumulators stay in registers across it.
// - bf16 activations: per K step of 32, the x tile (64 x 32 bf16) and the
//   int8 W tile (128 columns x 32, K contiguous: the K-major B operand of
//   mma.sync, so the port's [N, K] pack needs no new layout) are staged into
//   shared memory with one 16-byte load per thread each. The int8 weights
//   become bf16 while they are staged (exact for every int8, as the TPU
//   kernel's int8 -> f32 -> bf16 convert). bf16_tile_loop runs the two
//   buffers and the mma.sync.m16n8k16 steps.
// - f32 activations: f32_tile_loop (exact f32 products; the int8 weights
//   convert exactly), each thread 4 x 8 outputs.
// - The epilogue reads the accumulators from registers: acc * scale, + bias,
//   activation, rounded once to the output dtype; the ragged M and N edges
//   are masked (rows past M are staged as zeros and never stored).

#include "tile_mma.cuh"

namespace rt {
namespace {

struct QmArgs {
  const void* x;       // [m, k] f32 or bf16, 16-byte aligned, k % 16 == 0
  int m, n, k;
  const int8_t* w;     // [n, k] int8 (int8_pack), 16-byte aligned
  const float* scale;  // [n]
  const float* bias;   // [n] or null
  int act;             // activations.py ACTIVATION_CODES (common.cuh activate)
  void* out;           // [m, n] f32 or bf16 (out_bf16)
  int out_bf16;
};

__device__ __forceinline__ void col_params(const QmArgs& a, int col, float& s, float& b) {
  s = col < a.n ? __ldg(a.scale + col) : 0.f;
  b = (a.bias && col < a.n) ? __ldg(a.bias + col) : 0.f;
}

__global__ void __launch_bounds__(TILE_THREADS) qmm_bf16_kernel(QmArgs a) {
  __shared__ __align__(16) Bf16Tiles<false> s;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TILE_BM, n0 = blockIdx.x * TILE_BN;

  // Staging: thread tid loads 8 bf16 of x row xr and 16 int8 of W column wr.
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 1, wc = (tid & 1) * 16;
  const bool x_ok = m0 + xr < a.m, w_ok = n0 + wr < a.n;
  const __nv_bfloat16* xp =
      static_cast<const __nv_bfloat16*>(a.x) + (size_t)(x_ok ? m0 + xr : 0) * a.k + xc;
  const int8_t* wp = a.w + (size_t)(w_ok ? n0 + wr : 0) * a.k + wc;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4 xv, wv;
  auto load = [&](int kt) {
    const int k0 = kt * TILE_BK;  // k % 16 == 0, so a 16-byte piece is whole or past K
    xv = (x_ok && k0 + xc < a.k) ? __ldg(reinterpret_cast<const int4*>(xp + k0)) : zero;
    wv = (w_ok && k0 + wc < a.k) ? __ldg(reinterpret_cast<const int4*>(wp + k0)) : zero;
  };
  auto store = [&](int buf) {
    *reinterpret_cast<int4*>(&s.a[buf][xr][xc]) = xv;
    float f[16];
    unpack16(wv, f);
    uint4 lo, hi;
    lo.x = pack_bf16x2(f[0], f[1]);
    lo.y = pack_bf16x2(f[2], f[3]);
    lo.z = pack_bf16x2(f[4], f[5]);
    lo.w = pack_bf16x2(f[6], f[7]);
    hi.x = pack_bf16x2(f[8], f[9]);
    hi.y = pack_bf16x2(f[10], f[11]);
    hi.z = pack_bf16x2(f[12], f[13]);
    hi.w = pack_bf16x2(f[14], f[15]);
    *reinterpret_cast<uint4*>(&s.b[buf][wr][wc]) = lo;
    *reinterpret_cast<uint4*>(&s.b[buf][wr][wc + 8]) = hi;
  };
  float acc[2][4][4];
  bf16_tile_loop<false>((a.k + TILE_BK - 1) / TILE_BK, load, store, s, acc);

  float s0, s1, b0, b1;
  bf16_tile_epilogue(
      acc, m0, n0,
      [&](int col) {
        col_params(a, col, s0, b0);
        col_params(a, col + 1, s1, b1);
      },
      [&](int row, int col, float v0, float v1) {
        if (row >= a.m || col >= a.n) return;
        store_out_pair(a.out, a.out_bf16, a.m, a.n, row, col, activate(v0 * s0 + b0, a.act),
                       activate(v1 * s1 + b1, a.act));
      });
}

__global__ void __launch_bounds__(TILE_THREADS) qmm_f32_kernel(QmArgs a) {
  __shared__ __align__(16) F32Tiles s;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * TILE_BM, n0 = blockIdx.x * TILE_BN;
  const float* x = static_cast<const float*>(a.x);
  auto stage = [&](int k0) {  // k % 16 == 0: every step is whole
    {
      const int r = tid >> 2, kq = (tid & 3) * 4;
      const float4 v = m0 + r < a.m
                           ? __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * a.k + k0 + kq))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      s.a[kq][r] = v.x;
      s.a[kq + 1][r] = v.y;
      s.a[kq + 2][r] = v.z;
      s.a[kq + 3][r] = v.w;
    }
    if (tid < TILE_BN) {
      const int4 wv = n0 + tid < a.n
                          ? __ldg(reinterpret_cast<const int4*>(a.w + (size_t)(n0 + tid) * a.k + k0))
                          : make_int4(0, 0, 0, 0);
      float f[16];
      unpack16(wv, f);
#pragma unroll
      for (int e = 0; e < 16; ++e) s.b[e][tid] = f[e];
    }
  };
  float acc[4][8];
  f32_tile_loop(a.k, stage, s, acc);

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= a.n) continue;
    float sc, b;
    col_params(a, col, sc, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < a.m) store_act(a.out, a.out_bf16, (size_t)row * a.n + col, activate(acc[i][j] * sc + b, a.act));
    }
  }
}

}  // namespace
}  // namespace rt

extern "C" int rt_quant_matmul(
    const void* x, int x_bf16, int m, int k,
    const int8_t* w_t, const float* scales, const float* bias, int n,
    int act, void* out, int out_bf16,
    void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16 || (m + rt::TILE_BM - 1) / rt::TILE_BM > 65535 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(w_t) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rt::QmArgs a{x, m, n, k, w_t, scales, bias, act, out, out_bf16};
  const dim3 grid((n + rt::TILE_BN - 1) / rt::TILE_BN, (m + rt::TILE_BM - 1) / rt::TILE_BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    rt::qmm_bf16_kernel<<<grid, rt::TILE_THREADS, 0, st>>>(a);
  } else {
    rt::qmm_f32_kernel<<<grid, rt::TILE_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
