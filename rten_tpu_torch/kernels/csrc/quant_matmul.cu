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
// specialisation are later work):
// - One block of 256 threads per 64 x 128 output tile; a loop over K inside
//   the block takes the place of the TPU's sequential K grid axis, and the
//   f32 accumulators stay in registers across it.
// - bf16 activations: per K step of 32, the x tile (64 x 32 bf16) and the
//   int8 W tile (128 columns x 32, K contiguous: the K-major B operand of
//   mma.sync, so the port's [N, K] pack needs no new layout) are staged into
//   shared memory with one 16-byte load per thread each. The int8 weights
//   become bf16 while they are staged (exact for every int8, as the TPU
//   kernel's int8 -> f32 -> bf16 convert). Rows are padded to 40 elements
//   (80 bytes) so that ldmatrix's eight 16-byte rows fall in distinct banks.
//   Two buffers: the next step's global loads are in flight while the
//   tensor cores work on this one.
// - 8 warps as 2 x 4, each owning 32 x 32 of the tile: per k16 step two
//   ldmatrix.x4 for A, two for B, and 2 x 4 mma.sync.m16n8k16 (bf16 in, f32
//   accumulate): 32 f32 accumulators per thread.
// - f32 activations: an f32 SIMT kernel with the same tiling (exact f32
//   products; the int8 weights convert exactly), each thread 4 x 8 outputs.
// - The epilogue reads the accumulators from registers: acc * scale, + bias,
//   activation, rounded once to the output dtype; the ragged M and N edges
//   are masked (rows past M are staged as zeros and never stored).

#include "common.cuh"

namespace rt {
namespace {

constexpr int QM_BM = 64, QM_BN = 128, QM_THREADS = 256;
constexpr int QM_BK = 32;          // K step of the bf16 kernel
constexpr int QM_LDS = QM_BK + 8;  // its shared-memory row stride, in bf16
constexpr int QF_BK = 16;          // K step of the f32 kernel

struct QmArgs {
  const void* x;       // [m, k] f32 or bf16, 16-byte aligned, k % 16 == 0
  int m, n, k;
  const int8_t* w;     // [n, k] int8 (int8_pack), 16-byte aligned
  const float* scale;  // [n]
  const float* bias;   // [n] or null
  int act;             // 0 none, 1 gelu (erf polynomial), 2 relu
  void* out;           // [m, n] f32 or bf16 (out_bf16)
  int out_bf16;
};

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The epilogue for two neighbouring columns (col, col + 1) of one row.
__device__ __forceinline__ void store_pair(const QmArgs& a, int row, int col, float v0, float v1,
                                           float s0, float s1, float b0, float b1) {
  if (row >= a.m || col >= a.n) return;
  store_out_pair(a.out, a.out_bf16, a.m, a.n, row, col, activate(v0 * s0 + b0, a.act),
                 activate(v1 * s1 + b1, a.act));
}

__device__ __forceinline__ void col_params(const QmArgs& a, int col, float& s, float& b) {
  s = col < a.n ? __ldg(a.scale + col) : 0.f;
  b = (a.bias && col < a.n) ? __ldg(a.bias + col) : 0.f;
}

__global__ void __launch_bounds__(QM_THREADS) qmm_bf16_kernel(QmArgs a) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][QM_BM][QM_LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[2][QM_BN][QM_LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * QM_BM, n0 = blockIdx.x * QM_BN;

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
    const int k0 = kt * QM_BK;  // k % 16 == 0, so a 16-byte piece is whole or past K
    xv = (x_ok && k0 + xc < a.k) ? __ldg(reinterpret_cast<const int4*>(xp + k0)) : zero;
    wv = (w_ok && k0 + wc < a.k) ? __ldg(reinterpret_cast<const int4*>(wp + k0)) : zero;
  };
  auto store = [&](int buf) {
    *reinterpret_cast<int4*>(&xs[buf][xr][xc]) = xv;
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
    *reinterpret_cast<uint4*>(&ws[buf][wr][wc]) = lo;
    *reinterpret_cast<uint4*>(&ws[buf][wr][wc + 8]) = hi;
  };

  const int wm = warp >> 2, wn = warp & 3;  // this warp's 32 x 32: rows wm*32, cols wn*32
  const int mat = lane >> 3, r8 = lane & 7;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (a.k + QM_BK - 1) / QM_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < QM_BK; kk += 16) {
      unsigned af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // A 16 x 16: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
        ldmatrix_x4(af[i], &xs[buf][wm * 32 + i * 16 + r8 + (mat & 1) * 8][kk + (mat >> 1) * 8]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // B, two n8 tiles: (k 0-7, k 8-15) of columns 0-7, then 8-15
        ldmatrix_x4(bfr[j], &ws[buf][wn * 32 + j * 16 + r8 + (mat >> 1) * 8][kk + (mat & 1) * 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2], bfr[j >> 1][(j & 1) * 2 + 1]);
        }
      }
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // Accumulator layout of m16n8: c0, c1 at row lane/4, columns 2*(lane%4)
  // and +1; c2, c3 eight rows below.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + t4 * 2;
    float s0, s1, b0, b1;
    col_params(a, col, s0, b0);
    col_params(a, col + 1, s1, b1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + wm * 32 + i * 16 + g;
      store_pair(a, row, col, acc[i][j][0], acc[i][j][1], s0, s1, b0, b1);
      store_pair(a, row + 8, col, acc[i][j][2], acc[i][j][3], s0, s1, b0, b1);
    }
  }
}

__global__ void __launch_bounds__(QM_THREADS) qmm_f32_kernel(QmArgs a) {
  __shared__ __align__(16) float xs[QF_BK][QM_BM + 4];  // x tile, transposed: [k][row]
  __shared__ __align__(16) float ws[QF_BK][QM_BN];      // W tile, transposed: [k][column]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * QM_BM, n0 = blockIdx.x * QM_BN;
  const float* x = static_cast<const float*>(a.x);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.k; k0 += QF_BK) {  // k % 16 == 0: every step is whole
    {
      const int r = tid >> 2, kq = (tid & 3) * 4;
      const float4 v = m0 + r < a.m
                           ? __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * a.k + k0 + kq))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      xs[kq][r] = v.x;
      xs[kq + 1][r] = v.y;
      xs[kq + 2][r] = v.z;
      xs[kq + 3][r] = v.w;
    }
    if (tid < QM_BN) {
      const int4 wv = n0 + tid < a.n
                          ? __ldg(reinterpret_cast<const int4*>(a.w + (size_t)(n0 + tid) * a.k + k0))
                          : make_int4(0, 0, 0, 0);
      float f[16];
      unpack16(wv, f);
#pragma unroll
      for (int e = 0; e < 16; ++e) ws[e][tid] = f[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QF_BK; ++kk) {
      float xv[4], wv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= a.n) continue;
    float s, b;
    col_params(a, col, s, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < a.m) store_act(a.out, a.out_bf16, (size_t)row * a.n + col, activate(acc[i][j] * s + b, a.act));
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
  if (m < 1 || n < 1 || k < 16 || k % 16 || (m + rt::QM_BM - 1) / rt::QM_BM > 65535 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(w_t) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rt::QmArgs a{x, m, n, k, w_t, scales, bias, act, out, out_bf16};
  const dim3 grid((n + rt::QM_BN - 1) / rt::QM_BN, (m + rt::QM_BM - 1) / rt::QM_BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    rt::qmm_bf16_kernel<<<grid, rt::QM_THREADS, 0, st>>>(a);
  } else {
    rt::qmm_f32_kernel<<<grid, rt::QM_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
