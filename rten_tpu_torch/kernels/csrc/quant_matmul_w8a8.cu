// quant_matmul_w8a8: the prefill matmul in W8A8 mode, M > 8 rows of
// activations quantized per row to int8, against an int8 weight matrix with
// per-output-channel f32 scales, on the int8 tensor cores:
//
//     out = activation((codes @ W) * sx * scale + bias)
//
// Replaces rten_tpu/kernels/quant_matmul.py quant_matmul_w8a8 (:760; Pallas
// kernel _q8_kernel :715) and the XLA row quantization before it
// (:792-796). Two launches on one stream:
// - quantize_rows_kernel (rt_quantize_rows), one block per row: absmax by a
//   block max (exact in any order), sx = absmax / 127 by IEEE division (1
//   for an all-zero row), codes = rint(x / sx) clipped to +-127, into
//   int8 [M, K] and f32 sx [M]. On the TPU this is XLA outside the kernel;
//   a kernel here, since eager PyTorch would take ~7 launches for it.
// - qmm_s8_kernel: 64 x 128 output tiles of 256 threads, K steps of 64
//   codes. The code tile (64 x 64 bytes) and the weight tile (128 columns x
//   64 bytes, K contiguous: the port's [N, K] pack is already the `col`
//   operand of mma.sync, so no new weight layout) are staged with 16-byte
//   loads into shared memory rows of 80 bytes (ldmatrix's eight 16-byte
//   rows fall in distinct banks), two buffers, the next step's loads in
//   flight during this one's math. 8 warps as 2 x 4, each 32 x 32: per k32
//   step two ldmatrix.x4 for the codes, two for the weights, and 2 x 4
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32. The int32 sums are exact; the
//   epilogue rescales once, ((float)acc * sx[row]) * scale[col] rounded
//   after each product (the TPU's two f32 products), + bias, activation,
//   and one rounding to the output dtype. Rows past M are staged as zero
//   codes and never stored.
//
// Bound on the H100: at M 64 the weight stream (1 byte a weight, read once
// per 64-row tile of M); from a few hundred rows the int8 tensor cores
// (1979 TOPS dense). This first kernel keeps quant_matmul.cu's simple shape
// (one register stage, no wgmma, no TMA); those are later work.

#include "common.cuh"

namespace rt {
namespace {

constexpr int Q8_BM = 64, Q8_BN = 128, Q8_THREADS = 256;
constexpr int Q8_BK = 64;            // K step, in codes (bytes)
constexpr int Q8_LDS = Q8_BK + 16;   // shared-memory row stride, bytes
constexpr int QR_THREADS = 256;

__global__ void __launch_bounds__(QR_THREADS) quantize_rows_kernel(const void* x, int bf16, int k,
                                                                    int8_t* codes, float* sx) {
  __shared__ float red[QR_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * k;
  const float scale = quantize_row<QR_THREADS>([&](int v) { return load_act4(x, bf16, base + 4 * v); }, k >> 2,
                                               reinterpret_cast<unsigned*>(codes + base), red);
  if (threadIdx.x == 0) sx[blockIdx.x] = scale;
}

struct Q8Args {
  const int8_t* xq;    // [m, k] int8 codes, 16-byte aligned, k % 16 == 0
  const float* sx;     // [m] per-row scales
  int m, n, k;
  const int8_t* w;     // [n, k] int8 (int8_pack), 16-byte aligned
  const float* scale;  // [n]
  const float* bias;   // [n] or null
  int act;             // 0 none, 1 gelu (erf polynomial), 2 relu
  void* out;           // [m, n] f32 or bf16 (out_bf16)
  int out_bf16;
};

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float rescale(int acc, float sx, float s, float b, int act) {
  return activate(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), s) + b, act);
}

__global__ void __launch_bounds__(Q8_THREADS) qmm_s8_kernel(Q8Args a) {
  __shared__ __align__(16) int8_t xs[2][Q8_BM][Q8_LDS];
  __shared__ __align__(16) int8_t ws[2][Q8_BN][Q8_LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * Q8_BM, n0 = blockIdx.x * Q8_BN;

  // Staging: thread tid loads 16 codes of row xr, and 2 x 16 weights of column wr.
  const int xr = tid >> 2, xc = (tid & 3) * 16;
  const int wr = tid >> 1, wc = (tid & 1) * 32;
  const bool x_ok = m0 + xr < a.m, w_ok = n0 + wr < a.n;
  const int8_t* xp = a.xq + (size_t)(x_ok ? m0 + xr : 0) * a.k + xc;
  const int8_t* wp = a.w + (size_t)(w_ok ? n0 + wr : 0) * a.k + wc;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4 xv, wv0, wv1;
  auto load = [&](int kt) {
    const int k0 = kt * Q8_BK;  // k % 16 == 0, so a 16-byte piece is whole or past K
    xv = (x_ok && k0 + xc < a.k) ? __ldg(reinterpret_cast<const int4*>(xp + k0)) : zero;
    wv0 = (w_ok && k0 + wc < a.k) ? __ldg(reinterpret_cast<const int4*>(wp + k0)) : zero;
    wv1 = (w_ok && k0 + wc + 16 < a.k) ? __ldg(reinterpret_cast<const int4*>(wp + k0 + 16)) : zero;
  };
  auto store = [&](int buf) {
    *reinterpret_cast<int4*>(&xs[buf][xr][xc]) = xv;
    *reinterpret_cast<int4*>(&ws[buf][wr][wc]) = wv0;
    *reinterpret_cast<int4*>(&ws[buf][wr][wc + 16]) = wv1;
  };

  const int wm = warp >> 2, wn = warp & 3;  // this warp's 32 x 32: rows wm*32, cols wn*32
  const int mat = lane >> 3, r8 = lane & 7;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (a.k + Q8_BK - 1) / Q8_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < Q8_BK; kk += 32) {
      unsigned af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // A 16 x 32 bytes: matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31)
        ldmatrix_x4(af[i], &xs[buf][wm * 32 + i * 16 + r8 + (mat & 1) * 8][kk + (mat >> 1) * 16]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // B, two n8 tiles: (k 0-15, k 16-31) of columns 0-7, then 8-15
        ldmatrix_x4(bfr[j], &ws[buf][wn * 32 + j * 16 + r8 + (mat >> 1) * 8][kk + (mat & 1) * 16]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_s8(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2], bfr[j >> 1][(j & 1) * 2 + 1]);
        }
      }
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // Accumulator layout of m16n8: c0, c1 at row lane/4, columns 2*(lane%4)
  // and +1; c2, c3 eight rows below.
  const int g = lane >> 2, t4 = lane & 3;
  float sxr[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + i * 16 + h * 8 + g;
      sxr[i][h] = row < a.m ? __ldg(a.sx + row) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + t4 * 2;
    const float s0 = col < a.n ? __ldg(a.scale + col) : 0.f;
    const float s1 = col + 1 < a.n ? __ldg(a.scale + col + 1) : 0.f;
    const float b0 = (a.bias && col < a.n) ? __ldg(a.bias + col) : 0.f;
    const float b1 = (a.bias && col + 1 < a.n) ? __ldg(a.bias + col + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + h * 8 + g;
        store_out_pair(a.out, a.out_bf16, a.m, a.n, row, col,
                       rescale(acc[i][j][2 * h], sxr[i][h], s0, b0, a.act),
                       rescale(acc[i][j][2 * h + 1], sxr[i][h], s1, b1, a.act));
      }
    }
  }
}

}  // namespace
}  // namespace rt

extern "C" int rt_quantize_rows(const void* x, int x_bf16, int m, int k, int8_t* codes, float* sx,
                                void* stream) {
  if (m < 1 || k < 16 || k % 16 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(codes) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rt::quantize_rows_kernel<<<m, rt::QR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, x_bf16, k, codes, sx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_quant_matmul_w8a8(
    const int8_t* codes, const float* sx, int m, int k,
    const int8_t* w_t, const float* scales, const float* bias, int n,
    int act, void* out, int out_bf16,
    void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16 || (m + rt::Q8_BM - 1) / rt::Q8_BM > 65535 ||
      (reinterpret_cast<uintptr_t>(codes) & 15) || (reinterpret_cast<uintptr_t>(w_t) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rt::Q8Args a{codes, sx, m, n, k, w_t, scales, bias, act, out, out_bf16};
  const dim3 grid((n + rt::Q8_BN - 1) / rt::Q8_BN, (m + rt::Q8_BM - 1) / rt::Q8_BM);
  rt::qmm_s8_kernel<<<grid, rt::Q8_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
