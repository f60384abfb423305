// The 64 x 128 output tile of 256 threads of matmul_fused.cu's ragged route
// (dense bf16 rows TMA cannot address; the bf16 loop). The kernel stages
// its own operands into shared memory; the K loop, the tensor-core step and
// the order of the epilogue are here. The mma_bf16 step, pack_bf16x2 and
// the exact three-way split of an f32 value into bf16 parts (split3, and
// the six-product step on split operands, mma_split6) serve
// flash_attention.cu and quant_matmul.cu too.
//
// - bf16 (tensor cores): per K step of 32, the A tile (64 rows x 32, k
//   contiguous) and the B tile are staged as bf16 into two buffers, the
//   next step's global loads in flight while the tensor cores work on this
//   one. B is stored either n-major ([128 columns][32 k], k contiguous: the
//   int8 pack's [N, K] layout, read with ldmatrix) or k-major ([32 k][128
//   columns]: a dense [K, N] matrix, read with ldmatrix.trans). Rows are
//   padded by 16 bytes so that ldmatrix's eight 16-byte rows fall in
//   distinct banks. 8 warps as 2 x 4, each owning 32 x 32: per k16 step two
//   ldmatrix.x4 for A, two for B, and 2 x 4 mma.sync.m16n8k16 (bf16 in, f32
//   accumulate): 32 f32 accumulators per thread.
#pragma once

#include "common.cuh"

namespace rt {
namespace {

constexpr int TILE_BM = 64, TILE_BN = 128, TILE_THREADS = 256;
constexpr int TILE_BK = 32;              // K step of the bf16 loop
constexpr int TILE_LDS = TILE_BK + 8;    // [row][k] stride of a bf16 tile, in bf16
constexpr int TILE_LDN = TILE_BN + 8;    // [k][column] stride of a k-major bf16 B tile

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

// Bits of x cut to bf16's 8 significant bits (x's upper half).
__device__ __forceinline__ float cut_bf16(float x) { return __uint_as_float(__float_as_uint(x) & 0xffff0000u); }

// x = hi + mid + lo, each a bf16 value, exactly where |x| >= 2^-110: hi is
// x cut to bf16's 8 significant bits, mid the remainder x - hi (exact) cut
// the same way, lo what is left (exact: at most 8 significant bits remain).
// Truncation rather than rounding: no value near f32's maximum overflows,
// and a part costs two instructions. So |mid| < 2^-7 |x| and |lo| < 2^-15
// |x|. Where |x| is under 2^-110, lo (under 2^-125; below 2^-118, mid)
// falls below bf16's normal range and is rounded to its subnormal grid by
// the conversion, or flushed by the tensor cores: an error in the part
// under 2^-126, whatever the value's size. An infinite
// x gives hi = x and mid = lo = 0, so its products are IEEE's; NaN stays
// NaN. The f32 routes of quant_matmul.cu and flash_attention.cu use it.
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  const bool fin = fabsf(x) <= 3.4028234663852886e38f;
  hi = fin ? cut_bf16(x) : x;
  const float r = fin ? x - hi : 0.f;  // exact: hi holds x's leading bits
  mid = cut_bf16(r);
  lo = r - mid;  // exact, at most 8 significant bits
}

// Two f32 values as three bf16 pairs (hi, mid, lo; x0 in the low half), the
// pairs' sums the values exactly (split3). The conversions are exact but
// for a subnormal lo.
__device__ __forceinline__ void split3_pair(float x0, float x1, unsigned& hi, unsigned& mid, unsigned& lo) {
  float h0, m0, l0, h1, m1, l1;
  split3(x0, h0, m0, l0);
  split3(x1, h1, m1, l1);
  hi = pack_bf16x2(h0, h1);
  mid = pack_bf16x2(m0, m1);
  lo = pack_bf16x2(l0, l1);
}

// c += a · (n8 half h of b) over split operands (parts [0] hi, [1] mid,
// [2] lo; b an ldmatrix x4 B fragment set, two n8 tiles): the six products
// of weight 2^-16 and above, the smallest first (lo·hi, mid·mid, hi·lo,
// mid·hi, hi·mid, hi·hi). The three dropped (mid·lo, lo·mid, lo·lo) are
// each under 2^-22 |a||b| (nominally 2^-24): together at most 2^-21 of a
// product's magnitude, and in practice ~2^-24, the size of one f32
// rounding. The six start from zero and their sum is added into c on the
// CUDA cores, so the tensor cores' truncating accumulation spans one k16
// step.
__device__ __forceinline__ void mma_split6(float (&c)[4], const unsigned (&a)[3][4], const unsigned (&b)[3][4],
                                           int h) {
  constexpr int PA[6] = {2, 1, 0, 1, 0, 0}, PB[6] = {0, 1, 2, 0, 1, 0};  // the parts of a and b, pass by pass
  float part[4] = {};
#pragma unroll
  for (int pass = 0; pass < 6; ++pass) mma_bf16(part, a[PA[pass]], b[PB[pass]][2 * h], b[PB[pass]][2 * h + 1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += part[e];
}

// Shared memory of the bf16 loop; B_KN: B stored k-major.
template <bool B_KN>
struct Bf16Tiles {
  __nv_bfloat16 a[2][TILE_BM][TILE_LDS];
  __nv_bfloat16 b[2][B_KN ? TILE_BK : TILE_BN][B_KN ? TILE_LDN : TILE_LDS];
};

// One K step of this warp's 32 x 32 (rows wm * 32, columns wn * 32) on
// buffer buf.
template <bool B_KN>
__device__ __forceinline__ void bf16_tile_step(const Bf16Tiles<B_KN>& s, int buf, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < TILE_BK; kk += 16) {
    unsigned af[2][4], bfr[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A 16 x 16: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
      ldmatrix_x4(af[i], &s.a[buf][wm * 32 + i * 16 + r8 + (mat & 1) * 8][kk + (mat >> 1) * 8]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // B, two n8 tiles: (k 0-7, k 8-15) of columns 0-7, then 8-15
      if constexpr (B_KN) {
        ldmatrix_x4_trans(bfr[j], &s.b[buf][kk + (mat & 1) * 8 + r8][wn * 32 + j * 16 + (mat >> 1) * 8]);
      } else {
        ldmatrix_x4(bfr[j], &s.b[buf][wn * 32 + j * 16 + r8 + (mat >> 1) * 8][kk + (mat & 1) * 8]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2], bfr[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }
}

// The double-buffered K loop over nk steps: load(kt) fetches step kt's
// global pieces into the thread's registers, store(buf) writes them into
// buffer buf. Leaves the sums in acc.
template <bool B_KN, typename Load, typename Store>
__device__ __forceinline__ void bf16_tile_loop(int nk, const Load& load, const Store& store,
                                               const Bf16Tiles<B_KN>& s, float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
    bf16_tile_step<B_KN>(s, buf, acc);
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
}

// The epilogue walk of the bf16 accumulators: pair(row, col, v0, v1, j) for
// columns col and col + 1 (col even) of each row this thread holds, in the
// m16n8 layout (c0, c1 at row lane / 4, columns 2 * (lane % 4) and + 1;
// c2, c3 eight rows below). col_setup(col) runs once per column pair first.
template <typename ColSetup, typename Pair>
__device__ __forceinline__ void bf16_tile_epilogue(const float (&acc)[2][4][4], int m0, int n0,
                                                   const ColSetup& col_setup, const Pair& pair) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + t4 * 2;
    col_setup(col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + wm * 32 + i * 16 + g;
      pair(row, col, acc[i][j][0], acc[i][j][1]);
      pair(row + 8, col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace
}  // namespace rt
