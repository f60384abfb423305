// flash_attention: tiled online-softmax attention for prefill,
//
//     out = softmax(q @ k^T * sm_scale + mask) @ v
//
// with q [B, Hq, Tq, D] and k, v [B, Hk, S, D] (GQA: q head h reads k/v
// head h / (Hq / Hk), no repeat), per-row q_offset and kv_len read on the
// device, causal or not. Every operand is addressed by its own (batch, head,
// position) strides with D contiguous, so the decoder passes q as a view of
// its packed qkv and receives the output in a [B, Tq, Hq, D] buffer without
// a copy either way.
//
// Replaces rten_tpu/kernels/attention.py flash_attention (:117; Pallas
// kernel _flash_kernel :29) and keeps every part of its function: the mask
// value -0.7 * f32 max (not -inf), the running max and sum in f32, KV tiles
// wholly past kv_len or wholly above the diagonal skipped, P rounded to v's
// dtype before P.V (the sum l from the unrounded P), and 0 for a row with
// l = 0 (kv_len 0).
//
// Bound on the H100: operations at prefill sizes (4 * D operations per
// (query, key) pair against 2 * D bytes of k and v per key, reused by all
// 64 rows of a q tile); bytes for short prompts.
//
// Design (a first, simple version on the CUDA cores; tensor-core products
// are later work):
// - One block of 256 threads per (64-row q tile, q head, batch row). A loop
//   over 64-position K/V tiles inside the block, up to min(kv_len,
//   q_offset + tile end), takes the place of the TPU's sequential kv grid
//   axis; the running max, sum and output accumulator stay in f32
//   registers across it. The block reads its row's q_offset and kv_len
//   itself (the TPU's scalar prefetch).
// - The q tile, each K and V tile (converted to f32) and the P tile sit in
//   shared memory with rows padded by one float, so the column reads of
//   the two products hit distinct banks. Only positions below kv_len are
//   read from memory; the rest of a tile is zero.
// - Thread (ty, tx) owns query rows ty + 16 i (i < 4): scores of columns
//   tx + 16 j (j < 4) and output columns tx + 16 j (j < D / 16). A row's
//   maximum and sum reduce over its 16 threads, which share one half-warp.

#include "common.cuh"

namespace rt {
namespace {

constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256;
constexpr float FA_MASK = -0.7f * 3.4028234663852886e38f;  // attention.py DEFAULT_MASK_VALUE

struct FlashArgs {
  const void* q;            // element strides: batch, head, position; D contiguous
  long long q_sb, q_sh, q_st;
  const void* k;
  long long k_sb, k_sh, k_ss;
  const void* v;
  long long v_sb, v_sh, v_ss;
  void* o;
  long long o_sb, o_sh, o_st;
  const int* q_offset;  // [B] or null (0)
  const int* kv_len;    // [B] or null (S)
  int hq, hk, tq, s, causal;
  float sm_scale;
};

// Rows [row0, row0 + n_valid) of a [*, D] operand (row stride `stride`
// elements) into a 64-row f32 tile with row stride D + 1; rows past n_valid
// are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long long stride, int row0,
                                           int n_valid) {
  constexpr int VN = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = D / VN;         // loads per row
  for (int i = threadIdx.x; i < FA_BQ * VPR; i += FA_THREADS) {
    const int r = i / VPR, c = (i % VPR) * VN;
    float f[VN];
    if (r < n_valid) {
      load16(src + (row0 + r) * stride + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[r * (D + 1) + c + e] = f[e];
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS) flash_kernel(FlashArgs a) {
  constexpr int LD = D + 1, LP = FA_BK + 1, DJ = D / 16;
  extern __shared__ float4 fa_smem[];
  float* qs = reinterpret_cast<float*>(fa_smem);  // [BQ][LD]
  float* ks = qs + FA_BQ * LD;                    // [BK][LD]
  float* vs = ks + FA_BK * LD;                    // [BK][LD]
  float* ps = vs + FA_BK * LD;                    // [BQ][LP]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * FA_BQ;
  const int q_off = (a.causal && a.q_offset) ? a.q_offset[b] : 0;
  const int kv_len = min(max(a.kv_len ? a.kv_len[b] : a.s, 0), a.s);
  // Columns at or past kv_len, and (causal) past the tile's last row, are
  // masked for every row of the tile: their KV tiles are never read.
  const int kv_end = a.causal ? min(kv_len, q_off + q0 + FA_BQ) : kv_len;
  const int n_tiles = kv_end > 0 ? (kv_end + FA_BK - 1) / FA_BK : 0;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  stage_tile<T, D>(qs, qp, a.q_st, q0, min(FA_BQ, a.tq - q0));

  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * FA_BK;
    __syncthreads();  // the previous tile's readers (and the q staging) are done
    stage_tile<T, D>(ks, kp, a.k_ss, c0, min(FA_BK, kv_len - c0));
    stage_tile<T, D>(vs, vp, a.v_ss, c0, min(FA_BK, kv_len - c0));
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_off + q0 + ty + 16 * i;  // absolute position of the query
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool ok = col < kv_len && (!a.causal || col <= row);
        s[i][j] = ok ? s[i][j] * a.sm_scale : FA_MASK;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], half_warp_max(mx));
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = round_to<T>(p);
      }
      l_i[i] = alpha * l_i[i] + half_warp_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < FA_BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.tq) continue;
    const float inv = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) store_elt(op + r * a.o_st + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_flash(const FlashArgs& a, int b, cudaStream_t st) {
  constexpr size_t smem = (3 * FA_BQ * (D + 1) + FA_BQ * (FA_BK + 1)) * sizeof(float);
  static bool smem_allowed = false;
  const cudaError_t e = allow_smem(flash_kernel<T, D>, smem, smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.tq + FA_BQ - 1) / FA_BQ, a.hq, b);
  flash_kernel<T, D><<<grid, FA_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt

extern "C" int rt_flash_attention(
    const void* q, long long q_sb, long long q_sh, long long q_st,
    const void* k, long long k_sb, long long k_sh, long long k_ss,
    const void* v, long long v_sb, long long v_sh, long long v_ss,
    void* o, long long o_sb, long long o_sh, long long o_st,
    const int* q_offset, const int* kv_len,
    int bf16, int b, int hq, int hk, int tq, int s, int d, int causal, float sm_scale,
    void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hk < 1 || hq % hk || tq < 1 || s < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rt::FlashArgs a{q, q_sb, q_sh, q_st, k, k_sb, k_sh, k_ss, v, v_sb, v_sh, v_ss,
                        o, o_sb, o_sh, o_st, q_offset, kv_len, hq, hk, tq, s, causal, sm_scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d == 64) {
    e = bf16 ? rt::launch_flash<__nv_bfloat16, 64>(a, b, st) : rt::launch_flash<float, 64>(a, b, st);
  } else if (d == 128) {
    e = bf16 ? rt::launch_flash<__nv_bfloat16, 128>(a, b, st) : rt::launch_flash<float, 128>(a, b, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
