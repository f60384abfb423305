// Split-KV decode attention over a KV cache that is either one contiguous
// row per sequence ([B, H, S, D]) or pages of a shared pool ([P, H, page, D]
// found through a [B, max_pages] page table), with bf16/f32 or int8 payloads
// (int8 with one f32 scale per (token, head): [B, H, S] or [P, H, page]).
// One query token per row (MHA, packed q|k|v); the new token's k/v are
// appended in place at kv_len (quantized first for int8) and the output is
// the attention vector [B, H*D] in the activations' dtype.
//
// Shared by decode_attention.cu (whose fused wo reads the vector in f32),
// paged_attention.cu, decode_attention_int8.cu and paged_attention_int8.cu
// (rten_tpu/kernels/decode_attention.py _decode_attn_kernel,
// _decode_attn_int8_kernel; paged_attention.py _paged_attn_kernel,
// _paged_attn_int8_kernel). On the TPU one grid cell per row walks its
// pages (or blocks) in order under a running online softmax, with the new
// token seeding it. Here two launches:
//   1. kv_split_kernel, grid (chunk, head, row): KV_CHUNK positions of the
//      prefix plus the new token each (a chunk never crosses a page: pages
//      are multiples of KV_CHUNK); blocks past kv_len + 1 exit at once. It
//      scores its positions in f32 (int8: q.k_int8 * scale * sm_scale) and
//      writes its softmax max, sum and unnormalised P.V (int8: (p * scale)
//      . v_int8). The block whose chunk holds position kv_len appends the new
//      token there and uses it from shared memory, so no block reads a cache
//      row another block writes.
//   2. kv_combine_kernel, grid (head, row): rescales the partials to the
//      common maximum and normalises.
// The int8 append quantizes per head as the TPU wrapper does: absmax over
// D, scale = absmax / 127 (1 where absmax is 0), code = rint(x / scale)
// clipped to +-127 (IEEE division and round-half-even, the jnp.round rule),
// and the new token's score and value use the dequantized code * scale.
//
// Both kernels' bodies are device functions of a work item (kv_split_item,
// kv_combine_item), which decode_block.cu's persistent kernel calls too.
//
// Bound on the H100: bytes, the valid prefix's payload (and scales) read
// once. The split puts (kv_len + 1) / 64 x H blocks on the card per row;
// every cache row is read as 16-byte vectors by neighbouring lanes.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {
namespace {

constexpr int KV_CHUNK = 64;  // positions per split block (kernels/paged_attention.py CHUNK)
constexpr int KV_THREADS = 128;

struct KvArgs {
  const void* qkv;       // [B, 3 * H * D]: q heads, then k_new, then v_new
  void* k;               // payload: [B, H, cap, D] contiguous, or [n_pages, H, page, D]
  void* v;
  float* k_scale;        // int8 only: [B, H, cap] or [n_pages, H, page]
  float* v_scale;
  const int* kv_len;     // [B], valid length before this token
  const int* table;      // paged only: [B, max_pages]
  int h;
  int cap;               // positions a row can hold: S, or max_pages * page
  int page, max_pages, n_pages;  // paged only
  int nc;                // chunks per row (cap / KV_CHUNK rounded up)
  float* part_m;         // [B, H, nc]
  float* part_l;
  float* part_acc;       // [B, H, nc, D]
  float sm_scale;
};

// 16 bytes of a cache row to f32: 4 floats, 8 bf16 values or 16 int8 codes.
__device__ __forceinline__ void load16(const int8_t* p, float* f) {
  unpack16(*reinterpret_cast<const int4*>(p), *reinterpret_cast<float(*)[16]>(f));
}

// One split work item, chunk c of head hh of row b, by a block of
// KV_THREADS threads (kv_split_kernel's body; decode_block.cu's phase 1
// loops it over the items of a persistent grid).
template <typename T, typename KV, int D, bool PAGED>
__device__ void kv_split_item(const KvArgs& a, int c, int hh, int b) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static_assert(INT8 || std::is_same<KV, T>::value, "a float cache holds the activations' dtype");
  constexpr int VN = 16 / sizeof(KV);            // elements in a 16-byte vector
  constexpr int VPR = D / VN;                    // vectors (lanes) per cache row
  constexpr int RPW = 32 / VPR;                  // rows a warp scores per step
  constexpr int SLICES = KV_THREADS / VPR;       // position slices of the P.V sum
  constexpr int WARPS = KV_THREADS / 32;
  const int len = a.kv_len[b];
  if (len < 0 || len >= a.cap) return;  // no room to append: nothing written, NaN out
  const int start = c * KV_CHUNK;
  const int total = len + 1;
  if (start >= total) return;
  const int n_pos = min(KV_CHUNK, total - start);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t idx = ((size_t)b * a.h + hh) * a.nc + c;

  size_t row0;  // row (of D elements) of position `start` in the payload
  if constexpr (PAGED) {
    const int pg = a.table[(size_t)b * a.max_pages + start / a.page];
    if (pg < 0 || pg >= a.n_pages) {  // a page id outside the pool: NaN out, nothing read
      if (tid == 0) {
        a.part_m[idx] = NAN;
        a.part_l[idx] = NAN;
      }
      return;
    }
    row0 = ((size_t)pg * a.h + hh) * a.page + start % a.page;
  } else {
    row0 = ((size_t)b * a.h + hh) * a.cap + start;
  }
  KV* kc = static_cast<KV*>(a.k) + row0 * D;
  KV* vc = static_cast<KV*>(a.v) + row0 * D;

  __shared__ float qs[D], kn[D], vn[D];
  __shared__ float ps[KV_CHUNK], ks[KV_CHUNK], vs[KV_CHUNK];
  __shared__ float pv[SLICES][D];
  __shared__ float red[2 * WARPS];
  __shared__ float red_m, red_l, new_sk, new_sv;

  const T* row = static_cast<const T*>(a.qkv) + (size_t)b * 3 * a.h * D;
  const T* q = row + (size_t)hh * D;
  const T* k_new = row + (size_t)(a.h + hh) * D;
  const T* v_new = row + (size_t)(2 * a.h + hh) * D;
  const int t_new = len - start;               // the new token's place in this chunk
  const bool holds_new = t_new < KV_CHUNK;
  for (int i = tid; i < D; i += KV_THREADS) {
    qs[i] = to_f32(q[i]);
    if (holds_new) {
      kn[i] = to_f32(k_new[i]);
      vn[i] = to_f32(v_new[i]);
    }
  }
  if constexpr (INT8) {
    for (int t = tid; t < n_pos; t += KV_THREADS) {
      ks[t] = t == t_new ? 1.f : a.k_scale[row0 + t];  // the new token is dequantized below
      vs[t] = t == t_new ? 1.f : a.v_scale[row0 + t];
    }
  }
  __syncthreads();

  if (holds_new) {  // append in place at position len
    if constexpr (INT8) {
      float ak = tid < D ? fabsf(kn[tid]) : 0.f;
      float av = tid < D ? fabsf(vn[tid]) : 0.f;
      ak = warp_max(ak);
      av = warp_max(av);
      if (lane == 0) {
        red[warp] = ak;
        red[WARPS + warp] = av;
      }
      __syncthreads();
      if (tid == 0) {
        float mk = 0.f, mv = 0.f;
        for (int w = 0; w < WARPS; ++w) {
          mk = fmaxf(mk, red[w]);
          mv = fmaxf(mv, red[WARPS + w]);
        }
        new_sk = mk == 0.f ? 1.f : mk / 127.f;
        new_sv = mv == 0.f ? 1.f : mv / 127.f;
        a.k_scale[row0 + t_new] = new_sk;
        a.v_scale[row0 + t_new] = new_sv;
      }
      __syncthreads();
      const float sk = new_sk, sv = new_sv;
      for (int i = tid; i < D; i += KV_THREADS) {
        const float ck = fminf(fmaxf(rintf(kn[i] / sk), -127.f), 127.f);
        const float cv = fminf(fmaxf(rintf(vn[i] / sv), -127.f), 127.f);
        kc[(size_t)t_new * D + i] = static_cast<int8_t>(ck);
        vc[(size_t)t_new * D + i] = static_cast<int8_t>(cv);
        kn[i] = ck * sk;
        vn[i] = cv * sv;
      }
      __syncthreads();
    } else {
      for (int i = tid; i < D; i += KV_THREADS) {
        kc[(size_t)t_new * D + i] = k_new[i];
        vc[(size_t)t_new * D + i] = v_new[i];
      }
    }
  }

  // Scores: VPR lanes read one cache row as 16-byte vectors, each dots its
  // slice with the query, and the VPR partial sums reduce by shuffles.
  const int sub = lane % VPR, rw = lane / VPR;
  for (int t0 = warp * RPW; t0 < n_pos; t0 += WARPS * RPW) {
    const int t = t0 + rw;
    float f[VN];
    if (t == t_new) {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = kn[sub * VN + e];
    } else if (t < n_pos) {
      load16(kc + (size_t)t * D + sub * VN, f);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) s += qs[sub * VN + e] * f[e];
#pragma unroll
    for (int o = VPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (sub == 0 && t < n_pos) ps[t] = INT8 ? s * ks[t] * a.sm_scale : s * a.sm_scale;
  }
  __syncthreads();

  if (warp == 0) {
    float mx = -INFINITY;
    for (int t = lane; t < n_pos; t += 32) mx = fmaxf(mx, ps[t]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int t = lane; t < KV_CHUNK; t += 32) {
      const float p = t < n_pos ? expf(ps[t] - mx) : 0.f;
      ps[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      red_m = mx;
      red_l = l;
    }
  }
  __syncthreads();

  // P.V: thread (slice, vector) sums positions slice, slice + SLICES, ...
  // of its 16-byte column slice; the slices reduce in shared memory.
  const int vi = tid % VPR, slice = tid / VPR;
  float acc[VN];
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = 0.f;
  for (int t = slice; t < n_pos; t += SLICES) {
    float f[VN];
    if (t == t_new) {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = vn[vi * VN + e];
    } else {
      load16(vc + (size_t)t * D + vi * VN, f);
    }
    const float p = INT8 ? ps[t] * vs[t] : ps[t];
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] += p * f[e];
  }
#pragma unroll
  for (int e = 0; e < VN; ++e) pv[slice][vi * VN + e] = acc[e];
  __syncthreads();
  for (int i = tid; i < D; i += KV_THREADS) {
    float sum = 0.f;
#pragma unroll 4
    for (int sl = 0; sl < SLICES; ++sl) sum += pv[sl][i];
    a.part_acc[idx * D + i] = sum;
  }
  if (tid == 0) {
    a.part_m[idx] = red_m;
    a.part_l[idx] = red_l;
  }
}

template <typename T, typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(KV_THREADS) kv_split_kernel(KvArgs a) {
  kv_split_item<T, KV, D, PAGED>(a, blockIdx.x, blockIdx.y, blockIdx.z);
}

// The combine of head hh of row b by threads 0..D-1 (kv_combine_kernel's
// body; decode_block.cu's phase 2).
template <typename O, int D>
__device__ void kv_combine_item(const KvArgs& a, O* out, int hh, int b) {
  const int tid = threadIdx.x;
  const int len = a.kv_len[b];
  O* dst = out + ((size_t)b * a.h + hh) * D;
  if (len < 0 || len >= a.cap) {  // no room to append: the row's output is NaN, never plausible
    store_elt(dst + tid, NAN);
    return;
  }
  const int n_valid = (len + KV_CHUNK) / KV_CHUNK;  // ceil((len + 1) / CHUNK)
  const size_t base = ((size_t)b * a.h + hh) * a.nc;
  float mx = -INFINITY;
  for (int c = 0; c < n_valid; ++c) mx = fmaxf(mx, a.part_m[base + c]);
  float den = 0.f, num = 0.f;
  for (int c = 0; c < n_valid; ++c) {
    const float w = expf(a.part_m[base + c] - mx);
    den += w * a.part_l[base + c];
    num += w * a.part_acc[(base + c) * D + tid];
  }
  store_elt(dst + tid, num * (den == 0.f ? 1.f : 1.f / den));
}

template <typename O, int D>
__global__ void __launch_bounds__(D) kv_combine_kernel(KvArgs a, O* out) {
  kv_combine_item<O, D>(a, out, blockIdx.x, blockIdx.y);
}

template <typename T, typename KV, int D, bool PAGED, bool F32_OUT>
cudaError_t launch_kv(const KvArgs& a, int b, void* out, cudaStream_t st) {
  using O = std::conditional_t<F32_OUT, float, T>;
  kv_split_kernel<T, KV, D, PAGED><<<dim3(a.nc, a.h, b), KV_THREADS, 0, st>>>(a);
  kv_combine_kernel<O, D><<<dim3(a.h, b), D, 0, st>>>(a, static_cast<O*>(out));
  return cudaGetLastError();
}

// Instantiation by (activation dtype, head dim); the cache holds the
// activations' dtype or int8 codes (INT8_KV). The attention vector is
// written in the activations' dtype, or in f32 (F32_OUT) for a caller that
// projects it unrounded (decode_attention.cu's fused wo).
template <bool INT8_KV, bool PAGED, bool F32_OUT = false>
int run_kv_attention(const KvArgs& a, int bf16, int b, int d, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || a.h < 1 || a.cap < 1 || a.nc * KV_CHUNK < a.cap ||
      (PAGED && (a.page < KV_CHUNK || a.page % KV_CHUNK || a.max_pages < 1 || a.n_pages < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using BF = __nv_bfloat16;
  cudaError_t e;
  if (d == 64) {
    e = bf16 ? launch_kv<BF, std::conditional_t<INT8_KV, int8_t, BF>, 64, PAGED, F32_OUT>(a, b, out, st)
             : launch_kv<float, std::conditional_t<INT8_KV, int8_t, float>, 64, PAGED, F32_OUT>(a, b, out, st);
  } else if (d == 128) {
    e = bf16 ? launch_kv<BF, std::conditional_t<INT8_KV, int8_t, BF>, 128, PAGED, F32_OUT>(a, b, out, st)
             : launch_kv<float, std::conditional_t<INT8_KV, int8_t, float>, 128, PAGED, F32_OUT>(a, b, out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // namespace
}  // namespace rt
