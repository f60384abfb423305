// Split-KV decode attention over a KV cache that is either one contiguous
// row per sequence ([B, Hk, S, D]) or pages of a shared pool ([P, Hk, page, D]
// found through a [B, max_pages] page table), with bf16/f32 or int8 payloads
// (int8 with one f32 scale per (token, kv head): [B, Hk, S] or [P, Hk, page]).
// One query token per row, Hq query heads over Hk kv heads (grouped-query
// attention: query head h reads kv head h / (Hq / Hk); Hq == Hk is MHA). The
// operands are three pointers with row strides: q [B, Hq, D], k_new and
// v_new [B, Hk, D], each row's heads contiguous, so a packed MHA q|k|v
// buffer [B, 3 * H * D] is three views of one tensor and RoPE'd q and k
// arrive as their own tensors. The new token's k/v are appended in place at
// kv_len (quantized first for int8) and the output is the attention vector
// [B, Hq * D] in the activations' dtype.
//
// Shared by decode_attention.cu (whose fused wo reads the vector in f32),
// paged_attention.cu, decode_attention_int8.cu and paged_attention_int8.cu
// (rten_tpu/kernels/decode_attention.py _decode_attn_kernel,
// _decode_attn_int8_kernel; paged_attention.py _paged_attn_kernel,
// _paged_attn_int8_kernel). On the TPU one grid cell per row walks its
// pages (or blocks) in order under a running online softmax, with the new
// token seeding it and the group's query rows scored together. Here two
// launches:
//   1. kv_split_kernel, grid (chunk, kv head, row): KV_CHUNK positions of
//      the prefix plus the new token each (a chunk never crosses a page:
//      pages are multiples of KV_CHUNK); blocks past kv_len + 1 exit at
//      once. A block reads its chunk of one kv head and scores every query
//      head of that head's group against it (GT heads at a time: each cache
//      row is loaded once per GT heads, and the device-memory bytes stay
//      those of Hk heads), in f32 (int8: q.k_int8 * scale * sm_scale); for
//      each query head it writes its softmax max, sum and unnormalised P.V
//      (int8: (p * scale) . v_int8). The block whose chunk holds position
//      kv_len appends the new token there, once per kv head, and uses it
//      from shared memory, so no block reads a cache row another block
//      writes.
//   2. kv_combine_kernel, grid (query head, row): rescales the partials to
//      the common maximum and normalises.
// The int8 append quantizes per kv head as the TPU wrapper does: absmax over
// D, scale = absmax / 127 (1 where absmax is 0), code = rint(x / scale)
// clipped to +-127 (IEEE division and round-half-even, the jnp.round rule),
// and the new token's score and value use the dequantized code * scale.
//
// Both kernels' bodies are device functions of a work item (kv_split_item,
// kv_combine_item), which decode_block.cu's persistent kernel calls too (at
// group 1).
//
// Bound on the H100: bytes, the valid prefix's payload (and scales) read
// once per kv head. The split puts (kv_len + 1) / 64 x Hk blocks on the card
// per row; every cache row is read as 16-byte vectors by neighbouring lanes.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {
namespace {

constexpr int KV_CHUNK = 64;  // positions per split block (kernels/paged_attention.py CHUNK)
constexpr int KV_THREADS = 128;

struct KvArgs {
  const void* q;         // [B, Hq, D]: row b at q + b * q_stride (elements)
  const void* k_new;     // [B, Hk, D]
  const void* v_new;
  long long q_stride, kn_stride, vn_stride;
  void* k;               // payload: [B, Hk, cap, D] contiguous, or [n_pages, Hk, page, D]
  void* v;
  float* k_scale;        // int8 only: [B, Hk, cap] or [n_pages, Hk, page]
  float* v_scale;
  const int* kv_len;     // [B], valid length before this token
  const int* table;      // paged only: [B, max_pages]
  int hq, hk;            // query heads, kv heads (hq % hk == 0)
  int cap;               // positions a row can hold: S, or max_pages * page
  int page, max_pages, n_pages;  // paged only
  int nc;                // chunks per row (cap / KV_CHUNK rounded up)
  float* part_m;         // [B, Hq, nc]
  float* part_l;
  float* part_acc;       // [B, Hq, nc, D]
  float sm_scale;
};

// Query heads a split block scores at a time under GQA: GT * 16 / sizeof(KV)
// f32 accumulators a thread (64).
template <typename KV>
constexpr int kv_group_tile() { return 4 * static_cast<int>(sizeof(KV)); }

// 16 bytes of a cache row to f32: 4 floats, 8 bf16 values or 16 int8 codes.
__device__ __forceinline__ void load16(const int8_t* p, float* f) {
  unpack16(*reinterpret_cast<const int4*>(p), *reinterpret_cast<float(*)[16]>(f));
}

// One split work item, chunk c of kv head kvh of row b, by a block of
// KV_THREADS threads (kv_split_kernel's body; decode_block.cu's phase 1
// loops it over the items of a persistent grid). GT: query heads scored at
// a time (1 for MHA).
template <typename T, typename KV, int D, bool PAGED, int GT>
__device__ void kv_split_item(const KvArgs& a, int c, int kvh, int b) {
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
  const int group = a.hq / a.hk;
  const size_t head0 = (size_t)b * a.hq + (size_t)kvh * group;  // (row, first query head of the group)

  size_t row0;  // row (of D elements) of position `start` in the payload
  if constexpr (PAGED) {
    const int pg = a.table[(size_t)b * a.max_pages + start / a.page];
    if (pg < 0 || pg >= a.n_pages) {  // a page id outside the pool: NaN out, nothing read
      for (int g = tid; g < group; g += KV_THREADS) {
        a.part_m[(head0 + g) * a.nc + c] = NAN;
        a.part_l[(head0 + g) * a.nc + c] = NAN;
      }
      return;
    }
    row0 = ((size_t)pg * a.hk + kvh) * a.page + start % a.page;
  } else {
    row0 = ((size_t)b * a.hk + kvh) * a.cap + start;
  }
  KV* kc = static_cast<KV*>(a.k) + row0 * D;
  KV* vc = static_cast<KV*>(a.v) + row0 * D;

  __shared__ float qs[GT][D], kn[D], vn[D];
  __shared__ float ps[GT][KV_CHUNK], ks[KV_CHUNK], vs[KV_CHUNK];
  __shared__ float pv[SLICES][D];
  __shared__ float red[2 * WARPS];
  __shared__ float red_m[GT], red_l[GT], new_sk, new_sv;

  const T* k_new = static_cast<const T*>(a.k_new) + b * a.kn_stride + (size_t)kvh * D;
  const T* v_new = static_cast<const T*>(a.v_new) + b * a.vn_stride + (size_t)kvh * D;
  const int t_new = len - start;               // the new token's place in this chunk
  const bool holds_new = t_new < KV_CHUNK;
  if (holds_new) {
    for (int i = tid; i < D; i += KV_THREADS) {
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

  if (holds_new) {  // append in place at position len, once per kv head
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

  const int sub = lane % VPR, rw = lane / VPR;
  const int vi = tid % VPR, slice = tid / VPR;
  for (int g0 = 0; g0 < group; g0 += GT) {  // the group's query heads, GT at a time
    const int gt = min(GT, group - g0);
    const T* q = static_cast<const T*>(a.q) + b * a.q_stride + ((size_t)kvh * group + g0) * D;
    for (int i = tid; i < gt * D; i += KV_THREADS) qs[i / D][i % D] = to_f32(q[i]);
    __syncthreads();

    // Scores: VPR lanes read one cache row as 16-byte vectors, each dots its
    // slice with every query head of the tile, and the VPR partial sums
    // reduce by shuffles.
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
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < gt) {  // uniform over the block
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < VN; ++e) s += qs[g][sub * VN + e] * f[e];
#pragma unroll
          for (int o = VPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (sub == 0 && t < n_pos) ps[g][t] = INT8 ? s * ks[t] * a.sm_scale : s * a.sm_scale;
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < gt; g += WARPS) {  // softmax statistics, a warp a head
      float mx = -INFINITY;
      for (int t = lane; t < n_pos; t += 32) mx = fmaxf(mx, ps[g][t]);
      mx = warp_max(mx);
      float l = 0.f;
      for (int t = lane; t < KV_CHUNK; t += 32) {
        const float p = t < n_pos ? expf(ps[g][t] - mx) : 0.f;
        ps[g][t] = p;
        l += p;
      }
      l = warp_sum(l);
      if (lane == 0) {
        red_m[g] = mx;
        red_l[g] = l;
      }
    }
    __syncthreads();

    // P.V: thread (slice, vector) sums positions slice, slice + SLICES, ...
    // of its 16-byte column slice for every head of the tile; the slices
    // reduce in shared memory, a head at a time.
    float acc[GT][VN];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[g][e] = 0.f;
    }
    for (int t = slice; t < n_pos; t += SLICES) {
      float f[VN];
      if (t == t_new) {
#pragma unroll
        for (int e = 0; e < VN; ++e) f[e] = vn[vi * VN + e];
      } else {
        load16(vc + (size_t)t * D + vi * VN, f);
      }
      const float sv = INT8 ? vs[t] : 1.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < gt) {
          const float p = ps[g][t] * sv;
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[g][e] += p * f[e];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < gt) {
#pragma unroll
        for (int e = 0; e < VN; ++e) pv[slice][vi * VN + e] = acc[g][e];
        __syncthreads();
        const size_t idx = (head0 + g0 + g) * a.nc + c;
        for (int i = tid; i < D; i += KV_THREADS) {
          float sum = 0.f;
#pragma unroll 4
          for (int sl = 0; sl < SLICES; ++sl) sum += pv[sl][i];
          a.part_acc[idx * D + i] = sum;
        }
        if (tid == 0) {
          a.part_m[idx] = red_m[g];
          a.part_l[idx] = red_l[g];
        }
        __syncthreads();
      }
    }
  }
}

template <typename T, typename KV, int D, bool PAGED, int GT>
__global__ void __launch_bounds__(KV_THREADS) kv_split_kernel(KvArgs a) {
  kv_split_item<T, KV, D, PAGED, GT>(a, blockIdx.x, blockIdx.y, blockIdx.z);
}

// The combine of query head hh of row b by threads 0..D-1
// (kv_combine_kernel's body; decode_block.cu's phase 2).
template <typename O, int D>
__device__ void kv_combine_item(const KvArgs& a, O* out, int hh, int b) {
  const int tid = threadIdx.x;
  const int len = a.kv_len[b];
  O* dst = out + ((size_t)b * a.hq + hh) * D;
  if (len < 0 || len >= a.cap) {  // no room to append: the row's output is NaN, never plausible
    store_elt(dst + tid, NAN);
    return;
  }
  const int n_valid = (len + KV_CHUNK) / KV_CHUNK;  // ceil((len + 1) / CHUNK)
  const size_t base = ((size_t)b * a.hq + hh) * a.nc;
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
  const dim3 grid(a.nc, a.hk, b);
  if (a.hq == a.hk) {
    kv_split_kernel<T, KV, D, PAGED, 1><<<grid, KV_THREADS, 0, st>>>(a);
  } else {
    kv_split_kernel<T, KV, D, PAGED, kv_group_tile<KV>()><<<grid, KV_THREADS, 0, st>>>(a);
  }
  kv_combine_kernel<O, D><<<dim3(a.hq, b), D, 0, st>>>(a, static_cast<O*>(out));
  return cudaGetLastError();
}

// Instantiation by (activation dtype, head dim); the cache holds the
// activations' dtype or int8 codes (INT8_KV). The attention vector is
// written in the activations' dtype, or in f32 (F32_OUT) for a caller that
// projects it unrounded (decode_attention.cu's fused wo).
template <bool INT8_KV, bool PAGED, bool F32_OUT = false>
int run_kv_attention(const KvArgs& a, int bf16, int b, int d, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || a.hk < 1 || a.hq < a.hk || a.hq % a.hk || a.cap < 1 || a.nc * KV_CHUNK < a.cap ||
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

// The arguments every KV entry point shares: the three operands with their
// row strides, the head counts, the lengths and the split scratch.
KvArgs kv_args(const void* q, const void* k_new, const void* v_new, long long q_stride, long long kn_stride,
               long long vn_stride, int hq, int hk, const int* kv_len, float* part_m, float* part_l,
               float* part_acc, int n_chunks, float sm_scale) {
  KvArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.q_stride = q_stride;
  a.kn_stride = kn_stride;
  a.vn_stride = vn_stride;
  a.hq = hq;
  a.hk = hk;
  a.kv_len = kv_len;
  a.part_m = part_m;
  a.part_l = part_l;
  a.part_acc = part_acc;
  a.nc = n_chunks;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace
}  // namespace rt
