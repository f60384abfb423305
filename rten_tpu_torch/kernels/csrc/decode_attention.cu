// decode_attention: one query token per row against a preallocated KV cache
// [B, H, S, D] (MHA), with the new token's k/v appended in place at kv_len
// and the int8 output projection, its bias and the residual fused in.
//
// Replaces rten_tpu/kernels/decode_attention.py decode_attention (:734;
// Pallas kernel _decode_attn_kernel :83) in its packed-qkv, fused-wo mode
// (which the TPU kernel supports for MHA only, as here).
// On the TPU one grid cell per row walks the valid prefix in order with a
// running online softmax and a double-buffered DMA. Here three launches on
// one stream:
//   1. attn_split_kernel, grid (chunk, head, row): each block takes
//      ATTN_CHUNK positions of the valid prefix (blocks past kv_len + 1
//      exit at once, so only the valid prefix is read), scores them in f32,
//      and writes its softmax max, sum and unnormalised P.V (split-KV,
//      "flash-decoding"). The block whose chunk holds position kv_len
//      writes k_new / v_new into the caches there and uses them from the
//      packed operand, so no block reads a cache row another block writes.
//   2. attn_combine_kernel, grid (head, row): rescales the partials to the
//      common maximum and normalises, giving the f32 attention vector.
//   3. gemv_kernel (gemv.cuh): attn @ W_o * s + bias + residual, the dot in
//      f32 as on the TPU (the attention vector is not rounded).
//
// Bound on the H100: bytes, the valid KV prefix (2 * H * (kv_len + 1) * D
// elements) plus the int8 W_o (H*D x Dm). Splitting the prefix into chunks
// puts (kv_len + 1) / 64 x H blocks on the card instead of H, so at batch 1
// the cache stream is spread over the SMs; every cache row is read as
// 16-byte vectors by neighbouring lanes; all softmax statistics and sums
// are f32.

#include "gemv.cuh"

namespace rt {
namespace {

constexpr int ATTN_CHUNK = 64;  // positions per split block (decode_attention.py CHUNK)
constexpr int ATTN_THREADS = 128;

struct AttnArgs {
  const void* qkv;    // [B, 3 * H * D]: q heads, then k_new, then v_new
  void* k_cache;      // [B, H, S, D]
  void* v_cache;
  const int* kv_len;  // [B], valid length before this token
  float* part_m;      // [B, H, nc]
  float* part_l;      // [B, H, nc]
  float* part_acc;    // [B, H, nc, D]
  int h, s_max, nc;
  float sm_scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of a row to f32: 4 floats or 8 bf16 values.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const unsigned words[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                             static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(ATTN_THREADS) attn_split_kernel(AttnArgs a) {
  constexpr int VN = 16 / sizeof(T);             // elements in a 16-byte vector
  constexpr int VPR = D / VN;                    // vectors (lanes) per cache row
  constexpr int RPW = 32 / VPR;                  // rows a warp scores per step
  constexpr int SLICES = ATTN_THREADS / VPR;     // position slices of the P.V sum
  constexpr int WARPS = ATTN_THREADS / 32;
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int len = a.kv_len[b];
  if (len < 0 || len >= a.s_max) return;  // no room to append: nothing written, NaN out
  const int start = c * ATTN_CHUNK;
  const int total = len + 1;
  if (start >= total) return;
  const int n_pos = min(ATTN_CHUNK, total - start);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float qs[D];
  __shared__ float ps[ATTN_CHUNK];
  __shared__ float pv[SLICES][D];
  __shared__ float red_m, red_l;

  const T* row = static_cast<const T*>(a.qkv) + (size_t)b * 3 * a.h * D;
  const T* q = row + (size_t)hh * D;
  const T* k_new = row + (size_t)(a.h + hh) * D;
  const T* v_new = row + (size_t)(2 * a.h + hh) * D;
  T* kc = static_cast<T*>(a.k_cache) + ((size_t)b * a.h + hh) * a.s_max * D;
  T* vc = static_cast<T*>(a.v_cache) + ((size_t)b * a.h + hh) * a.s_max * D;

  for (int i = tid; i < D; i += ATTN_THREADS) qs[i] = to_f32(q[i]);
  if (len < start + ATTN_CHUNK) {  // this chunk holds position len: append in place
    for (int i = tid; i < D; i += ATTN_THREADS) {
      kc[(size_t)len * D + i] = k_new[i];
      vc[(size_t)len * D + i] = v_new[i];
    }
  }
  __syncthreads();

  // Scores: VPR lanes read one cache row as 16-byte vectors (a coalesced
  // row), each dots its slice with the query, and the VPR partial sums
  // reduce by shuffles.
  const int sub = lane % VPR, rw = lane / VPR;
  for (int t0 = warp * RPW; t0 < n_pos; t0 += WARPS * RPW) {
    const int t = t0 + rw;
    const int pos = start + t;
    float f[VN];
    if (t < n_pos) {
      load16((pos == len ? k_new : kc + (size_t)pos * D) + sub * VN, f);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) s += qs[sub * VN + e] * f[e];
#pragma unroll
    for (int o = VPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (sub == 0 && t < n_pos) ps[t] = s * a.sm_scale;
  }
  __syncthreads();

  if (warp == 0) {
    float mx = -INFINITY;
    for (int t = lane; t < n_pos; t += 32) mx = fmaxf(mx, ps[t]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int t = lane; t < ATTN_CHUNK; t += 32) {
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
    const int pos = start + t;
    float f[VN];
    load16((pos == len ? v_new : vc + (size_t)pos * D) + vi * VN, f);
    const float p = ps[t];
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] += p * f[e];
  }
#pragma unroll
  for (int e = 0; e < VN; ++e) pv[slice][vi * VN + e] = acc[e];
  __syncthreads();
  const size_t idx = ((size_t)b * a.h + hh) * a.nc + c;
  for (int i = tid; i < D; i += ATTN_THREADS) {
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

template <int D>
__global__ void __launch_bounds__(D) attn_combine_kernel(AttnArgs a, float* attn) {
  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = a.kv_len[b];
  float* dst = attn + ((size_t)b * a.h + hh) * D;
  if (len < 0 || len >= a.s_max) {  // a full cache: the row's output is NaN, never plausible
    dst[tid] = NAN;
    return;
  }
  const int n_valid = (len + ATTN_CHUNK) / ATTN_CHUNK;  // ceil((len + 1) / CHUNK)
  const size_t base = ((size_t)b * a.h + hh) * a.nc;
  float mx = -INFINITY;
  for (int c = 0; c < n_valid; ++c) mx = fmaxf(mx, a.part_m[base + c]);
  float den = 0.f, num = 0.f;
  for (int c = 0; c < n_valid; ++c) {
    const float w = expf(a.part_m[base + c] - mx);
    den += w * a.part_l[base + c];
    num += w * a.part_acc[(base + c) * D + tid];
  }
  dst[tid] = num * (den == 0.f ? 1.f : 1.f / den);
}

template <typename T, int D>
cudaError_t launch_attention(const AttnArgs& a, int b, float* attn, cudaStream_t st) {
  attn_split_kernel<T, D><<<dim3(a.nc, a.h, b), ATTN_THREADS, 0, st>>>(a);
  attn_combine_kernel<D><<<dim3(a.h, b), D, 0, st>>>(a, attn);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt

extern "C" int rt_decode_attention(
    const void* qkv, int bf16, int b, int h, int d,
    void* k_cache, void* v_cache, int s_max, const int* kv_len,
    float* part_m, float* part_l, float* part_acc, float* attn, int n_chunks,
    const int8_t* wo_t, const float* wo_scales, const float* wo_bias, int dm,
    const void* residual, void* out, float sm_scale,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > rt::MAXM || h < 1 || n_chunks * rt::ATTN_CHUNK < s_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rt::AttnArgs a{qkv, k_cache, v_cache, kv_len, part_m, part_l, part_acc,
                 h, s_max, n_chunks, sm_scale};
  cudaError_t e;
  if (d == 64) {
    e = bf16 ? rt::launch_attention<__nv_bfloat16, 64>(a, b, attn, st)
             : rt::launch_attention<float, 64>(a, b, attn, st);
  } else if (d == 128) {
    e = bf16 ? rt::launch_attention<__nv_bfloat16, 128>(a, b, attn, st)
             : rt::launch_attention<float, 128>(a, b, attn, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);

  rt::GemvArgs g{};
  g.x = attn;
  g.x_bf16 = 0;
  g.m = b;
  g.w = wo_t;
  g.scale = wo_scales;
  g.n = dm;
  g.k = h * d;
  g.bias = wo_bias;
  g.dot_bf16 = 0;  // f32 attention vector times the int8 weights, as on the TPU
  g.residual = residual;
  g.out = out;
  g.out_bf16 = bf16;
  return static_cast<int>(rt::launch_gemv(g, st));
}
