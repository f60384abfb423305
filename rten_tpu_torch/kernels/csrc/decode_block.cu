// decode_block: a whole transformer block of one decode token (batch 1) as
// one persistent cooperative kernel:
//
//     attn = softmax(q k^T / sqrt(D)) v   over the cache prefix + the new token
//     h    = attn @ W_o * s_o + b_o + residual            (f32, not rounded)
//     out  = act(norm2(h) @ W_up * s_up + b_up) @ W_down * s_down + b_down + h
//     qkv  = norm1_next(out_f32) @ W_qkv * s_qkv + b_qkv   (optional)
//
// with the new token's k/v appended to the [1, H, S, D] cache in place.
//
// Replaces the whole-block ("mega") mode of rten_tpu/kernels/
// decode_attention.py decode_attention (:734; _decode_attn_kernel's mega
// branch :118-148 and :357-405), which the JAX decoder takes under
// RTEN_DECODE_FUSE=mega at batch 1. Its numbers are the TPU kernel's, not
// those of decode_attention followed by quant_mlp_int8: the hidden state h
// after wo + bias + residual stays f32 (ln2 normalises it unrounded and the
// down projection adds it as its residual); the normalised row, the
// activated up row and the next-qkv input are rounded to the model dtype
// before their int8 dots (bf16 in a bf16 model); out and qkv are stored in
// the model dtype, and the next qkv normalises the f32 out.
//
// Bound on the H100: bytes, the valid KV prefix and the four int8 weight
// matrices (7.08 MB at GPT-2-small with the next qkv), read once.
//
// Design: one launch (cudaLaunchCooperativeKernel) of a grid that is all
// resident (the occupancy of this kernel times the SM count, at most
// DB_BLOCKS_PER_SM a SM), blocks of 128 threads. Six phases, separated by
// cooperative_groups grid syncs; in each, the blocks stride over the
// phase's work items by gridDim.x:
//   1. the split-KV items (chunk, head; split_item below), the block whose
//      chunk holds kv_len appending the new token, each writing its chunk's
//      softmax max, sum and unnormalised P.V to the f32 scratch;
//   2. the combine of each head (combine_item) into the f32 attention
//      vector;
//   3. wo: gemv_prologue + gemv_body (block_gemv.cuh) on that vector, f32 dot,
//      + bias + residual into the f32 scratch h;
//   4. ln2 + up + bias + activation, into the f32 scratch u;
//   5. down + bias + the f32 h, giving out (model dtype) and its f32 copy;
//   6. the next layer's ln1 + qkv (when asked).
// Data that other blocks wrote in an earlier phase is read from L2
// (gemv_prologue<1, true>), not through the read-only path. A block with no
// columns in a GEMV phase skips it (and its prologue). A row with no room
// (kv_len >= S) appends nothing and its outputs are NaN, as in
// kv_attention.cuh. A grid that cannot be co-resident is refused by the
// launch (cudaErrorCooperativeLaunchTooLarge); nothing falls back.
//
// Phases 1-2 are the split-KV design the separate decode attention had
// before it became one clustered launch (kv_attention.cuh): a cooperative
// grid cannot be launched as clusters, so this kernel keeps that design as
// its own two phase functions.

#include <cooperative_groups.h>

#include "block_gemv.cuh"

namespace rt {
namespace {

namespace cg = cooperative_groups;

constexpr int DB_THREADS = 128;
constexpr int DB_BLOCKS_PER_SM = 4;
constexpr int DB_CHUNK = 64;  // cache positions per split item
static_assert(DB_THREADS == GEMV_THREADS, "one block shape for every phase");

// The attention of row 0 (H heads, MHA) and its split scratch.
struct SplitArgs {
  const void* q;      // [H, D]: the q, k_new and v_new parts of the packed row
  const void* k_new;
  const void* v_new;
  void* k;            // [1, H, cap, D]
  void* v;
  const int* kv_len;  // [1]
  int cap;            // S
  int nc;             // chunks per row (cap / DB_CHUNK rounded up)
  float* part_m;      // [H, nc]
  float* part_l;
  float* part_acc;    // [H, nc, D]
  float sm_scale;
};

// Phase 1's item: chunk c of head hh, by a block of DB_THREADS threads.
// Scores in f32 (VPR lanes read a cache row as 16-byte vectors and reduce
// by shuffles), the chunk's softmax max and sum, and its unnormalised P.V
// (thread (slice, vector) sums positions slice, slice + SLICES, ..., the
// slices reduced in shared memory) into part_m / part_l / part_acc. The
// block whose chunk holds position kv_len appends the new token there and
// uses it from shared memory, so no block reads a row another block writes.
template <typename T, int D>
__device__ void split_item(const SplitArgs& a, int c, int hh) {
  constexpr int VN = 16 / sizeof(T);             // elements in a 16-byte vector
  constexpr int VPR = D / VN;                    // vectors (lanes) per cache row
  constexpr int RPW = 32 / VPR;                  // rows a warp scores per step
  constexpr int SLICES = DB_THREADS / VPR;       // position slices of the P.V sum
  constexpr int WARPS = DB_THREADS / 32;
  const int len = a.kv_len[0];
  if (len < 0 || len >= a.cap) return;  // no room to append: nothing written, NaN out
  const int start = c * DB_CHUNK;
  const int total = len + 1;
  if (start >= total) return;
  const int n_pos = min(DB_CHUNK, total - start);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)hh * a.cap + start;  // row (of D elements) of position `start`
  T* kc = static_cast<T*>(a.k) + row0 * D;
  T* vc = static_cast<T*>(a.v) + row0 * D;

  __shared__ float qs[D], kn[D], vn[D];
  __shared__ float ps[DB_CHUNK];
  __shared__ float pv[SLICES][D];
  __shared__ float red_m, red_l;

  const T* k_new = static_cast<const T*>(a.k_new) + (size_t)hh * D;
  const T* v_new = static_cast<const T*>(a.v_new) + (size_t)hh * D;
  const int t_new = len - start;               // the new token's place in this chunk
  const bool holds_new = t_new < DB_CHUNK;
  if (holds_new) {
    for (int i = tid; i < D; i += DB_THREADS) {
      kn[i] = to_f32(k_new[i]);
      vn[i] = to_f32(v_new[i]);
    }
  }
  __syncthreads();
  if (holds_new) {  // append in place at position len
    for (int i = tid; i < D; i += DB_THREADS) {
      kc[(size_t)t_new * D + i] = k_new[i];
      vc[(size_t)t_new * D + i] = v_new[i];
    }
  }

  const int sub = lane % VPR, rw = lane / VPR;
  const int vi = tid % VPR, slice = tid / VPR;
  const T* q = static_cast<const T*>(a.q) + (size_t)hh * D;
  for (int i = tid; i < D; i += DB_THREADS) qs[i] = to_f32(q[i]);
  __syncthreads();

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
    if (sub == 0 && t < n_pos) ps[t] = s * a.sm_scale;
  }
  __syncthreads();

  if (warp == 0) {  // softmax statistics
    float mx = -INFINITY;
    for (int t = lane; t < n_pos; t += 32) mx = fmaxf(mx, ps[t]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int t = lane; t < DB_CHUNK; t += 32) {
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
    const float p = ps[t];
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] += p * f[e];
  }
#pragma unroll
  for (int e = 0; e < VN; ++e) pv[slice][vi * VN + e] = acc[e];
  __syncthreads();
  const size_t idx = (size_t)hh * a.nc + c;
  for (int i = tid; i < D; i += DB_THREADS) {
    float sum = 0.f;
#pragma unroll 4
    for (int sl = 0; sl < SLICES; ++sl) sum += pv[sl][i];
    a.part_acc[idx * D + i] = sum;
  }
  if (tid == 0) {
    a.part_m[idx] = red_m;
    a.part_l[idx] = red_l;
  }
  __syncthreads();
}

// Phase 2's item: head hh's combine by threads 0..D-1: the chunks'
// partials rescaled to their common maximum and normalised.
template <int D>
__device__ void combine_item(const SplitArgs& a, float* out, int hh) {
  const int tid = threadIdx.x;
  const int len = a.kv_len[0];
  float* dst = out + (size_t)hh * D;
  if (len < 0 || len >= a.cap) {  // no room to append: the output is NaN, never plausible
    dst[tid] = NAN;
    return;
  }
  const int n_valid = (len + DB_CHUNK) / DB_CHUNK;  // ceil((len + 1) / CHUNK)
  const size_t base = (size_t)hh * a.nc;
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

struct BlockArgs {
  SplitArgs kv;   // the attention of row 0 and its split scratch
  int h;          // heads
  float* attn;    // [H * D] f32 attention vector
  GemvArgs wo;    // attn -> h (f32 out_f32)
  GemvArgs up;    // h -> u (f32 out_f32)
  GemvArgs down;  // u -> out (+ f32 copy for the next qkv)
  GemvArgs qkv;   // out_f32 -> next qkv; qkv.w null: no phase 6
};

// One GEMV phase of one row: the blocks that own columns normalise the row
// into shared memory and stride over their columns.
__device__ __forceinline__ void gemv_phase(const GemvArgs& a, float* xs) {
  if ((int)blockIdx.x * GEMV_WARPS >= a.n) return;
  gemv_prologue<1, true>(a, xs);
  gemv_body<1, 1>(a, xs);
}

template <typename T, int D>
__global__ void __launch_bounds__(DB_THREADS) decode_block_kernel(BlockArgs p) {
  extern __shared__ float4 db_smem[];
  float* xs = reinterpret_cast<float*>(db_smem);
  cg::grid_group grid = cg::this_grid();
  const SplitArgs& kv = p.kv;
  const int len = kv.kv_len[0];
  const int items = (len >= 0 && len < kv.cap) ? (len + DB_CHUNK) / DB_CHUNK * p.h : 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    split_item<T, D>(kv, i / p.h, i % p.h);
    __syncthreads();  // the next item reuses the shared buffers
  }
  grid.sync();
  for (int hh = blockIdx.x; hh < p.h; hh += gridDim.x) {
    if ((int)threadIdx.x < D) combine_item<D>(kv, p.attn, hh);
  }
  grid.sync();
  gemv_phase(p.wo, xs);
  grid.sync();
  gemv_phase(p.up, xs);
  grid.sync();
  gemv_phase(p.down, xs);
  if (p.qkv.w != nullptr) {
    grid.sync();
    gemv_phase(p.qkv, xs);
  }
}

// Resident blocks a launch uses: min(occupancy, DB_BLOCKS_PER_SM) per SM,
// cached per (device, dynamic shared memory).
template <typename T, int D>
cudaError_t block_grid(size_t smem, int& grid) {
  static int cached_grid[64] = {0};
  static size_t cached_smem[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached_grid[dev] == 0 || cached_smem[dev] != smem) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(decode_block_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    int sms = 0, per_sm = 0, coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_block_kernel<T, D>, DB_THREADS, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached_grid[dev] = (per_sm < DB_BLOCKS_PER_SM ? per_sm : DB_BLOCKS_PER_SM) * sms;
    cached_smem[dev] = smem;
  }
  grid = cached_grid[dev];
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_block(BlockArgs& p, size_t smem, cudaStream_t st) {
  int grid = 0;
  const cudaError_t e = block_grid<T, D>(smem, grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(decode_block_kernel<T, D>), dim3(grid),
                                     dim3(DB_THREADS), args, smem, st);
}

bool gemv_ok(const GemvArgs& a) {
  const auto mis = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  return a.k % 16 == 0 && a.n >= 1 && !mis(a.x) && !mis(a.w) && !(a.norm && mis(a.norm_scale)) &&
         !(a.norm_bias && mis(a.norm_bias));
}

}  // namespace
}  // namespace rt

extern "C" int rt_decode_block(
    const void* qkv, int bf16, int h, int d,
    void* k_cache, void* v_cache, int s_max, const int* kv_len,
    float* part_m, float* part_l, float* part_acc, float* attn, int n_chunks,
    const int8_t* wo_t, const float* wo_scales, const float* wo_bias, int dm,
    const void* residual, float* h_buf,
    const int8_t* w_up_t, const float* s_up, const float* b_up, int ff, float* u_buf,
    const int8_t* w_down_t, const float* s_down, const float* b_down,
    const float* ln2_scale, const float* ln2_bias, int norm, float eps, int act,
    void* out, float* out_f32,
    const int8_t* w_qkv_t, const float* s_qkv, const float* b_qkv, int nq,
    const float* next_scale, const float* next_bias, void* qkv_out,
    float sm_scale, void* stream) {
  if (h < 1 || s_max < 1 || n_chunks * rt::DB_CHUNK < s_max || (norm != 1 && norm != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rt::BlockArgs p{};
  // The packed [1, 3 * H * D] q|k|v as the three operands of the MHA split.
  const size_t part_bytes = (size_t)h * d * (bf16 ? 2 : 4);
  const char* packed = static_cast<const char*>(qkv);
  rt::SplitArgs& kv = p.kv;
  kv.q = packed;
  kv.k_new = packed + part_bytes;
  kv.v_new = packed + 2 * part_bytes;
  kv.k = k_cache;
  kv.v = v_cache;
  kv.kv_len = kv_len;
  kv.cap = s_max;
  kv.nc = n_chunks;
  kv.part_m = part_m;
  kv.part_l = part_l;
  kv.part_acc = part_acc;
  kv.sm_scale = sm_scale;
  p.h = h;
  p.attn = attn;

  rt::GemvArgs& wo = p.wo;  // f32 attention vector times the int8 W_o, as in decode_attention.cu
  wo.x = attn;
  wo.m = 1;
  wo.w = wo_t;
  wo.scale = wo_scales;
  wo.n = dm;
  wo.k = h * d;
  wo.bias = wo_bias;
  wo.residual = residual;
  wo.out_bf16 = bf16;  // the residual's dtype; the output is the f32 scratch alone
  wo.out_f32 = h_buf;

  rt::GemvArgs& up = p.up;
  up.x = h_buf;
  up.m = 1;
  up.w = w_up_t;
  up.scale = s_up;
  up.n = ff;
  up.k = dm;
  up.bias = b_up;
  up.norm_scale = ln2_scale;
  up.norm_bias = ln2_bias;
  up.norm = norm;
  up.eps = eps;
  up.dot_bf16 = bf16;
  up.act = act;
  up.out_f32 = u_buf;

  rt::GemvArgs& down = p.down;
  down.x = u_buf;
  down.m = 1;
  down.w = w_down_t;
  down.scale = s_down;
  down.n = dm;
  down.k = ff;
  down.bias = b_down;
  down.dot_bf16 = bf16;
  down.residual = h_buf;  // the block residual: the f32 h
  down.res_f32 = 1;
  down.out = out;
  down.out_bf16 = bf16;
  down.out_f32 = w_qkv_t ? out_f32 : nullptr;

  if (w_qkv_t) {
    rt::GemvArgs& q = p.qkv;
    q.x = out_f32;
    q.m = 1;
    q.w = w_qkv_t;
    q.scale = s_qkv;
    q.n = nq;
    q.k = dm;
    q.bias = b_qkv;
    q.norm_scale = next_scale;
    q.norm_bias = next_bias;
    q.norm = norm;
    q.eps = eps;
    q.dot_bf16 = bf16;
    q.out = qkv_out;
    q.out_bf16 = bf16;
  }
  if (!rt::gemv_ok(wo) || !rt::gemv_ok(up) || !rt::gemv_ok(down) || (w_qkv_t && !rt::gemv_ok(p.qkv))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int kmax = h * d > dm ? h * d : dm;
  kmax = kmax > ff ? kmax : ff;
  const size_t smem = (size_t)kmax * sizeof(float);
  if (smem > rt::MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  cudaError_t e;
  if (d == 64) {
    e = bf16 ? rt::launch_block<BF, 64>(p, smem, st) : rt::launch_block<float, 64>(p, smem, st);
  } else if (d == 128) {
    e = bf16 ? rt::launch_block<BF, 128>(p, smem, st) : rt::launch_block<float, 128>(p, smem, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
