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
// phase's work items by gridDim.x, through the same device functions as the
// separate kernels:
//   1. the split-KV items (chunk, head) of kv_attention.cuh (kv_split_item),
//      the block whose chunk holds kv_len appending the new token;
//   2. the combine of each head (kv_combine_item) into the f32 attention
//      vector;
//   3. wo: gemv_prologue + gemv_body (gemv.cuh) on that vector, f32 dot,
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

#include <cooperative_groups.h>

#include "gemv.cuh"
#include "kv_attention.cuh"

namespace rt {
namespace {

namespace cg = cooperative_groups;

constexpr int DB_THREADS = 128;
constexpr int DB_BLOCKS_PER_SM = 4;
static_assert(DB_THREADS == KV_THREADS && DB_THREADS == GEMV_THREADS, "one block shape for every phase");

struct BlockArgs {
  KvArgs kv;      // the attention of row 0; kv.part_* scratch
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
  gemv_body<1, 1, false>(a, xs, nullptr, nullptr);
}

template <typename T, int D>
__global__ void __launch_bounds__(DB_THREADS) decode_block_kernel(BlockArgs p) {
  extern __shared__ float4 db_smem[];
  float* xs = reinterpret_cast<float*>(db_smem);
  cg::grid_group grid = cg::this_grid();
  const KvArgs& kv = p.kv;
  const int len = kv.kv_len[0];
  const int items = (len >= 0 && len < kv.cap) ? (len + KV_CHUNK) / KV_CHUNK * kv.hk : 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    kv_split_item<T, T, D, false, 1>(kv, i / kv.hk, i % kv.hk, 0);
    __syncthreads();  // the next item reuses the shared buffers
  }
  grid.sync();
  for (int hh = blockIdx.x; hh < kv.hq; hh += gridDim.x) {
    if ((int)threadIdx.x < D) kv_combine_item<float, D>(kv, p.attn, hh, 0);
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
  if (h < 1 || s_max < 1 || n_chunks * rt::KV_CHUNK < s_max || (norm != 1 && norm != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rt::BlockArgs p{};
  // The packed [1, 3 * H * D] q|k|v as the three operands of the MHA split.
  const size_t part_bytes = (size_t)h * d * (bf16 ? 2 : 4);
  const char* packed = static_cast<const char*>(qkv);
  p.kv = rt::kv_args(packed, packed + part_bytes, packed + 2 * part_bytes, 3LL * h * d, 3LL * h * d,
                     3LL * h * d, h, h, kv_len, part_m, part_l, part_acc, n_chunks, sm_scale);
  p.kv.k = k_cache;
  p.kv.v = v_cache;
  p.kv.cap = s_max;
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
