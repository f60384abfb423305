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
//   1-2. kv_attention.cuh's split-KV pair over the contiguous cache
//      (blocks of 64 positions of the valid prefix scored in f32, the block
//      holding kv_len appending k_new / v_new there; a combine launch),
//      giving the f32 attention vector;
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
#include "kv_attention.cuh"

extern "C" int rt_decode_attention(
    const void* qkv, int bf16, int b, int h, int d,
    void* k_cache, void* v_cache, int s_max, const int* kv_len,
    float* part_m, float* part_l, float* part_acc, float* attn, int n_chunks,
    const int8_t* wo_t, const float* wo_scales, const float* wo_bias, int dm,
    const void* residual, void* out, float sm_scale,
    void* stream) {
  if (b > rt::MAXM) return static_cast<int>(cudaErrorInvalidValue);
  rt::KvArgs a{qkv, k_cache, v_cache, nullptr, nullptr, kv_len, nullptr, h, s_max,
               0, 0, 0, n_chunks, part_m, part_l, part_acc, sm_scale};
  const int e = rt::run_kv_attention<false, false, true>(a, bf16, b, d, attn, stream);
  if (e != 0) return e;

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
  return static_cast<int>(rt::launch_gemv(g, static_cast<cudaStream_t>(stream)));
}
