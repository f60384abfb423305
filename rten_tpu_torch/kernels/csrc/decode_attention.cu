// decode_attention: one query token per row against a preallocated KV cache
// [B, Hk, S, D] (Hq query heads over Hk kv heads: MHA or grouped-query), with
// the new token's k/v appended in place at kv_len and, optionally, the int8
// output projection, its bias and the residual fused in.
//
// Replaces rten_tpu/kernels/decode_attention.py decode_attention (:734;
// Pallas kernel _decode_attn_kernel :83) in its three decode-step modes: the
// packed-qkv fused-wo mode of MHA models (three views of the packed buffer
// here), the unpacked q / k_new / v_new fused-wo mode with GQA of the RoPE
// and GQA models, and the mode without wo, which returns the attention
// vector (the JAX decoder takes it when the step is not fused).
// On the TPU one grid cell per row walks the valid prefix in order with a
// running online softmax and a double-buffered DMA. Here one or two
// launches on one stream:
//   1. kv_attention.cuh's clustered split-KV kernel over the contiguous
//      cache (a cluster of C blocks a (kv head, row), the group's query
//      heads scored in one pass over each 64-position chunk, the rank whose
//      chunk holds kv_len appending k_new / v_new there, the ranks' partial
//      softmax states combined through distributed shared memory), giving
//      the attention vector (f32 for the fused wo, else in the activations'
//      dtype);
//   2. with wo: gemv_kernel (gemv.cuh): attn @ W_o * s + bias + residual,
//      the dot in f32 as on the TPU (the attention vector is not rounded;
//      its f32 mode, quant_matmul.py gemv_plan the plan). Fusing it into
//      the attention launch needs every head's vector, a grid-wide
//      dependency; it stays its own launch.
//
// Bound on the H100: bytes, the valid KV prefix (2 * Hk * (kv_len + 1) * D
// elements) plus the int8 W_o (Hq*D x Dm). Design and its reasons in
// kv_attention.cuh; all softmax statistics and sums are f32.

#include "gemv.cuh"
#include "kv_attention.cuh"

extern "C" int rt_decode_attention(
    const void* q, const void* k_new, const void* v_new,
    long long q_stride, long long kn_stride, long long vn_stride,
    int bf16, int b, int hq, int hk, int d,
    void* k_cache, void* v_cache, int s_max, const int* kv_len,
    float* attn, int split,
    const int8_t* wo_t, const float* wo_scales, const float* wo_bias, int dm,
    const void* residual, void* out, float sm_scale,
    const int* wo_plan, int* work, void* stream) {
  rt::KvArgs a = rt::kv_args(q, k_new, v_new, q_stride, kn_stride, vn_stride, hq, hk, kv_len, sm_scale);
  a.k = k_cache;
  a.v = v_cache;
  a.cap = s_max;
  if (wo_t == nullptr) {  // the attention vector alone, in the activations' dtype
    return rt::run_kv_attention<false, false>(a, bf16, b, d, out, split, stream);
  }
  if (b > rt::MAXM) return static_cast<int>(cudaErrorInvalidValue);
  const int e = rt::run_kv_attention<false, false, true>(a, bf16, b, d, attn, split, stream);
  if (e != 0) return e;

  rt::GvArgs g{};
  g.phases = 1;
  g.m = b;
  rt::GvPhase& p = g.ph[0];
  p.x = attn;
  p.x_bf16 = 0;
  p.w = wo_t;
  p.scale = wo_scales;
  p.n = dm;
  p.k = hq * d;
  p.bias = wo_bias;
  p.residual = residual;
  p.out = out;
  p.out_bf16 = bf16;
  // The f32 attention vector times the int8 weights, as on the TPU.
  return static_cast<int>(rt::launch_gemv(g, rt::DOT_F32, wo_plan, work, static_cast<cudaStream_t>(stream)));
}

// The cluster capacity of the kernel a call of (bf16, d, gqa, with wo)
// launches, for attention.py kv_plan.
extern "C" int rt_decode_attention_clusters(int bf16, int d, int gqa, int with_wo, int split) {
  return with_wo ? rt::kv_clusters<false, false, true>(bf16, d, gqa, split)
                 : rt::kv_clusters<false, false>(bf16, d, gqa, split);
}
