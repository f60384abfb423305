// decode_attention_int8: one query token per row against an int8 KV cache
// [B, Hk, S, D] with one f32 scale per (token, kv head) [B, Hk, S] (Hq
// query heads over Hk kv heads: MHA or grouped-query); the new token is
// quantized per kv head (absmax / 127, round half to even), appended in
// place at kv_len with its scale, and its dequantized value seeds the
// softmax.
//
// Replaces rten_tpu/kernels/decode_attention.py decode_attention_int8
// (:1667; Pallas kernel _decode_attn_int8_kernel :1230) in its per-row mode
// (not batched), MHA and GQA. The TPU wrapper quantizes the new token
// outside the kernel and splices its scale after it; here the rank whose
// chunk holds kv_len does both, once per kv head. Split-KV design and bound
// in kv_attention.cuh; the payload is dequantized in f32 inside the kernel;
// wo is left to the GEMV, as on the TPU path.

#include "kv_attention.cuh"

extern "C" int rt_decode_attention_int8(
    const void* q, const void* k_new, const void* v_new,
    long long q_stride, long long kn_stride, long long vn_stride,
    int bf16, int b, int hq, int hk, int d,
    void* k_cache, void* v_cache, float* k_scale, float* v_scale, int s_max, const int* kv_len,
    int split, void* out, float sm_scale, void* stream) {
  rt::KvArgs a = rt::kv_args(q, k_new, v_new, q_stride, kn_stride, vn_stride, hq, hk, kv_len, sm_scale);
  a.k = k_cache;
  a.v = v_cache;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.cap = s_max;
  return rt::run_kv_attention<true, false>(a, bf16, b, d, out, split, stream);
}

extern "C" int rt_decode_attention_int8_clusters(int bf16, int d, int gqa, int split) {
  return rt::kv_clusters<true, false>(bf16, d, gqa, split);
}
