// decode_attention_int8: one query token per row against an int8 KV cache
// [B, H, S, D] with one f32 scale per (token, head) [B, H, S]; the new
// token is quantized per head (absmax / 127, round half to even), appended
// in place at kv_len with its scale, and its dequantized value seeds the
// softmax.
//
// Replaces rten_tpu/kernels/decode_attention.py decode_attention_int8
// (:1667; Pallas kernel _decode_attn_int8_kernel :1230) in its per-row mode
// (not batched). The TPU wrapper quantizes the new token outside the kernel
// and splices its scale after it; here the block whose chunk holds kv_len
// does both. Split-KV design and bound in kv_attention.cuh; the payload is
// dequantized in f32 inside the kernel; wo is left to the GEMV, as on the
// TPU path.

#include "kv_attention.cuh"

extern "C" int rt_decode_attention_int8(
    const void* qkv, int bf16, int b, int h, int d,
    void* k_cache, void* v_cache, float* k_scale, float* v_scale, int s_max, const int* kv_len,
    float* part_m, float* part_l, float* part_acc, int n_chunks,
    void* out, float sm_scale, void* stream) {
  rt::KvArgs a{qkv, k_cache, v_cache, k_scale, v_scale, kv_len, nullptr, h, s_max,
               0, 0, 0, n_chunks, part_m, part_l, part_acc, sm_scale};
  return rt::run_kv_attention<true, false>(a, bf16, b, d, out, stream);
}
