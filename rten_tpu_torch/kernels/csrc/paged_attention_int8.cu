// paged_decode_attention_int8: paged_decode_attention over int8 pages
// [n_pages, H, page, D] with f32 scale pages [n_pages, H, page]; the new
// token is quantized per head (absmax / 127, round half to even) and
// appended with its scale into the page that holds kv_len.
//
// Replaces rten_tpu/kernels/paged_attention.py paged_decode_attention_int8
// (:413; Pallas kernel _paged_attn_int8_kernel :228). Split-KV design and
// bound in kv_attention.cuh: the page table of paged_attention.cu and the
// in-kernel quantization of decode_attention_int8.cu together.

#include "kv_attention.cuh"

extern "C" int rt_paged_attention_int8(
    const void* qkv, int bf16, int b, int h, int d,
    void* k_pages, void* v_pages, float* k_scale_pages, float* v_scale_pages, int n_pages, int page,
    const int* table, int max_pages, const int* kv_len,
    float* part_m, float* part_l, float* part_acc, int n_chunks,
    void* out, float sm_scale, void* stream) {
  rt::KvArgs a{qkv, k_pages, v_pages, k_scale_pages, v_scale_pages, kv_len, table, h,
               max_pages * page, page, max_pages, n_pages, n_chunks, part_m, part_l, part_acc,
               sm_scale};
  return rt::run_kv_attention<true, true>(a, bf16, b, d, out, stream);
}
