// paged_decode_attention_int8: paged_decode_attention over int8 pages
// [n_pages, Hk, page, D] with f32 scale pages [n_pages, Hk, page] (MHA or
// grouped-query); the new token is quantized per kv head (absmax / 127,
// round half to even) and appended with its scale into the page that holds
// kv_len.
//
// Replaces rten_tpu/kernels/paged_attention.py paged_decode_attention_int8
// (:413; Pallas kernel _paged_attn_int8_kernel :228), MHA and GQA.
// Clustered split-KV design and bound in kv_attention.cuh: the page table of
// paged_attention.cu and the in-kernel quantization of
// decode_attention_int8.cu together.

#include "kv_attention.cuh"

extern "C" int rt_paged_attention_int8(
    const void* q, const void* k_new, const void* v_new,
    long long q_stride, long long kn_stride, long long vn_stride,
    int bf16, int b, int hq, int hk, int d,
    void* k_pages, void* v_pages, float* k_scale_pages, float* v_scale_pages, int n_pages, int page,
    const int* table, int max_pages, const int* kv_len,
    int split, void* out, float sm_scale, void* stream) {
  rt::KvArgs a = rt::kv_args(q, k_new, v_new, q_stride, kn_stride, vn_stride, hq, hk, kv_len, sm_scale);
  a.k = k_pages;
  a.v = v_pages;
  a.k_scale = k_scale_pages;
  a.v_scale = v_scale_pages;
  a.table = table;
  a.cap = max_pages * page;
  a.page = page;
  a.max_pages = max_pages;
  a.n_pages = n_pages;
  return rt::run_kv_attention<true, true>(a, bf16, b, d, out, split, stream);
}

extern "C" int rt_paged_attention_int8_clusters(int bf16, int d, int gqa, int split) {
  return rt::kv_clusters<true, true>(bf16, d, gqa, split);
}
