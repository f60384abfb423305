// paged_decode_attention: one query token per row against KV pages of a
// shared pool [n_pages, Hk, page, D] (bf16 or f32), found through a
// [B, max_pages] page table (Hq query heads over Hk kv heads: MHA or
// grouped-query), with the new token's k/v appended in place into the page
// that holds position kv_len.
//
// Replaces rten_tpu/kernels/paged_attention.py paged_decode_attention
// (:592; Pallas kernel _paged_attn_kernel :34), MHA and GQA. The clustered
// split-KV kernel is kv_attention.cuh's (design and bound there); wo is left to
// the GEMV, as the TPU path leaves it to _fproj. A row of length 0 points
// its table at the pool's scratch page, so its append lands in memory no
// row reads.

#include "kv_attention.cuh"

extern "C" int rt_paged_attention(
    const void* q, const void* k_new, const void* v_new,
    long long q_stride, long long kn_stride, long long vn_stride,
    int bf16, int b, int hq, int hk, int d,
    void* k_pages, void* v_pages, int n_pages, int page,
    const int* table, int max_pages, const int* kv_len,
    int split, void* out, float sm_scale, void* stream) {
  rt::KvArgs a = rt::kv_args(q, k_new, v_new, q_stride, kn_stride, vn_stride, hq, hk, kv_len, sm_scale);
  a.k = k_pages;
  a.v = v_pages;
  a.table = table;
  a.cap = max_pages * page;
  a.page = page;
  a.max_pages = max_pages;
  a.n_pages = n_pages;
  return rt::run_kv_attention<false, true>(a, bf16, b, d, out, split, stream);
}

extern "C" int rt_paged_attention_clusters(int bf16, int d, int gqa, int split) {
  return rt::kv_clusters<false, true>(bf16, d, gqa, split);
}
