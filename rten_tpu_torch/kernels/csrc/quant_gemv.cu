// quant_gemv_int8: the decode GEMV (M <= 8) with fused pre-norm and a
// bias / activation / residual epilogue, or the fused greedy argmax.
//
// Replaces rten_tpu/kernels/quant_matmul.py quant_gemv_int8 (:339; Pallas
// kernels _gemv_kernel :201 and _gemv_epilogue :159). On the decode path it
// computes layer 0's qkv (ln1 fused) and the lm_head (final norm fused, and
// the argmax over the vocabulary in greedy decoding).
//
// Bound on the H100: bytes, the int8 weight stream (the lm_head of
// GPT-2-small streams 51200 x 768 bytes per token). The kernel is
// gemv_kernel of gemv.cuh, whose notes give the design; the argmax takes a
// second launch over the per-block partials.

#include "gemv.cuh"

extern "C" int rt_max_blocks() { return rt::max_blocks(); }

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int rt_quant_gemv(
    const void* x, int x_bf16, int m,
    const int8_t* w_t, const float* scales, int n, int k,
    const float* bias, const float* norm_scale, const float* norm_bias, int norm, float eps,
    int act, const void* residual, void* out, int out_bf16,
    int argmax_n, float* part_max, int* part_idx, int* argmax_out,
    void* stream) {
  rt::GemvArgs a{};
  a.x = x;
  a.x_bf16 = x_bf16;
  a.m = m;
  a.w = w_t;
  a.scale = scales;
  a.n = n;
  a.k = k;
  a.bias = bias;
  a.norm_scale = norm_scale;
  a.norm_bias = norm_bias;
  a.norm = norm;
  a.eps = eps;
  a.dot_bf16 = x_bf16;  // the dot runs in the activations' dtype
  a.act = act;
  a.residual = residual;
  a.out = out;
  a.out_bf16 = out_bf16;
  a.argmax_n = argmax_n;
  a.part_max = part_max;
  a.part_idx = part_idx;
  a.argmax_out = argmax_out;
  return static_cast<int>(rt::launch_gemv(a, static_cast<cudaStream_t>(stream)));
}
