// quant_gemv_int8: the decode GEMV (M <= 8) with fused pre-norm and a
// bias / activation / residual epilogue, or the fused greedy argmax, in one
// launch.
//
// Replaces rten_tpu/kernels/quant_matmul.py quant_gemv_int8 (:339; Pallas
// kernels _gemv_kernel :201 and _gemv_epilogue :159). On the decode path it
// computes layer 0's qkv (ln1 fused), the wo after flash attention, a
// SwiGLU layer's gate|up (ln2 fused) and down, an MLP past the fused
// budget, and the lm_head (final norm fused, and the argmax over the
// vocabulary in greedy decoding).
//
// With w8a8 it also replaces the W8A8 branch of _gemv_kernel (:224-261):
// the rows are quantized per row to int8 in the prologue and the dots are
// s8 x s8 -> s32 on the tensor cores.
//
// Bound on the H100: bytes, the int8 weight stream (the lm_head of
// GPT-2-small streams 51200 x 768 bytes per token). The kernel is
// gemv_kernel of gemv.cuh, whose notes give the design; quant_matmul.py
// gemv_plan gives its plan.

#include "gemv.cuh"

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int rt_quant_gemv(
    const void* x, int x_bf16, int m,
    const int8_t* w_t, const float* scales, int n, int k, int w8a8,
    const float* bias, const float* norm_scale, const float* norm_bias, int norm, float eps,
    int act, const void* residual, void* out, int out_bf16,
    int argmax_n, int* argmax_out, const int* plan, int* work,
    void* stream) {
  rt::GvArgs a{};
  a.phases = 1;
  a.m = m;
  rt::GvPhase& p = a.ph[0];
  p.x = x;
  p.x_bf16 = x_bf16;
  p.w = w_t;
  p.scale = scales;
  p.n = n;
  p.k = k;
  p.bias = bias;
  p.norm_scale = norm_scale;
  p.norm_bias = norm_bias;
  p.norm = norm;
  p.eps = eps;
  p.act = act;
  p.residual = residual;
  p.out = out;
  p.out_bf16 = out_bf16;
  p.argmax_n = argmax_n;
  p.argmax_out = argmax_out;
  // The dot runs in the activations' dtype (bf16 or f32), or on codes.
  const int dot = w8a8 ? rt::DOT_S8 : x_bf16 ? rt::DOT_BF16 : rt::DOT_F32;
  return static_cast<int>(rt::launch_gemv(a, dot, plan, work, static_cast<cudaStream_t>(stream)));
}
