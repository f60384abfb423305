// quant_mlp_int8: a whole transformer-MLP decode step (M <= 8),
//
//     out = norm(x) @ W_up (+b) -> activation -> @ W_down (+b) + residual
//
// and, optionally, the next layer's pre-norm + qkv projection of the block
// output.
//
// Replaces rten_tpu/kernels/quant_matmul.py quant_mlp_int8 (:935; Pallas
// kernel _mlp_kernel :863), which holds both int8 matrices in VMEM and runs
// gridless. On the GPU the down projection needs the whole up output, a
// dependency across blocks, so this entry point launches three phases of
// gemv_kernel (gemv.cuh) on one stream:
//   1. up: ln2 prologue, bias and GELU epilogue, into an f32 [M, FF]
//      scratch (12 KB a row, resident in L2 for phase 2);
//   2. down: reads that scratch (rounded to bf16 before the dot when the
//      model runs bf16, as the TPU's _qdot casts it), bias and residual,
//      writes the output and, when phase 3 runs, an f32 copy of it;
//   3. next qkv: the next layer's ln1 over the f32 block output (not its
//      rounded copy: the TPU kernel normalises the f32 value,
//      quant_matmul.py:914), bias.
//
// Bound on the H100: bytes, the three int8 weight streams (2.36 + 2.36 +
// 1.77 MB on GPT-2-small). Each phase is a weight-streaming GEMV; the
// intermediates are a few KB and stay in L2.

#include "gemv.cuh"

extern "C" int rt_quant_mlp(
    const void* x, int bf16, int m, int d,
    const int8_t* w_up_t, const float* s_up, const float* b_up, int ff,
    const int8_t* w_down_t, const float* s_down, const float* b_down,
    const float* norm_scale, const float* norm_bias, int norm, float eps, int act,
    const void* residual, void* out, float* up_buf, float* h_buf,
    const int8_t* w_qkv_t, const float* s_qkv, const float* b_qkv, int nq,
    const float* next_norm_scale, const float* next_norm_bias, void* qkv_out,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  rt::GemvArgs up{};
  up.x = x;
  up.x_bf16 = bf16;
  up.m = m;
  up.w = w_up_t;
  up.scale = s_up;
  up.n = ff;
  up.k = d;
  up.bias = b_up;
  up.norm_scale = norm_scale;
  up.norm_bias = norm_bias;
  up.norm = norm;
  up.eps = eps;
  up.dot_bf16 = bf16;
  up.act = act;
  up.out_f32 = up_buf;
  cudaError_t e = rt::launch_gemv(up, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  rt::GemvArgs down{};
  down.x = up_buf;
  down.x_bf16 = 0;
  down.m = m;
  down.w = w_down_t;
  down.scale = s_down;
  down.n = d;
  down.k = ff;
  down.bias = b_down;
  down.dot_bf16 = bf16;
  down.residual = residual;
  down.out = out;
  down.out_bf16 = bf16;
  down.out_f32 = w_qkv_t ? h_buf : nullptr;
  e = rt::launch_gemv(down, st);
  if (e != cudaSuccess || w_qkv_t == nullptr) return static_cast<int>(e);

  rt::GemvArgs qkv{};
  qkv.x = h_buf;
  qkv.x_bf16 = 0;
  qkv.m = m;
  qkv.w = w_qkv_t;
  qkv.scale = s_qkv;
  qkv.n = nq;
  qkv.k = d;
  qkv.bias = b_qkv;
  qkv.norm_scale = next_norm_scale;
  qkv.norm_bias = next_norm_bias;
  qkv.norm = norm;
  qkv.eps = eps;
  qkv.dot_bf16 = bf16;
  qkv.out = qkv_out;
  qkv.out_bf16 = bf16;
  return static_cast<int>(rt::launch_gemv(qkv, st));
}
