"""``matmul_fused``: a dense matmul with the bias and the activation fused
into its epilogue, beside its plain PyTorch version.

Counterpart of ``rten_tpu/kernels/matmul_pallas.py`` ``matmul_fused``
(:102; Pallas kernel ``_matmul_kernel`` :58): ``activation(x @ w + bias)``
with x [M, K] and w [K, N] dense, f32 accumulation, the bias added in f32
and the activation applied once after the whole K sum, then one rounding to
the output dtype. The TPU function pads every operand to its blocks; the
port takes any M, N and K and masks the edges in the kernel.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels.activations import ACTIVATIONS, activation_code
from rten_tpu_torch.kernels.dispatch import LAUNCHES, PLAIN, use_kernel
from rten_tpu_torch.kernels.quant_matmul import _ptr, _stream, _vec_f32


def matmul_fused_ref(x, w, bias=None, *, activation=None, out_dtype=None):
    """Plain version of ``matmul_fused`` (same signature and result): the
    product of the operands in f32, ``+ bias``, the activation, then
    ``out_dtype``."""
    PLAIN["matmul_fused"] += 1
    out = x.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    return ACTIVATIONS[activation](out).to(out_dtype or x.dtype)


def matmul_fused(x, w, bias=None, *, activation=None, out_dtype=None):
    """``activation(x @ w + bias)``.

    x: [M, K] and w: [K, N], both f32 or both bf16; bias [N]; any M, N, K.
    Returns [M, N] in ``out_dtype`` (default x.dtype). Sums are f32; the
    order is ``acc → + bias → activation → out_dtype``; the activations are
    those of ``kernels.activations`` (none, relu, gelu, silu, sigmoid,
    tanh).

    CUDA tensors launch ``csrc/matmul_fused.cu``: bf16 operands on the
    tensor cores (``mma.sync``, f32 accumulation), f32 operands as f32 FMA
    on the CUDA cores (not TF32). CPU tensors run ``matmul_fused_ref``."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_fused expects x [M, K] and w [K, N], got {tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if not use_kernel(x, w, bias):
        return matmul_fused_ref(x, w, bias, activation=activation, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"matmul_fused: x and w must both be float32 or both bfloat16, got {x.dtype}, {w.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul_fused: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_fused: x and w must be contiguous")
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"matmul_fused: empty operands {tuple(x.shape)} @ {tuple(w.shape)}")
    b = _vec_f32(bias, n, "matmul_fused bias")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rc = _build.library().rt_matmul_fused(
        x.data_ptr(), w.data_ptr(), _ptr(b), int(x.dtype == torch.bfloat16), m, n, k,
        activation_code(activation), out.data_ptr(), int(out_dtype == torch.bfloat16), _stream(x),
    )
    _build.check(rc, "matmul_fused")
    LAUNCHES["matmul_fused"] += 1
    return out
