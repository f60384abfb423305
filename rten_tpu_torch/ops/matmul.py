"""MatMul and Gemm: counterpart of ``rten_tpu/ops/matmul.py``.

The JAX package runs these as plain XLA dots at ``Precision.HIGHEST`` for
f32 operands (``rten_tpu/kernels/dispatch.py`` ``precision_for``,
``matmul``), outside any Pallas kernel; here they are ``torch.matmul`` in
IEEE f32 (``models.ieee``: no TF32). Integer operands sum exactly: CUDA
PyTorch has no integer matmul, so the product runs in f64 (exact for any
sum below 2^53, every int8 / uint8 one of a realistic K) and wraps to
int32 as the JAX package's int32 accumulation does.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.models import ieee
from rten_tpu_torch.ops.elementwise import promote
from rten_tpu_torch.ops.layout import permute
from rten_tpu_torch.ops.registry import OpError, register


def matmul(a, b):
    """Batched matmul with numpy semantics, in the operands' common dtype:
    IEEE f32 (or the float dtype), or exact integer sums as int32."""
    a, b = promote(a, b)
    if a.dtype.is_floating_point:
        return ieee.matmul(a, b)
    return torch.matmul(a.double(), b.double()).to(torch.int64).to(torch.int32)


@register("MatMul")
def matmul_op(ctx, attrs, a, b):
    # Absorbed input permutations (the optimizer's transpose absorption):
    # "reverse" is the ONNX Transpose default (reverse all dims).
    perm_a = attrs.get("perm_a")
    perm_b = attrs.get("perm_b")
    if perm_a is not None:
        a = permute(a, perm_a)
    if perm_b is not None:
        b = permute(b, perm_b)
    if a.dim() == 0 or b.dim() == 0:
        raise OpError("MatMul inputs must be at least 1-D")
    return matmul(a, b)


@register("Gemm")
def gemm(ctx, attrs, a, b, c=None):
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transpose_a", False):
        a = a.t()
    if attrs.get("transpose_b", False):
        b = b.t()
    out = matmul(a, b)
    if alpha != 1.0:
        out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out
