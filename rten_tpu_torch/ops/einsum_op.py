"""Einsum: counterpart of ``rten_tpu/ops/einsum_op.py``. The JAX package
hands the whole contraction to XLA at ``Precision.HIGHEST`` for f32; here
it is ``torch.einsum`` in IEEE f32 (``models.ieee``), in the operands'
common dtype.
"""

from __future__ import annotations

import torch

from rten_tpu_torch.models.ieee import ieee_f32
from rten_tpu_torch.ops.elementwise import promote
from rten_tpu_torch.ops.registry import OpError, register


@register("Einsum")
def einsum(ctx, attrs, *xs):
    equation = attrs.get("equation")
    if not equation:
        raise OpError("Einsum requires an equation")
    with ieee_f32():
        return torch.einsum(equation.replace(" ", ""), *promote(*xs))
