"""Quantization ops: counterpart of ``rten_tpu/ops/quant.py``, ONNX
QuantizeLinear / DequantizeLinear / DynamicQuantizeLinear / QLinearMatMul.

QLinearMatMul sums its zero-point-shifted integer operands exactly
(``ops.matmul.matmul``: f64 products on every device, wrapped to int32 like
the JAX package's int32 accumulation) and rescales in f32. Every division
takes a tensor divisor (IEEE on every device).
"""

from __future__ import annotations

import torch

from rten_tpu_torch.ops.matmul import matmul
from rten_tpu_torch.ops.registry import register


def _qrange(dtype):
    info = torch.iinfo(dtype)
    return info.min, info.max


def _per_axis_shape(scale, x_ndim: int, axis: int):
    if scale.dim() == 0:
        return scale
    shape = [1] * x_ndim
    shape[axis % x_ndim] = scale.shape[0]
    return scale.reshape(shape)


@register("QuantizeLinear")
def quantize_linear(ctx, attrs, x, scale, zero_point=None):
    axis = attrs.get("axis", 1)
    out_dtype = zero_point.dtype if zero_point is not None else torch.uint8
    s = _per_axis_shape(scale, x.dim(), axis)
    q = torch.round(x / s)
    if zero_point is not None:
        q = q + _per_axis_shape(zero_point, x.dim(), axis).to(q.dtype)
    lo, hi = _qrange(out_dtype)
    return torch.clamp(q, lo, hi).to(out_dtype)


@register("DequantizeLinear")
def dequantize_linear(ctx, attrs, x, scale, zero_point=None):
    axis = attrs.get("axis", 1)
    s = _per_axis_shape(scale, x.dim(), axis)
    xf = x.to(torch.float32)
    if zero_point is not None:
        xf = xf - _per_axis_shape(zero_point, x.dim(), axis).to(torch.float32)
    return xf * s


@register("DynamicQuantizeLinear")
def dynamic_quantize_linear(ctx, attrs, x):
    x = x.to(torch.float32)
    x_min = torch.clamp(torch.amin(x), max=0.0)
    x_max = torch.clamp(torch.amax(x), min=0.0)
    scale = (x_max - x_min) / torch.full_like(x_max, 255.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(0.0 - x_min / scale), 0, 255)
    q = torch.clamp(torch.round(x / scale) + zp, 0, 255).to(torch.uint8)
    return q, scale.to(torch.float32), zp.to(torch.uint8)


@register("QLinearMatMul")
def qlinear_matmul(ctx, attrs, a, a_scale, a_zp, b, b_scale, b_zp, y_scale, y_zp):
    a_i = a.to(torch.int32) - a_zp.to(torch.int32)
    b_i = b.to(torch.int32) - b_zp.to(torch.int32)
    acc = matmul(a_i, b_i)
    m = a_scale.to(torch.float32) * b_scale.to(torch.float32) / y_scale.to(torch.float32)
    y = torch.round(acc.to(torch.float32) * m) + y_zp.to(torch.float32)
    lo, hi = _qrange(y_zp.dtype)
    return torch.clamp(y, lo, hi).to(y_zp.dtype)
