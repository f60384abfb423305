"""Normalization and softmax ops: counterpart of ``rten_tpu/ops/norm.py``.

Each computes what the JAX op computes, in the same order: population
variance, ``rsqrt(var + eps)``. LayerNormalization whose scale and bias
cover the normalized dims exactly is one ``F.layer_norm`` call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rten_tpu_torch.ops.registry import register


def _channel(v, x):
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


@register("BatchNormalization")
def batch_norm(ctx, attrs, x, scale, b, mean, var):
    # Inference mode (reference: src/ops/norm.rs:78).
    eps = attrs.get("epsilon", 1e-5)
    inv = torch.rsqrt(_channel(var, x) + eps)
    return (x - _channel(mean, x)) * inv * _channel(scale, x) + _channel(b, x)


@register("InstanceNormalization")
def instance_norm(ctx, attrs, x, scale, b):
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * _channel(scale, x) + _channel(b, x)


@register("LayerNormalization")
def layer_norm(ctx, attrs, x, scale, bias=None):
    axis = attrs.get("axis", -1)
    if axis < 0:
        axis += x.dim()
    eps = attrs.get("epsilon", 1e-5)
    normalized = tuple(x.shape[axis:])
    if (x.dtype == scale.dtype and tuple(scale.shape) == normalized
            and (bias is None or (bias.dtype == x.dtype and tuple(bias.shape) == normalized))):
        return F.layer_norm(x, normalized, scale, bias, eps)
    axes = tuple(range(axis, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return out


@register("Softmax")
def softmax(ctx, attrs, x):
    return torch.softmax(x, dim=attrs.get("axis", -1))


@register("LogSoftmax")
def log_softmax(ctx, attrs, x):
    return torch.log_softmax(x, dim=attrs.get("axis", -1))
