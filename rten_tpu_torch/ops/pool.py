"""Pooling ops: counterpart of ``rten_tpu/ops/pool.py`` (layout NCHW).

The padding goes on first (``-inf`` for MaxPool, zeros for AveragePool),
then an unpadded window reduction, as ``lax.reduce_window`` does with the
init value at the pads. AveragePool divides the window sums by the kernel
size, or (``count_include_pad`` off) by each window's in-bounds count.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rten_tpu_torch.ops.conv import _norm, _spatial_padding, pad_spatial, same_upper
from rten_tpu_torch.ops.registry import OpError, register

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_args(attrs, x):
    n_spatial = x.dim() - 2
    kernel = attrs.get("kernel_size")
    if not kernel:
        raise OpError("pool requires kernel_size")
    kernel = tuple(int(k) for k in kernel)
    strides = _norm(attrs.get("strides"), n_spatial)
    if attrs.get("auto_pad", "not_set") == "same":
        pairs = same_upper(x.shape[2:], kernel, strides)
    else:
        pairs = _spatial_padding(attrs.get("pads"), n_spatial)
    return n_spatial, kernel, strides, pairs


def _window_sums(x, n_spatial, kernel, strides):
    """Sums over each window of an already padded x."""
    return _AVG[n_spatial](x, kernel, strides) * float(np.prod(kernel))


@register("MaxPool")
def max_pool(ctx, attrs, x):
    n_spatial, kernel, strides, pairs = _window_args(attrs, x)
    init = float("-inf") if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
    return _MAX[n_spatial](pad_spatial(x, pairs, init), kernel, strides)


@register("AveragePool")
def average_pool(ctx, attrs, x):
    n_spatial, kernel, strides, pairs = _window_args(attrs, x)
    sums = _window_sums(pad_spatial(x, pairs), n_spatial, kernel, strides)
    if attrs.get("count_include_pad", False):
        return sums / torch.full_like(sums, float(np.prod(kernel)))
    # Count only in-bounds elements per window.
    counts = _window_sums(pad_spatial(torch.ones_like(x), pairs), n_spatial, kernel, strides)
    return sums / counts


@register("GlobalAveragePool")
def global_average_pool(ctx, attrs, x):
    return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)
