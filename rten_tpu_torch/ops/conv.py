"""Conv / ConvTranspose: counterpart of ``rten_tpu/ops/conv.py``.

The JAX package lowers both onto ``lax.conv_general_dilated`` at
``Precision.HIGHEST`` for f32, plain XLA outside any Pallas kernel; here
they are cuDNN's (or the CPU's) convolutions in IEEE f32 (``models.ieee``).
Layout is ONNX NCHW / OIHW; 1-3 spatial dims, groups, dilation, fixed or
SAME_UPPER padding (asymmetric pads go through ``F.pad`` first).
ConvTranspose is ``F.conv_transpose{1,2,3}d`` of the full output, cropped by
the ONNX pads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rten_tpu_torch.models.ieee import ieee_f32
from rten_tpu_torch.ops.elementwise import promote
from rten_tpu_torch.ops.layout import slice_axis
from rten_tpu_torch.ops.registry import OpError, register

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _spatial_padding(pads: list[int] | None, n_spatial: int) -> list[tuple[int, int]]:
    """ONNX pads [x1_begin, x2_begin, ..., x1_end, x2_end...] → per-dim pairs."""
    if not pads:
        return [(0, 0)] * n_spatial
    if len(pads) != 2 * n_spatial:
        raise OpError(f"expected {2 * n_spatial} pad values, got {len(pads)}")
    return [(int(pads[i]), int(pads[i + n_spatial])) for i in range(n_spatial)]


def _norm(vals, n_spatial, default=1):
    if not vals:
        return (default,) * n_spatial
    return tuple(int(v) for v in vals)


def same_upper(sizes, kernel, strides, dilations=None) -> list[tuple[int, int]]:
    """XLA's "SAME" padding (SAME_UPPER) per spatial dim."""
    out = []
    for i, (size, k, s) in enumerate(zip(sizes, kernel, strides)):
        d = dilations[i] if dilations else 1
        out_size = -(-size // s)
        total = max((out_size - 1) * s + (k - 1) * d + 1 - size, 0)
        out.append((total // 2, total - total // 2))
    return out


def pad_spatial(x, pairs, value=0.0):
    """``x`` padded by (before, after) per spatial dim (negative crops)."""
    if not any(p for pair in pairs for p in pair):
        return x
    n = len(pairs)
    for i, (pb, pe) in enumerate(pairs):
        if pb < 0 or pe < 0:
            ax = x.dim() - n + i
            x = slice_axis(x, ax, slice(-pb if pb < 0 else None, pe if pe < 0 else None))
    flat = [max(p, 0) for pair in reversed(pairs) for p in (pair[0], pair[1])]
    return F.pad(x, flat, value=value)


@register("Conv")
def conv(ctx, attrs, x, w, b=None):
    n_spatial = x.dim() - 2
    if n_spatial < 1:
        raise OpError("Conv input must have at least one spatial dim")
    if n_spatial > 3:
        raise OpError("Conv supports at most 3 spatial dims")
    x, w = promote(x, w)
    strides = _norm(attrs.get("strides"), n_spatial)
    dilations = _norm(attrs.get("dilations"), n_spatial)
    groups = int(attrs.get("groups", 1) or 1)
    if attrs.get("auto_pad", "not_set") == "same":
        pairs = same_upper(x.shape[2:], w.shape[2:], strides, dilations)
    else:
        pairs = _spatial_padding(attrs.get("pads"), n_spatial)
    with ieee_f32():
        out = _CONV[n_spatial](pad_spatial(x, pairs), w, None, stride=strides, dilation=dilations, groups=groups)
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * n_spatial)
    return out


@register("ConvTranspose")
def conv_transpose(ctx, attrs, x, w, b=None):
    """ONNX ConvTranspose (w: [C_in, C_out, *kernel]): the full output of
    ``F.conv_transpose``, then the ONNX pads cropped off each side."""
    n_spatial = x.dim() - 2
    x, w = promote(x, w)
    strides = _norm(attrs.get("strides"), n_spatial)
    kernel = w.shape[2:]
    if attrs.get("auto_pad", "not_set") == "same":
        # output size = input * stride
        pads = []
        for k, s in zip(kernel, strides):
            total = max(k - s, 0)
            pads.append(total // 2)
        pads = pads + [max(k - s, 0) - p for (k, s), p in zip(zip(kernel, strides), pads)]
    else:
        pads = attrs.get("pads") or [0] * (2 * n_spatial)
    pairs = _spatial_padding(pads, n_spatial)
    with ieee_f32():
        out = _CONV_T[n_spatial](x, w, None, stride=strides)
    out = pad_spatial(out, [(-pb, -pe) for pb, pe in pairs])
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * n_spatial)
    return out
