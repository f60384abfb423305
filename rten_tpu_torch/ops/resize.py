"""Resize: counterpart of ``rten_tpu/ops/resize.py`` — nearest and linear
modes with ONNX coordinate-transform modes, as separable per-axis gathers.
Source coordinates are computed in f32 on the tensor's device, each
division by a tensor (an IEEE division on every device).
"""

from __future__ import annotations

import numpy as np
import torch

from rten_tpu_torch.ops.gather import take
from rten_tpu_torch.ops.registry import OpError, register, require_static


def _src_coords(out_len: int, in_len: int, scale: float, coord_mode: str, device):
    x_out = torch.arange(out_len, dtype=torch.float32, device=device)
    s = torch.full_like(x_out, scale)
    if coord_mode == "half_pixel":
        return (x_out + 0.5) / s - 0.5
    if coord_mode == "asymmetric":
        return x_out / s
    if coord_mode == "align_corners":
        if out_len == 1:
            return torch.zeros_like(x_out)
        return x_out * (in_len - 1) / torch.full_like(x_out, out_len - 1)
    raise OpError(f"unsupported coord transform mode {coord_mode!r}")


def _round_nearest(x, nearest_mode: str):
    if nearest_mode == "floor":
        return torch.floor(x)
    if nearest_mode == "ceil":
        return torch.ceil(x)
    if nearest_mode == "round_prefer_floor":
        return torch.ceil(x - 0.5)
    if nearest_mode == "round_prefer_ceil":
        return torch.floor(x + 0.5)
    raise OpError(f"unsupported nearest mode {nearest_mode!r}")


@register("Resize")
def resize(ctx, attrs, x, roi=None, scales=None, sizes=None):
    mode = attrs.get("mode", "nearest")
    coord_mode = attrs.get("coord_mode", "half_pixel")
    nearest_mode = attrs.get("nearest_mode", "round_prefer_floor")

    if sizes is not None:
        out_shape = [int(v) for v in np.atleast_1d(require_static(sizes, "Resize sizes"))]
        scale_vals = [o / i for o, i in zip(out_shape, x.shape)]
    elif scales is not None:
        scale_vals = [float(v) for v in np.atleast_1d(require_static(scales, "Resize scales"))]
        out_shape = [int(np.floor(i * s)) for i, s in zip(x.shape, scale_vals)]
    else:
        raise OpError("Resize requires scales or sizes")

    out = x
    for axis in range(x.dim()):
        in_len = x.shape[axis]
        out_len = out_shape[axis]
        if out_len == in_len and scale_vals[axis] == 1.0:
            continue
        src = _src_coords(out_len, in_len, scale_vals[axis], coord_mode, x.device)
        if mode == "nearest":
            idx = torch.clamp(_round_nearest(src, nearest_mode), 0, in_len - 1).to(torch.int64)
            out = take(out, idx, axis)
        elif mode == "linear":
            src_c = torch.clamp(src, 0.0, in_len - 1)
            lo_f = torch.floor(src_c)
            lo = lo_f.to(torch.int64)
            hi = torch.clamp(lo + 1, max=in_len - 1)
            frac = (src_c - lo_f).to(x.dtype)
            shape = [1] * out.dim()
            shape[axis] = out_len
            frac = frac.reshape(shape)
            out = take(out, lo, axis) * (1 - frac) + take(out, hi, axis) * frac
        else:
            raise OpError(f"unsupported resize mode {mode!r}")
    return out
