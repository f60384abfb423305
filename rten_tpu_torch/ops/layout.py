"""Shape / layout ops: counterpart of ``rten_tpu/ops/layout.py``.

Shape-valued inputs (Reshape target, Slice starts / ends, ...) must be
static in compile mode; they stay static whenever they derive from
constants, ``Shape`` or ``Size`` (``ops.registry.require_static``).
``Shape`` and ``Size`` return host int32 arrays whatever their input.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from rten_tpu_torch.ops.elementwise import promote
from rten_tpu_torch.ops.registry import OpError, register, require_static, static_int_list

_CAST = {
    "int32": torch.int32,
    "float": torch.float32,
    "float32": torch.float32,
    "int8": torch.int8,
    "uint8": torch.uint8,
}


@register("Identity")
def identity(ctx, attrs, x):
    return x


@register("Cast")
def cast(ctx, attrs, x):
    to = attrs.get("to", "float32")
    dtype = _CAST.get(to)
    if dtype is None:
        raise OpError(f"Cast: unsupported target dtype {to!r}")
    return x.to(dtype)


@register("Shape")
def shape(ctx, attrs, x):
    return np.asarray(tuple(x.shape), dtype=np.int32)


@register("Size")
def size(ctx, attrs, x):
    return np.asarray(x.numel(), dtype=np.int32)


@register("Reshape")
def reshape(ctx, attrs, x, target_shape):
    dims = static_int_list(target_shape, "Reshape shape")
    allow_zero = attrs.get("allow_zero", False)
    out = []
    for i, d in enumerate(dims):
        if d == 0 and not allow_zero:
            if i >= x.dim():
                raise OpError("Reshape: 0-dim index out of range")
            out.append(x.shape[i])
        else:
            out.append(d)
    return x.reshape(out)


@register("Flatten")
def flatten(ctx, attrs, x):
    axis = attrs.get("axis", 1)
    if axis < 0:
        axis += x.dim()
    lead = int(np.prod(x.shape[:axis]))
    trail = int(np.prod(x.shape[axis:]))
    return x.reshape(lead, trail)


def permute(x, perm):
    """``jnp.transpose(x, perm)``; None reverses every dim."""
    if perm is None or perm == "reverse":
        perm = list(reversed(range(x.dim())))
    return x.permute(*[p % x.dim() for p in perm]) if x.dim() else x


@register("Transpose")
def transpose(ctx, attrs, x):
    return permute(x, attrs.get("perm"))


@register("Squeeze")
def squeeze(ctx, attrs, x, axes=None):
    if axes is None:
        return torch.squeeze(x)
    ax = tuple(a % x.dim() for a in static_int_list(axes, "Squeeze axes"))
    return torch.squeeze(x, dim=ax) if ax else x


@register("Unsqueeze")
def unsqueeze(ctx, attrs, x, axes):
    ax = static_int_list(axes, "Unsqueeze axes")
    out_ndim = x.dim() + len(ax)
    for a in sorted(a % out_ndim for a in ax):
        x = x.unsqueeze(a)
    return x


@register("Expand")
def expand(ctx, attrs, x, target_shape):
    dims = static_int_list(target_shape, "Expand shape")
    # ONNX Expand: broadcast both ways (target dims of 1 keep input size).
    ndim = builtins.max(x.dim(), len(dims))
    dims = [1] * (ndim - len(dims)) + dims
    in_shape = (1,) * (ndim - x.dim()) + tuple(x.shape)
    out = [builtins.max(d, s) for d, s in zip(dims, in_shape)]
    return torch.broadcast_to(x.reshape(in_shape), out)


@register("Concat")
def concat(ctx, attrs, *xs):
    axis = attrs.get("axis", 0)
    return torch.cat(promote(*xs), dim=axis)


@register("Tile")
def tile(ctx, attrs, x, repeats):
    reps = static_int_list(repeats, "Tile repeats")
    return torch.tile(x, tuple(reps))


def slice_axis(x, ax: int, sl: slice):
    """``x`` sliced along ``ax`` with Python slice semantics (negative
    steps included, which torch indexing lacks)."""
    start, stop, step = sl.indices(x.shape[ax])
    n = len(range(start, stop, step))
    if step > 0:
        return x.narrow(ax, start, 0) if n == 0 else x.narrow(ax, start, (n - 1) * step + 1)[
            (slice(None),) * ax + (slice(None, None, step),)]
    if n == 0:
        return x.narrow(ax, 0, 0)
    last = start + (n - 1) * step
    seg = torch.flip(x.narrow(ax, last, start - last + 1), dims=(ax,))
    return seg[(slice(None),) * ax + (slice(None, None, -step),)]


@register("Slice")
def slice_(ctx, attrs, x, starts, ends, axes=None, steps=None):
    starts_v = static_int_list(starts, "Slice starts")
    ends_v = static_int_list(ends, "Slice ends")
    axes_v = (
        static_int_list(axes, "Slice axes")
        if axes is not None
        else list(range(len(starts_v)))
    )
    steps_v = static_int_list(steps, "Slice steps") if steps is not None else [1] * len(starts_v)
    for st, en, ax, sp in zip(starts_v, ends_v, axes_v, steps_v):
        ax %= x.dim()
        # Clamp like numpy; INT_MAX/INT_MIN sentinels common in ONNX graphs.
        st_c = None if st in (-(2**31), -(2**63)) else st
        en_c = None if en in (2**31 - 1, 2**63 - 1) else en
        if sp < 0:
            en_c = None if en_c is not None and en_c <= -x.shape[ax] - 1 else en_c
        x = slice_axis(x, ax, slice(st_c, en_c, sp))
    return x


@register("Split")
def split(ctx, attrs, x, splits=None):
    axis = attrs.get("axis", 0) % x.dim()
    n_outputs = attrs.get("_n_outputs")  # injected by the executor
    if splits is not None:
        sizes = static_int_list(splits, "Split sizes")
        idx = [int(i) for i in np.cumsum(sizes[:-1])]
        return tuple(torch.tensor_split(x, idx, dim=axis))
    if not n_outputs:
        raise OpError("Split without sizes requires known output count")
    dim = x.shape[axis]
    chunk = -(-dim // n_outputs)
    idx = [chunk * i for i in range(1, n_outputs)]
    return tuple(torch.tensor_split(x, idx, dim=axis))


def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Indices of ``jnp.pad(mode="reflect")`` along one axis of size n."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register("Pad")
def pad(ctx, attrs, x, pads, value=None, axes=None):
    pads_v = static_int_list(pads, "Pad pads")
    if axes is not None:
        axes_v = [a % x.dim() for a in static_int_list(axes, "Pad axes")]
    else:
        axes_v = list(range(x.dim()))
    n = len(axes_v)
    pad_width = [(0, 0)] * x.dim()
    for i, ax in enumerate(axes_v):
        pad_width[ax] = (pads_v[i], pads_v[i + n])
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        cval = 0 if value is None else require_static(value, "Pad value").reshape(-1)[0].item()
        if any(p < 0 for pair in pad_width for p in pair):
            # Negative pads crop (ONNX allows them).
            for ax, (pb, pe) in enumerate(pad_width):
                x = slice_axis(x, ax, slice(-pb if pb < 0 else None, pe if pe < 0 else None))
            pad_width = [(builtins.max(pb, 0), builtins.max(pe, 0)) for pb, pe in pad_width]
        flat = [p for pair in reversed(pad_width) for p in pair]
        return F.pad(x, flat, value=cval) if any(flat) else x.clone()
    if mode == "reflect":
        for ax, (pb, pe) in enumerate(pad_width):
            if pb or pe:
                x = torch.index_select(x, ax, _reflect_index(x.shape[ax], pb, pe, x.device))
        return x
    raise OpError(f"Pad: unsupported mode {mode!r}")


@register("Trilu")
def trilu(ctx, attrs, x, k=None):
    kk = int(require_static(k, "Trilu k")) if k is not None else 0
    if attrs.get("upper", True):
        return torch.triu(x, diagonal=kk)
    return torch.tril(x, diagonal=kk)
