"""Gather / Scatter family: counterpart of ``rten_tpu/ops/gather.py``.

Negative indices wrap as in the JAX package; indices become int64 only
inside an op. Scatter reductions follow the JAX package's ``.at[]``
combinators: ``none`` sets, ``add`` / ``mul`` / ``min`` / ``max`` combine
with the existing values.
"""

from __future__ import annotations

import numpy as np
import torch

from rten_tpu_torch.ops.registry import OpError, register, require_static

_REDUCE = {"add": "sum", "mul": "prod", "min": "amin", "max": "amax"}


def _wrap_indices(indices, dim_size):
    indices = indices.to(torch.int64)
    return torch.where(indices < 0, indices + dim_size, indices)


def take(x, idx, axis: int):
    """``jnp.take(x, idx, axis)`` for in-range int64 ``idx`` of any shape."""
    flat = torch.index_select(x, axis, idx.reshape(-1))
    return flat.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))


@register("Gather")
def gather(ctx, attrs, x, indices):
    axis = attrs.get("axis", 0) % x.dim()
    return take(x, _wrap_indices(indices, x.shape[axis]), axis)


@register("GatherElements")
def gather_elements(ctx, attrs, x, indices):
    axis = attrs.get("axis", 0) % x.dim()
    return torch.gather(x, axis, _wrap_indices(indices, x.shape[axis]))


@register("GatherND")
def gather_nd(ctx, attrs, x, indices):
    indices = indices.to(torch.int64)
    batch_dims = attrs.get("batch_dims", 0)
    if batch_dims == 0:
        return x[tuple(torch.movedim(indices, -1, 0))]
    # Flatten the batch dims and index each batch element's slice.
    batch_shape = tuple(x.shape[:batch_dims])
    xb = x.reshape((-1,) + tuple(x.shape[batch_dims:]))
    ib = indices.reshape((xb.shape[0],) + tuple(indices.shape[batch_dims:]))
    b = torch.arange(xb.shape[0], device=x.device).reshape((-1,) + (1,) * (ib.dim() - 2))
    out = xb[(b.expand(ib.shape[:-1]),) + tuple(torch.movedim(ib, -1, 0))]
    return out.reshape(batch_shape + tuple(out.shape[1:]))


def _reduction(attrs) -> str:
    reduction = attrs.get("reduction", "none")
    if reduction not in ("none", None, *_REDUCE):
        raise OpError(f"unsupported scatter reduction {reduction!r}")
    return reduction or "none"


@register("ScatterElements")
def scatter_elements(ctx, attrs, x, indices, updates):
    axis = attrs.get("axis", 0) % x.dim()
    idx = _wrap_indices(indices, x.shape[axis])
    updates = updates.to(x.dtype)
    reduction = _reduction(attrs)
    if reduction == "none":
        return x.scatter(axis, idx, updates)
    return x.scatter_reduce(axis, idx, updates, _REDUCE[reduction], include_self=True)


@register("ScatterND")
def scatter_nd(ctx, attrs, x, indices, updates):
    indices = indices.to(torch.int64)
    k = indices.shape[-1]
    lead = tuple(x.shape[:k])
    # The k index columns as one linear index into the leading k dims.
    lin = None
    for i in range(k):
        col = indices[..., i]
        term = torch.where(col < 0, col + lead[i], col) * int(np.prod(lead[i + 1:], dtype=np.int64))
        lin = term if lin is None else lin + term
    lin = lin.reshape(-1)
    x2 = x.reshape((-1,) + tuple(x.shape[k:]))
    upd = updates.to(x.dtype).reshape((lin.shape[0],) + tuple(x.shape[k:]))
    reduction = _reduction(attrs)
    if reduction == "none":
        out = x2.index_put((lin,), upd)
    elif reduction == "add":
        out = x2.index_put((lin,), upd, accumulate=True)
    else:
        index = lin.reshape((-1,) + (1,) * (upd.dim() - 1)).expand(upd.shape)
        out = x2.scatter_reduce(0, index, upd, _REDUCE[reduction], include_self=True)
    return out.reshape(x.shape)


@register("OneHot")
def one_hot(ctx, attrs, indices, depth, values):
    depth_v = int(require_static(depth, "OneHot depth"))
    axis = attrs.get("axis", -1)
    idx = _wrap_indices(indices, depth_v)
    oh = (idx.unsqueeze(-1) == torch.arange(depth_v, device=idx.device)).to(values.dtype)
    out_ndim = idx.dim() + 1
    if axis % out_ndim != out_ndim - 1:
        oh = torch.movedim(oh, -1, axis % out_ndim)
    return oh * (values[1] - values[0]) + values[0]
