"""Reduction ops: counterpart of ``rten_tpu/ops/reduce.py``.

ArgMax / ArgMin and TopK take the lowest index among equal values, as the
JAX package does (a stable sort for TopK: ``torch.topk`` on CUDA promises
no order among ties). Reduce* with no axes reduce everything; sums and
products of integers stay in their dtype (int32), as jnp's do. NonZero has
a data-dependent output shape and runs in interpret mode only.
"""

from __future__ import annotations

import numpy as np
import torch

from rten_tpu_torch.ops.registry import CompileError, register, require_static, to_numpy


def _axes(attrs, ndim) -> tuple[int, ...]:
    axes = attrs.get("axes")
    if not axes:
        return tuple(range(ndim))
    return tuple(a % ndim for a in axes)


def _acc_dtype(x):
    """jnp's result dtype of a sum or product: bool → int32, else x's."""
    return torch.int32 if x.dtype == torch.bool else x.dtype


def _sum(x, axis, keepdims):
    return torch.sum(x, dim=axis, keepdim=keepdims, dtype=_acc_dtype(x)) if axis else x.to(_acc_dtype(x))


def _mean(x, axis, keepdims):
    x = x if x.dtype.is_floating_point else x.to(torch.float32)
    return torch.mean(x, dim=axis, keepdim=keepdims) if axis else x


def _prod(x, axis, keepdims):
    out = x.to(_acc_dtype(x))
    for a in sorted(axis, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdims, dtype=out.dtype)
    return out


def _amin(x, axis, keepdims):
    return torch.amin(x, dim=axis, keepdim=keepdims) if axis else x


def _amax(x, axis, keepdims):
    return torch.amax(x, dim=axis, keepdim=keepdims) if axis else x


def _reduce(name, fn):
    @register(name)
    def op(ctx, attrs, x):
        keep = bool(attrs.get("keep_dims", True))
        return fn(x, _axes(attrs, x.dim()), keep)

    return op


_reduce("ReduceSum", _sum)
_reduce("ReduceMean", _mean)
_reduce("ReduceProd", _prod)
_reduce("ReduceMin", _amin)
_reduce("ReduceMax", _amax)
_reduce("ReduceL2", lambda x, axis, keepdims: torch.sqrt(_sum(x * x, axis, keepdims).to(
    x.dtype if x.dtype.is_floating_point else torch.float32)))
_reduce("ReduceSumSquare", lambda x, axis, keepdims: _sum(x * x, axis, keepdims))


def _arg_reduce(name, fn):
    @register(name)
    def op(ctx, attrs, x):
        axis = attrs.get("axis", 0)
        out = fn(x, dim=axis).to(torch.int32)  # the first index among equal values
        if attrs.get("keep_dims", True):
            out = out.unsqueeze(axis % x.dim())
        return out

    return op


_arg_reduce("ArgMax", torch.argmax)
_arg_reduce("ArgMin", torch.argmin)


@register("CumSum")
def cumsum(ctx, attrs, x, axis):
    ax = int(require_static(axis, "CumSum axis"))
    return torch.cumsum(x, dim=ax, dtype=_acc_dtype(x))


@register("NonZero", data_dependent=True)
def nonzero(ctx, attrs, x):
    if ctx.mode != "eager":
        raise CompileError("NonZero has a data-dependent shape; interpret-mode only")
    nz = np.stack(np.nonzero(to_numpy(x))).astype(np.int32)
    return torch.from_numpy(nz).to(x.device)


@register("TopK")
def topk(ctx, attrs, x, k):
    k_val = int(require_static(k, "TopK k"))
    axis = attrs.get("axis", -1) % x.dim()
    largest = attrs.get("largest", True)
    x_m = torch.movedim(x, axis, -1) if axis != x.dim() - 1 else x
    # A stable sort: among equal values the lowest index comes first, as
    # lax.top_k gives it (of -x for the smallest).
    values, indices = torch.sort(x_m, dim=-1, descending=bool(largest), stable=True)
    values, indices = values[..., :k_val], indices[..., :k_val]
    if axis != x.dim() - 1:
        values = torch.movedim(values, -1, axis)
        indices = torch.movedim(indices, -1, axis)
    return values, indices.to(torch.int32)
