"""Value-generating ops: counterpart of ``rten_tpu/ops/generate_ops.py``.

Random* ops are non-deterministic and therefore excluded from partial
evaluation; they draw from the run's ``torch.Generator``, seeded from
``RunOptions.seed`` (an ONNX ``seed`` attr seeds one of the op's own,
making the op reproducible), so one seed gives the same values on every
run in either mode.
"""

from __future__ import annotations

import numpy as np
import torch

from rten_tpu_torch.ops.registry import canon_numpy, register, require_static, static_int_list, to_tensor


@register("ConstantOfShape")
def constant_of_shape(ctx, attrs, shape):
    dims = static_int_list(shape, "ConstantOfShape shape")
    value = canon_numpy(attrs.get("value", np.float32(0.0)))
    return torch.full(dims, value.reshape(-1)[0].item(), dtype=to_tensor(value).dtype, device=ctx.device)


@register("Range")
def range_(ctx, attrs, start, limit, delta):
    s = require_static(start, "Range start").item()
    l = require_static(limit, "Range limit").item()
    d = require_static(delta, "Range delta").item()
    dtype = canon_numpy(np.asarray(require_static(start, "Range start"))).dtype
    return to_tensor(np.arange(s, l, d, dtype=dtype), ctx.device)


def _rng_for(ctx, attrs) -> torch.Generator:
    seed = attrs.get("seed")
    if seed is not None:
        return ctx.generator_for(np.float32(seed).view(np.int32).item())
    return ctx.next_rng()


def _uniform(ctx, attrs, shape):
    low = attrs.get("low", 0.0)
    high = attrs.get("high", 1.0)
    u = torch.rand(shape, generator=_rng_for(ctx, attrs), dtype=torch.float32, device=ctx.device)
    return u * (high - low) + low


def _normal(ctx, attrs, shape):
    mean = attrs.get("mean", 0.0)
    scale = attrs.get("scale", 1.0)
    return mean + scale * torch.randn(shape, generator=_rng_for(ctx, attrs), dtype=torch.float32, device=ctx.device)


@register("RandomUniform", deterministic=False)
def random_uniform(ctx, attrs, *_):
    return _uniform(ctx, attrs, [int(s) for s in attrs.get("shape", [])])


@register("RandomUniformLike", deterministic=False)
def random_uniform_like(ctx, attrs, x):
    return _uniform(ctx, attrs, list(x.shape))


@register("RandomNormal", deterministic=False)
def random_normal(ctx, attrs, *_):
    return _normal(ctx, attrs, [int(s) for s in attrs.get("shape", [])])


@register("RandomNormalLike", deterministic=False)
def random_normal_like(ctx, attrs, x):
    return _normal(ctx, attrs, list(x.shape))
