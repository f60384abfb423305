"""Elementwise operators.

Counterpart of ``rten_tpu/ops/elementwise.py``. NumPy broadcasting
throughout; a binary op promotes its operands as the JAX package does
(``torch.promote_types``: a 0-d operand does not lose to the other's
dtype, as it would under PyTorch's own rules). Comparison and logical ops
return int32 0/1. Divisions take a tensor divisor, so they are IEEE
divisions on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rten_tpu_torch.ops.registry import OpError, register


def _is_int(x) -> bool:
    return not x.dtype.is_floating_point and x.dtype != torch.bool


def promote(*xs):
    """The operands in their common dtype (JAX's promotion of arrays)."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return [x if x.dtype == dtype else x.to(dtype) for x in xs]


def _float(x):
    """x as a float tensor (an integer or bool one as float32), as a jnp
    transcendental promotes it."""
    return x if x.dtype.is_floating_point else x.to(torch.float32)


# ---- binary ---------------------------------------------------------------


@register("Add", commutative=True)
def add(ctx, attrs, a, b):
    a, b = promote(a, b)
    return torch.add(a, b)


@register("Sub")
def sub(ctx, attrs, a, b):
    a, b = promote(a, b)
    return torch.sub(a, b)


@register("Mul", commutative=True)
def mul(ctx, attrs, a, b):
    a, b = promote(a, b)
    return torch.mul(a, b)


@register("Div")
def div(ctx, attrs, a, b):
    a, b = promote(a, b)
    if _is_int(a):
        # ONNX integer division truncates toward zero (C semantics).
        return torch.div(a, b, rounding_mode="trunc")
    return torch.div(a, b)


@register("Mod")
def mod(ctx, attrs, a, b):
    a, b = promote(a, b)
    if attrs.get("fmod", False):
        return torch.fmod(a, b)  # sign of dividend
    return torch.remainder(a, b)  # sign of divisor


@register("Pow")
def pow_(ctx, attrs, a, b):
    a, b = promote(a, b)
    return torch.pow(a, b)


@register("Where")
def where(ctx, attrs, cond, x, y):
    x, y = promote(x, y)
    return torch.where(cond != 0, x, y)


def _cmp(fn):
    def op(ctx, attrs, a, b):
        a, b = promote(a, b)
        return fn(a, b).to(torch.int32)

    return op


register("Equal")(_cmp(torch.eq))
register("Greater")(_cmp(torch.gt))
register("GreaterOrEqual")(_cmp(torch.ge))
register("Less")(_cmp(torch.lt))
register("LessOrEqual")(_cmp(torch.le))


def _logical(fn):
    def op(ctx, attrs, a, b):
        return fn(a != 0, b != 0).to(torch.int32)

    return op


register("And", commutative=True)(_logical(torch.logical_and))
register("Or", commutative=True)(_logical(torch.logical_or))
register("Xor", commutative=True)(_logical(torch.logical_xor))


@register("Not")
def not_(ctx, attrs, x):
    return (x == 0).to(torch.int32)


# ---- variadic -------------------------------------------------------------


def _fold(name, fn):
    def op(ctx, attrs, *xs):
        if not xs:
            raise OpError(f"{name} requires at least one input")
        xs = promote(*xs)
        out = xs[0]
        for x in xs[1:]:
            out = fn(out, x)
        return out

    return op


max_ = register("Max", commutative=True)(_fold("Max", torch.maximum))
min_ = register("Min", commutative=True)(_fold("Min", torch.minimum))
sum_ = register("Sum", commutative=True)(_fold("Sum", torch.add))


@register("Mean", commutative=True)
def mean_(ctx, attrs, *xs):
    total = _float(sum_(ctx, attrs, *xs))
    return total / torch.full_like(total, len(xs))


# ---- unary ----------------------------------------------------------------


def _unary(name, fn, **kw):
    @register(name, **kw)
    def op(ctx, attrs, x):
        return fn(x)

    return op


def _keep_int(fn):
    """A rounding function that leaves integers as they are (jnp's)."""
    return lambda x: x.clone() if _is_int(x) or x.dtype == torch.bool else fn(x)


_unary("Abs", torch.abs)
_unary("Acos", lambda x: torch.acos(_float(x)))
_unary("Asin", lambda x: torch.asin(_float(x)))
_unary("Atan", lambda x: torch.atan(_float(x)))
_unary("Ceil", _keep_int(torch.ceil))
_unary("Cos", lambda x: torch.cos(_float(x)))
_unary("Erf", lambda x: torch.erf(_float(x)))
_unary("Exp", lambda x: torch.exp(_float(x)))
_unary("Floor", _keep_int(torch.floor))
_unary("Log", lambda x: torch.log(_float(x)))
_unary("Neg", torch.neg)
_unary("Reciprocal", lambda x: torch.reciprocal(_float(x)))
_unary("Relu", torch.relu)
_unary("Round", _keep_int(torch.round))  # round-half-to-even, matches ONNX
_unary("Sigmoid", lambda x: torch.sigmoid(_float(x)))
_unary("Sign", torch.sign)
_unary("Sin", lambda x: torch.sin(_float(x)))
_unary("Softplus", lambda x: torch.logaddexp(_float(x), torch.zeros_like(_float(x))))
_unary("Sqrt", lambda x: torch.sqrt(_float(x)))
_unary("Tan", lambda x: torch.tan(_float(x)))
_unary("Tanh", lambda x: torch.tanh(_float(x)))
# Silu is not an ONNX/.rten op; the graph optimizer fuses x*Sigmoid(x) into it.
_unary("Silu", lambda x: F.silu(_float(x)))


@register("Clip")
def clip(ctx, attrs, x, min_=None, max_=None):
    if min_ is not None:
        x, min_ = promote(x, min_)
        x = torch.maximum(x, min_)
    if max_ is not None:
        x, max_ = promote(x, max_)
        x = torch.minimum(x, max_)
    return x


@register("Elu")
def elu(ctx, attrs, x):
    return F.elu(_float(x), alpha=attrs.get("alpha", 1.0))


@register("Gelu")
def gelu(ctx, attrs, x):
    # erf-based: 0.5x(1+erf(x/sqrt(2))).
    return F.gelu(_float(x))


@register("HardSigmoid")
def hard_sigmoid(ctx, attrs, x):
    alpha = attrs.get("alpha", 0.2)
    beta = attrs.get("beta", 0.5)
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register("HardSwish")
def hard_swish(ctx, attrs, x):
    return x * torch.clamp(x / torch.full_like(x, 6.0) + 0.5, 0.0, 1.0)


@register("LeakyRelu")
def leaky_relu(ctx, attrs, x):
    return F.leaky_relu(_float(x), negative_slope=attrs.get("alpha", 0.01))
