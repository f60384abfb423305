"""Graph pattern matching DSL for optimizer rewrites.

A copy of ``rten_tpu/optimize/pattern_matcher.py`` (pure Python). Reference:
src/optimize/pattern_matcher.rs — a backtracking symbolic matcher with
operator-overloaded pattern expressions. Python port of the idea:

    x = Sym("x")
    pattern = (x - x.mean()) / (((x - x.mean())**2).mean() + eps).sqrt()

is written here as nested ``Op``/``Sym``/``Const`` nodes; ``match(graph,
value_id, pattern)`` returns the symbol bindings if the subgraph rooted at
``value_id`` has that shape. Commutative binary ops try both operand orders.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from rten_tpu_torch.graph import ConstantNode, Graph, OperatorNode

_COMMUTATIVE = {"Add", "Mul"}


@dataclasses.dataclass
class Sym:
    """Matches any value; same name must bind to the same node id."""

    name: str


@dataclasses.dataclass
class Const:
    """Matches a constant node; ``value`` (optional) must match numerically,
    ``tol`` relative. Binds to ``name`` when given."""

    value: float | None = None
    name: str | None = None
    tol: float = 1e-4


@dataclasses.dataclass
class Op:
    """Matches an operator producing the root value."""

    op_type: str
    inputs: tuple
    attrs: dict[str, Any] | None = None


def match(graph: Graph, value_id: int, pattern, bindings: dict | None = None) -> dict | None:
    """Match ``pattern`` against the subgraph producing ``value_id``.
    Returns {sym_name: node_id, ...} plus {"__ops__": [op node ids]} or None."""
    if bindings is None:
        bindings = {"__ops__": []}
    if isinstance(pattern, Sym):
        bound = bindings.get(pattern.name)
        if bound is None:
            bindings[pattern.name] = value_id
            return bindings
        return bindings if bound == value_id else None
    if isinstance(pattern, Const):
        node = graph.nodes[value_id]
        if not isinstance(node, ConstantNode):
            return None
        if pattern.value is not None:
            v = node.value
            if v.size != 1 or not np.allclose(
                float(v.reshape(())), pattern.value, rtol=pattern.tol, atol=pattern.tol
            ):
                return None
        if pattern.name:
            bindings[pattern.name] = value_id
        return bindings
    if isinstance(pattern, Op):
        prod = graph.producer_of().get(value_id)
        if prod is None:
            return None
        op = graph.nodes[prod]
        assert isinstance(op, OperatorNode)
        if op.op_type != pattern.op_type:
            return None
        real_inputs = [i for i in op.inputs if i is not None]
        if len(real_inputs) != len(pattern.inputs):
            return None
        if pattern.attrs:
            for k, v in pattern.attrs.items():
                if op.attrs.get(k) != v:
                    return None

        orders = [pattern.inputs]
        if op.op_type in _COMMUTATIVE and len(pattern.inputs) == 2:
            orders.append((pattern.inputs[1], pattern.inputs[0]))
        for order in orders:
            trial = dict(bindings)
            trial["__ops__"] = list(bindings["__ops__"]) + [prod]
            ok = True
            for sub_pattern, sub_id in zip(order, real_inputs):
                result = match(graph, sub_id, sub_pattern, trial)
                if result is None:
                    ok = False
                    break
                trial = result
            if ok:
                bindings.clear()
                bindings.update(trial)
                return bindings
        return None
    raise TypeError(f"bad pattern {pattern!r}")
