"""Graph IR: the dataflow graph of an inference model.

A copy of ``rten_tpu/graph.py`` (pure Python and numpy), so that the port
imports nothing of the JAX package. This IR is a *description*; execution
strategies live in ``rten_tpu_torch.runtime`` (eager interpret mode, or the
compile mode: one trace-mode run per signature, captured as one CUDA graph
on the card).

Node ids are indexes into ``Graph.nodes`` (reference: NodeId=usize,
src/graph.rs:271). Operator inputs/outputs use ``None`` for missing optional
slots (reference encodes these as negative ints in the FlatBuffers,
src/schema.fbs:469-472).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np

# Dtypes storable as graph constants. The reference supports f32/i32 only
# (src/schema.fbs:489-492); we extend with int8/uint8 + bfloat16/float16 for
# the quantized and reduced-precision paths.
CONSTANT_DTYPES = ("float32", "int32", "int8", "uint8", "bfloat16", "float16")


@dataclasses.dataclass
class ConstantNode:
    """A weight / constant tensor baked into the model.

    Reference: src/graph.rs:98-183 (Constant / ConstantNodeData). Data is kept
    as a host numpy array; executors move it to the model's device.
    """

    name: str | None
    value: np.ndarray

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> str:
        return str(self.value.dtype)


@dataclasses.dataclass
class ValueNode:
    """A runtime tensor value: graph input or operator output.

    Reference: src/schema.fbs:521-524 (ValueNode with symbolic dims).
    ``shape`` entries are int (fixed), str (named symbolic dim) or None
    (anonymous dynamic dim). ``dtype`` is advisory (the schema does not store
    it; it is inferred at run time).
    """

    name: str | None
    shape: list[int | str | None] | None = None
    dtype: str | None = None


@dataclasses.dataclass
class OperatorNode:
    """An operator application.

    Reference: src/graph.rs:38 (OperatorNode), src/schema.fbs:464-473.
    ``op_type`` is the ONNX-aligned operator name (e.g. "MatMul"); ``attrs``
    is a plain dict; subgraph-carrying attrs (If) hold ``Graph`` values.
    """

    name: str | None
    op_type: str
    attrs: dict[str, Any]
    inputs: list[int | None]
    outputs: list[int | None]


Node = ConstantNode | ValueNode | OperatorNode


class Graph:
    """A dataflow graph. Reference: src/graph.rs:566 (Graph struct).

    ``captures`` lists node ids whose values are resolved from an enclosing
    scope when this graph runs as a subgraph (If branches) — reference
    CaptureEnv semantics, src/graph.rs:442.
    """

    def __init__(self) -> None:
        self.nodes: list[Node] = []
        self.inputs: list[int] = []
        self.outputs: list[int] = []
        self.captures: list[int] = []

    # ---- construction -----------------------------------------------------

    def add_constant(self, name: str | None, value: np.ndarray) -> int:
        value = np.asarray(value)
        self.nodes.append(ConstantNode(name, value))
        return len(self.nodes) - 1

    def add_value(
        self,
        name: str | None,
        shape: list[int | str | None] | None = None,
        dtype: str | None = None,
    ) -> int:
        self.nodes.append(ValueNode(name, shape, dtype))
        return len(self.nodes) - 1

    def add_operator(
        self,
        name: str | None,
        op_type: str,
        attrs: dict[str, Any] | None = None,
        inputs: Sequence[int | None] = (),
        outputs: Sequence[int | None] = (),
    ) -> int:
        self.nodes.append(
            OperatorNode(name, op_type, dict(attrs or {}), list(inputs), list(outputs))
        )
        return len(self.nodes) - 1

    def add_simple_op(
        self,
        op_type: str,
        inputs: Sequence[int | None],
        attrs: dict[str, Any] | None = None,
        name: str | None = None,
        n_outputs: int = 1,
    ) -> int:
        """Add an operator plus fresh value nodes for its outputs; returns the
        first output's node id (convenience used by tests and graph constructors)."""
        base = name or op_type
        out_ids = [
            self.add_value(f"{base}_out{i}" if n_outputs > 1 else f"{base}_out")
            for i in range(n_outputs)
        ]
        self.add_operator(name or op_type, op_type, attrs, inputs, out_ids)
        return out_ids[0]

    # ---- lookup -----------------------------------------------------------

    def node(self, node_id: int) -> Node:
        return self.nodes[node_id]

    def get_node_id(self, name: str) -> int | None:
        for i, n in enumerate(self.nodes):
            if n.name == name:
                return i
        return None

    def node_name(self, node_id: int) -> str:
        n = self.nodes[node_id]
        return n.name if n.name else f"[node_{node_id}]"

    def operator_nodes(self) -> Iterable[tuple[int, OperatorNode]]:
        for i, n in enumerate(self.nodes):
            if isinstance(n, OperatorNode):
                yield i, n

    def total_params(self) -> int:
        """Total elements across constant nodes (reference:
        src/model.rs:614 Model::total_params)."""
        total = 0
        for n in self.nodes:
            if isinstance(n, ConstantNode):
                total += int(n.value.size)
        for _, op in self.operator_nodes():
            for sub in subgraphs_of(op):
                total += sub.total_params()
        return total

    # ---- planning ---------------------------------------------------------

    def producer_of(self) -> dict[int, int]:
        """Map value-node id → operator-node id that produces it."""
        prod: dict[int, int] = {}
        for op_id, op in self.operator_nodes():
            for out in op.outputs:
                if out is not None:
                    prod[out] = op_id
        return prod

    def create_plan(
        self,
        inputs: Sequence[int],
        outputs: Sequence[int],
        *,
        captures_available: bool = True,
    ) -> list[int]:
        """Operator execution plan: iterative post-order DFS from ``outputs``,
        treating ``inputs`` (and captures) as already-resolved leaves.

        Reference: src/graph.rs:1392 create_plan. Raises ``PlanError`` if an
        output is unreachable from the given inputs + constants.
        """
        prod = self.producer_of()
        resolved: set[int] = set(inputs)
        for i, n in enumerate(self.nodes):
            if isinstance(n, ConstantNode):
                resolved.add(i)
        if captures_available:
            resolved.update(self.captures)

        plan: list[int] = []
        planned: set[int] = set()

        for out in outputs:
            if out in resolved:
                continue
            # Iterative DFS (graphs can be thousands of ops deep).
            stack: list[tuple[int, bool]] = [(out, False)]
            while stack:
                val, expanded = stack.pop()
                if val in resolved:
                    continue
                op_id = prod.get(val)
                if op_id is None:
                    raise PlanError(
                        f"missing operator output: value '{self.node_name(val)}' "
                        f"is not a graph input, constant or operator output"
                    )
                if expanded:
                    if op_id not in planned:
                        plan.append(op_id)
                        planned.add(op_id)
                    for o in self.nodes[op_id].outputs:
                        if o is not None:
                            resolved.add(o)
                    continue
                stack.append((val, True))
                for dep in operator_dependencies(self, self.nodes[op_id]):
                    if dep is not None and dep not in resolved:
                        stack.append((dep, False))
        return plan

    def prune_plan(
        self, plan: Sequence[int], available: set[int], outputs: Sequence[int]
    ) -> tuple[list[int], list[int]]:
        """Trim a plan to the suffix runnable from ``available`` values,
        for partial evaluation (reference: src/graph.rs:1276 prune_plan).

        Returns (pruned_plan, resolved_values): the operators that can run
        given only ``available`` + constants, and the set of requested outputs
        they resolve.
        """
        from rten_tpu_torch.ops.registry import is_deterministic

        resolved = set(available)
        for i, n in enumerate(self.nodes):
            if isinstance(n, ConstantNode):
                resolved.add(i)
        pruned: list[int] = []
        for op_id in plan:
            op = self.nodes[op_id]
            assert isinstance(op, OperatorNode)
            # Non-deterministic ops (Random*) are excluded from partial
            # evaluation (reference: src/graph.rs:1308).
            if not is_deterministic(op.op_type):
                continue
            deps = operator_dependencies(self, op)
            if all(d is None or d in resolved for d in deps):
                pruned.append(op_id)
                for o in op.outputs:
                    if o is not None:
                        resolved.add(o)
        resolved_outputs = [o for o in outputs if o in resolved]
        return pruned, resolved_outputs


def operator_dependencies(graph: Graph, op: OperatorNode) -> list[int | None]:
    """All value dependencies of an operator: its inputs plus any subgraph
    captures (reference: src/graph.rs:1362 operator_dependencies)."""
    deps = list(op.inputs)
    for sub in subgraphs_of(op):
        for cap in sub.captures:
            name = sub.node_name(cap)
            outer = graph.get_node_id(name)
            if outer is not None:
                deps.append(outer)
    return deps


def subgraphs_of(op: OperatorNode) -> list[Graph]:
    """Subgraphs held in operator attrs (If branches)."""
    return [v for v in op.attrs.values() if isinstance(v, Graph)]


class PlanError(ValueError):
    """Raised when an execution plan cannot be created
    (reference: RunError::PlanningError, src/graph.rs:275)."""
