"""Optimizer passes: counterpart of ``rten_tpu/optimize/passes.py``, the
same passes over the port's ``Graph``; constant folding runs each op on the
host (``runtime.executor.run_static``). Reference: src/optimize.rs.

``propagate_constants`` mirrors the reference's pass (src/optimize.rs:356):
any deterministic operator whose inputs are all constants is executed eagerly
at load time and its outputs become ConstantNodes.

``fuse_patterns`` recognizes primitive-op subgraphs and rewrites them to
single ops (reference: fuse_silu :435, fuse_gelu :456, fuse_layer_norm :482).
The win is numerics control (one fused op instead of a chain) and fewer
launches a run.
"""

from __future__ import annotations

import numpy as np

from rten_tpu_torch.graph import ConstantNode, Graph, OperatorNode, ValueNode
from rten_tpu_torch.ops.registry import OpContext, get_op, is_deterministic
from rten_tpu_torch.runtime.executor import run_static


# Don't fold ops whose constant inputs are huge: folding DequantizeLinear or
# a weight transpose would materialize (and 4×) the very tensors the
# quantized path keeps small. The reference folds unconditionally
# (src/optimize.rs:356).
FOLD_MAX_INPUT_ELEMENTS = 1 << 20


def propagate_constants(graph: Graph) -> Graph:
    const_ids = {
        i for i, n in enumerate(graph.nodes) if isinstance(n, ConstantNode)
    }
    # Never fold graph inputs/captures (they are runtime values by definition).
    runtime = set(graph.inputs) | set(graph.captures)
    # Ops with no remaining consumers (orphans left by fusions) aren't folded.
    consumed: set[int] = set(graph.outputs)
    for _, op in graph.operator_nodes():
        consumed.update(i for i in op.inputs if i is not None)
    ctx = OpContext("eager")

    folded: set[int] = set()
    changed = True
    while changed:
        changed = False
        for op_id, op in list(graph.operator_nodes()):
            if op_id in folded:
                continue
            if not is_deterministic(op.op_type):
                continue
            deps = [i for i in op.inputs if i is not None]
            if not deps or not all(d in const_ids and d not in runtime for d in deps):
                continue
            if any(isinstance(v, Graph) for v in op.attrs.values()):
                continue  # don't fold control flow
            if not any(o in consumed for o in op.outputs if o is not None):
                continue  # orphan (e.g. DequantizeLinear absorbed by fusion)
            if any(
                graph.nodes[d].value.size > FOLD_MAX_INPUT_ELEMENTS for d in deps
            ):
                continue
            try:
                args = [
                    None if i is None else graph.nodes[i].value for i in op.inputs
                ]
                while args and args[-1] is None:
                    args.pop()
                attrs = op.attrs
                if op.op_type == "Split":
                    attrs = dict(attrs)
                    attrs["_n_outputs"] = len(op.outputs)
                result = run_static(get_op(op.op_type), ctx, attrs, args)
            except Exception:
                continue  # leave for runtime (e.g. unsupported edge case)
            outs = result if isinstance(result, tuple) else (result,)
            for out_id, val in zip(op.outputs, outs):
                if out_id is None:
                    continue
                node = graph.nodes[out_id]
                graph.nodes[out_id] = ConstantNode(
                    node.name if node.name else None, np.asarray(val)
                )
                const_ids.add(out_id)
            folded.add(op_id)
            changed = True
    return graph


def sweep_dead_constants(graph: Graph) -> Graph:
    """Free constants with no remaining consumers (weights orphaned by the
    quant rewrite): the node becomes a ValueNode placeholder so ids stay
    stable but the array memory is released. The counterpart of the
    reference's buffer reclamation (it keeps the whole mmap alive instead,
    src/constant_storage.rs — we can't afford 4× dead f32 weights)."""
    from rten_tpu_torch.graph import ValueNode, subgraphs_of

    used: set[int] = set(graph.outputs) | set(graph.inputs) | set(graph.captures)
    for _, op in graph.operator_nodes():
        used.update(i for i in op.inputs if i is not None)
        for sub in subgraphs_of(op):
            for cap in sub.captures:
                outer = graph.get_node_id(sub.node_name(cap))
                if outer is not None:
                    used.add(outer)
    for i, node in enumerate(graph.nodes):
        if isinstance(node, ConstantNode) and i not in used:
            graph.nodes[i] = ValueNode(node.name, None)
    return graph


def convert_captured_values_to_constants(graph: Graph) -> Graph:
    """Captured values in If-subgraphs that resolve to a CONSTANT in the
    enclosing graph become local constants of the subgraph (reference:
    src/optimize.rs:320 convert_captured_values_to_constants). This runs
    before constant propagation so subgraph expressions over captured
    weights fold at load time. Handles one nesting level; ``optimize_graph``
    recurses, so deeper levels convert against their (already-converted)
    parents."""
    from rten_tpu_torch.graph import subgraphs_of

    for _, op in graph.operator_nodes():
        for sub in subgraphs_of(op):
            remaining: list[int] = []
            for cap in sub.captures:
                name = sub.node_name(cap)
                outer = graph.get_node_id(name)
                node = graph.nodes[outer] if outer is not None else None
                if isinstance(node, ConstantNode):
                    # Share the array (zero-copy view into the model buffer).
                    sub.nodes[cap] = ConstantNode(sub.nodes[cap].name, node.value)
                else:
                    remaining.append(cap)
            sub.captures = remaining
    return graph


def absorb_transposes(graph: Graph) -> Graph:
    """``MatMul(Transpose(X), Y)`` → ``MatMul(X, Y)`` with a ``perm_a``/
    ``perm_b`` attr (reference: src/optimize.rs:388 fuse_transpose wrapping
    with FusedTranspose, src/ops/fused.rs:69). The reference's win is not
    materializing the transposed operand; here the MatMul op permutes its
    operand as a view and the Transpose leaves the plan."""
    sole = _single_consumer(graph)
    for _, op in list(graph.operator_nodes()):
        if op.op_type != "Transpose" or not op.outputs or op.outputs[0] is None:
            continue
        t_out = op.outputs[0]
        tgt_id = sole.get(t_out)
        if tgt_id is None:
            continue
        tgt = _op(graph, tgt_id)
        # Same op whitelist as the reference: operators known to handle a
        # permuted input without a copy.
        if tgt.op_type != "MatMul":
            continue
        x = op.inputs[0]
        if x is None or t_out not in tgt.inputs:
            continue
        idx = tgt.inputs.index(t_out)
        attr = "perm_a" if idx == 0 else "perm_b"
        if attr in tgt.attrs:
            continue  # already absorbed one on this slot
        # ONNX Transpose default (no perm) reverses all dims; keep that
        # rank-agnostic with the "reverse" sentinel.
        perm = op.attrs.get("perm")
        tgt.attrs[attr] = list(perm) if perm is not None else "reverse"
        tgt.inputs[idx] = x
        # The Transpose is now an orphan; it drops out of future plans and
        # sweep_dead_constants reclaims a constant input if unused.
    return graph


def sweep_dead_operators(graph: Graph) -> Graph:
    """Drop operators none of whose outputs are consumed — the orphans left
    behind by fusions (absorbed Transposes, the Sigmoid half of a fused SiLU,
    GELU chains). The executor's plan already skips them (reference relies on
    the same property, plans are DFS-from-outputs); sweeping keeps the node
    table honest for introspection and lets sweep_dead_constants reclaim
    their constant inputs."""
    from rten_tpu_torch.graph import operator_dependencies

    changed = True
    while changed:
        changed = False
        needed: set[int] = set(graph.outputs)
        for _, op in graph.operator_nodes():
            needed.update(i for i in operator_dependencies(graph, op) if i is not None)
        for op_id, op in list(graph.operator_nodes()):
            live = any(
                o in needed and not isinstance(graph.nodes[o], ConstantNode)
                for o in op.outputs
                if o is not None
            )  # outputs turned ConstantNode by folding no longer need the op
            if not live:
                graph.nodes[op_id] = ValueNode(op.name, None)
                changed = True
    return graph


def _producer_map(graph: Graph) -> dict[int, int]:
    return graph.producer_of()


def _single_consumer(graph: Graph) -> dict[int, int]:
    """value id → op id of its sole consumer (absent if 0 or >1 consumers or
    it is a graph output)."""
    counts: dict[int, int] = {}
    consumer: dict[int, int] = {}
    for op_id, op in graph.operator_nodes():
        for inp in op.inputs:
            if inp is not None:
                counts[inp] = counts.get(inp, 0) + 1
                consumer[inp] = op_id
    outputs = set(graph.outputs)
    return {
        v: op_id
        for v, op_id in consumer.items()
        if counts[v] == 1 and v not in outputs
    }


def fuse_patterns(graph: Graph) -> Graph:
    graph = _fuse_silu(graph)
    graph = _fuse_gelu(graph)
    graph = _fuse_layer_norm(graph)
    return graph


def _op(graph: Graph, op_id: int) -> OperatorNode:
    node = graph.nodes[op_id]
    assert isinstance(node, OperatorNode)
    return node


def _fuse_silu(graph: Graph) -> Graph:
    """x * Sigmoid(x) → Silu(x) (reference: src/optimize.rs:435)."""
    sole = _single_consumer(graph)
    for op_id, op in list(graph.operator_nodes()):
        if op.op_type != "Sigmoid" or not op.outputs or op.outputs[0] is None:
            continue
        sig_out = op.outputs[0]
        mul_id = sole.get(sig_out)
        if mul_id is None:
            continue
        mul = _op(graph, mul_id)
        if mul.op_type != "Mul":
            continue
        x = op.inputs[0]
        if x is None or set(mul.inputs) != {x, sig_out}:
            continue
        # Rewrite Mul → Silu(x); the orphaned Sigmoid drops out of future plans.
        mul.op_type = "Silu"
        mul.attrs = {}
        mul.inputs = [x]
    return graph


def _fuse_layer_norm(graph: Graph) -> Graph:
    """Recognize the primitive-op LayerNorm subgraph ONNX exporters emit for
    pre-opset-17 models and rewrite to one LayerNormalization op
    (reference: src/optimize.rs:482 fuse_layer_norm):

        y = (x - mean(x)) / sqrt(mean((x - mean(x))²) + eps) [* scale] [+ bias]
    """
    from rten_tpu_torch.optimize.pattern_matcher import Const, Op, Sym, match

    x = Sym("x")
    mean = Op("ReduceMean", (x,))
    d = Op("Sub", (x, mean))
    denom = lambda var: Op("Sqrt", (Op("Add", (var, Const(name="eps"))),))
    patterns = [
        Op("Div", (d, denom(Op("ReduceMean", (Op("Pow", (d, Const(2.0))),))))),
        Op("Div", (d, denom(Op("ReduceMean", (Op("Mul", (d, d)),))))),
    ]

    sole = _single_consumer(graph)
    for div_id, div in list(graph.operator_nodes()):
        if div.op_type != "Div" or not div.outputs or div.outputs[0] is None:
            continue
        m = None
        for pat in patterns:
            m = match(graph, div.outputs[0], pat)
            if m:
                break
        if not m:
            continue
        # Both ReduceMeans must normalize the trailing axis with keepdims.
        rm = [
            graph.nodes[i]
            for i in m["__ops__"]
            if isinstance(graph.nodes[i], OperatorNode)
            and graph.nodes[i].op_type == "ReduceMean"
        ]
        if not all(
            o.attrs.get("axes") in ([-1],) and o.attrs.get("keep_dims", True)
            for o in rm
        ):
            continue
        eps = float(np.asarray(graph.nodes[m["eps"]].value).reshape(()))
        x_id = m["x"]

        # Optional affine tail: Mul(·, scale) then Add(·, bias).
        final_id, final = div_id, div
        scale_id = bias_id = None
        nxt = sole.get(final.outputs[0])
        if nxt is not None:
            op2 = graph.nodes[nxt]
            if isinstance(op2, OperatorNode) and op2.op_type == "Mul":
                other = [i for i in op2.inputs if i != final.outputs[0]]
                if other and isinstance(graph.nodes[other[0]], ConstantNode):
                    scale_id, final_id, final = other[0], nxt, op2
                    nxt2 = sole.get(final.outputs[0])
                    if nxt2 is not None:
                        op3 = graph.nodes[nxt2]
                        if isinstance(op3, OperatorNode) and op3.op_type == "Add":
                            other2 = [i for i in op3.inputs if i != final.outputs[0]]
                            if other2 and isinstance(graph.nodes[other2[0]], ConstantNode):
                                bias_id, final_id, final = other2[0], nxt2, op3
        if scale_id is None:
            x_node = graph.nodes[x_id]
            width = None
            if isinstance(x_node, ConstantNode):
                width = x_node.value.shape[-1]
            if width is None:
                continue  # can't synthesize a scale of unknown width
            scale_id = graph.add_constant("ln_scale_ones", np.ones(width, np.float32))
        final.op_type = "LayerNormalization"
        final.attrs = {"axis": -1, "epsilon": eps}
        final.inputs = [x_id, scale_id] + ([bias_id] if bias_id is not None else [])
    return graph


def _fuse_gelu(graph: Graph) -> Graph:
    """0.5 * x * (1 + Erf(x / sqrt(2))) → Gelu(x)
    (reference: src/optimize.rs:456). Matches the common ONNX emission:
    Div(x, sqrt2) → Erf → Add(1) → Mul(x) → Mul(0.5) in any Mul order."""
    prod = _producer_map(graph)

    def const_value(nid):
        n = graph.nodes[nid] if nid is not None else None
        return n.value if isinstance(n, ConstantNode) else None

    for op_id, op in list(graph.operator_nodes()):
        if op.op_type != "Erf":
            continue
        erf_in, erf_out = op.inputs[0], op.outputs[0]
        if erf_in is None or erf_out is None:
            continue
        div_id = prod.get(erf_in)
        if div_id is None:
            continue
        div = _op(graph, div_id)
        if div.op_type != "Div":
            continue
        x = div.inputs[0]
        sqrt2 = const_value(div.inputs[1])
        if x is None or sqrt2 is None or not np.allclose(sqrt2, np.sqrt(2.0), rtol=1e-4):
            continue
        # Erf output → Add(1)
        add_id = next(
            (
                oid
                for oid, o in graph.operator_nodes()
                if o.op_type == "Add" and erf_out in o.inputs
            ),
            None,
        )
        if add_id is None:
            continue
        add = _op(graph, add_id)
        other = [i for i in add.inputs if i != erf_out]
        one = const_value(other[0]) if other else None
        if one is None or not np.allclose(one, 1.0):
            continue
        add_out = add.outputs[0]
        # Add output → Mul with x → Mul with 0.5 (the two Muls in either order)
        mul1_id = next(
            (
                oid
                for oid, o in graph.operator_nodes()
                if o.op_type == "Mul" and add_out in o.inputs
            ),
            None,
        )
        if mul1_id is None:
            continue
        mul1 = _op(graph, mul1_id)
        partner = [i for i in mul1.inputs if i != add_out]
        if not partner:
            continue
        p = partner[0]
        half = const_value(p)
        final_id = None
        if p == x:
            # (x * (1+erf)) then * 0.5
            m1_out = mul1.outputs[0]
            mul2_id = next(
                (
                    oid
                    for oid, o in graph.operator_nodes()
                    if o.op_type == "Mul" and m1_out in o.inputs
                ),
                None,
            )
            if mul2_id is None:
                continue
            mul2 = _op(graph, mul2_id)
            other2 = [i for i in mul2.inputs if i != m1_out]
            if not other2:
                continue
            half2 = const_value(other2[0])
            if half2 is None or not np.allclose(half2, 0.5):
                continue
            final_id = mul2_id
        elif half is not None and np.allclose(half, 0.5):
            # ((1+erf) * 0.5) then * x
            m1_out = mul1.outputs[0]
            mul2_id = next(
                (
                    oid
                    for oid, o in graph.operator_nodes()
                    if o.op_type == "Mul" and m1_out in o.inputs and x in o.inputs
                ),
                None,
            )
            if mul2_id is None:
                continue
            final_id = mul2_id
        else:
            continue
        final = _op(graph, final_id)
        final.op_type = "Gelu"
        final.attrs = {}
        final.inputs = [x]
    return graph
