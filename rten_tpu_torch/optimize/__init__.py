"""Load-time graph optimizer: counterpart of ``rten_tpu/optimize/__init__.py``,
the same passes in the same order.

Reference: src/optimize.rs:295 GraphOptimizer::optimize — pass pipeline:
captured-value→constant conversion, constant propagation, and fusions
(Transpose absorption, SiLU, GELU, LayerNorm). The passes that pay most are (1) constant
propagation — it shrinks the plan and keeps shape-math concrete — and (2)
pattern rewrites that change *numerics or kernel choice*: LayerNorm
recognition and quantized-subgraph → the int8 kernels (QuantMatMul).
"""

from __future__ import annotations

from rten_tpu_torch.graph import Graph
from rten_tpu_torch.optimize.passes import (
    absorb_transposes,
    convert_captured_values_to_constants,
    fuse_patterns,
    propagate_constants,
    sweep_dead_constants,
    sweep_dead_operators,
)
from rten_tpu_torch.optimize.quantize import fuse_dequant_matmul


def optimize_graph(graph: Graph) -> Graph:
    # Pipeline mirrors the reference's (src/optimize.rs:302-310):
    # captured→const, then quant fusion BEFORE constant-folding (folding
    # would otherwise "fold" DequantizeLinear and materialize the f32
    # weights it exists to avoid), const-prop, transpose absorption,
    # pattern fusions, dead-constant sweep; subgraphs optimize recursively
    # against their converted captures (reference OpLoadContext behavior).
    graph = convert_captured_values_to_constants(graph)
    for _, op in graph.operator_nodes():
        for key, val in op.attrs.items():
            if isinstance(val, Graph):
                op.attrs[key] = optimize_graph(val)
    graph = fuse_dequant_matmul(graph)
    graph = propagate_constants(graph)
    graph = absorb_transposes(graph)
    graph = fuse_patterns(graph)
    graph = sweep_dead_operators(graph)
    graph = sweep_dead_constants(graph)
    return graph
