"""Graph-level INT8 weight-only quantization + fused-kernel recognition:
counterpart of ``rten_tpu/optimize/quantize.py``.

- ``quantize_graph_int8`` (offline, converter ``--quantize``): rewrites large
  float weight constants feeding MatMul/Gemm into int8 constants +
  DequantizeLinear, producing a standard ONNX-semantics quantized graph
  (storable in `.rten` via the schema extension).

- ``fuse_dequant_matmul`` (load-time optimizer pass): recognizes
  DequantizeLinear(w_q, scales) → MatMul(x, ·) and rewrites it to the
  internal QuantMatMul op, which runs the port's int8 kernels
  (``kernels.quant_matmul``: ``quant_matmul_int8``, which hands M ≤ 8 to
  ``quant_gemv_int8``) instead of materializing the dequantized matrix.

QuantMatMul follows the JAX package's TPU branch on every device
(``rten_tpu/optimize/quantize.py:100-101``): ``(x @ w_q) * scales``, on the
card through ``csrc/quant_matmul.cu`` and ``csrc/quant_gemv.cu``, on the CPU
through their plain versions. The JAX package's CPU branch (dequantize,
then matmul) is not copied.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rten_tpu_torch.graph import ConstantNode, Graph, OperatorNode
from rten_tpu_torch.kernels.quant_matmul import quant_matmul_int8, quantize_weights_int8
from rten_tpu_torch.ops.registry import register

MIN_QUANT_ELEMENTS = 1 << 14


def quantize_graph_int8(graph: Graph, min_elements: int = MIN_QUANT_ELEMENTS) -> tuple[Graph, int]:
    """Replace big f32 weight constants used as MatMul/Gemm B-inputs with
    int8 + per-column scales + DequantizeLinear."""
    n_quantized = 0
    for op_id, op in list(graph.operator_nodes()):
        if op.op_type not in ("MatMul", "Gemm") or len(op.inputs) < 2:
            continue
        if op.op_type == "Gemm" and op.attrs.get("transpose_b"):
            continue  # per-column scales wouldn't match the transposed layout
        w_id = op.inputs[1]
        if w_id is None:
            continue
        node = graph.nodes[w_id]
        if not isinstance(node, ConstantNode):
            continue
        w = node.value
        if w.dtype != np.float32 or w.ndim != 2 or w.size < min_elements:
            continue
        w_q, scales = quantize_weights_int8(w, axis=-1)
        q_id = graph.add_constant(f"{node.name}_q", w_q)
        s_id = graph.add_constant(f"{node.name}_scale", scales)
        deq_out = graph.add_value(f"{node.name}_deq")
        graph.add_operator(
            f"{node.name}_dequant",
            "DequantizeLinear",
            {"axis": w.ndim - 1},
            [q_id, s_id],
            [deq_out],
        )
        op.inputs[1] = deq_out
        n_quantized += 1
    return graph, n_quantized


def fuse_dequant_matmul(graph: Graph) -> Graph:
    """DequantizeLinear(w_q, s) → MatMul(x, ·)   ⇒   QuantMatMul(x, w_q, s)."""
    prod = graph.producer_of()
    for op_id, op in list(graph.operator_nodes()):
        if op.op_type != "MatMul" or len(op.inputs) < 2 or op.inputs[1] is None:
            continue
        deq_id = prod.get(op.inputs[1])
        if deq_id is None:
            continue
        deq = graph.nodes[deq_id]
        assert isinstance(deq, OperatorNode)
        if deq.op_type != "DequantizeLinear" or len(deq.inputs) < 2:
            continue
        if len(deq.inputs) > 2 and deq.inputs[2] is not None:
            continue  # zero-point form not fused (symmetric-only kernel)
        w_id, s_id = deq.inputs[0], deq.inputs[1]
        w_node = graph.nodes[w_id] if w_id is not None else None
        if not isinstance(w_node, ConstantNode) or w_node.value.dtype != np.int8:
            continue
        if w_node.value.ndim != 2:
            continue
        op.op_type = "QuantMatMul"
        op.inputs = [op.inputs[0], w_id, s_id]
        # The orphaned DequantizeLinear drops out of future plans.
    return graph


def pack_weight(w_q: torch.Tensor) -> torch.Tensor:
    """The int8 ``[K, N]`` weight in the kernels' ``[N, Kp]`` layout
    (``int8_pack``'s ``qt``), K zero-padded to a multiple of 16: the GEMV's
    rule at M ≤ 8, and a multiple of 8 for the matmul above. Made once a
    weight tensor (a constant's is the model's, so once a node) and kept
    on it."""
    qt = getattr(w_q, "_rten_pack", None)
    if qt is None:
        k = w_q.shape[0]
        qt = F.pad(w_q.t(), (0, -k % 16)).contiguous()
        w_q._rten_pack = qt
    return qt


@register("QuantMatMul")
def quant_matmul_op(ctx, attrs, x, w_q, scales):
    """Internal fused op produced by fuse_dequant_matmul (not in the wire
    format — serialization re-expands to DequantizeLinear+MatMul):
    ``quant_matmul_int8(x2, w_q, scales)`` on the rows of x, zero-padded to
    the pack's K (exact) as a contiguous, 16-byte aligned [M, Kp] matrix."""
    qt = pack_weight(w_q)
    shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if qt.shape[1] != x2.shape[1]:
        x2 = F.pad(x2, (0, qt.shape[1] - x2.shape[1]))
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    out = quant_matmul_int8(x2, qt, scales)
    return out.reshape(*shape, -1)
