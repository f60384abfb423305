"""Load / save `.rten` model files ⇄ the port's Graph IR
(``rten_tpu_torch.graph``): the counterpart of ``rten_tpu/format/rten_io.py``.

Read path mirrors the reference loader (src/model.rs:297 load_impl,
:344 load_graph, :419 add_graph_operator, :523 add_graph_constant): V2 header
or V1 bare FlatBuffer, zero-copy constants out of the tensor data segment
(read-only numpy views of the caller's buffer, or of its mapping under
``Model.load_mmap``). Write path mirrors the reference converter's
serializer (rten-convert/rten_convert/converter.py:1335 build_graph, :1386
serialize_model, :1417 write_header) with the 64-byte-aligned tensor segment
(tensor_data.py:8 TensorDataBuilder), through the port's own FlatBuffers
writer (``fbs.FbsWriter``). Files written by either package load into the
other to the same graph.
"""

from __future__ import annotations

import math
import re
import struct
from typing import Any

import numpy as np

from rten_tpu_torch.format import fbs
from rten_tpu_torch.format.header import Header, HeaderError
from rten_tpu_torch.graph import ConstantNode, Graph, OperatorNode, ValueNode


class ModelLoadError(ValueError):
    """Reference: ModelLoadError, src/model.rs:706."""


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


_SNAKE_CACHE = {v: _snake(v) for vals in (
    fbs.AUTO_PAD, fbs.RNN_DIRECTIONS, fbs.RESIZE_MODES,
    fbs.COORD_TRANSFORM_MODES, fbs.NEAREST_MODES, fbs.PAD_MODES,
    fbs.SCATTER_REDUCTIONS, fbs.NMS_BOX_ORDERS, fbs.DATA_TYPES,
    fbs.CONSTANT_DATA_TYPES,
) for v in vals}


def _enum_to_ir(values: list[str], v: int) -> str:
    return _SNAKE_CACHE[values[v]]


def _enum_from_ir(values: list[str], s: str) -> int:
    for i, name in enumerate(values):
        if _SNAKE_CACHE[name] == s:
            return i
    raise ModelLoadError(f"unknown enum value {s!r} for {values}")


# Field spec: kind ∈ {"scalar", "intlist", "enum:<EnumName>", "graph", "scalar_union"}
_ENUMS = {
    "AutoPad": fbs.AUTO_PAD,
    "RNNDirection": fbs.RNN_DIRECTIONS,
    "ResizeMode": fbs.RESIZE_MODES,
    "CoordTransformMode": fbs.COORD_TRANSFORM_MODES,
    "NearestMode": fbs.NEAREST_MODES,
    "PadMode": fbs.PAD_MODES,
    "ScatterReduction": fbs.SCATTER_REDUCTIONS,
    "NMSBoxOrder": fbs.NMS_BOX_ORDERS,
    "DataType": fbs.DATA_TYPES,
    "ConstantDataType": fbs.CONSTANT_DATA_TYPES,
}

# op_type → (attrs table name, {field: kind}). Ops absent here carry no attrs.
OP_ATTRS: dict[str, tuple[str, dict[str, str]]] = {
    "ArgMax": ("ArgMaxAttrs", {"axis": "scalar", "keep_dims": "scalar"}),
    "ArgMin": ("ArgMaxAttrs", {"axis": "scalar", "keep_dims": "scalar"}),
    "AveragePool": ("AveragePoolAttrs", {
        "kernel_size": "intlist", "auto_pad": "enum:AutoPad", "pads": "intlist",
        "strides": "intlist", "count_include_pad": "scalar"}),
    "BatchNormalization": ("BatchNormalizationAttrs", {"epsilon": "scalar"}),
    "InstanceNormalization": ("BatchNormalizationAttrs", {"epsilon": "scalar"}),
    "Cast": ("CastAttrs", {"to": "enum:DataType"}),
    "Concat": ("ConcatAttrs", {"axis": "scalar"}),
    "ConstantOfShape": ("ConstantOfShapeAttrs", {"value": "scalar_union"}),
    "Conv": ("ConvAttrs", {
        "auto_pad": "enum:AutoPad", "pads": "intlist", "groups": "scalar",
        "strides": "intlist", "dilations": "intlist"}),
    "ConvTranspose": ("ConvTransposeAttrs", {
        "strides": "intlist", "auto_pad": "enum:AutoPad", "pads": "intlist"}),
    "Einsum": ("EinsumAttrs", {"equation": "scalar"}),
    "Elu": ("EluAttrs", {"alpha": "scalar"}),
    "Flatten": ("FlattenAttrs", {"axis": "scalar"}),
    "Gather": ("GatherAttrs", {"axis": "scalar"}),
    "GatherElements": ("GatherAttrs", {"axis": "scalar"}),
    "GatherND": ("GatherNDAttrs", {"batch_dims": "scalar"}),
    "Gelu": ("GeluAttrs", {}),
    "Gemm": ("GemmAttrs", {
        "alpha": "scalar", "beta": "scalar",
        "transpose_a": "scalar", "transpose_b": "scalar"}),
    "GRU": ("GRUAttrs", {
        "direction": "enum:RNNDirection", "hidden_size": "scalar",
        "linear_before_reset": "scalar"}),
    "HardSigmoid": ("HardSigmoidAttrs", {"alpha": "scalar", "beta": "scalar"}),
    "If": ("IfAttrs", {"then_branch": "graph", "else_branch": "graph"}),
    "LayerNormalization": ("LayerNormalizationAttrs", {"axis": "scalar", "epsilon": "scalar"}),
    "LeakyRelu": ("LeakyReluAttrs", {"alpha": "scalar"}),
    "LSTM": ("LSTMAttrs", {"direction": "enum:RNNDirection", "hidden_size": "scalar"}),
    "MaxPool": ("MaxPoolAttrs", {
        "kernel_size": "intlist", "auto_pad": "enum:AutoPad", "pads": "intlist",
        "strides": "intlist"}),
    "Mod": ("ModAttrs", {"fmod": "scalar"}),
    "NonMaxSuppression": ("NonMaxSuppressionAttrs", {"box_order": "enum:NMSBoxOrder"}),
    "OneHot": ("OneHotAttrs", {"axis": "scalar"}),
    "Pad": ("PadAttrs", {"mode": "enum:PadMode"}),
    "RandomNormal": ("RandomNormalAttrs", {
        "mean": "scalar", "scale": "scalar", "seed": "scalar", "shape": "intlist"}),
    "RandomNormalLike": ("RandomNormalLikeAttrs", {
        "mean": "scalar", "scale": "scalar", "seed": "scalar"}),
    "RandomUniform": ("RandomUniformAttrs", {
        "shape": "intlist", "high": "scalar", "low": "scalar", "seed": "scalar"}),
    "RandomUniformLike": ("RandomUniformLikeAttrs", {
        "high": "scalar", "low": "scalar", "seed": "scalar"}),
    **{
        op: ("ReduceMeanAttrs", {"axes": "intlist_opt", "keep_dims": "scalar"})
        for op in ("ReduceMean", "ReduceL2", "ReduceMin", "ReduceMax",
                   "ReduceProd", "ReduceSum", "ReduceSumSquare")
    },
    "Reshape": ("ReshapeAttrs", {"allow_zero": "scalar"}),
    "Resize": ("ResizeAttrs", {
        "mode": "enum:ResizeMode", "coord_mode": "enum:CoordTransformMode",
        "nearest_mode": "enum:NearestMode"}),
    "ScatterElements": ("ScatterElementsAttrs", {
        "axis": "scalar", "reduction": "enum:ScatterReduction"}),
    "ScatterND": ("ScatterNDAttrs", {"reduction": "enum:ScatterReduction"}),
    "Softmax": ("SoftmaxAttrs", {"axis": "scalar"}),
    "LogSoftmax": ("SoftmaxAttrs", {"axis": "scalar"}),
    "Split": ("SplitAttrs", {"axis": "scalar"}),
    "TopK": ("TopKAttrs", {"axis": "scalar", "largest": "scalar", "sorted": "scalar"}),
    "Transpose": ("TransposeAttrs", {"perm": "intlist_opt"}),
    "Trilu": ("TriluAttrs", {"upper": "scalar"}),
    # rten_tpu quantization extension
    "QuantizeLinear": ("QuantizeAttrs", {"axis": "scalar", "output_dtype": "scalar"}),
    "DequantizeLinear": ("QuantizeAttrs", {"axis": "scalar", "output_dtype": "scalar"}),
    "QLinearMatMul": ("QLinearMatMulAttrs", {}),
}


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def load_rten(data: bytes | bytearray | memoryview) -> tuple[Graph, dict[str, Any]]:
    """Parse a `.rten` file into (Graph, metadata dict).

    Constants referencing the tensor data segment are zero-copy numpy views
    into ``data`` (reference: src/constant_storage.rs ArcSlice)."""
    buf = memoryview(data)
    try:
        header = Header.from_buf(buf)
        model_buf = buf[header.model_offset : header.model_offset + header.model_len]
        tensor_data = (
            buf[header.tensor_data_offset :] if header.tensor_data_offset else None
        )
    except HeaderError:
        # V1: bare FlatBuffer (reference: src/model.rs:305-310)
        model_buf = buf
        tensor_data = None

    reader = fbs.FbsReader(model_buf)
    try:
        model = reader.root("Model")
    except (ValueError, IndexError, struct.error) as e:
        raise ModelLoadError(f"malformed FlatBuffers model data: {e}") from e
    graph_tbl = model.get("graph")
    if graph_tbl is None:
        raise ModelLoadError("model has no graph")
    graph = _graph_from_fbs(graph_tbl, tensor_data)
    metadata = {}
    md = model.get("metadata")
    if md:
        metadata = {k: v for k, v in md.items() if not k.startswith("__") and v is not None}
    return graph, metadata


def _graph_from_fbs(g: dict, tensor_data: memoryview | None) -> Graph:
    graph = Graph()
    for node in g.get("nodes") or []:
        name = node.get("name")
        kind = node.get("data")
        if kind is None:
            raise ModelLoadError(f"node {name!r} has no data")
        member, tbl = kind
        if member == "ValueNode":
            shape = None
            if tbl.get("shape") is not None:
                shape = [
                    d["name"] if d.get("name") else int(d.get("value") or 0)
                    for d in tbl["shape"]
                ]
            graph.add_value(name, shape)
        elif member == "ConstantNode":
            graph.add_constant(name, _constant_from_fbs(name, tbl, tensor_data))
        elif member == "OperatorNode":
            op_type = fbs.OPERATOR_TYPES[tbl["type"]]
            attrs = _attrs_from_fbs(op_type, tbl.get("attrs"), tensor_data)
            inputs = [int(i) if i >= 0 else None for i in (tbl.get("inputs") if tbl.get("inputs") is not None else [])]
            outputs = [int(o) if o >= 0 else None for o in (tbl.get("outputs") if tbl.get("outputs") is not None else [])]
            graph.add_operator(name, op_type, attrs, inputs, outputs)
        else:
            raise ModelLoadError(f"unknown node kind {member}")
    graph.inputs = [int(i) for i in (g.get("inputs") if g.get("inputs") is not None else [])]
    graph.outputs = [int(o) for o in (g.get("outputs") if g.get("outputs") is not None else [])]
    graph.captures = [int(c) for c in (g.get("captures") if g.get("captures") is not None else [])]
    return graph


def _constant_from_fbs(
    name: str | None, tbl: dict, tensor_data: memoryview | None
) -> np.ndarray:
    shape = tuple(int(d) for d in (tbl.get("shape") if tbl.get("shape") is not None else []))
    n_elements = math.prod(shape)
    data_offset = tbl.get("data_offset")
    if data_offset is not None:
        if tensor_data is None:
            raise ModelLoadError(
                f"constant {name!r} references tensor segment but file has none"
            )
        dtype_idx = tbl.get("dtype")
        if dtype_idx is None:
            raise ModelLoadError(f"constant {name!r} in tensor segment missing dtype")
        np_dtype = fbs.CONSTANT_DTYPE_TO_NUMPY[fbs.CONSTANT_DATA_TYPES[dtype_idx]]
        arr = np.frombuffer(
            tensor_data, dtype=np_dtype, count=n_elements, offset=int(data_offset)
        )
        return arr.reshape(shape)
    data = tbl.get("data")
    if data is None:
        raise ModelLoadError(f"constant {name!r} has no data")
    member, payload = data
    arr = np.asarray(payload["data"])
    expect = {
        "FloatData": np.float32, "IntData": np.int32,
        "Int8Data": np.int8, "UInt8Data": np.uint8,
    }[member]
    dtype_idx = tbl.get("dtype")
    if dtype_idx is not None:
        expect = fbs.CONSTANT_DTYPE_TO_NUMPY[fbs.CONSTANT_DATA_TYPES[dtype_idx]]
    return arr.view(expect).reshape(shape) if arr.dtype.itemsize == np.dtype(expect).itemsize else arr.astype(expect).reshape(shape)


def _attrs_from_fbs(
    op_type: str, attrs_union, tensor_data: memoryview | None
) -> dict[str, Any]:
    spec = OP_ATTRS.get(op_type)
    if spec is None or attrs_union is None:
        return {}
    _table_name, field_specs = spec
    _, tbl = attrs_union
    out: dict[str, Any] = {}
    for field, kind in field_specs.items():
        raw = tbl.get(field)
        if kind == "scalar":
            if raw is not None:
                out[field] = (
                    bool(raw) if isinstance(raw, (bool, np.bool_))
                    else raw if isinstance(raw, str)
                    else float(raw) if isinstance(raw, float) else int(raw)
                )
        elif kind in ("intlist", "intlist_opt"):
            if raw is not None:
                out[field] = [int(v) for v in raw]
        elif kind.startswith("enum:"):
            if raw is not None:
                name = _enum_to_ir(_ENUMS[kind[5:]], int(raw))
                # An AutoPad of NotSet means "use explicit pads" — keep the
                # IR attr absent (ops treat absence as not_set), preserving
                # save→load identity.
                if kind == "enum:AutoPad" and name == "not_set":
                    continue
                out[field] = name
        elif kind == "graph":
            if raw is not None:
                out[field] = _graph_from_fbs(raw, tensor_data)
        elif kind == "scalar_union":
            if raw is not None:
                member, payload = raw
                np_t = np.int32 if member == "IntScalar" else np.float32
                out[field] = np_t(payload["value"])
    return out


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

_TENSOR_ALIGN = 64  # reference: tensor_data.py:23 (align = 64)


def save_rten(
    graph: Graph,
    metadata: dict[str, Any] | None = None,
    *,
    inline_constants: bool = False,
) -> bytes:
    """Serialize a Graph to `.rten` V2 bytes (header + FlatBuffers + 64B-aligned
    tensor segment). With ``inline_constants`` the tensor data embeds in the
    FlatBuffer instead (like reference V1-style files)."""
    segment = _TensorSegment()
    writer = fbs.FbsWriter()
    graph_dict = _graph_to_fbs(graph, segment, inline_constants)
    model_dict: dict[str, Any] = {"schema_version": 1, "graph": graph_dict}
    if metadata:
        model_dict["metadata"] = {
            k: v for k, v in metadata.items()
            if k in dict.fromkeys(n for n, _, _ in fbs.TABLES["Metadata"])
        }
    root = writer.write_table("Model", model_dict)
    model_bytes = writer.finish(root)

    model_offset = Header.LEN
    tensor_data_offset = 0
    parts = [model_bytes]
    if segment.chunks:
        end = model_offset + len(model_bytes)
        pad = -end % _TENSOR_ALIGN
        parts.append(b"\0" * pad)
        tensor_data_offset = end + pad
        parts.extend(segment.chunks)
    header = Header(2, model_offset, len(model_bytes), tensor_data_offset)
    return header.to_bytes() + b"".join(parts)


class _TensorSegment:
    """64-byte-aligned tensor data accumulator
    (reference: tensor_data.py TensorDataBuilder)."""

    def __init__(self) -> None:
        self.chunks: list[bytes] = []
        self.offset = 0

    def add(self, arr: np.ndarray) -> int:
        pad = -self.offset % _TENSOR_ALIGN
        if pad:
            self.chunks.append(b"\0" * pad)
            self.offset += pad
        off = self.offset
        raw = np.ascontiguousarray(arr).tobytes()
        self.chunks.append(raw)
        self.offset += len(raw)
        return off


def _graph_to_fbs(graph: Graph, segment: _TensorSegment, inline: bool) -> dict:
    nodes = []
    for node in graph.nodes:
        if isinstance(node, ValueNode):
            dims = None
            if node.shape is not None:
                dims = [
                    {"name": d} if isinstance(d, str) else {"value": int(d or 0)}
                    for d in node.shape
                ]
            kind = ("ValueNode", {"shape": dims})
        elif isinstance(node, ConstantNode):
            kind = ("ConstantNode", _constant_to_fbs(node, segment, inline))
        elif isinstance(node, OperatorNode):
            kind = ("OperatorNode", _operator_to_fbs(node, segment, inline))
        else:
            raise TypeError(type(node))
        nodes.append({"name": node.name, "data": kind})
    return {
        "nodes": nodes,
        "inputs": graph.inputs,
        "outputs": graph.outputs,
        "captures": graph.captures or None,
    }


def _constant_to_fbs(node: ConstantNode, segment: _TensorSegment, inline: bool) -> dict:
    arr = node.value
    if arr.dtype == np.int64 or arr.dtype == np.bool_:
        # Converter policy: i64/bool clamp to i32 (reference: converter.py:446-467)
        arr = arr.astype(np.int32)
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    dtype_name = fbs.NUMPY_TO_CONSTANT_DTYPE.get(arr.dtype)
    if dtype_name is None:
        raise ModelLoadError(f"unsupported constant dtype {arr.dtype}")
    out: dict[str, Any] = {
        "shape": list(arr.shape),
        "dtype": fbs.CONSTANT_DATA_TYPES.index(dtype_name),
    }
    if inline:
        member = {
            "Float32": "FloatData", "Int32": "IntData",
            "Int8": "Int8Data", "UInt8": "UInt8Data",
        }[dtype_name]
        out["data"] = (member, {"data": arr.reshape(-1)})
    else:
        out["data_offset"] = segment.add(arr)
    return out


# Attrs that exist only in the in-memory IR (written by optimizer passes,
# e.g. absorb_transposes' perm_a/perm_b on MatMul) and have no .rten wire
# field. Serializing a graph that carries one would silently drop it and
# change results on reload — refuse loudly instead. (Optimized graphs are
# normally never saved: optimize_graph runs at Model load.)
_RUNTIME_ONLY_ATTRS = frozenset({"perm_a", "perm_b"})


def _operator_to_fbs(node: OperatorNode, segment: _TensorSegment, inline: bool) -> dict:
    if node.op_type not in fbs.OPERATOR_TYPES:
        raise ModelLoadError(f"unsupported operator type {node.op_type!r}")
    hazards = _RUNTIME_ONLY_ATTRS.intersection(node.attrs)
    if hazards:
        raise ModelLoadError(
            f"operator {node.op_type!r} carries runtime-only attrs "
            f"{sorted(hazards)} (written by the graph optimizer) that have no "
            f".rten wire field — saving would silently drop them; serialize "
            f"the unoptimized graph instead"
        )
    out: dict[str, Any] = {
        "type": fbs.OPERATOR_TYPES.index(node.op_type),
        "inputs": [i if i is not None else -1 for i in node.inputs],
        "outputs": [o if o is not None else -1 for o in node.outputs],
    }
    spec = OP_ATTRS.get(node.op_type)
    if spec is not None:
        table_name, field_specs = spec
        tbl: dict[str, Any] = {}
        for field, kind in field_specs.items():
            val = node.attrs.get(field)
            if val is None:
                if kind == "enum:AutoPad":
                    # CRITICAL: most attr tables default AutoPad to Same
                    # (schema.fbs:133 puts Same first), and FlatBuffers
                    # omits default-valued fields — so an absent IR attr
                    # (= explicit pads) MUST be written as NotSet or every
                    # reader sees SAME padding. Caught by the ResNet-50
                    # ONNX→.rten e2e parity test.
                    tbl[field] = _enum_from_ir(_ENUMS["AutoPad"], "not_set")
                continue
            if kind == "scalar":
                tbl[field] = val
            elif kind in ("intlist", "intlist_opt"):
                tbl[field] = [int(v) for v in val]
            elif kind.startswith("enum:"):
                tbl[field] = _enum_from_ir(_ENUMS[kind[5:]], val)
            elif kind == "graph":
                tbl[field] = _graph_to_fbs(val, segment, inline)
            elif kind == "scalar_union":
                v = np.asarray(val)
                if v.dtype.kind == "f":
                    tbl[field] = ("FloatScalar", {"value": float(v)})
                else:
                    tbl[field] = ("IntScalar", {"value": int(v)})
        out["attrs"] = (table_name, tbl)
    return out
