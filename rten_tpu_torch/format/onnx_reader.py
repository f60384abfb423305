"""ONNX importer: .onnx ModelProto → the port's Graph
(``rten_tpu_torch.graph``): a copy of ``rten_tpu/format/onnx_reader.py``.

The equivalent of the reference converter's front half
(rten-convert/rten_convert/converter.py:992 graph_from_onnx_graph, :562
op_node_from_onnx_operator, :446-467 i64/bool→i32 policy), at load time; a
graph re-serializes to `.rten` through ``rten_io.save_rten`` (the
``convert`` CLI). Initializers keep their ONNX dtype but the policy's: int64
and the other wide integers clamp to int32, bool becomes int32, f64 / f16
become f32, as the port's ops see them (JAX's x64-off rules).

Parses the protobuf wire format directly (``format.protobuf``): no onnx
package needed.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from rten_tpu_torch.format.protobuf import Schema, decode
from rten_tpu_torch.graph import ConstantNode, Graph

# ---- ONNX protobuf schemas (onnx.proto3 field numbers) ----------------------

TENSOR = Schema({
    1: ("dims", "repeated_int64"),
    2: ("data_type", "varint"),
    4: ("float_data", "repeated_float"),
    5: ("int32_data", "repeated_int64"),
    7: ("int64_data", "repeated_int64"),
    8: ("name", "string"),
    9: ("raw_data", "bytes"),
    10: ("double_data", "repeated_double"),
    11: ("uint64_data", "repeated_int64"),
})
DIM = Schema({1: ("dim_value", "int64"), 2: ("dim_param", "string")})
SHAPE = Schema({1: ("dim", "repeated_message:Dimension")})
TENSOR_TYPE = Schema({1: ("elem_type", "varint"), 2: ("shape", "message:Shape")})
TYPE = Schema({1: ("tensor_type", "message:TensorType")})
VALUE_INFO = Schema({1: ("name", "string"), 2: ("type", "message:Type")})
ATTRIBUTE = Schema({
    1: ("name", "string"),
    2: ("f", "float"),
    3: ("i", "int64"),
    4: ("s", "bytes"),
    5: ("t", "message:Tensor"),
    6: ("g", "message:Graph"),
    7: ("floats", "repeated_float"),
    8: ("ints", "repeated_int64"),
    9: ("strings", "repeated_bytes"),
    20: ("type", "varint"),
})
NODE = Schema({
    1: ("input", "repeated_string"),
    2: ("output", "repeated_string"),
    3: ("name", "string"),
    4: ("op_type", "string"),
    5: ("attribute", "repeated_message:Attribute"),
    7: ("domain", "string"),
})
GRAPH = Schema({
    1: ("node", "repeated_message:Node"),
    2: ("name", "string"),
    5: ("initializer", "repeated_message:Tensor"),
    11: ("input", "repeated_message:ValueInfo"),
    12: ("output", "repeated_message:ValueInfo"),
    13: ("value_info", "repeated_message:ValueInfo"),
})
OPSET = Schema({1: ("domain", "string"), 2: ("version", "int64")})
MODEL = Schema({
    1: ("ir_version", "int64"),
    7: ("graph", "message:Graph"),
    8: ("opset_import", "repeated_message:Opset"),
})

_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64, 16: np.float32,  # bfloat16 → f32 on import
}


class OnnxImportError(ValueError):
    pass


def tensor_to_numpy(t: dict) -> np.ndarray:
    dims = [int(d) for d in t.get("dims", [])]
    dtype_code = t.get("data_type", 1)
    np_dtype = _ONNX_DTYPES.get(dtype_code)
    if np_dtype is None:
        raise OnnxImportError(f"unsupported ONNX tensor dtype {dtype_code}")
    raw = t.get("raw_data")
    if raw is not None:
        if dtype_code == 16:  # bfloat16 raw: upcast via int16 << 16
            u16 = np.frombuffer(raw, np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, np_dtype)
    elif t.get("float_data"):
        arr = np.asarray(t["float_data"], np.float32)
    elif t.get("int32_data"):
        arr = np.asarray(t["int32_data"], np.int32)
    elif t.get("int64_data"):
        arr = np.asarray(t["int64_data"], np.int64)
    elif t.get("double_data"):
        arr = np.asarray(t["double_data"], np.float64)
    else:
        arr = np.zeros(0, np_dtype)
    return arr.reshape(dims)


def _clamp_to_supported(arr: np.ndarray) -> np.ndarray:
    """Reference converter policy (converter.py:446-467): i64 clamps to i32,
    bool → i32, f64/f16 → f32."""
    if arr.dtype == np.int64 or arr.dtype in (np.uint32, np.uint64, np.int16, np.uint16):
        return np.clip(arr, -(2**31), 2**31 - 1).astype(np.int32)
    if arr.dtype == np.bool_:
        return arr.astype(np.int32)
    if arr.dtype in (np.float64, np.float16):
        return arr.astype(np.float32)
    return arr


def _attrs_list(node: dict) -> dict[str, Any]:
    out = {}
    for raw in node.get("attribute", []):
        a = decode(raw, ATTRIBUTE)
        name = a.get("name")
        atype = a.get("type", 0)
        if atype == 1:
            out[name] = float(a.get("f", 0.0))
        elif atype == 2:
            out[name] = int(a.get("i", 0))
        elif atype == 3:
            out[name] = a.get("s", b"").decode("utf-8")
        elif atype == 4:
            out[name] = tensor_to_numpy(decode(a["t"], TENSOR))
        elif atype == 5:
            out[name] = a["g"]  # raw graph bytes; decoded by caller
        elif atype == 6:
            out[name] = [float(v) for v in a.get("floats", [])]
        elif atype == 7:
            out[name] = [int(v) for v in a.get("ints", [])]
        elif atype == 8:
            out[name] = [s.decode("utf-8") for s in a.get("strings", [])]
        else:
            out[name] = None
    return out


def load_onnx(data: bytes) -> tuple[Graph, dict[str, Any]]:
    model = decode(data, MODEL)
    graph_raw = model.get("graph")
    if graph_raw is None:
        raise OnnxImportError("model has no graph")
    graph = _import_graph(decode(graph_raw, GRAPH))
    return graph, {"ir_version": model.get("ir_version")}


def load_onnx_file(path: str) -> tuple[Graph, dict[str, Any]]:
    with open(path, "rb") as f:
        return load_onnx(f.read())


def _shape_from_value_info(vi: dict) -> list[int | str | None] | None:
    t = vi.get("type")
    if t is None:
        return None
    tt = decode(t, TYPE).get("tensor_type")
    if tt is None:
        return None
    shape_raw = decode(tt, TENSOR_TYPE).get("shape")
    if shape_raw is None:
        return None
    dims = []
    for draw in decode(shape_raw, SHAPE).get("dim", []):
        d = decode(draw, DIM)
        if d.get("dim_param"):
            dims.append(d["dim_param"])
        else:
            dims.append(int(d.get("dim_value", 0)))
    return dims


def _import_graph(g: dict, outer: "dict[str, int] | None" = None) -> Graph:
    graph = Graph()
    name_to_id: dict[str, int] = {}

    def get_or_create(name: str) -> int:
        nid = name_to_id.get(name)
        if nid is None:
            nid = graph.add_value(name)
            name_to_id[name] = nid
        return nid

    for raw in g.get("initializer", []):
        t = decode(raw, TENSOR)
        arr = _clamp_to_supported(tensor_to_numpy(t))
        name_to_id[t.get("name", "")] = graph.add_constant(t.get("name"), arr)

    initializer_names = set(name_to_id)
    for raw in g.get("input", []):
        vi = decode(raw, VALUE_INFO)
        name = vi.get("name", "")
        if name in initializer_names:
            continue  # initializers may be re-listed as inputs
        nid = graph.add_value(name, _shape_from_value_info(vi))
        name_to_id[name] = nid
        graph.inputs.append(nid)

    # Captures: names consumed in this graph but defined in the enclosing
    # scope (If branch subgraphs).
    def note_capture(name: str) -> int:
        nid = graph.add_value(name)
        name_to_id[name] = nid
        graph.captures.append(nid)
        return nid

    for raw in g.get("node", []):
        node = decode(raw, NODE)
        op_type = node.get("op_type", "")
        attrs = _attrs_list(node)
        if op_type == "Constant":
            # Becomes a ConstantNode directly (reference: converter.py:477) —
            # handled before output value nodes are created.
            _add_onnx_operator(graph, node, op_type, attrs, [], [], name_to_id)
            continue
        inputs: list[int | None] = []
        for in_name in node.get("input", []):
            if in_name == "":
                inputs.append(None)
            elif in_name in name_to_id:
                inputs.append(name_to_id[in_name])
            elif outer is not None and in_name in outer:
                inputs.append(note_capture(in_name))
            else:
                inputs.append(note_capture(in_name) if outer is not None else get_or_create(in_name))
        out_ids = []
        for out_name in node.get("output", []):
            out_ids.append(get_or_create(out_name) if out_name else None)

        _add_onnx_operator(graph, node, op_type, attrs, inputs, out_ids, name_to_id)

    for raw in g.get("output", []):
        vi = decode(raw, VALUE_INFO)
        nid = name_to_id.get(vi.get("name", ""))
        if nid is not None:
            graph.outputs.append(nid)
    return graph


def _const_input(graph: Graph, name: str, arr: np.ndarray) -> int:
    return graph.add_constant(name, _clamp_to_supported(np.asarray(arr)))


_DIRECTIONS = {"forward": "forward", "reverse": "reverse", "bidirectional": "bidirectional"}
_COORD_MODES = {
    "half_pixel": "half_pixel",
    "pytorch_half_pixel": "half_pixel",
    "asymmetric": "asymmetric",
    "align_corners": "align_corners",
}
_NEAREST_MODES = {
    "floor": "floor", "ceil": "ceil",
    "round_prefer_floor": "round_prefer_floor",
    "round_prefer_ceil": "round_prefer_ceil",
}
_CAST_TARGETS = {1: "float32", 6: "int32", 7: "int32", 9: "int32", 3: "int8", 2: "uint8", 10: "float32", 11: "float32"}


def _add_onnx_operator(graph, node, op_type, attrs, inputs, out_ids, name_to_id):
    """Per-op attribute translation (reference: converter.py:562
    op_node_from_onnx_operator)."""
    name = node.get("name") or op_type
    a: dict[str, Any] = {}

    def auto_pad_attrs():
        ap = attrs.get("auto_pad", "NOTSET")
        if ap in ("SAME_UPPER", "SAME_LOWER"):
            a["auto_pad"] = "same"
        elif attrs.get("pads"):
            a["pads"] = attrs["pads"]

    if op_type == "Constant":
        # Becomes a ConstantNode directly (reference: converter.py:477).
        value = attrs.get("value")
        if value is None:
            for key in ("value_float", "value_int"):
                if key in attrs:
                    value = np.asarray(attrs[key])
        if value is None:
            raise OnnxImportError(f"Constant node {name!r} without value")
        arr = _clamp_to_supported(np.asarray(value))
        out_name = node.get("output", [""])[0]
        cid = graph.add_constant(out_name, arr)
        name_to_id[out_name] = cid
        return

    if op_type == "Dropout":
        op_type = "Identity"
        inputs = inputs[:1]
        out_ids = out_ids[:1]
    elif op_type in ("ArgMax", "ArgMin"):
        if attrs.get("select_last_index"):
            raise OnnxImportError(f"{op_type}: select_last_index unsupported")
        a = {"axis": attrs.get("axis", 0), "keep_dims": bool(attrs.get("keepdims", 1))}
    elif op_type in ("AveragePool", "MaxPool"):
        if attrs.get("ceil_mode"):
            raise OnnxImportError(f"{op_type}: ceil_mode unsupported")
        a = {"kernel_size": attrs.get("kernel_shape", [])}
        auto_pad_attrs()
        if attrs.get("strides"):
            a["strides"] = attrs["strides"]
        if op_type == "AveragePool":
            a["count_include_pad"] = bool(attrs.get("count_include_pad", 0))
    elif op_type in ("BatchNormalization", "InstanceNormalization"):
        a = {"epsilon": attrs.get("epsilon", 1e-5)}
        out_ids = out_ids[:1]
    elif op_type == "Cast":
        to = _CAST_TARGETS.get(attrs.get("to", 1))
        if to is None:
            raise OnnxImportError(f"Cast: unsupported target {attrs.get('to')}")
        a = {"to": to}
    elif op_type == "CastLike":
        raise OnnxImportError("CastLike unsupported; run ONNX shape inference first")
    elif op_type == "Clip":
        # opset<11 attrs → constant inputs
        if "min" in attrs or "max" in attrs:
            inputs = [
                inputs[0],
                _const_input(graph, f"{name}_min", np.float32(attrs.get("min", -np.inf))),
                _const_input(graph, f"{name}_max", np.float32(attrs.get("max", np.inf))),
            ]
    elif op_type == "Concat":
        a = {"axis": attrs.get("axis", 0)}
    elif op_type == "ConstantOfShape":
        v = attrs.get("value")
        a = {"value": np.asarray(v).reshape(()) if v is not None else np.float32(0)}
    elif op_type == "Conv":
        a = {"groups": attrs.get("group", 1)}
        auto_pad_attrs()
        for key in ("strides", "dilations"):
            if attrs.get(key):
                a[key] = attrs[key]
    elif op_type == "ConvTranspose":
        if attrs.get("output_padding") or attrs.get("output_shape"):
            raise OnnxImportError("ConvTranspose: output_padding/output_shape unsupported")
        if attrs.get("group", 1) != 1:
            raise OnnxImportError("ConvTranspose: groups unsupported")
        auto_pad_attrs()
        if attrs.get("strides"):
            a["strides"] = attrs["strides"]
    elif op_type == "CumSum":
        if attrs.get("exclusive") or attrs.get("reverse"):
            raise OnnxImportError("CumSum: exclusive/reverse unsupported")
    elif op_type in ("DequantizeLinear", "QuantizeLinear"):
        a = {"axis": attrs.get("axis", 1)}
    elif op_type == "Einsum":
        a = {"equation": attrs.get("equation", "")}
    elif op_type == "Elu":
        a = {"alpha": attrs.get("alpha", 1.0)}
    elif op_type == "Flatten":
        a = {"axis": attrs.get("axis", 1)}
    elif op_type in ("Gather", "GatherElements"):
        a = {"axis": attrs.get("axis", 0)}
    elif op_type == "GatherND":
        a = {"batch_dims": attrs.get("batch_dims", 0)}
    elif op_type == "Gelu":
        if attrs.get("approximate") == "tanh":
            raise OnnxImportError("Gelu: tanh approximation unsupported")
    elif op_type == "Gemm":
        a = {
            "alpha": attrs.get("alpha", 1.0),
            "beta": attrs.get("beta", 1.0),
            "transpose_a": bool(attrs.get("transA", 0)),
            "transpose_b": bool(attrs.get("transB", 0)),
        }
    elif op_type == "GRU":
        a = {
            "direction": _DIRECTIONS[attrs.get("direction", "forward")],
            "hidden_size": attrs.get("hidden_size", 0),
            "linear_before_reset": bool(attrs.get("linear_before_reset", 0)),
        }
    elif op_type == "LSTM":
        a = {
            "direction": _DIRECTIONS[attrs.get("direction", "forward")],
            "hidden_size": attrs.get("hidden_size", 0),
        }
        out_ids = out_ids[:3]
    elif op_type == "HardSigmoid":
        a = {"alpha": attrs.get("alpha", 0.2), "beta": attrs.get("beta", 0.5)}
    elif op_type == "If":
        a = {
            "then_branch": _import_graph(decode(attrs["then_branch"], GRAPH), outer=name_to_id),
            "else_branch": _import_graph(decode(attrs["else_branch"], GRAPH), outer=name_to_id),
        }
    elif op_type == "LayerNormalization":
        a = {"axis": attrs.get("axis", -1), "epsilon": attrs.get("epsilon", 1e-5)}
        out_ids = out_ids[:1]
    elif op_type == "LeakyRelu":
        a = {"alpha": attrs.get("alpha", 0.01)}
    elif op_type in ("Softmax", "LogSoftmax"):
        a = {"axis": attrs.get("axis", -1)}
    elif op_type == "Mod":
        a = {"fmod": bool(attrs.get("fmod", 0))}
    elif op_type == "NonMaxSuppression":
        a = {
            "box_order": "center_width_height"
            if attrs.get("center_point_box")
            else "top_left_bottom_right"
        }
    elif op_type == "OneHot":
        a = {"axis": attrs.get("axis", -1)}
    elif op_type == "Pad":
        a = {"mode": attrs.get("mode", "constant")}
        if "pads" in attrs:  # opset<11 → input
            inputs = [
                inputs[0],
                _const_input(graph, f"{name}_pads", np.asarray(attrs["pads"], np.int64)),
            ]
    elif op_type.startswith("Reduce"):
        a = {"keep_dims": bool(attrs.get("keepdims", 1))}
        if attrs.get("axes"):
            a["axes"] = attrs["axes"]
        elif len(inputs) > 1 and inputs[1] is not None:
            # opset 18 axes-as-input: fold when constant
            axes_node = graph.nodes[inputs[1]]
            if isinstance(axes_node, ConstantNode):
                a["axes"] = [int(v) for v in axes_node.value]
                inputs = inputs[:1]
            else:
                raise OnnxImportError(f"{op_type}: dynamic axes input unsupported")
    elif op_type == "Reshape":
        a = {"allow_zero": bool(attrs.get("allowzero", 0))}
    elif op_type == "Resize":
        mode = attrs.get("mode", "nearest")
        if mode not in ("nearest", "linear"):
            raise OnnxImportError(f"Resize: mode {mode!r} unsupported")
        cm = attrs.get("coordinate_transformation_mode", "half_pixel")
        if cm not in _COORD_MODES:
            raise OnnxImportError(f"Resize: coord mode {cm!r} unsupported")
        a = {
            "mode": mode,
            "coord_mode": _COORD_MODES[cm],
            "nearest_mode": _NEAREST_MODES.get(
                attrs.get("nearest_mode", "round_prefer_floor"), "round_prefer_floor"
            ),
        }
    elif op_type == "ScatterElements":
        a = {"axis": attrs.get("axis", 0), "reduction": attrs.get("reduction", "none")}
    elif op_type == "ScatterND":
        a = {"reduction": attrs.get("reduction", "none")}
    elif op_type == "Shape":
        if attrs.get("start") or "end" in attrs:
            raise OnnxImportError("Shape: start/end attrs unsupported")
    elif op_type == "Split":
        a = {"axis": attrs.get("axis", 0)}
        if attrs.get("split"):  # opset<13 attr → input
            inputs = list(inputs[:1]) + [
                _const_input(graph, f"{name}_split", np.asarray(attrs["split"], np.int64))
            ]
    elif op_type in ("Squeeze", "Unsqueeze"):
        if attrs.get("axes"):  # opset<13 attr → input
            inputs = list(inputs[:1]) + [
                _const_input(graph, f"{name}_axes", np.asarray(attrs["axes"], np.int64))
            ]
    elif op_type == "TopK":
        a = {
            "axis": attrs.get("axis", -1),
            "largest": bool(attrs.get("largest", 1)),
            "sorted": bool(attrs.get("sorted", 1)),
        }
        if "k" in attrs:  # opset 1
            inputs = list(inputs[:1]) + [
                _const_input(graph, f"{name}_k", np.asarray(attrs["k"], np.int64))
            ]
    elif op_type == "Transpose":
        if attrs.get("perm"):
            a = {"perm": attrs["perm"]}
    elif op_type == "Trilu":
        a = {"upper": bool(attrs.get("upper", 1))}
    elif op_type in (
        "RandomNormal", "RandomNormalLike", "RandomUniform", "RandomUniformLike",
    ):
        a = {k: attrs[k] for k in ("mean", "scale", "high", "low", "seed", "shape") if k in attrs}

    from rten_tpu_torch.ops.registry import have_op

    if not have_op(op_type):
        raise OnnxImportError(f"unsupported ONNX operator {op_type!r}")
    graph.add_operator(name, op_type, a, inputs, out_ids)
