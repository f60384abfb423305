"""Programmatic ONNX writer (no onnx package needed): a copy of
``rten_tpu/format/onnx_builder.py``.

The counterpart of the reference's ModelBuilder test utility
(src/model_builder.rs) on the ONNX side: builds ModelProto bytes via the
minimal protobuf encoder, used by round-trip tests and by tooling that needs
to emit ONNX fixtures.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from rten_tpu_torch.format import onnx_reader as o
from rten_tpu_torch.format.protobuf import encode

_NP_TO_ONNX = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float64): 11,
}


def make_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    return encode(
        {
            "dims": list(arr.shape),
            "data_type": _NP_TO_ONNX[arr.dtype],
            "raw_data": np.ascontiguousarray(arr).tobytes(),
            "name": name,
        },
        o.TENSOR,
    )


def make_attribute(name: str, value: Any) -> bytes:
    d: dict[str, Any] = {"name": name}
    if isinstance(value, bool):
        d.update(type=2, i=int(value))
    elif isinstance(value, int):
        d.update(type=2, i=value)
    elif isinstance(value, float):
        d.update(type=1, f=value)
    elif isinstance(value, str):
        d.update(type=3, s=value.encode("utf-8"))
    elif isinstance(value, np.ndarray):
        d.update(type=4, t=make_tensor(name, value))
    elif isinstance(value, bytes):
        d.update(type=5, g=value)  # sub-graph
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            d.update(type=7, ints=[int(v) for v in value])
        elif all(isinstance(v, (float, np.floating)) for v in value):
            d.update(type=6, floats=[float(v) for v in value])
        else:
            d.update(type=8, strings=[str(v).encode() for v in value])
    else:
        raise TypeError(f"unsupported attribute value {value!r}")
    return encode(d, o.ATTRIBUTE)


def make_node(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str | None = None,
    **attrs,
) -> bytes:
    return encode(
        {
            "input": list(inputs),
            "output": list(outputs),
            "name": name or op_type,
            "op_type": op_type,
            "attribute": [make_attribute(k, v) for k, v in attrs.items()],
        },
        o.NODE,
    )


def make_value_info(name: str, shape: Sequence[int | str] | None, elem_type: int = 1) -> bytes:
    type_bytes = None
    if shape is not None:
        dims = []
        for d in shape:
            if isinstance(d, str):
                dims.append(encode({"dim_param": d}, o.DIM))
            else:
                dims.append(encode({"dim_value": int(d)}, o.DIM))
        shape_bytes = encode({"dim": dims}, o.SHAPE)
        tt = encode({"elem_type": elem_type, "shape": shape_bytes}, o.TENSOR_TYPE)
        type_bytes = encode({"tensor_type": tt}, o.TYPE)
    d = {"name": name}
    if type_bytes is not None:
        d["type"] = type_bytes
    return encode(d, o.VALUE_INFO)


def make_graph(
    nodes: Sequence[bytes],
    name: str = "graph",
    inputs: Sequence[bytes] = (),
    outputs: Sequence[bytes] = (),
    initializers: Sequence[bytes] = (),
) -> bytes:
    return encode(
        {
            "node": list(nodes),
            "name": name,
            "initializer": list(initializers),
            "input": list(inputs),
            "output": list(outputs),
        },
        o.GRAPH,
    )


def make_model(graph: bytes, ir_version: int = 8, opset: int = 17) -> bytes:
    return encode(
        {
            "ir_version": ir_version,
            "graph": graph,
            "opset_import": [encode({"domain": "", "version": opset}, o.OPSET)],
        },
        o.MODEL,
    )
