"""Declarative FlatBuffers schema for `.rten` and a generic reader / writer.

Counterpart of ``rten_tpu/format/fbs.py``: the same schema tables and enums
(the reference's src/schema.fbs, with the rten_tpu quantization extension:
``ConstantDataType`` Int8 / UInt8, the DequantizeLinear..QLinearMatMul
operators, QuantizeAttrs / QLinearMatMulAttrs), read by the same
``FbsReader`` on ``struct``. The writer builds the buffer itself on
``struct`` (``_Builder``), with no ``flatbuffers`` package: back to front,
vtables (deduplicated), 32-bit offsets, each scalar aligned to its size,
unions as a type byte plus an offset, a field equal to its default left
out. It is deterministic, so ``save(load(save(g)))`` equals ``save(g)``
byte for byte.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# Enums (reference: src/schema.fbs:12-163, 353-356, 366-369, 416-422, 489-492)
# ---------------------------------------------------------------------------

OPERATOR_TYPES = [
    "Add", "ArgMin", "ArgMax", "AveragePool", "BatchNormalization", "Cast",
    "Clip", "Concat", "ConstantOfShape", "Conv", "ConvTranspose", "Cos",
    "CumSum", "Div", "Equal", "Erf", "Expand", "Flatten", "Gather", "Gemm",
    "GlobalAveragePool", "Greater", "GRU", "Identity", "LeakyRelu", "Less",
    "LessOrEqual", "Log", "LogSoftmax", "LSTM", "MatMul", "MaxPool", "Mod",
    "Mul", "Pad", "Pow", "Range", "ReduceMean", "ReduceL2", "Relu", "Reshape",
    "Resize", "Shape", "Sigmoid", "Sin", "Slice", "Split", "Sqrt", "Squeeze",
    "Softmax", "Sub", "Tanh", "Transpose", "Unsqueeze", "Where",
    # New operators appended for binary compatibility (schema.fbs:69-120)
    "ReduceProd", "ReduceSum", "ReduceMin", "ReduceMax", "NonZero",
    "ScatterElements", "Tile", "Not", "Abs", "Max", "Mean", "Min", "Sum",
    "OneHot", "Round", "Floor", "Ceil", "Reciprocal", "TopK", "Neg", "Exp",
    "GreaterOrEqual", "Size", "Tan", "Acos", "Asin", "Atan",
    "InstanceNormalization", "HardSigmoid", "HardSwish", "And", "Or", "Xor",
    "Trilu", "ScatterND", "NonMaxSuppression", "Sign", "GatherElements",
    "LayerNormalization", "ReduceSumSquare", "RandomUniform", "Elu",
    "RandomUniformLike", "RandomNormal", "RandomNormalLike", "Softplus",
    "GatherND", "Gelu", "Einsum", "If",
    # --- rten_tpu quantization extension (appended; not in reference) ---
    "DequantizeLinear", "QuantizeLinear", "DynamicQuantizeLinear",
    "QLinearMatMul",
]

RNN_DIRECTIONS = ["Forward", "Reverse", "Bidirectional"]
AUTO_PAD = ["Same", "NotSet"]
DATA_TYPES = ["Int32", "Float"]
COORD_TRANSFORM_MODES = ["HalfPixel", "Asymmetric", "AlignCorners"]
NEAREST_MODES = ["Floor", "Ceil", "RoundPreferFloor", "RoundPreferCeil"]
RESIZE_MODES = ["Nearest", "Linear"]
NMS_BOX_ORDERS = ["TopLeftBottomRight", "CenterWidthHeight"]
PAD_MODES = ["Constant", "Reflect"]
SCATTER_REDUCTIONS = ["None", "Add", "Mul", "Min", "Max"]
# Int8/UInt8 appended (extension); reference has Int32/Float32 only.
CONSTANT_DATA_TYPES = ["Int32", "Float32", "Int8", "UInt8"]

CONSTANT_DTYPE_TO_NUMPY = {
    "Int32": np.int32,
    "Float32": np.float32,
    "Int8": np.int8,
    "UInt8": np.uint8,
}
NUMPY_TO_CONSTANT_DTYPE = {
    np.dtype(np.int32): "Int32",
    np.dtype(np.float32): "Float32",
    np.dtype(np.int8): "Int8",
    np.dtype(np.uint8): "UInt8",
}

# ---------------------------------------------------------------------------
# Unions — member order defines the type tag (tag = index + 1; 0 = NONE).
# ---------------------------------------------------------------------------

UNIONS: dict[str, list[str]] = {
    # reference: src/schema.fbs:166-210 (+ extension entries appended)
    "OperatorAttrs": [
        "ArgMaxAttrs", "AveragePoolAttrs", "BatchNormalizationAttrs",
        "CastAttrs", "ConcatAttrs", "ConstantOfShapeAttrs", "ConvAttrs",
        "ConvTransposeAttrs", "FlattenAttrs", "GatherAttrs", "GemmAttrs",
        "GRUAttrs", "LeakyReluAttrs", "LSTMAttrs", "MaxPoolAttrs",
        "ReduceMeanAttrs", "ReshapeAttrs", "ResizeAttrs", "SplitAttrs",
        "SoftmaxAttrs", "TransposeAttrs",
        "ModAttrs", "ScatterElementsAttrs", "OneHotAttrs", "TopKAttrs",
        "HardSigmoidAttrs", "TriluAttrs", "ScatterNDAttrs",
        "NonMaxSuppressionAttrs", "LayerNormalizationAttrs",
        "RandomUniformAttrs", "EluAttrs", "RandomUniformLikeAttrs",
        "RandomNormalAttrs", "RandomNormalLikeAttrs", "GatherNDAttrs",
        "GeluAttrs", "EinsumAttrs", "IfAttrs", "PadAttrs",
        # --- rten_tpu quantization extension ---
        "QuantizeAttrs", "QLinearMatMulAttrs",
    ],
    "NodeKind": ["OperatorNode", "ConstantNode", "ValueNode"],
    "ConstantData": ["FloatData", "IntData", "Int8Data", "UInt8Data"],
    "Scalar": ["IntScalar", "FloatScalar"],
}

# ---------------------------------------------------------------------------
# Tables. Each field: (name, kind, default).
#   kind ∈ scalar names | 'string' | 'table:X' | 'union:X' | 'vector:<elem>'
#   A union occupies TWO slots (type, value); list it once.
#   default=None on a scalar means "nullable": absent reads as None and any
#   provided value is force-written.
# ---------------------------------------------------------------------------

TABLES: dict[str, list[tuple[str, str, Any]]] = {
    "Model": [
        ("schema_version", "int", 0),
        ("graph", "table:Graph", None),
        ("metadata", "table:Metadata", None),
    ],
    "Graph": [
        ("nodes", "vector:table:Node", None),
        ("inputs", "vector:uint", None),
        ("outputs", "vector:uint", None),
        ("captures", "vector:uint", None),
    ],
    "Node": [
        ("name", "string", None),
        ("data", "union:NodeKind", None),
    ],
    "OperatorNode": [
        ("type", "ubyte", 0),
        ("attrs", "union:OperatorAttrs", None),
        ("inputs", "vector:int", None),
        ("outputs", "vector:int", None),
    ],
    "ConstantNode": [
        ("shape", "vector:uint", None),
        ("data", "union:ConstantData", None),
        ("dtype", "ushort", None),
        ("data_offset", "ulong", None),
    ],
    "ValueNode": [
        ("shape", "vector:table:Dim", None),
    ],
    "Dim": [
        ("value", "uint", 0),
        ("name", "string", None),
    ],
    "Metadata": [
        ("onnx_hash", "string", None),
        ("description", "string", None),
        ("license", "string", None),
        ("commit", "string", None),
        ("code_repository", "string", None),
        ("model_repository", "string", None),
        ("run_id", "string", None),
        ("run_url", "string", None),
    ],
    "FloatData": [("data", "vector:float", None)],
    "IntData": [("data", "vector:int", None)],
    "Int8Data": [("data", "vector:byte", None)],
    "UInt8Data": [("data", "vector:ubyte", None)],
    "IntScalar": [("value", "int", 0)],
    "FloatScalar": [("value", "float", 0.0)],
    # --- operator attrs (reference: src/schema.fbs:212-453) ---
    "ArgMaxAttrs": [("axis", "int", 0), ("keep_dims", "bool", False)],
    "AveragePoolAttrs": [
        ("kernel_size", "vector:uint", None),
        ("auto_pad", "ubyte", 0),
        ("pads", "vector:uint", None),
        ("strides", "vector:uint", None),
        ("count_include_pad", "bool", False),
    ],
    "BatchNormalizationAttrs": [("epsilon", "float", 0.0)],
    "CastAttrs": [("to", "ubyte", 0)],
    "ConcatAttrs": [("axis", "int", 0)],
    "ConstantOfShapeAttrs": [("value", "union:Scalar", None)],
    "ConvAttrs": [
        ("auto_pad", "ubyte", 0),
        ("pads", "vector:uint", None),
        ("groups", "uint", 0),
        ("strides", "vector:uint", None),
        ("dilations", "vector:uint", None),
    ],
    "ConvTransposeAttrs": [
        ("strides", "vector:uint", None),
        ("auto_pad", "ubyte", 1),  # default NotSet (schema.fbs:273)
        ("pads", "vector:uint", None),
    ],
    "FlattenAttrs": [("axis", "int", 0)],
    "GatherAttrs": [("axis", "int", 0)],
    "GemmAttrs": [
        ("alpha", "float", 0.0),
        ("beta", "float", 0.0),
        ("transpose_a", "bool", False),
        ("transpose_b", "bool", False),
    ],
    "GRUAttrs": [
        ("direction", "ubyte", 0),
        ("hidden_size", "uint", 0),
        ("linear_before_reset", "bool", False),
    ],
    "LeakyReluAttrs": [("alpha", "float", 0.0)],
    "LSTMAttrs": [("direction", "ubyte", 0), ("hidden_size", "uint", 0)],
    "MaxPoolAttrs": [
        ("kernel_size", "vector:uint", None),
        ("auto_pad", "ubyte", 0),
        ("pads", "vector:uint", None),
        ("strides", "vector:uint", None),
    ],
    "ReduceMeanAttrs": [("axes", "vector:int", None), ("keep_dims", "bool", False)],
    "ReshapeAttrs": [("allow_zero", "bool", False)],
    "ResizeAttrs": [
        ("mode", "ubyte", 0),
        ("coord_mode", "ubyte", 0),
        ("nearest_mode", "ubyte", 0),
    ],
    "SplitAttrs": [("axis", "int", 0)],
    "SoftmaxAttrs": [("axis", "int", 0)],
    "TransposeAttrs": [("perm", "vector:uint", None)],
    "ModAttrs": [("fmod", "bool", False)],
    "ScatterElementsAttrs": [("axis", "int", 0), ("reduction", "ubyte", 0)],
    "OneHotAttrs": [("axis", "int", 0)],
    "TopKAttrs": [
        ("axis", "int", 0),
        ("largest", "bool", False),
        ("sorted", "bool", False),
    ],
    "HardSigmoidAttrs": [("alpha", "float", 0.0), ("beta", "float", 0.0)],
    "TriluAttrs": [("upper", "bool", False)],
    "ScatterNDAttrs": [("reduction", "ubyte", 0)],
    "NonMaxSuppressionAttrs": [("box_order", "ubyte", 0)],
    "LayerNormalizationAttrs": [("axis", "int", 0), ("epsilon", "float", 0.0)],
    "RandomUniformAttrs": [
        ("shape", "vector:uint", None),
        ("high", "float", 0.0),
        ("low", "float", 0.0),
        ("seed", "float", None),
    ],
    "EluAttrs": [("alpha", "float", 0.0)],
    "RandomUniformLikeAttrs": [
        ("high", "float", 0.0),
        ("low", "float", 0.0),
        ("seed", "float", None),
    ],
    "RandomNormalAttrs": [
        ("mean", "float", 0.0),
        ("scale", "float", 0.0),
        ("seed", "float", None),
        ("shape", "vector:uint", None),
    ],
    "RandomNormalLikeAttrs": [
        ("mean", "float", 0.0),
        ("scale", "float", 0.0),
        ("seed", "float", None),
    ],
    "GatherNDAttrs": [("batch_dims", "int", 0)],
    "GeluAttrs": [],
    "EinsumAttrs": [("equation", "string", None)],
    "IfAttrs": [
        ("then_branch", "table:Graph", None),
        ("else_branch", "table:Graph", None),
    ],
    "PadAttrs": [("mode", "ubyte", 0)],
    # --- rten_tpu quantization extension ---
    "QuantizeAttrs": [("axis", "int", 1), ("output_dtype", "ubyte", 0)],
    "QLinearMatMulAttrs": [],
}

_SCALAR_FMT = {
    "bool": ("<?", 1),
    "byte": ("<b", 1),
    "ubyte": ("<B", 1),
    "short": ("<h", 2),
    "ushort": ("<H", 2),
    "int": ("<i", 4),
    "uint": ("<I", 4),
    "long": ("<q", 8),
    "ulong": ("<Q", 8),
    "float": ("<f", 4),
    "double": ("<d", 8),
}
_VECTOR_NUMPY = {
    "bool": np.bool_,
    "byte": np.int8,
    "ubyte": np.uint8,
    "short": np.int16,
    "ushort": np.uint16,
    "int": np.int32,
    "uint": np.uint32,
    "long": np.int64,
    "ulong": np.uint64,
    "float": np.float32,
    "double": np.float64,
}


# ---------------------------------------------------------------------------
# Generic reader
# ---------------------------------------------------------------------------


class FbsReader:
    """Reads tables per the spec above into plain dicts.

    Union fields read as ``(member_type_name, value_dict)``. Numeric vectors
    read as zero-copy numpy views into the underlying buffer.
    """

    def __init__(self, buf: bytes | bytearray | memoryview, base: int = 0):
        self.buf = memoryview(buf)
        self.base = base

    def _u16(self, pos: int) -> int:
        return struct.unpack_from("<H", self.buf, pos)[0]

    def _i32(self, pos: int) -> int:
        return struct.unpack_from("<i", self.buf, pos)[0]

    def _u32(self, pos: int) -> int:
        return struct.unpack_from("<I", self.buf, pos)[0]

    def root(self, table_name: str) -> dict:
        root_pos = self.base + self._u32(self.base)
        return self.read_table(table_name, root_pos)

    def _field_pos(self, table_pos: int, slot: int) -> int | None:
        """Absolute position of field data for vtable slot, or None if absent."""
        vtable_pos = table_pos - self._i32(table_pos)
        vtable_len = self._u16(vtable_pos)
        entry = 4 + 2 * slot
        if entry >= vtable_len:
            return None
        off = self._u16(vtable_pos + entry)
        if off == 0:
            return None
        return table_pos + off

    def _read_scalar(self, kind: str, pos: int):
        return struct.unpack_from(_SCALAR_FMT[kind][0], self.buf, pos)[0]

    def _read_string(self, field_pos: int) -> str:
        spos = field_pos + self._u32(field_pos)
        n = self._u32(spos)
        return bytes(self.buf[spos + 4 : spos + 4 + n]).decode("utf-8")

    def _read_vector(self, elem_kind: str, field_pos: int):
        vpos = field_pos + self._u32(field_pos)
        n = self._u32(vpos)
        data_pos = vpos + 4
        if elem_kind.startswith("table:"):
            name = elem_kind[len("table:") :]
            out = []
            for i in range(n):
                p = data_pos + 4 * i
                out.append(self.read_table(name, p + self._u32(p)))
            return out
        if elem_kind == "string":
            return [self._read_string(data_pos + 4 * i) for i in range(n)]
        return np.frombuffer(self.buf, dtype=_VECTOR_NUMPY[elem_kind], count=n, offset=data_pos)

    def read_table(self, table_name: str, table_pos: int) -> dict:
        fields = TABLES[table_name]
        out: dict[str, Any] = {"__table__": table_name}
        slot = 0
        for name, kind, default in fields:
            if kind.startswith("union:"):
                union_name = kind[len("union:") :]
                type_pos = self._field_pos(table_pos, slot)
                val_pos = self._field_pos(table_pos, slot + 1)
                slot += 2
                if type_pos is None or val_pos is None:
                    out[name] = None
                    continue
                tag = self._read_scalar("ubyte", type_pos)
                if tag == 0:
                    out[name] = None
                    continue
                member = UNIONS[union_name][tag - 1]
                tpos = val_pos + self._u32(val_pos)
                out[name] = (member, self.read_table(member, tpos))
                continue
            fpos = self._field_pos(table_pos, slot)
            slot += 1
            if fpos is None:
                out[name] = default
                continue
            if kind == "string":
                out[name] = self._read_string(fpos)
            elif kind.startswith("table:"):
                tname = kind[len("table:") :]
                out[name] = self.read_table(tname, fpos + self._u32(fpos))
            elif kind.startswith("vector:"):
                out[name] = self._read_vector(kind[len("vector:") :], fpos)
            else:
                out[name] = self._read_scalar(kind, fpos)
        return out


# ---------------------------------------------------------------------------
# Builder: a FlatBuffer written back to front on struct
# ---------------------------------------------------------------------------


class _Builder:
    """The FlatBuffers wire format, written from the end of a growing
    buffer towards its front. An "offset" is a distance from the end of
    the buffer (``offset()``), which the finished buffer turns into the
    forward 32-bit offsets readers follow. A table is its fields, then its
    signed offset to a vtable of 16-bit field offsets (written just before
    it, or shared with an earlier table whose vtable is the same)."""

    def __init__(self, size: int = 1024) -> None:
        self.buf = bytearray(size)
        self.head = size
        self.minalign = 1
        self.vtable: list[int] | None = None
        self.object_end = 0
        self.vtables: dict[tuple, int] = {}

    def offset(self) -> int:
        return len(self.buf) - self.head

    def _grow(self, needed: int) -> None:
        while self.head < needed:
            old = len(self.buf)
            new = bytearray(max(2 * old, 1))
            new[len(new) - old :] = self.buf
            self.buf = new
            self.head += len(new) - old

    def prep(self, size: int, additional: int) -> None:
        """Zero-pad so that, after ``additional`` more bytes, the next
        ``size``-byte element lands aligned to ``size``."""
        self.minalign = max(self.minalign, size)
        pad = -(len(self.buf) - self.head + additional) % size
        self._grow(pad + size + additional)
        self.head -= pad  # the new buffer's bytes are zero

    def place(self, fmt: str, value) -> None:
        self.head -= struct.calcsize(fmt)
        struct.pack_into(fmt, self.buf, self.head, value)

    def prepend(self, fmt: str, value) -> None:
        self.prep(struct.calcsize(fmt), 0)
        self.place(fmt, value)

    def prepend_offset(self, off: int) -> None:
        """A forward offset to ``off``, from the position it is written at."""
        self.prep(4, 0)
        self.place("<I", self.offset() - off + 4)

    def _bytes(self, raw: bytes) -> None:
        self.head -= len(raw)
        self.buf[self.head : self.head + len(raw)] = raw

    def string(self, s: str) -> int:
        raw = s.encode("utf-8")
        self.prep(4, len(raw) + 1)
        self.place("<B", 0)
        self._bytes(raw)
        self.place("<I", len(raw))
        return self.offset()

    def numpy_vector(self, arr: np.ndarray) -> int:
        raw = np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        self.prep(4, len(raw))
        self.prep(arr.dtype.alignment, len(raw))
        self._bytes(raw)
        self.place("<I", arr.size)
        return self.offset()

    def offset_vector(self, offsets: list[int]) -> int:
        self.prep(4, 4 * len(offsets))
        for off in reversed(offsets):
            self.prepend_offset(off)
        self.place("<I", len(offsets))
        return self.offset()

    def start_table(self, n_slots: int) -> None:
        self.vtable = [0] * n_slots
        self.object_end = self.offset()

    def slot(self, index: int) -> None:
        self.vtable[index] = self.offset()

    def end_table(self) -> int:
        """Write the table's vtable offset, and its vtable unless an equal
        one (the same field offsets and table size) was written before."""
        self.prepend("<i", 0)
        obj = self.offset()
        entries = [obj - v if v else 0 for v in self.vtable]
        while entries and entries[-1] == 0:
            entries.pop()
        size = obj - self.object_end
        key = (*entries, size)
        vt = self.vtables.get(key)
        if vt is None:
            for e in reversed(entries):
                self.prepend("<H", e)
            self.prepend("<H", size)
            self.prepend("<H", 2 * (len(entries) + 2))
            vt = self.vtables[key] = self.offset()
            struct.pack_into("<i", self.buf, len(self.buf) - obj, vt - obj)
        else:  # a shared vtable, written earlier: nearer the end
            struct.pack_into("<i", self.buf, len(self.buf) - obj, vt - obj)
        self.vtable = None
        return obj

    def finish(self, root: int, file_identifier: bytes) -> bytes:
        self.prep(self.minalign, 8)
        self.prep(4, 4)
        self._bytes(file_identifier)
        self.prepend_offset(root)
        return bytes(self.buf[self.head :])


# ---------------------------------------------------------------------------
# Generic writer (drives _Builder from the same spec)
# ---------------------------------------------------------------------------


class FbsWriter:
    def __init__(self) -> None:
        self.builder = _Builder()

    def finish(self, root_offset: int, file_identifier: bytes = b"RTEN") -> bytes:
        return self.builder.finish(root_offset, file_identifier)

    @staticmethod
    def _num_slots(table_name: str) -> int:
        return sum(2 if kind.startswith("union:") else 1 for _, kind, _ in TABLES[table_name])

    def _write_vector(self, elem_kind: str, values) -> int:
        b = self.builder
        if elem_kind.startswith("table:"):
            name = elem_kind[len("table:") :]
            return b.offset_vector([self.write_table(name, v) for v in values])
        if elem_kind == "string":
            return b.offset_vector([b.string(s) for s in values])
        arr = np.asarray(values).astype(_VECTOR_NUMPY[elem_kind], copy=False).reshape(-1)
        return b.numpy_vector(arr)

    def write_table(self, table_name: str, data: dict) -> int:
        b = self.builder
        fields = TABLES[table_name]

        # First pass: the children (offset-typed fields), bottom-up.
        child_offsets: dict[str, int] = {}
        for name, kind, _default in fields:
            val = data.get(name)
            if val is None:
                continue
            if kind == "string":
                child_offsets[name] = b.string(val)
            elif kind.startswith("table:"):
                child_offsets[name] = self.write_table(kind[len("table:") :], val)
            elif kind.startswith("vector:"):
                child_offsets[name] = self._write_vector(kind[len("vector:") :], val)
            elif kind.startswith("union:"):
                member, member_data = val
                child_offsets[name] = self.write_table(member, member_data)

        # Second pass: the table itself, its fields in slot order. A scalar
        # equal to its default is left out; a nullable one (default None)
        # is always written.
        b.start_table(self._num_slots(table_name))
        slot = 0
        for name, kind, default in fields:
            val = data.get(name)
            if kind.startswith("union:"):
                if val is not None:
                    tag = UNIONS[kind[len("union:") :]].index(val[0]) + 1
                    b.prepend("<B", tag)
                    b.slot(slot)
                    b.prepend_offset(child_offsets[name])
                    b.slot(slot + 1)
                slot += 2
                continue
            if kind in _SCALAR_FMT:
                if val is not None and (default is None or val != default):
                    b.prepend(_SCALAR_FMT[kind][0], val)
                    b.slot(slot)
            elif name in child_offsets:
                b.prepend_offset(child_offsets[name])
                b.slot(slot)
            slot += 1
        return b.end_table()


def enum_value(values: list[str], name: str) -> int:
    return values.index(name)


def enum_name(values: list[str], value: int) -> str:
    return values[value]
