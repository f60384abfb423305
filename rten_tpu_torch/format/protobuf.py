"""Minimal protobuf wire-format decoder and encoder (no protobuf / onnx
package needed): a copy of ``rten_tpu/format/protobuf.py``. Enough of
proto3 to read ONNX ModelProto: varint/fixed/length-delimited fields,
repeated + packed fields. Schema-driven: callers describe messages as
{field_number: (name, kind)}.

kinds: "varint", "int64" (zigzag NOT used by onnx — plain varint, two's
complement), "float", "double", "bytes", "string",
"message:<Schema>", each optionally "repeated_"-prefixed.
Packed repeated scalars are auto-detected (wire type 2 on a scalar field).
"""

from __future__ import annotations

import struct
from typing import Any


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


class Schema(dict):
    """{field_number: (name, kind)}"""

    def field(self, name: str) -> tuple[int, str]:
        for num, (n, kind) in self.items():
            if n == name:
                return num, kind
        raise KeyError(name)


def _write_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode(data: dict, schema: Schema) -> bytes:
    """Encode a dict into protobuf wire format per the schema. Message-typed
    values may be dicts (encoded recursively with their sub-schema passed as
    ``(sub_dict, sub_schema)``) or pre-encoded bytes."""
    out = bytearray()
    for num, (name, kind) in schema.items():
        if name not in data or data[name] is None:
            continue
        repeated = kind.startswith("repeated_")
        base = kind[len("repeated_"):] if repeated else kind
        values = data[name] if repeated else [data[name]]
        for v in values:
            if base in ("varint", "int64"):
                out += _write_varint(num << 3 | 0)
                out += _write_varint(int(v))
            elif base == "float":
                out += _write_varint(num << 3 | 5)
                out += struct.pack("<f", float(v))
            elif base == "double":
                out += _write_varint(num << 3 | 1)
                out += struct.pack("<d", float(v))
            elif base == "string":
                raw = v.encode("utf-8")
                out += _write_varint(num << 3 | 2) + _write_varint(len(raw)) + raw
            elif base == "bytes":
                out += _write_varint(num << 3 | 2) + _write_varint(len(v)) + bytes(v)
            elif base.startswith("message:"):
                raw = v if isinstance(v, (bytes, bytearray)) else encode(*v)
                out += _write_varint(num << 3 | 2) + _write_varint(len(raw)) + raw
            else:
                raise ValueError(f"cannot encode kind {base}")
    return bytes(out)


def decode(buf, schema: Schema) -> dict[str, Any]:
    buf = memoryview(buf)
    out: dict[str, Any] = {}
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field_num = tag >> 3
        wire_type = tag & 7
        spec = schema.get(field_num)
        name, kind = spec if spec else (None, None)
        repeated = kind.startswith("repeated_") if kind else False
        base = kind[len("repeated_"):] if repeated else kind

        if wire_type == 0:  # varint
            val, pos = _read_varint(buf, pos)
            if base in ("int64", "varint", None):
                val = _to_signed64(val)
        elif wire_type == 1:  # 64-bit
            val = struct.unpack_from("<d", buf, pos)[0] if base == "double" else struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wire_type == 5:  # 32-bit
            val = struct.unpack_from("<f", buf, pos)[0] if base == "float" else struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        elif wire_type == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            raw = buf[pos : pos + length]
            pos += length
            if base is None:
                continue
            if base == "string":
                val = bytes(raw).decode("utf-8")
            elif base == "bytes":
                val = bytes(raw)
            elif base.startswith("message:"):
                val = raw  # decoded lazily by caller via decode()
            elif base in ("varint", "int64"):  # packed
                vals = []
                p = 0
                while p < length:
                    v, p = _read_varint(raw, p)
                    vals.append(_to_signed64(v) if base == "int64" else v)
                if repeated:
                    out.setdefault(name, []).extend(vals)
                    continue
                val = vals[-1] if vals else 0
            elif base == "float":  # packed
                val = list(struct.unpack_from(f"<{length // 4}f", raw, 0))
                if repeated:
                    out.setdefault(name, []).extend(val)
                    continue
            elif base == "double":
                val = list(struct.unpack_from(f"<{length // 8}d", raw, 0))
                if repeated:
                    out.setdefault(name, []).extend(val)
                    continue
            else:
                raise ValueError(f"cannot parse {base} from length-delimited field")
        else:
            raise ValueError(f"unsupported wire type {wire_type}")

        if name is None:
            continue
        if repeated:
            out.setdefault(name, []).append(val)
        else:
            out[name] = val
    return out
