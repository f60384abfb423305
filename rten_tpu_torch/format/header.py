"""The 32-byte `.rten` V2 file header: a copy of ``rten_tpu/format/header.py``.

Layout (reference: src/header.rs:62-77, rten-convert write_header,
converter.py:1417-1444), all little-endian:

    bytes 0..4   magic b"RTEN"
    bytes 4..8   u32 version (2)
    bytes 8..16  u64 model_offset  (FlatBuffers model data)
    bytes 16..24 u64 model_len
    bytes 24..32 u64 tensor_data_offset (out-of-band tensor segment)

V1 files are a bare FlatBuffer with file identifier "RTEN" at bytes 4..8
(reference: src/model.rs:305-310 falls back to V1 when header parse fails).
"""

from __future__ import annotations

import dataclasses
import struct


class HeaderError(ValueError):
    pass


@dataclasses.dataclass
class Header:
    version: int
    model_offset: int
    model_len: int
    tensor_data_offset: int

    LEN = 32
    _STRUCT = struct.Struct("<4sIQQQ")

    @classmethod
    def from_buf(cls, buf: bytes | memoryview) -> "Header":
        if len(buf) < cls.LEN:
            raise HeaderError("header too short")
        magic, version, model_offset, model_len, tensor_data_offset = (
            cls._STRUCT.unpack_from(buf, 0)
        )
        if magic != b"RTEN":
            raise HeaderError("invalid magic")
        if version != 2:
            raise HeaderError(f"unsupported version {version}")
        file_size = len(buf)
        if model_offset < cls.LEN or model_offset > file_size:
            raise HeaderError("invalid model offset")
        if model_offset + model_len > file_size:
            raise HeaderError("invalid model length")
        if tensor_data_offset and (
            tensor_data_offset < model_offset + model_len
            or tensor_data_offset > file_size
        ):
            raise HeaderError("invalid tensor data offset")
        return cls(version, model_offset, model_len, tensor_data_offset)

    def to_bytes(self) -> bytes:
        return self._STRUCT.pack(
            b"RTEN",
            self.version,
            self.model_offset,
            self.model_len,
            self.tensor_data_offset,
        )


def is_v1(buf: bytes | memoryview) -> bool:
    """A V1 file is a bare FlatBuffer whose file identifier "RTEN" sits at
    bytes 4..8 (after the root offset)."""
    return len(buf) >= 8 and bytes(buf[4:8]) == b"RTEN" and bytes(buf[0:4]) != b"RTEN"
