"""`.rten` model files and ONNX import: the counterpart of
``rten_tpu/format/``, on ``struct`` and numpy alone (no ``flatbuffers``,
``protobuf`` or ``onnx`` package). ``load_rten`` / ``save_rten`` read and
write `.rten` (V1 and V2, the int8 / QLinear extension included) to and
from the port's ``Graph``; ``onnx_reader.load_onnx`` imports an ONNX
ModelProto, ``onnx_builder`` writes one."""

from rten_tpu_torch.format.header import Header, HeaderError
from rten_tpu_torch.format.rten_io import ModelLoadError, load_rten, save_rten

__all__ = ["Header", "HeaderError", "ModelLoadError", "load_rten", "save_rten"]
