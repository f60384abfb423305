"""ONNX → `.rten` converter (reference: rten-convert package), the
counterpart of ``rten_tpu/convert``:

    python -m rten_tpu_torch.convert model.onnx [model.rten] [--quantize] [--metadata FILE]

``--quantize`` rewrites the large float weights as INT8 constants through
``optimize.quantize.quantize_graph_int8`` (the rten_tpu schema extension);
the metadata carries the ONNX file's SHA-256.
"""
