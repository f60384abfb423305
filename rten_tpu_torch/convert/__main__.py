"""Converter CLI entry point (reference: rten-convert converter.py:1478 main);
a copy of ``rten_tpu/convert/__main__.py`` on the port's modules."""

from __future__ import annotations

import argparse
import hashlib
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rten_tpu_torch.convert",
        description="Convert ONNX models to .rten format",
    )
    parser.add_argument("model", help="input .onnx model")
    parser.add_argument("out", nargs="?", help="output .rten path (default: input with .rten)")
    parser.add_argument("--metadata", help="JSON file with extra metadata fields")
    parser.add_argument(
        "--quantize", action="store_true",
        help="rewrite large float weights to INT8 DequantizeLinear subgraphs "
             "(rten_tpu schema extension)",
    )
    parser.add_argument("--no-optimize", action="store_true")
    args = parser.parse_args(argv)

    from rten_tpu_torch.format.onnx_reader import load_onnx_file
    from rten_tpu_torch.format.rten_io import save_rten

    graph, _info = load_onnx_file(args.model)

    if args.quantize:
        from rten_tpu_torch.optimize.quantize import quantize_graph_int8

        graph, n = quantize_graph_int8(graph)
        print(f"quantized {n} weight tensors to INT8", file=sys.stderr)

    # Metadata with source hash (reference: converter.py:1446-1476).
    with open(args.model, "rb") as f:
        onnx_hash = hashlib.sha256(f.read()).hexdigest()
    metadata = {"onnx_hash": onnx_hash}
    if args.metadata:
        with open(args.metadata) as f:
            metadata.update(json.load(f))

    out_path = args.out or (args.model.rsplit(".", 1)[0] + ".rten")
    data = save_rten(graph, metadata)
    with open(out_path, "wb") as f:
        f.write(data)
    print(f"wrote {out_path} ({len(data):,} bytes)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
