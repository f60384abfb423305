"""Model inspection / benchmark CLI (reference: rten-cli/src/main.rs:100):
the counterpart of ``rten_tpu/cli.py``, on an NVIDIA card.

    python -m rten_tpu_torch.cli model.rten [-n ITERS] [-t|--timing] [-v]
        [--shape NAME=D1,D2,...] [--size SYMBOL=N] [--mmap] [--quiet]
        [--mode compile|interpret] [--no-optimize] [--device cuda|cpu]

Synthesizes inputs from the model's declared shapes (symbolic dims settable
via --size, whole shapes via --shape, default 1 — reference: DimSize,
main.rs:32), runs N iterations on ``--device`` (default ``cuda``: the card;
``cpu`` runs the kernels' plain versions), prints per-iteration latency
(each run synchronized with the card), the optional per-op timing table
(interpret mode), and model metadata.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def synthesize_input(shape, dtype, dim_sizes: dict[str, int], rng) -> np.ndarray:
    dims = []
    for d in shape or []:
        if isinstance(d, int) and d > 0:
            dims.append(d)
        elif isinstance(d, str):
            dims.append(dim_sizes.get(d, 1))
        else:
            dims.append(1)
    np_dtype = np.dtype(dtype or "float32")
    if np_dtype.kind == "f":
        return rng.standard_normal(dims).astype(np_dtype)
    return rng.integers(0, 2, dims).astype(np_dtype)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rten-tpu-torch", description="Inspect and benchmark .rten models on an NVIDIA GPU (CUDA)"
    )
    parser.add_argument("model", help="path to .rten model")
    parser.add_argument("-n", "--n-iters", type=int, default=1)
    parser.add_argument("-t", "--timing", action="store_true", help="per-op timing table")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("--mmap", action="store_true", help="zero-copy mmap load")
    parser.add_argument(
        "--shape", action="append", default=[], metavar="NAME=D1,D2,...",
        help="override an input's full shape",
    )
    parser.add_argument(
        "--size", action="append", default=[], metavar="SYM=N",
        help="set a symbolic dimension (e.g. batch=4)",
    )
    parser.add_argument("--mode", choices=["compile", "interpret"], default="compile")
    parser.add_argument("--no-optimize", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from rten_tpu_torch.runtime.session import Model, ModelOptions, RunOptions

    t0 = time.perf_counter()
    options = ModelOptions(
        enable_optimization=not args.no_optimize, mode=args.mode
    )
    model = (
        Model.load_mmap(args.model, options, args.device)
        if args.mmap
        else Model.load_file(args.model, options, args.device)
    )
    load_s = time.perf_counter() - t0

    dim_sizes: dict[str, int] = {}
    for spec in args.size:
        name, _, val = spec.partition("=")
        dim_sizes[name] = int(val)
    shape_overrides: dict[str, list[int]] = {}
    for spec in args.shape:
        name, _, val = spec.partition("=")
        shape_overrides[name] = [int(v) for v in val.split(",") if v]

    rng = np.random.default_rng(0)
    inputs = {}
    for nid in model.input_ids:
        name = model.graph.node_name(nid)
        node = model.graph.nodes[nid]
        if name in shape_overrides:
            arr = synthesize_input(shape_overrides[name], getattr(node, "dtype", None), {}, rng)
        else:
            arr = synthesize_input(
                getattr(node, "shape", None), getattr(node, "dtype", None), dim_sizes, rng
            )
        inputs[nid] = arr
        if not args.quiet:
            print(f"  input {name!r}: shape {list(arr.shape)} dtype {arr.dtype}")

    if not args.quiet:
        print(f"loaded {args.model} in {load_s * 1e3:.1f} ms; "
              f"{model.total_params():,} params; mode={args.mode}")

    opts = RunOptions(timing=args.timing, verbose=args.verbose)
    times = []
    for _ in range(args.n_iters):
        t0 = time.perf_counter()
        outs = model.run(inputs, opts=opts)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        times.append(time.perf_counter() - t0)
    if not args.quiet:
        for oid, out in zip(model.output_ids, outs):
            print(f"  output {model.graph.node_name(oid)!r}: shape {list(out.shape)}")
        if len(times) > 1:
            steady = times[1:]
            print(
                f"latency: first {times[0] * 1e3:.2f} ms (incl. compile); "
                f"mean {np.mean(steady) * 1e3:.3f} ms; min {np.min(steady) * 1e3:.3f} ms "
                f"over {len(steady)} iters"
            )
        else:
            print(f"latency: {times[0] * 1e3:.2f} ms (single run, incl. compile)")
        if model.metadata:
            print("metadata:")
            for k, v in model.metadata.items():
                print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
