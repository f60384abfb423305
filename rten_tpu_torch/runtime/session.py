"""Model session: optimize → run. Counterpart of
``rten_tpu/runtime/session.py``.

``run`` executes in *interpret* mode (op by op, per-op timing) or *compile*
mode (one ``executor.CompiledPlan`` a signature: on the card one captured
CUDA graph, replayed). A ``Model`` lives on one device: ``"cuda"`` unless
the caller asks for the CPU (``device="cpu"``, the plain versions of the
kernels). A ``Model`` is built from a ``rten_tpu_torch.graph.Graph`` or
loaded from a `.rten` file (``Model.load``, ``load_file``, ``load_mmap``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from rten_tpu_torch.graph import Graph, ValueNode
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.ops.registry import canon_numpy
from rten_tpu_torch.runtime import executor
from rten_tpu_torch.runtime.timing import RunTiming


@dataclasses.dataclass
class RunOptions:
    """Reference: RunOptions, src/graph.rs:524-540 (+ the execution mode)."""

    timing: bool = False
    verbose: bool = False
    timing_sort: str = "time"
    timing_by_shape: bool = False
    mode: str | None = None  # None → session default ("compile" | "interpret")
    seed: int | None = None
    # Compile mode on the card: device tensors are read in place by the
    # captured graph (the entry is keyed on their addresses and keeps them);
    # host arrays are always copied into the entry's own buffers.
    donate_inputs: bool = False


@dataclasses.dataclass
class ModelOptions:
    """Reference: ModelOptions, src/model.rs:173-196."""

    enable_optimization: bool = True
    mode: str = "compile"
    allowed_ops: set[str] | None = None  # selective registration equivalent


def _meta(value) -> tuple:
    """(shape, dtype) of an input as the model will see it (canonical)."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), str({torch.int64: torch.int32, torch.float64: torch.float32}.get(
            value.dtype, value.dtype))
    arr = np.asarray(value)
    return tuple(arr.shape), str(canon_numpy(arr.reshape(-1)[:0]).dtype)


class Model:
    def __init__(
        self,
        graph: Graph,
        metadata: dict[str, Any] | None = None,
        options: ModelOptions | None = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.options = options or ModelOptions()
        self.metadata = metadata or {}
        if self.options.enable_optimization:
            from rten_tpu_torch.optimize import optimize_graph

            graph = optimize_graph(graph)
        self.graph = graph
        self._validate_ops()
        self._compiled: dict[tuple, executor.CompiledPlan] = {}
        self._consts = executor.ConstCache(self.device)
        # name → the first node of that name (``Graph.get_node_id``'s answer,
        # without its scan of every node on each run)
        self._ids: dict[str, int] = {}
        for i, node in enumerate(self.graph.nodes):
            if node.name:
                self._ids.setdefault(node.name, i)

    # ---- loading ----------------------------------------------------------

    @classmethod
    def load_file(cls, path: str | os.PathLike, options: ModelOptions | None = None, device="cuda") -> "Model":
        """A `.rten` file read into memory (reference: src/model.rs:238)."""
        with open(path, "rb") as f:
            data = f.read()
        return cls.load(data, options, device)

    @classmethod
    def load(cls, data: bytes, options: ModelOptions | None = None, device="cuda") -> "Model":
        """`.rten` bytes (V1 or V2) as a Model on ``device``; the constants
        are numpy views of ``data`` until they go to the device."""
        from rten_tpu_torch.format.rten_io import load_rten

        graph, metadata = load_rten(data)
        return cls(graph, metadata, options, device)

    @classmethod
    def load_mmap(cls, path: str | os.PathLike, options: ModelOptions | None = None, device="cuda") -> "Model":
        """Zero-copy load through a read-only mapping of the file
        (reference: src/model.rs:255-295 load_mmap). The constants are
        read-only numpy views of the mapping, which each view keeps open;
        ``executor.ConstCache`` copies a constant before it becomes a tensor
        (``registry.to_tensor``), so nothing writes through a view."""
        import mmap

        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        model = cls.load(mm, options, device)  # type: ignore[arg-type]
        model._mapping = mm
        return model

    def _validate_ops(self) -> None:
        from rten_tpu_torch.ops.registry import OpError, have_op

        allowed = self.options.allowed_ops
        for _, op in self.graph.operator_nodes():
            if not have_op(op.op_type):
                raise OpError(f"model uses unregistered operator {op.op_type!r}")
            if allowed is not None and op.op_type not in allowed:
                raise OpError(f"operator {op.op_type!r} is not in the allowed set")

    # ---- introspection ------------------------------------------------------

    @property
    def input_ids(self) -> list[int]:
        return list(self.graph.inputs)

    @property
    def output_ids(self) -> list[int]:
        return list(self.graph.outputs)

    def input_names(self) -> list[str]:
        return [self.graph.node_name(i) for i in self.graph.inputs]

    def output_names(self) -> list[str]:
        return [self.graph.node_name(o) for o in self.graph.outputs]

    def node_id(self, name: str) -> int:
        nid = self._ids.get(name)
        if nid is None:
            raise KeyError(f"no node named {name!r}")
        return nid

    def input_shape(self, node_id: int) -> list[int | str | None] | None:
        node = self.graph.nodes[node_id]
        return node.shape if isinstance(node, ValueNode) else None

    def total_params(self) -> int:
        return self.graph.total_params()

    # ---- running ------------------------------------------------------------

    def _resolve_ids(self, keys) -> list[int]:
        out = []
        for k in keys:
            out.append(k if isinstance(k, int) else self.node_id(k))
        return out

    def run(
        self,
        inputs: Mapping[str | int, Any] | Sequence[Any],
        outputs: Sequence[str | int] | None = None,
        opts: RunOptions | None = None,
    ) -> list[torch.Tensor]:
        """The outputs (default: the graph's) as tensors on the model's
        device. Inputs are numpy arrays or tensors, named or in the graph's
        input order."""
        opts = opts or RunOptions()
        opts = _apply_timing_env(opts)
        if isinstance(inputs, Mapping):
            in_ids = self._resolve_ids(inputs.keys())
            in_vals = list(inputs.values())
        else:
            in_ids = self.input_ids
            in_vals = list(inputs)
            if len(in_vals) != len(in_ids):
                raise ValueError(
                    f"model expects {len(in_ids)} inputs, got {len(in_vals)}"
                )
        out_ids = (
            self._resolve_ids(outputs) if outputs is not None else self.output_ids
        )
        mode = opts.mode or self.options.mode
        if opts.timing:
            mode = "interpret"  # per-op timing only meaningful eagerly

        if mode == "interpret":
            timing = RunTiming() if opts.timing else None
            result = executor.run_plan(
                self.graph,
                dict(zip(in_ids, in_vals)),
                out_ids,
                rng=opts.seed,
                timing=timing,
                device=self.device,
                consts=self._consts,
            )
            if timing is not None:
                print(timing.summary(opts.timing_sort, opts.timing_by_shape))
            return [executor.as_output(r, self.device) for r in result]

        # compile mode
        donated = [
            opts.donate_inputs and self.device.type == "cuda" and isinstance(v, torch.Tensor)
            and v.device == self.device and executor.canon_tensor(v) is v
            for v in in_vals
        ]
        sig = (
            tuple(in_ids),
            tuple(out_ids),
            tuple(_meta(v) for v in in_vals),
            opts.seed,
            tuple((v.data_ptr(), v.stride()) if d else None for v, d in zip(in_vals, donated)),
        )
        entry = self._compiled.get(sig)
        if entry is None:
            entry = executor.CompiledPlan(
                self.graph, in_ids, out_ids, rng_seed=opts.seed, device=self.device, consts=self._consts
            )
            result = entry(in_vals, donated)  # a first call that raises leaves no entry
            self._compiled[sig] = entry
            return result
        return entry(in_vals, donated)

    def run_one(self, input_value: Any, opts: RunOptions | None = None) -> Any:
        """Single-input single-output convenience (reference: src/model.rs:668)."""
        outs = self.run([input_value], opts=opts)
        return outs[0]

    def run_n(
        self,
        inputs: Mapping[str | int, Any],
        outputs: Sequence[str | int],
        opts: RunOptions | None = None,
    ) -> list[Any]:
        return self.run(inputs, outputs, opts)

    def partial_run(
        self,
        inputs: Mapping[str | int, Any],
        outputs: Sequence[str | int],
        opts: RunOptions | None = None,
    ) -> list[tuple[int, Any]]:
        """Evaluate as much of the graph as possible given only ``inputs``
        (reference: src/model.rs:694 → src/graph.rs:1237). Returns the
        resolved requested outputs PLUS the evaluation frontier — computed
        values consumed by operators that could NOT run, so a generation
        loop can hoist loop-invariant subgraphs and feed them back as extra
        inputs on every step. Always eager; values are tensors on the
        model's device."""
        del opts
        from rten_tpu_torch.graph import operator_dependencies
        from rten_tpu_torch.ops.registry import OpContext

        in_ids = self._resolve_ids(inputs.keys())
        out_ids = self._resolve_ids(outputs)
        # Plan as if every graph input were present, then prune to what the
        # provided subset can actually compute (reference: src/graph.rs:1276).
        plan_inputs = sorted(set(self.graph.inputs) | set(in_ids))
        plan = self.graph.create_plan(plan_inputs, out_ids)
        pruned, resolved = self.graph.prune_plan(plan, set(in_ids), out_ids)
        values: dict[int, Any] = {
            nid: executor.as_input(v, self.device) for nid, v in zip(in_ids, inputs.values())
        }
        for cid in executor.const_args(self.graph, pruned):
            values.setdefault(cid, self._consts.get(self.graph, cid, False))
        ctx = OpContext("eager", device=self.device, statics=executor.StaticValues(self.device, self._consts))
        executor.execute_plan(self.graph, pruned, values, resolved, ctx)

        executed = set(pruned)
        computed = {
            o
            for op_id in pruned
            for o in self.graph.nodes[op_id].outputs
            if o is not None
        }
        frontier: list[int] = []
        for op_id in plan:
            if op_id in executed:
                continue
            for dep in operator_dependencies(self.graph, self.graph.nodes[op_id]):
                if dep in computed and dep not in resolved and dep not in frontier:
                    frontier.append(dep)
        return [(o, executor.as_output(values[o], self.device)) for o in list(resolved) + frontier]


def _apply_timing_env(opts: RunOptions) -> RunOptions:
    """RTEN_TIMING env var (reference: src/model.rs:130-160,642): "1" or an
    option string like "sort=name by-shape=1" turns on the per-op timing
    table without touching call sites."""
    import os

    spec = os.environ.get("RTEN_TIMING")
    if not spec or opts.timing:
        return opts
    sort = opts.timing_sort
    by_shape = opts.timing_by_shape
    for tokens in spec.split():
        key, _, val = tokens.partition("=")
        if key == "sort" and val:
            sort = val
        elif key in ("by-shape", "by_shape"):
            by_shape = val in ("1", "true", "yes", "")
    return dataclasses.replace(
        opts, timing=True, timing_sort=sort, timing_by_shape=by_shape
    )
