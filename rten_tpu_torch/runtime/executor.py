"""Graph executors: counterpart of ``rten_tpu/runtime/executor.py``.

Two strategies over the same plan and the same op loop (``execute_plan``):

- ``run_plan``: interpret mode, op by op. ``require_static`` reads any
  tensor, and data-dependent ops (NonZero, NMS) run.

- ``CompiledPlan``: compile mode, one entry a signature. Its op loop runs
  in trace mode: a value that derives from a graph input may not be read on
  the host (``CompileError``), as under ``jax.jit``. Shape math folds on the
  host as it does at JAX trace time. On a CUDA device the entry's first
  call runs the plan once as a warm-up (which also puts on the device every
  static operand a device op reads, kept with the entry), then captures the
  plan as one ``torch.cuda.CUDAGraph`` over static input buffers; later
  calls copy their inputs in and replay. On the CPU the trace-mode plan
  runs each call without a capture.

Values. A value that derives only from constants, ``Shape`` or ``Size`` is
static: a host numpy array. In either mode an op whose every operand is
static runs on the host and its result stays static (the counterpart of
``jax.ensure_compile_time_eval``). Constants follow the JAX package's
``split_constants``: integer ones and small ones are static, large float
ones (weights) are tensors on the device. Everything that derives from a
graph input is a tensor on the device.
"""

from __future__ import annotations

import collections
import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from rten_tpu_torch.graph import ConstantNode, Graph, OperatorNode, subgraphs_of
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.ops.registry import (
    OpContext,
    OpError,
    RunRandom,
    canon_numpy,
    canon_tensor,
    get_op,
    static_tensor,
    to_numpy,
    to_tensor,
    tracing,
)
from rten_tpu_torch.runtime.timing import RunTiming, Timer, TimingRecord


class RunError(RuntimeError):
    """Reference: RunError, src/graph.rs:275."""


class Env:
    """Scoped name→value environment for subgraph captures
    (reference: CaptureEnv, src/graph.rs:442)."""

    def __init__(self, parent: "Env | None" = None) -> None:
        self.parent = parent
        self.by_name: dict[str, Any] = {}

    def lookup(self, name: str):
        env: Env | None = self
        while env is not None:
            if name in env.by_name:
                return env.by_name[name]
            env = env.parent
        raise RunError(f"capture {name!r} not found in enclosing scopes")


# ---------------------------------------------------------------------------
# Values on the host and on the device
# ---------------------------------------------------------------------------


class ConstCache:
    """A model's constants on its device, each made once: as a static
    operand (``static_tensor``, which ``require_static`` reads) or as a
    device value (a weight, which it does not)."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._cache: dict[tuple, torch.Tensor] = {}

    def get(self, graph: Graph, node_id: int, static: bool) -> torch.Tensor:
        key = (id(graph), node_id, static)
        t = self._cache.get(key)
        if t is None:
            value = graph.nodes[node_id].value
            t = static_tensor(value, self.device) if static else to_tensor(value, self.device)
            self._cache[key] = t
        return t


class StaticValues:
    """Puts static operands of device ops on the device, each (graph, node)
    once: a run's in interpret mode, an entry's in compile mode (the same
    signature gives the same static values, so a capture reads the copies
    its warm-up made). Constants come from the model's ``ConstCache``."""

    def __init__(self, device, consts: ConstCache | None = None) -> None:
        self.device = torch.device(device)
        self.consts = consts
        self._cache: dict[tuple, torch.Tensor] = {}

    def on_device(self, graph: Graph, node_id: int, value: np.ndarray) -> torch.Tensor:
        node = graph.nodes[node_id]
        if self.consts is not None and isinstance(node, ConstantNode) and node.value is value:
            return self.consts.get(graph, node_id, True)
        key = (id(graph), node_id)
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = static_tensor(value, self.device)
        return t


def as_input(value, device) -> torch.Tensor:
    """A graph input as a tensor on ``device`` in its canonical dtype."""
    if isinstance(value, torch.Tensor):
        return canon_tensor(value).to(device)
    return to_tensor(canon_numpy(value), device)


def as_output(value, device) -> torch.Tensor:
    """A result as a tensor on ``device`` (a static one copied there)."""
    if isinstance(value, torch.Tensor):
        return value
    return to_tensor(canon_numpy(value), device)


def _host_result(result):
    if isinstance(result, tuple):
        return tuple(_host_result(r) for r in result)
    if isinstance(result, torch.Tensor):
        return to_numpy(canon_tensor(result))
    return canon_numpy(result)


def _device_result(result):
    if isinstance(result, tuple):
        return tuple(_device_result(r) for r in result)
    if isinstance(result, torch.Tensor):
        return canon_tensor(result)
    return result


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# The op loop
# ---------------------------------------------------------------------------


def _gather_op_inputs(
    graph: Graph, op: OperatorNode, values: dict[int, Any], env: Env | None
) -> list[Any]:
    args = []
    for inp in op.inputs:
        if inp is None:
            args.append(None)
            continue
        if inp in values:
            args.append(values[inp])
            continue
        if env is not None:
            args.append(env.lookup(graph.node_name(inp)))
            continue
        raise RunError(f"missing value for input '{graph.node_name(inp)}'")
    # Trailing omitted optional inputs
    while args and args[-1] is None:
        args.pop()
    return args


def run_static(spec, ctx: OpContext, attrs: dict, args: Sequence[Any]):
    """``spec`` on static (numpy) operands, on the host; its results numpy."""
    host = OpContext(ctx.mode, ctx.rng, device="cpu")
    with tracing(False):
        result = spec.fn(host, attrs, *[None if a is None else static_tensor(a) for a in args])
    return _host_result(result)


def _apply_op(
    graph: Graph,
    op: OperatorNode,
    args: list[Any],
    ctx: OpContext,
    values: dict[int, Any],
) -> None:
    spec = get_op(op.op_type)
    attrs = op.attrs
    if op.op_type == "Split":
        attrs = dict(attrs)
        attrs["_n_outputs"] = len(op.outputs)
    try:
        if (
            spec.deterministic
            and not subgraphs_of(op)
            and all(a is None or isinstance(a, np.ndarray) for a in args)
        ):
            # Every operand is static: evaluate on the host so the result
            # stays static and downstream shape-valued consumers (Reshape,
            # Slice, ...) see concrete values in compile mode.
            result = run_static(spec, ctx, attrs, args)
        else:
            dev_args = [
                a if a is None or isinstance(a, torch.Tensor) else ctx.statics.on_device(graph, inp, a)
                for inp, a in zip(op.inputs, args)
            ]
            with tracing(ctx.mode == "trace"):
                result = _device_result(spec.fn(ctx, attrs, *dev_args))
    except OpError as e:
        raise RunError(f"operator '{op.name or op.op_type}' ({op.op_type}): {e}") from e
    outs = result if isinstance(result, tuple) else (result,)
    if len(outs) < len([o for o in op.outputs if o is not None]):
        raise RunError(
            f"operator {op.op_type} produced {len(outs)} outputs, "
            f"graph expects {len(op.outputs)}"
        )
    for out_id, val in zip(op.outputs, outs):
        if out_id is not None:
            values[out_id] = val


def _make_subgraph_runner(
    graph: Graph,
    values: dict[int, Any],
    env: Env | None,
    ctx: OpContext,
) -> Callable[..., list[Any]]:
    """Build the run_subgraph callback for control-flow ops: captures resolve
    against the current values by node NAME (reference: run_subgraph +
    CaptureEnv, src/graph.rs:843,442). With ``on_device`` every result is a
    tensor on the device (a static one through the run's static values)."""

    def run_subgraph(sub: Graph, on_device: bool = False) -> list[Any]:
        child_env = Env(env)
        for node_id, val in values.items():
            name = graph.nodes[node_id].name
            if name:
                child_env.by_name[name] = val
        for node in graph.nodes:
            if isinstance(node, ConstantNode) and node.name:
                child_env.by_name.setdefault(node.name, node.value)
        sub_values: dict[int, Any] = {}
        for cap in sub.captures:
            sub_values[cap] = child_env.lookup(sub.node_name(cap))
        outs = execute_plan(
            sub,
            sub.create_plan([], sub.outputs),
            sub_values,
            sub.outputs,
            ctx.child(),
            env=child_env,
        )
        if on_device:
            outs = [o if isinstance(o, torch.Tensor) else ctx.statics.on_device(sub, oid, o)
                    for o, oid in zip(outs, sub.outputs)]
        return outs

    return run_subgraph


def execute_plan(
    graph: Graph,
    plan: Sequence[int],
    values: dict[int, Any],
    outputs: Sequence[int],
    ctx: OpContext,
    *,
    env: Env | None = None,
    timing: RunTiming | None = None,
) -> list[Any]:
    """The core loop — both executors share it; ``ctx.mode`` decides whether
    a tensor may be read on the host."""
    # Constants resolve lazily (static numpy) unless the caller placed them.
    for i, node in enumerate(graph.nodes):
        if isinstance(node, ConstantNode) and i not in values:
            values[i] = node.value

    ctx.run_subgraph = _make_subgraph_runner(graph, values, env, ctx)

    for op_id in plan:
        op = graph.nodes[op_id]
        assert isinstance(op, OperatorNode)
        args = _gather_op_inputs(graph, op, values, env)
        if timing is not None:
            with Timer() as t:
                _apply_op(graph, op, args, ctx, values)
                _sync(ctx.device)
            timing.add(
                TimingRecord(
                    op.op_type,
                    op.name or "",
                    [tuple(np.shape(a)) for a in args if a is not None],
                    t.elapsed_s,
                )
            )
        else:
            _apply_op(graph, op, args, ctx, values)

    missing = [o for o in outputs if o not in values]
    if missing:
        names = ", ".join(graph.node_name(m) for m in missing)
        raise RunError(f"outputs not produced by plan: {names}")
    return [values[o] for o in outputs]


# ---------------------------------------------------------------------------
# Constants: static or device values
# ---------------------------------------------------------------------------

# Constants larger than this many elements (float ones) are device values
# (weights); smaller ones and integer ones are static, so that shape-math
# chains fold on the host (the JAX package bakes them into its trace).
BAKE_CONSTANT_MAX_ELEMENTS = 16384


def split_constants(graph: Graph) -> tuple[list[int], list[int]]:
    """(baked_ids, arg_ids) — int tensors and small tensors are static;
    large float tensors (weights) are device values."""
    baked, args = [], []
    for i, node in enumerate(graph.nodes):
        if not isinstance(node, ConstantNode):
            continue
        v = node.value
        if v.size <= BAKE_CONSTANT_MAX_ELEMENTS or np.issubdtype(v.dtype, np.integer):
            baked.append(i)
        else:
            args.append(i)
    return baked, args


def const_args(graph: Graph, plan: Sequence[int]) -> list[int]:
    """The device-value constants the plan reads (its ops' inputs and the
    outer constants its subgraphs capture by name)."""
    _, const_arg_ids = split_constants(graph)
    used: set[int] = set()
    for op_id in plan:
        op = graph.nodes[op_id]
        for inp in op.inputs:
            if inp is not None:
                used.add(inp)
        for sub in subgraphs_of(op):
            for cap in sub.captures:
                outer = graph.get_node_id(sub.node_name(cap))
                if outer is not None:
                    used.add(outer)
    return [c for c in const_arg_ids if c in used]


def run_plan(
    graph: Graph,
    inputs: Mapping[int, Any],
    outputs: Sequence[int],
    *,
    rng: int | None = None,
    timing: RunTiming | None = None,
    device="cpu",
    consts: ConstCache | None = None,
) -> list[Any]:
    """Interpret-mode execution (eager) on ``device``; ``rng`` is the seed
    of the run's Random* ops. Returns the outputs as they are (a static
    one as numpy)."""
    device = torch.device(device)
    consts = consts or ConstCache(device)
    plan = graph.create_plan(list(inputs), outputs)
    values: dict[int, Any] = {nid: as_input(v, device) for nid, v in inputs.items()}
    for cid in const_args(graph, plan):
        values.setdefault(cid, consts.get(graph, cid, False))
    ctx = OpContext("eager", rng=rng, device=device, statics=StaticValues(device, consts))
    return execute_plan(graph, plan, values, outputs, ctx, timing=timing)


# ---------------------------------------------------------------------------
# Compile mode
# ---------------------------------------------------------------------------

_CAPTURE_STREAMS: dict = {}


def _capture_stream(device: torch.device):
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class CompiledPlan:
    """One compile-mode entry: the plan from ``input_ids`` to
    ``output_ids`` in trace mode, with the device values and the static
    device copies it reads, and on a CUDA device its captured graph.

    ``donated`` (a per-input mask, by call) marks device tensors that the
    capture reads in place: the entry keeps them as its input buffers (the
    caller's key holds their addresses, so a later call passes the very
    same tensor and nothing is copied). Every other input is copied into a
    buffer of the entry's own. Results are copies, valid after the next
    call. A capture that fails raises; nothing falls back to eager."""

    def __init__(
        self,
        graph: Graph,
        input_ids: Sequence[int],
        output_ids: Sequence[int],
        *,
        rng_seed: int | None = None,
        device="cpu",
        consts: ConstCache | None = None,
    ) -> None:
        self.graph = graph
        self.input_ids = list(input_ids)
        self.output_ids = list(output_ids)
        self.plan = graph.create_plan(self.input_ids, self.output_ids)
        self.seed = rng_seed
        self.device = torch.device(device)
        self.consts = consts or ConstCache(self.device)
        self.const_arg_ids = const_args(graph, self.plan)
        self.statics = StaticValues(self.device, self.consts)
        self.cuda_graph = None
        self.buffers: list[torch.Tensor] = []
        self.outputs: list[Any] = []
        self.generators: list = []
        self.launches: collections.Counter = collections.Counter()

    def _trace(self, inputs: Sequence[torch.Tensor], random: RunRandom) -> list[Any]:
        values: dict[int, Any] = {cid: self.consts.get(self.graph, cid, False) for cid in self.const_arg_ids}
        values.update(zip(self.input_ids, inputs))
        ctx = OpContext("trace", rng=self.seed, device=self.device, statics=self.statics, random=random)
        return execute_plan(self.graph, self.plan, values, self.output_ids, ctx)

    def __call__(self, inputs: Sequence[Any], donated: Sequence[bool] | None = None) -> list[torch.Tensor]:
        donated = list(donated or [False] * len(inputs))
        if self.device.type != "cuda":
            outs = self._trace([as_input(v, self.device) for v in inputs], RunRandom(self.seed, self.device))
            return [as_output(o, self.device) for o in outs]
        if self.cuda_graph is None:
            return self._capture(inputs, donated)
        return self._replay(inputs, donated)

    def _capture(self, inputs, donated) -> list[torch.Tensor]:
        dev = self.device
        buffers = []
        for v, don in zip(inputs, donated):
            t = v if don else as_input(v, dev)
            buffers.append(t.clone() if (t is v and not don) else t)
        stream = _capture_stream(dev)
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            random = RunRandom(self.seed, dev)
            outs = self._trace(buffers, random)  # the warm-up: builds, plans, static copies
        stream.synchronize()
        self.generators = random.generators
        graph = torch.cuda.CUDAGraph()
        for gen, seed in self.generators:
            gen.manual_seed(seed)
            graph.register_generator_state(gen)
        before = collections.Counter(dispatch.LAUNCHES)
        try:
            with warnings.catch_warnings():
                # A plan of views and host ops alone captures an empty graph.
                warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
                with torch.cuda.graph(graph, stream=stream):
                    captured = self._trace(buffers, RunRandom(self.seed, dev, self.generators, reseed=False))
        finally:
            launches = collections.Counter(dispatch.LAUNCHES)
            launches.subtract(before)
            dispatch.LAUNCHES.clear()
            dispatch.LAUNCHES.update(before)
        current.wait_stream(stream)
        self.cuda_graph, self.buffers, self.outputs, self.launches = graph, buffers, captured, +launches
        # Copies on the caller's stream: a result never aliases an input buffer.
        return [o.clone() if isinstance(o, torch.Tensor) else as_output(o, dev) for o in outs]

    def _replay(self, inputs, donated) -> list[torch.Tensor]:
        for buf, v, don in zip(self.buffers, inputs, donated):
            if don and v is buf:
                continue
            buf.copy_(v if isinstance(v, torch.Tensor) else to_tensor(canon_numpy(v)))
        for gen, seed in self.generators:
            gen.manual_seed(seed)
        self.cuda_graph.replay()
        dispatch.LAUNCHES.update(self.launches)
        return [o.clone() if isinstance(o, torch.Tensor) else as_output(o, self.device) for o in self.outputs]
