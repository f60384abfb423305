"""Operator registry.

Counterpart of ``rten_tpu/ops/registry.py``: each op is a plain function
``fn(ctx, attrs, *inputs) -> tensor | tuple[tensor, ...]`` over torch
tensors, registered under the ONNX-aligned name the JAX package uses.

Values and where they live. A value that derives only from constants,
``Shape`` or ``Size`` is *static*: a host numpy array, as the JAX package
keeps such values concrete under ``jax.ensure_compile_time_eval``. A value
that derives from a graph input is a tensor on the model's device. An op
receives tensors only: the executor hands it a static operand as a tensor
that remembers its numpy value (``static_tensor``), on the host when every
operand is static (the op then runs on the CPU and its result stays
static) and on the device otherwise. ``require_static`` reads that value;
on a device tensor it raises ``CompileError`` in compile (trace) mode and
reads the tensor in interpret mode.

Dtypes follow the JAX package with x64 off: int64 values become int32 and
float64 values float32 before any op sees them, and every op returns the
dtype the JAX op returns (``Shape`` is int32, comparisons int32, ...).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable

import numpy as np
import torch


class OpError(ValueError):
    """Reference: OpError, src/ops/mod.rs:666."""


class CompileError(OpError):
    """Raised when an op cannot run in compile mode (a data-dependent shape,
    or a value that must be static but derives from a graph input).
    Interpret mode still runs it."""


@dataclasses.dataclass
class OpSpec:
    name: str
    fn: Callable
    deterministic: bool = True
    # Data-dependent output shape → interpret-mode only (NonZero, NMS).
    data_dependent: bool = False
    commutative: bool = False


_REGISTRY: dict[str, OpSpec] = {}


def register(
    name: str,
    *,
    deterministic: bool = True,
    data_dependent: bool = False,
    commutative: bool = False,
):
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = OpSpec(
            name=name,
            fn=fn,
            deterministic=deterministic,
            data_dependent=data_dependent,
            commutative=commutative,
        )
        return fn

    return deco


def get_op(name: str) -> OpSpec:
    _ensure_loaded()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise OpError(f"operator {name!r} is not registered")
    return spec


def have_op(name: str) -> bool:
    _ensure_loaded()
    return name in _REGISTRY


def all_ops() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def is_deterministic(name: str) -> bool:
    _ensure_loaded()
    spec = _REGISTRY.get(name)
    return spec.deterministic if spec else True


_loaded = False


def _ensure_loaded() -> None:
    """Import all op modules on first lookup (they self-register)."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from rten_tpu_torch.ops import (  # noqa: F401
        control_flow,
        conv,
        einsum_op,
        elementwise,
        gather,
        generate_ops,
        layout,
        matmul,
        nms,
        norm,
        pool,
        quant,
        reduce,
        resize,
        rnn,
    )


# ---------------------------------------------------------------------------
# Static values
# ---------------------------------------------------------------------------

_CANON = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32, np.dtype(np.float64): np.float32}


def canon_numpy(value) -> np.ndarray:
    """``value`` as a numpy array of the dtype the JAX package (x64 off)
    gives it: int64 → int32, uint64 → uint32, float64 → float32."""
    arr = np.asarray(value)
    to = _CANON.get(arr.dtype)
    return arr.astype(to) if to is not None else arr


def canon_tensor(t: torch.Tensor) -> torch.Tensor:
    """A tensor result in the JAX package's x64-off dtype."""
    if t.dtype == torch.int64:
        return t.to(torch.int32)
    if t.dtype == torch.float64:
        return t.to(torch.float32)
    return t


def to_tensor(value, device=None) -> torch.Tensor:
    """A numpy value (its canonical dtype; bfloat16 through its bits) as a
    tensor on ``device``."""
    arr = canon_numpy(value)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = arr.copy()  # torch.from_numpy wants a writable C-ordered array
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if device is None or torch.device(device).type == "cpu" else t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (bfloat16 through ml_dtypes' bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def static_tensor(value: np.ndarray, device=None) -> torch.Tensor:
    """A static value as the tensor an op receives: its canonical tensor on
    ``device`` that remembers the numpy value (``require_static`` reads it)."""
    t = to_tensor(value, device)
    t._rten_static = value
    return t


_TRACING: contextvars.ContextVar[bool] = contextvars.ContextVar("rten_tracing", default=False)


@contextlib.contextmanager
def tracing(on: bool):
    """Within the block, ``require_static`` refuses device tensors (compile
    mode) or reads them (interpret mode)."""
    token = _TRACING.set(on)
    try:
        yield
    finally:
        _TRACING.reset(token)


def is_static(x) -> bool:
    return isinstance(x, np.ndarray) or getattr(x, "_rten_static", None) is not None


def require_static(x, what: str = "input") -> np.ndarray:
    """Return a concrete numpy value for ``x`` or raise CompileError.

    Values that derive from constants and shapes are static, so shape-math
    chains (Shape → Gather → Concat → Reshape) fold on the host in compile
    mode; a tensor that derives from a graph input is readable in interpret
    mode only."""
    if isinstance(x, torch.Tensor):
        value = getattr(x, "_rten_static", None)
        if value is not None:
            return np.asarray(value)
        if _TRACING.get():
            raise CompileError(
                f"{what} must be statically known in compile mode; this graph needs "
                f"interpret mode or shape bucketing for this value"
            )
        return to_numpy(x)
    return np.asarray(x)


def static_int_list(x, what: str = "input") -> list[int]:
    return [int(v) for v in np.atleast_1d(require_static(x, what))]


# ---------------------------------------------------------------------------
# The context an op runs in
# ---------------------------------------------------------------------------


class RunRandom:
    """The generators of one run, shared by the run's contexts (a
    subgraph's too): ``(generator, seed)`` in the order the ops made them.
    A compiled entry hands the list of its warm-up run to its capture, so
    the captured graph draws from generators it registers and reseeds
    before every replay."""

    def __init__(self, seed: int | None, device, generators: list | None = None, reseed: bool = True) -> None:
        self.seed = seed
        self.device = device
        self.generators = [] if generators is None else generators
        self.reseed = reseed  # False under a capture: the entry reseeds them itself
        self._next = 0
        self._main = None

    def _make(self, seed: int) -> torch.Generator:
        if self._next < len(self.generators):
            gen, _ = self.generators[self._next]
            if self.reseed:
                gen.manual_seed(seed)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.generators.append((gen, seed))
        self._next += 1
        return gen

    def main(self) -> torch.Generator:
        if self.seed is None:
            raise OpError("random op requires an rng seed (RunOptions.seed)")
        if self._main is None:
            self._main = self._make(int(self.seed))
        return self._main


class OpContext:
    """Per-run execution context handed to every op function.

    ``mode`` is "eager" (interpret executor) or "trace" (compile executor:
    graph-input-derived values may not be read on the host). ``rng`` is the
    run's seed (``RunOptions.seed``); Random* ops draw from
    ``torch.Generator``s on ``device`` seeded from it (``random``, a
    ``RunRandom`` shared with the run's other contexts). ``run_subgraph``
    executes a nested Graph for control-flow ops (If). ``statics`` puts
    static operands on the device (the executor's ``StaticValues``)."""

    def __init__(
        self,
        mode: str = "eager",
        rng: int | None = None,
        run_subgraph: Callable | None = None,
        *,
        device=None,
        statics: Any = None,
        random: RunRandom | None = None,
    ) -> None:
        self.mode = mode
        self.rng = rng
        self.run_subgraph = run_subgraph
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.statics = statics
        self.random = random if random is not None else RunRandom(rng, self.device)

    def child(self) -> "OpContext":
        """A context for a subgraph of this run (same mode, device, statics
        and generators)."""
        return OpContext(self.mode, self.rng, device=self.device, statics=self.statics, random=self.random)

    def next_rng(self) -> torch.Generator:
        """The run's generator (seeded from ``rng`` at its first use); each
        draw advances it, as the JAX package splits its key."""
        return self.random.main()

    def generator_for(self, seed: int) -> torch.Generator:
        """A generator of its own for an op with an ONNX ``seed``."""
        return self.random._make(seed)
