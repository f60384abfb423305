"""Device-level tracing helpers: the port's counterpart of
``rten_tpu/runtime/profiler.py``.

Two levels exist in this framework:
1. the interpret executor's per-op timing table (RunOptions(timing=True),
   runtime/timing.py) — the reference's RunTiming equivalent;
2. this module — a ``torch.profiler`` trace around a block (host activity,
   and the card's kernels and copies where CUDA is available), written as a
   Chrome trace viewable in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str = "rten_tpu_torch_trace"):
    """Capture a trace around a block:

        with profiler.trace("trace_dir"):
            model.run(inputs)

    Records CPU activity, and CUDA activity too when
    ``torch.cuda.is_available()``; writes ``trace.json`` (Chrome trace
    format) into ``log_dir`` when the block ends, and yields ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Host-side per-step wall times with warmup split — the generation
    Metrics pattern generalized to any stepped workload (serving engine
    steps, training-style loops)."""

    def __init__(self) -> None:
        self.times_s: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times_s.append(time.perf_counter() - self._t0)
        self._t0 = None
        return False

    @property
    def steady_s(self) -> list[float]:
        return self.times_s[1:] if len(self.times_s) > 1 else self.times_s

    def mean_ms(self) -> float:
        ts = self.steady_s
        return 1e3 * sum(ts) / len(ts) if ts else 0.0

    def summary(self) -> str:
        return (
            f"{len(self.times_s)} steps; warmup "
            f"{(self.times_s[0] * 1e3 if self.times_s else 0):.1f} ms; "
            f"steady mean {self.mean_ms():.2f} ms"
        )
