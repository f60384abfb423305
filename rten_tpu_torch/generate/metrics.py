"""Generation throughput metrics: per-step host wall times (counterpart of
rten_tpu/generate/metrics.py; reference: rten-generate/src/metrics.rs —
Metrics :15, tokens_per_second :72, warmup split)."""

from __future__ import annotations

import time


class Metrics:
    """Records per-step wall times; the first step (prefill + compile) is
    reported separately from the steady-state decode rate, mirroring the
    reference's warmup split."""

    def __init__(self) -> None:
        self.step_times_s: list[float] = []
        self._t0: float | None = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self) -> None:
        if self._t0 is None:
            raise RuntimeError("end_step() without start_step()")
        self.step_times_s.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def warmup_time_s(self) -> float:
        return self.step_times_s[0] if self.step_times_s else 0.0

    @property
    def steady_times(self) -> list[float]:
        return self.step_times_s[1:]

    def mean_step_ms(self) -> float:
        ts = self.steady_times or self.step_times_s
        return 1e3 * sum(ts) / len(ts) if ts else 0.0

    def tokens_per_second(self) -> float:
        ts = self.steady_times or self.step_times_s
        total = sum(ts)
        return len(ts) / total if total > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{len(self.step_times_s)} tokens; warmup {self.warmup_time_s * 1e3:.1f} ms; "
            f"mean step {self.mean_step_ms():.2f} ms; "
            f"{self.tokens_per_second():.1f} tokens/s"
        )
