"""Per-op timing for the interpret executor.

Reference: src/timing.rs (RunTiming :146, TimingRecord :387, TimingSort :403)
— per-op wall-clock records aggregated per op type with %-of-total and an
optional per-input-shape breakdown. A copy of ``rten_tpu/runtime/timing.py``;
the interpret executor synchronises the model's device after each op so a
record holds the op's device time. On the compiled path (one CUDA graph a
signature) the table is meaningless; use ``torch.profiler`` there instead.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class TimingRecord:
    op_type: str
    node_name: str
    input_shapes: list[tuple[int, ...]]
    elapsed_s: float


class RunTiming:
    def __init__(self) -> None:
        self.records: list[TimingRecord] = []
        self.total_s = 0.0

    def add(self, record: TimingRecord) -> None:
        self.records.append(record)
        self.total_s += record.elapsed_s

    def summary(self, sort: str = "time", by_shape: bool = False) -> str:
        by_op: dict[str, list[TimingRecord]] = defaultdict(list)
        for r in self.records:
            by_op[r.op_type].append(r)
        rows = []
        for op_type, recs in by_op.items():
            t = sum(r.elapsed_s for r in recs)
            rows.append((op_type, len(recs), t))
        if sort == "name":
            rows.sort(key=lambda r: r[0])
        else:
            rows.sort(key=lambda r: -r[2])
        total = self.total_s or 1e-12
        lines = [f"{'op':<24}{'count':>8}{'time (ms)':>12}{'%':>8}"]
        for op_type, count, t in rows:
            lines.append(
                f"{op_type:<24}{count:>8}{t * 1e3:>12.3f}{100 * t / total:>7.2f}%"
            )
            if by_shape:
                shape_groups: dict[str, float] = defaultdict(float)
                shape_counts: dict[str, int] = defaultdict(int)
                for r in by_op[op_type]:
                    key = ", ".join(str(list(s)) for s in r.input_shapes)
                    shape_groups[key] += r.elapsed_s
                    shape_counts[key] += 1
                for key, t_s in sorted(shape_groups.items(), key=lambda kv: -kv[1]):
                    lines.append(
                        f"  {key:<30}{shape_counts[key]:>6}{t_s * 1e3:>12.3f}"
                    )
        lines.append(f"{'total':<24}{len(self.records):>8}{self.total_s * 1e3:>12.3f}")
        return "\n".join(lines)


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self.start
        return False
