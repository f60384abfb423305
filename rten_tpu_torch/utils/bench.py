"""Benchmark statistics helper (reference: rten-bench/src/lib.rs:25
run_bench → min/max/mean/median/variance over trials). A copy of
``rten_tpu/utils/bench.py`` that waits for the devices of the tensors in a
result (``torch.cuda.synchronize``) where the JAX one blocks on its arrays."""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import torch


def _devices(result, found: set) -> set:
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _devices(v, found)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _devices(v, found)
    return found


def block_until_ready(result):
    """Wait for the device of every CUDA tensor in ``result`` (nested in
    lists, tuples and dicts); a CPU tensor or any other value needs no
    wait. Returns ``result``."""
    for dev in _devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


@dataclasses.dataclass
class BenchStats:
    desc: str
    times_s: list[float]

    @property
    def min(self) -> float:
        return min(self.times_s)

    @property
    def max(self) -> float:
        return max(self.times_s)

    @property
    def mean(self) -> float:
        return statistics.fmean(self.times_s)

    @property
    def median(self) -> float:
        return statistics.median(self.times_s)

    @property
    def var(self) -> float:
        return statistics.pvariance(self.times_s)

    def __str__(self) -> str:
        ms = 1e3
        return (
            f"{self.desc}: mean {self.mean * ms:.3f} ms, median "
            f"{self.median * ms:.3f} ms, min {self.min * ms:.3f} ms, "
            f"max {self.max * ms:.3f} ms ({len(self.times_s)} trials)"
        )


def run_bench(trials: int, desc: str, f: Callable[[], object]) -> BenchStats:
    """Time ``f`` ``trials`` times (after one untimed warmup), waiting for
    the devices of the tensors in the result so device work is included."""
    block_until_ready(f())
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        block_until_ready(f())
        times.append(time.perf_counter() - t0)
    return BenchStats(desc, times)


def marginal_step_time(
    run_at: Callable[[int], object], short: int, long: int, trials: int = 6
) -> float:
    """Device-side per-step time as the slope between a short and a long run
    — fixed launch overhead cancels.

    Short/long runs are INTERLEAVED in pairs and the slope is taken from the
    global minima: the device is time-shared, so two sequential sample blocks
    can land in differently-contended windows and fake a slope; paired
    minima both converge to the uncontended device time."""
    block_until_ready(run_at(short))  # compile/warm both lengths
    block_until_ready(run_at(long))
    t_short, t_long = [], []
    for _ in range(trials):
        t0 = time.perf_counter()
        block_until_ready(run_at(short))
        t1 = time.perf_counter()
        block_until_ready(run_at(long))
        t2 = time.perf_counter()
        t_short.append(t1 - t0)
        t_long.append(t2 - t1)
    return (min(t_long) - min(t_short)) / (long - short)
