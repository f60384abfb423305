"""The port's utils (env flags, run_bench, marginal_step_time) and
runtime.profiler (trace, StepTimer) against the JAX package's behaviour
(tests/test_utils_scaling.py's cases), on the CPU."""

import json
import time

import numpy as np
import pytest
import torch

from rten_tpu.utils import env_flag as jenv_flag
from rten_tpu.utils import env_int as jenv_int
from rten_tpu_torch.runtime import profiler
from rten_tpu_torch.utils import BenchStats, env_flag, env_int, run_bench
from rten_tpu_torch.utils.bench import block_until_ready, marginal_step_time


@pytest.mark.parametrize("value", ["true", "0", "YES", " off ", "on", "junk", "", None, "7", "-3", "2.5"])
def test_env_flags_match_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("X_FLAG", raising=False)
    else:
        monkeypatch.setenv("X_FLAG", value)
    for default in (False, True):
        assert env_flag("X_FLAG", default) == jenv_flag("X_FLAG", default)
    assert env_int("X_FLAG", 3) == jenv_int("X_FLAG", 3)


def test_run_bench_stats():
    stats = run_bench(5, "noop", lambda: torch.zeros(4))
    assert isinstance(stats, BenchStats) and len(stats.times_s) == 5
    assert stats.min <= stats.median <= stats.max and stats.var >= 0
    assert "noop" in str(stats) and "5 trials" in str(stats)


def test_block_until_ready_walks_the_result():
    out = {"a": [torch.ones(2), (np.zeros(3), 4)], "b": "x"}
    assert block_until_ready(out) is out  # CPU tensors and other values: nothing to wait for


def test_marginal_step_time_linear():
    """A fake whose time is linear in its steps: the slope of the paired
    minima is its per-step time, the fixed part cancelled."""
    def run_at(n):
        time.sleep(0.004 + 0.001 * n)
        return torch.zeros(n)

    t = marginal_step_time(run_at, 1, 10, trials=3)
    assert 0.0005 < t < 0.005


def test_step_timer():
    timer = profiler.StepTimer()
    for d in (0.02, 0.002, 0.002):
        with timer:
            time.sleep(d)
    assert len(timer.times_s) == 3 and timer.steady_s == timer.times_s[1:]
    assert 1.5 < timer.mean_ms() < 10
    assert timer.summary().startswith("3 steps; warmup")
    empty = profiler.StepTimer()
    assert empty.mean_ms() == 0.0 and empty.summary().startswith("0 steps")


def test_trace_writes_chrome_trace(tmp_path):
    """profiler.trace around a CPU forward writes trace.json (Chrome trace
    format) naming the forward's operators, and yields its directory."""
    from rten_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(vocab_size=300, n_layers=1, n_heads=4, d_model=256, d_ff=512, max_seq=32,
                                dtype=torch.float32)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cpu"), device="cpu")
    log_dir = tmp_path / "trace"
    with profiler.trace(str(log_dir)) as d:
        decoder.prefill(params, cfg, torch.arange(12, dtype=torch.int32)[None],
                        decoder.init_cache(cfg, 1, device="cpu"))
    assert d == str(log_dir)
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)
