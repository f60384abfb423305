"""Small shared utilities (≙ the reference's misc utils: rten-bench's
run_bench, src/env.rs env flags): the port's copy of ``rten_tpu/utils``."""

from rten_tpu_torch.utils.bench import BenchStats, run_bench
from rten_tpu_torch.utils.env import env_flag, env_int

__all__ = ["BenchStats", "run_bench", "env_flag", "env_int"]
