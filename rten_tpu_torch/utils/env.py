"""Env-var flags (reference: src/env.rs:15 env_flag — the config pattern
used by RTEN_NUM_THREADS / RTEN_TIMING / RTEN_USE_POOL)."""

from __future__ import annotations

import os

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def env_flag(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    low = val.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    return default


def env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        return default
