"""Serving-session checkpoint and resume.

Counterpart of ``rten_tpu/serve/checkpoint.py``: a snapshot holds the
MUTABLE session state only (the KV cache, the slot table, the queue, the
sampler's generator, each request's progress), never the weights, which
reload from their file. It is a plain dict ``{"arrays": {name: np.ndarray},
"meta": {...}}``; ``save_snapshot`` writes the arrays to one ``.npz`` with
the metadata as JSON in its ``__meta__`` entry.

The port's session has more than the JAX engine's, and a snapshot carries
all of it: the host mirror of the lengths (``cache["host_len"]``, which
``forward`` reads to refuse a full row and to size the prefix it attends
over), the slot engine's per-slot budget mirror and last tokens, its tick
count, and the state of its ``torch.Generator``, so that a sampled
continuation draws the same noise as the uninterrupted run. Caches are
stored in the port's logical layouts (k/v ``[B, Hk, S, D]``, scales ``[B,
Hk, S]``); bf16 leaves as their 16-bit patterns, which numpy cannot hold as
numbers. A port snapshot need not load into the JAX package.

A restore builds its tensors on the engine's (or backend's) device and
checks that the batch and every cache leaf's shape and dtype match what the
engine was built with: a mismatch raises ValueError, nothing is cropped or
cast. The paged engine has no snapshot (the JAX package's reads
``engine.slots``, which its paged engine does not have).
"""

from __future__ import annotations

import json
from collections import deque

import numpy as np
import torch


def _host(leaf) -> tuple[np.ndarray, str]:
    """A cache leaf as a host array and its dtype's name (a numpy leaf
    as ``"host:<dtype>"``)."""
    if isinstance(leaf, np.ndarray):
        return leaf.copy(), f"host:{leaf.dtype}"
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy(), name


def _snapshot_cache(cache: dict) -> tuple[dict, dict, dict]:
    """Every cache leaf (k/v, an int8 cache's k_scale/v_scale, len,
    host_len, and whatever else the cache holds) as named host arrays, with
    the structure map (a list's length, or None) and each key's dtype for
    the restore. Iterating all leaves rather than naming k/v/len is what
    keeps int8-KV caches restorable."""
    arrays: dict[str, np.ndarray] = {}
    structure: dict[str, int | None] = {}
    dtypes: dict[str, str] = {}
    for key, val in cache.items():
        if isinstance(val, list):
            structure[key] = len(val)
            for li, leaf in enumerate(val):
                arrays[f"{key}{li}"], dtypes[key] = _host(leaf)
        else:
            structure[key] = None
            arrays[key], dtypes[key] = _host(val)
    return arrays, structure, dtypes


def _leaf(arr: np.ndarray, like, dtype_name: str, what: str):
    """``arr`` as a leaf of the kind, shape and dtype of ``like`` (on its
    device), or ValueError."""
    want = (f"host:{like.dtype}" if isinstance(like, np.ndarray)
            else str(like.dtype).removeprefix("torch."))
    if dtype_name != want or tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"snapshot leaf {what}: {dtype_name} {tuple(arr.shape)} does not fit the target's "
                         f"{want} {tuple(like.shape)}")
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype, copy=True)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def _restore_cache(arrays: dict, structure: dict, dtypes: dict, like: dict) -> dict:
    """A cache rebuilt from ``_snapshot_cache``'s arrays, leaf by leaf of
    the same kind, shape and dtype as the template ``like`` (the cache the
    target was built with), on its device. ValueError when the keys, a
    list's length or a leaf differ."""
    if set(structure) != set(like):
        raise ValueError(f"snapshot cache keys {sorted(structure)} != the target's {sorted(like)}")
    cache: dict = {}
    for key, n in structure.items():
        if n is None:
            cache[key] = _leaf(arrays[key], like[key], dtypes[key], key)
        else:
            if not isinstance(like[key], list) or len(like[key]) != n:
                raise ValueError(f"snapshot cache {key}: {n} layers do not fit the target's")
            cache[key] = [_leaf(arrays[f"{key}{li}"], like[key][li], dtypes[key], f"{key}{li}") for li in range(n)]
    if "host_len" in cache and (cache["host_len"] < cache["len"].cpu().numpy()).any():
        raise ValueError("snapshot host_len falls below the device lengths")
    return cache


def _req_meta(req) -> dict:
    return {
        "prompt": list(map(int, req.prompt)),
        "max_new_tokens": req.max_new_tokens,
        "eos_tokens": list(map(int, req.eos_tokens)),
        "request_id": req.request_id,
        "output": list(map(int, req.output)),
        "finished": req.finished,
    }


def snapshot_engine(engine) -> dict:
    """The session state of a ``ServingEngine`` between steps (device →
    host copies): its cache, last tokens, budget mirror, generator state,
    slots, queue and tick count."""
    from rten_tpu_torch.serve.engine import ServingEngine

    if not isinstance(engine, ServingEngine):
        raise TypeError(f"snapshot_engine takes a ServingEngine, got {type(engine).__name__}")
    arrays, structure, dtypes = _snapshot_cache(engine.cache)
    arrays["last_tokens"] = engine._last_tokens.copy()
    arrays["mirror_budget"] = engine._mirror_budget.copy()
    arrays["rng"] = engine._rng.get_state().numpy().copy()
    meta = {
        "slots": [None if r is None else _req_meta(r) for r in engine.slots],
        "queue": [_req_meta(r) for r in engine.queue],
        "steps": engine.steps,
        "max_batch": engine.max_batch,
        "eos_width": engine._eos_width,
        "cache_structure": structure,
        "cache_dtypes": dtypes,
    }
    return {"arrays": arrays, "meta": meta}


def restore_engine(engine, snapshot: dict) -> None:
    """Load a snapshot into a freshly constructed ``ServingEngine`` of the
    same params, cfg, ``max_batch`` and ``max_len`` (ValueError otherwise).
    Weights are not touched: the engine was built with them already. The
    sampler is the engine's own; its generator resumes at the snapshot's
    state."""
    from rten_tpu_torch.serve.engine import Request

    arrays, meta = snapshot["arrays"], snapshot["meta"]
    if meta["max_batch"] != engine.max_batch:
        raise ValueError(f"snapshot of {meta['max_batch']} slots, engine has {engine.max_batch}")
    engine.cache = _restore_cache(arrays, meta["cache_structure"], meta["cache_dtypes"], engine.cache)
    engine._last_tokens = np.asarray(arrays["last_tokens"], np.int32).copy()
    engine._mirror_budget = np.asarray(arrays["mirror_budget"], np.int64).copy()
    engine._rng.set_state(torch.from_numpy(np.asarray(arrays["rng"], np.uint8).copy()))
    engine.steps = int(meta["steps"])
    engine._eos_width = int(meta["eos_width"])
    engine._last_admitted = []

    def mk_req(m):
        if m is None:
            return None
        r = Request(prompt=m["prompt"], max_new_tokens=m["max_new_tokens"], eos_tokens=tuple(m["eos_tokens"]),
                    request_id=m["request_id"])
        r.output = list(m["output"])
        r.finished = m["finished"]
        return r

    engine.slots = [mk_req(m) for m in meta["slots"]]
    engine.queue = deque(mk_req(m) for m in meta["queue"])


def snapshot_backend(backend) -> dict:
    """A ``NativeBackend``'s KV session (multi-turn chat state): its cache
    and its host token count ``length``."""
    arrays, structure, dtypes = _snapshot_cache(backend.cache)
    return {"arrays": arrays, "meta": {"cache_structure": structure, "cache_dtypes": dtypes,
                                       "length": backend.length, "batch": backend.batch}}


def restore_backend(backend, snapshot: dict) -> None:
    """Load ``snapshot_backend``'s snapshot into a ``NativeBackend`` of the
    same params, cfg, batch and ``max_len`` (ValueError otherwise)."""
    meta = snapshot["meta"]
    if meta["batch"] != backend.batch:
        raise ValueError(f"snapshot of batch {meta['batch']}, backend has {backend.batch}")
    backend.cache = _restore_cache(snapshot["arrays"], meta["cache_structure"], meta["cache_dtypes"], backend.cache)
    backend.length = int(meta["length"])


def save_snapshot(snapshot: dict, path: str) -> None:
    buf = dict(snapshot["arrays"])
    buf["__meta__"] = np.frombuffer(json.dumps(snapshot["meta"]).encode(), dtype=np.uint8)
    np.savez(path, **buf)


def load_snapshot(path: str) -> dict:
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
    return {"arrays": arrays, "meta": meta}
