"""A world of ranks on one host: spawned processes joined by
``torch.distributed``, each running the same Python (SPMD).

The JAX package runs its meshes in one process over virtual devices
(``tests/conftest.py``: 8 CPU devices) or over the chips of a host; the
port runs one process a rank instead. ``World(size)`` spawns ``size``
processes (the ``spawn`` start method), initialises each with a
``FileStore`` in a fresh temporary directory (no TCP port, so worlds of
parallel test workers cannot collide) and ``init_process_group(timeout=…)``,
then runs tasks: ``world.run(fn, *args)`` calls ``fn(*args)`` on every
rank and returns the ranks' results in rank order. ``fn`` and its
arguments and results are pickled, so ``fn`` is a module-level function of
a module the ranks can import. A rank that raises, dies or outlives the
time limit makes the world kill every rank and raise: a collective that a
failed rank never enters cannot hang the caller.

The backend is NCCL when every rank has a card of its own
(``torch.cuda.device_count() >= size``) and gloo otherwise: on the CPU, or
when ranks share one card (NCCL refuses two ranks on one device). With
gloo on a card, ``parallel.mesh`` stages every collective through host
memory. The choice is never silent: ``World.backend`` and
``World.devices`` say what was taken, and ``run_ranks`` returns them with
the results.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch

from rten_tpu_torch.kernels.dispatch import resolve_device


def plan_world(size: int, device="cuda") -> tuple[str, list[str]]:
    """(backend, the device of each rank) for ``size`` ranks on ``device``:
    NCCL with a card a rank where the host has ``size`` cards, else gloo,
    the ranks sharing the cards round-robin; gloo on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", ["cpu"] * size
    n = torch.cuda.device_count()
    if n >= size:
        return "nccl", [f"cuda:{r}" for r in range(size)]
    return "gloo", [f"cuda:{r % n}" for r in range(size)]


def _rank_main(rank: int, size: int, backend: str, device: str, store_path: str, timeout_s: float,
               tasks, results) -> None:
    """A rank's process: join the group, then run tasks until told to stop.
    Every message to the parent is one pickled ``(status, rank, payload)``.
    One intra-op thread a rank: the ranks share the host's cores."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if device != "cpu":
            torch.cuda.set_device(torch.device(device))
        store = dist.FileStore(store_path, size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException:
        results.put(pickle.dumps(("error", rank, traceback.format_exc())))
        return
    results.put(pickle.dumps(("ready", rank, None)))
    try:
        while True:
            msg = tasks.get()
            if msg is None:
                break
            fn, args = pickle.loads(msg)
            try:
                out = ("ok", rank, fn(*args))
            except BaseException:
                out = ("error", rank, traceback.format_exc())
            results.put(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


class World:
    """``size`` spawned ranks on one host, joined by ``torch.distributed``.

    ``timeout_s`` bounds each rank's collectives (``init_process_group``'s
    timeout) and each ``run`` (its default wall limit). Use as a context
    manager, or call ``close``."""

    def __init__(self, size: int, device="cuda", *, timeout_s: float = 120.0) -> None:
        self.size = size
        self.timeout_s = timeout_s
        self.backend, self.devices = plan_world(size, device)
        self._closed = False
        self._dir = tempfile.mkdtemp(prefix="rten_world_")
        ctx = multiprocessing.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, size, self.backend, self.devices[r], os.path.join(self._dir, "store"),
                              timeout_s, self._tasks[r], self._results))
            for r in range(size)
        ]
        for p in self._procs:
            p.start()
        self._collect("ready", timeout_s)

    def __enter__(self) -> World:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn, *args, timeout_s: float | None = None) -> list:
        """``fn(*args)`` on every rank; the results in rank order. Raises
        RuntimeError (a rank raised or died) or TimeoutError (the wall limit,
        default the world's ``timeout_s``), after killing every rank."""
        if self._closed:
            raise RuntimeError("the world is closed")
        msg = pickle.dumps((fn, args))
        for q in self._tasks:
            q.put(msg)
        return self._collect("ok", timeout_s or self.timeout_s)

    def _collect(self, want: str, timeout_s: float) -> list:
        out: list = [None] * self.size
        pending = set(range(self.size))
        deadline = time.monotonic() + timeout_s
        while pending:
            try:
                status, rank, payload = pickle.loads(self._results.get(timeout=0.2))
            except queue.Empty:
                dead = [r for r in pending if not self._procs[r].is_alive()]
                if dead:
                    codes = [self._procs[r].exitcode for r in dead]
                    self.close(1.0)
                    raise RuntimeError(f"ranks {dead} died (exit codes {codes})") from None
                if time.monotonic() > deadline:
                    self.close(1.0)
                    raise TimeoutError(f"ranks {sorted(pending)} did not finish within {timeout_s} s") from None
                continue
            if status == "error":
                self.close(1.0)
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            if status != want:
                self.close(1.0)
                raise RuntimeError(f"rank {rank} answered {status!r}, expected {want!r}")
            out[rank] = payload
            pending.discard(rank)
        return out

    def close(self, grace_s: float = 10.0) -> None:
        """Stop every rank: a clean exit where it can, killed after
        ``grace_s`` (a rank that waits in a collective never exits)."""
        if self._closed:
            return
        self._closed = True
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + grace_s
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            try:  # drain: a rank's queue thread cannot exit before its messages are read
                self._results.get(timeout=0.05)
            except queue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        self._procs = []
        for q in (*self._tasks, self._results):
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)


@dataclasses.dataclass
class RankResults:
    """What ``run_ranks`` returns: each rank's result in rank order, the
    backend taken and each rank's device."""

    results: list
    backend: str
    devices: list[str]


def run_ranks(fn, world: int, *args, device="cuda", timeout_s: float = 600.0) -> RankResults:
    """Spawn ``world`` ranks on this host, run ``fn(*args)`` on each, stop
    them. ``timeout_s`` bounds the whole run and each collective."""
    with World(world, device, timeout_s=timeout_s) as w:
        return RankResults(w.run(fn, *args), w.backend, w.devices)
