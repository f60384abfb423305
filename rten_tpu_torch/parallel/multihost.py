"""Multi-host runtime: ``torch.distributed`` wiring, host health checks,
and a restartable serving supervisor.

Counterpart of ``rten_tpu/parallel/multihost.py``, in three pieces:

1. ``init_distributed`` — one call per process, joining the world from
   explicit arguments or the ``RTEN_COORDINATOR`` / ``RTEN_NUM_PROCESSES``
   / ``RTEN_PROCESS_ID`` environment variables (``init_process_group`` with
   a ``tcp://`` rendezvous at the coordinator); after it, ``parallel.mesh``
   meshes span every process. Without a coordinator it changes nothing and
   returns the single-process layout.
2. ``HeartbeatMonitor`` — a UDP heartbeat mesh between hosts (stdlib socket
   threads), copied as it is: peers whose beats go stale are reported dead.
3. ``ServingSupervisor`` — restartable serving over the port's
   ``serve.checkpoint``: a snapshot every N steps, and on a failure a fresh
   engine restored from the last one. Under a mesh every rank runs its own
   supervisor; after each step the ranks all-reduce a failure flag, so a
   step that raised on any rank makes every rank rebuild and restore from
   the snapshot of the same step.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import threading
import time
from typing import Callable

import torch


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    timeout_s: float = 300.0,
) -> dict:
    """Join the multi-process world (one call per process, before any mesh
    is made). Arguments default to RTEN_COORDINATOR (``host:port`` of rank
    0's rendezvous) / RTEN_NUM_PROCESSES / RTEN_PROCESS_ID; the backend is
    NCCL where CUDA is available, else gloo; ``timeout_s`` bounds each
    collective.

    Returns {"process_id", "num_processes", "local_devices",
    "global_devices"}: the devices are this host's CUDA cards (the CPU
    counts as one where there is none) and those times the world size.
    Without a coordinator or with one process nothing is initialised."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("RTEN_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("RTEN_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RTEN_PROCESS_ID", "0"))
    if coordinator_address and num_processes > 1 and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    local = torch.cuda.device_count() or 1
    return {
        "process_id": process_id,
        "num_processes": num_processes,
        "local_devices": local,
        "global_devices": local * num_processes,
    }


@dataclasses.dataclass
class PeerState:
    address: tuple[str, int]
    last_seen: float = 0.0
    alive: bool = True


class HeartbeatMonitor:
    """UDP heartbeat mesh: every host broadcasts a beat to all peers each
    ``interval`` seconds and marks peers dead after ``timeout`` without one.

    Dead peers trigger ``on_peer_dead(peer_id)`` exactly once per transition
    (a peer that recovers and beats again is resurrected and can die again).
    """

    def __init__(
        self,
        host_id: int,
        listen_port: int,
        peers: dict[int, tuple[str, int]],
        *,
        interval: float = 0.5,
        timeout: float = 2.0,
        on_peer_dead: Callable[[int], None] | None = None,
        bind_address: str = "0.0.0.0",
        cluster_token: str | None = None,
    ) -> None:
        self.host_id = host_id
        self.interval = interval
        self.timeout = timeout
        self.on_peer_dead = on_peer_dead
        # Heartbeats are unauthenticated UDP on a trusted cluster network
        # (ICI/DCN fabric). A spoofed beat could mask a real peer failure, so
        # deployments on shared networks should set ``cluster_token`` (any
        # shared secret): beats carry it and non-matching datagrams are
        # ignored.
        self.cluster_token = cluster_token
        self.peers = {pid: PeerState(addr) for pid, addr in peers.items()}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # Bind all interfaces by default — a loopback bind would silently
        # drop beats from peers on OTHER hosts, defeating multi-host failure
        # detection (override via bind_address to pin an interface).
        self._sock.bind((bind_address, listen_port))
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        now = time.monotonic()
        for p in self.peers.values():
            p.last_seen = now
        for fn in (self._recv_loop, self._beat_loop, self._check_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._sock.close()

    def alive_peers(self) -> list[int]:
        return [pid for pid, p in self.peers.items() if p.alive]

    def dead_peers(self) -> list[int]:
        return [pid for pid, p in self.peers.items() if not p.alive]

    # -- internals --------------------------------------------------------------

    def _beat_loop(self) -> None:
        beat = {"id": self.host_id}
        if self.cluster_token is not None:
            beat["token"] = self.cluster_token
        msg = json.dumps(beat).encode()
        while not self._stop.wait(self.interval):
            for p in self.peers.values():
                try:
                    self._sock.sendto(msg, p.address)
                except OSError:
                    pass

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(4096)
            except (socket.timeout, OSError):
                continue
            try:
                beat = json.loads(data.decode())
                pid = beat["id"]
            except (ValueError, KeyError):
                continue
            if self.cluster_token is not None and beat.get("token") != self.cluster_token:
                continue
            peer = self.peers.get(pid)
            if peer is not None:
                peer.last_seen = time.monotonic()
                peer.alive = True

    def _check_loop(self) -> None:
        while not self._stop.wait(self.interval):
            now = time.monotonic()
            for pid, p in self.peers.items():
                if p.alive and now - p.last_seen > self.timeout:
                    p.alive = False
                    if self.on_peer_dead:
                        self.on_peer_dead(pid)


class ServingSupervisor:
    """Restartable serving loop: a snapshot every ``snapshot_every`` engine
    steps; on a failure, a fresh engine from ``engine_factory()`` (weights
    reloaded, re-sharded under a mesh) restored from the last snapshot, and
    the run goes on. In-flight requests keep their generated prefixes; the
    requests that finished after that snapshot are finished again by the
    restored engine, and are reported once.

    ``mesh``: every rank of it runs a supervisor over its own engine (the
    same factory, the same requests). After each step the ranks all-reduce
    a failure flag, so that all of them rebuild and restore together; a
    rank's step must fail after the step's collectives (a failure inside
    one leaves its peers waiting in it until their timeout). With a
    ``snapshot_path`` each rank writes its own file, ``.rank<i>`` added.
    """

    def __init__(
        self,
        engine_factory: Callable[[], "object"],
        *,
        snapshot_every: int = 16,
        max_restarts: int = 3,
        snapshot_path: str | None = None,
        mesh=None,
    ) -> None:
        self.engine_factory = engine_factory
        self.snapshot_every = snapshot_every
        self.max_restarts = max_restarts
        self.mesh = mesh
        if snapshot_path and mesh is not None:
            snapshot_path = f"{snapshot_path}.rank{mesh.axis_index(None)}"
        self.snapshot_path = snapshot_path
        self.restarts = 0
        self.engine = engine_factory()
        self._snapshot = None

    def submit(self, request) -> None:
        self.engine.submit(request)

    def _any_failed(self, failed: bool) -> bool:
        if self.mesh is None:
            return failed
        flag = torch.tensor([int(failed)], dtype=torch.int32, device=self.mesh.device)
        return bool(self.mesh.pmax(flag, None).item())

    def _saved(self) -> str | None:
        if not self.snapshot_path:
            return None
        path = self.snapshot_path if self.snapshot_path.endswith(".npz") else self.snapshot_path + ".npz"
        return path if os.path.exists(path) else None

    def run(self) -> list:
        from rten_tpu_torch.serve import checkpoint

        done: list = []
        done_at_snapshot = 0
        steps_since_snapshot = 0
        while self.engine.has_work():
            error = None
            finished: list = []
            try:
                finished = self.engine.step()
            except Exception as exc:  # the boundary that must keep serving
                error = exc
            if not self._any_failed(error is not None):
                done.extend(finished)
                steps_since_snapshot += 1
                if steps_since_snapshot >= self.snapshot_every:
                    self._snapshot = checkpoint.snapshot_engine(self.engine)
                    if self.snapshot_path:
                        checkpoint.save_snapshot(self._snapshot, self.snapshot_path)
                    done_at_snapshot = len(done)
                    steps_since_snapshot = 0
                continue
            self.restarts += 1
            if self.restarts > self.max_restarts:
                if error is not None:
                    raise error
                raise RuntimeError("a peer rank's engine step failed past max_restarts")
            self.engine = self.engine_factory()
            snap = self._snapshot
            if snap is None and self._saved():
                snap = checkpoint.load_snapshot(self._saved())
            if snap is not None:
                checkpoint.restore_engine(self.engine, snap)
                del done[done_at_snapshot:]
            steps_since_snapshot = 0
        return done
