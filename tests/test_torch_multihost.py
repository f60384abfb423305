"""The port's multi-host runtime (``parallel/multihost.py``) against the
JAX package's on the CPU: ``init_distributed`` in one process, the
heartbeat mesh that reports a dead peer (stdlib UDP on loopback), and the
restartable ``ServingSupervisor``: without a mesh (a failure at step 3,
``tests/test_multihost_resilience.py``'s case, each stream the
uninterrupted run's) and on two gloo ranks of a (1, 2) mesh with a
failure injected on rank 1 only, after which both ranks rebuild and restore
from the same snapshot (every rank's streams equal the uninterrupted
run's). Ranks: one world of two for the module, 60 s collective timeout, a
wall limit a run.
"""

import time

import pytest
import torch

import torch_parallel_ranks as ranks
from rten_tpu.models import decoder as jdec
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.parallel.launch import World
from rten_tpu_torch.parallel.multihost import HeartbeatMonitor, PeerState, init_distributed
from torch_port_helpers import SLICE_CFG, dense_tree, to_jax, to_numpy

SPECS = [dict(prompt=[1, 2, 3], max_new_tokens=8), dict(prompt=[7, 8], max_new_tokens=5),
         dict(prompt=[4, 5, 6, 9], max_new_tokens=6)]


@pytest.fixture(scope="module")
def world():
    with World(2, device="cpu", timeout_s=60) as w:
        yield w


@pytest.fixture(scope="module")
def models():
    """SLICE_CFG's int8 packs (``fuse=False``) and the uninterrupted run's
    streams (one rank, no supervisor failure), the reference every
    recovery must give, as in ``tests/test_multihost_resilience.py``."""
    tcfg = tdec.DecoderConfig(**SLICE_CFG, dtype=torch.float32)
    tree = to_numpy(jdec.quantize_params_int8(to_jax(dense_tree(21)), fuse=False))
    want = ranks.supervised_run(None, tcfg, tree, SPECS, 0, None, 1)
    assert want["restarts"] == 0 and want["n_done"] == len(SPECS)
    return tcfg, tree, want["outputs"]


def test_init_distributed_single_process(monkeypatch):
    """No coordinator: nothing initialised, the JAX package's keys."""
    from rten_tpu.parallel.multihost import init_distributed as jinit

    for name in ("RTEN_COORDINATOR", "RTEN_NUM_PROCESSES", "RTEN_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    info = init_distributed()
    assert info["num_processes"] == 1 and info["process_id"] == 0
    assert info["global_devices"] >= 1 and set(info) == set(jinit())
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_heartbeat_detects_dead_peer():
    """``tests/test_multihost_resilience.py``'s case on the port's copy."""
    dead: list[int] = []
    m0 = HeartbeatMonitor(0, 0, {}, interval=0.1, timeout=0.5, bind_address="127.0.0.1")
    m0.start()
    m1 = HeartbeatMonitor(1, 0, {0: ("127.0.0.1", m0.port)}, interval=0.1, timeout=0.5, bind_address="127.0.0.1")
    m0.peers[1] = PeerState(("127.0.0.1", m1.port), last_seen=time.monotonic())
    m0.on_peer_dead = dead.append
    m1.start()
    try:
        time.sleep(0.4)
        assert m0.alive_peers() == [1]
        m1.stop()  # the peer goes silent
        deadline = time.monotonic() + 3
        while not dead and time.monotonic() < deadline:
            time.sleep(0.05)
        assert dead == [1] and m0.dead_peers() == [1]
    finally:
        m0.stop()


def test_supervisor_recovers_without_mesh(models, tmp_path):
    """A failure after step 3, snapshots every step (also written to a
    file): one restart, every stream the uninterrupted run's, each request
    reported once."""
    tcfg, tree, want = models
    res = ranks.supervised_run(None, tcfg, tree, SPECS, 0, 3, 1, str(tmp_path / "snap"))
    assert res["restarts"] == 1 and res["n_done"] == len(SPECS)
    assert res["outputs"] == want


def test_supervisor_on_two_ranks_recovers_from_rank_1(world, models):
    """A (1, 2) mesh, the failure on rank 1 only at step 4, snapshots every
    2 steps: both ranks restart once and every rank's streams equal the
    uninterrupted run's."""
    tcfg, tree, want = models
    for res in world.run(ranks.supervised_run, (1, 2), tcfg, tree, SPECS, 1, 4, 2):
        assert res["restarts"] == 1 and res["n_done"] == len(SPECS)
        assert res["outputs"] == want
