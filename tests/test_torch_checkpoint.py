"""Serving-session checkpoint and resume of the port
(``rten_tpu_torch.serve.checkpoint``): the twins of the JAX package's
``tests/test_multihost_resilience.py`` snapshot tests, on the CPU at the
tiny f32 config of ``torch_port_helpers`` with its int8 weights.

A slot engine snapshotted between ticks and restored into a fresh engine
(through the ``.npz`` file too) must continue every request token for
token as the uninterrupted engine does, greedy, sampled from a seed, and
with int8 KV; the restore must bring back the host mirrors (``host_len``,
the budget mirror) with the cache. A ``NativeBackend`` restored mid-chat
continues as the original. Mismatched targets are refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rten_tpu.models import decoder as jdec
from rten_tpu_torch.generate import NativeBackend, TemperatureSampler
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.serve import (
    PagedServingEngine,
    Request,
    ServingEngine,
    load_snapshot,
    restore_backend,
    restore_engine,
    save_snapshot,
    snapshot_backend,
    snapshot_engine,
)
from torch_port_helpers import configs, dense_tree, to_jax, to_numpy


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(0)))
    return tcfg, tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")


def _specs():
    rng = np.random.default_rng(9)
    return [dict(prompt=[int(t) for t in rng.integers(1, 500, n)], max_new_tokens=m)
            for n, m in ((3, 14), (11, 9), (6, 16), (2, 12))]


KINDS = {"greedy": {}, "sampled": dict(sampler=TemperatureSampler(0.8), seed=3), "int8_kv": {}}


def _engine(models, kind, **kw):
    cfg, params = models
    if kind == "int8_kv":
        cfg = dataclasses.replace(cfg, int8_kv=True)
    return ServingEngine(params, cfg, max_batch=3, steps_per_tick=2, device="cpu", **KINDS[kind], **kw)


def _outputs(done):
    return {r.request_id: r.output for r in done}


@pytest.mark.parametrize("at", [1, 3, 6])
@pytest.mark.parametrize("kind", list(KINDS))
def test_restore_continues_identically(models, kind, at):
    """Run A straight through; run B snapshotted after ``at`` ticks (four
    requests over three slots: some running, one queued or finished) and
    restored into a fresh engine C: every request's stream from C (and
    those B finished before the snapshot) equals A's, and C starts from B's
    host mirrors and generator state."""
    eng_a = _engine(models, kind)
    for s in _specs():
        eng_a.submit(Request(**s))
    want = _outputs(eng_a.run())

    eng_b = _engine(models, kind)
    for s in _specs():
        eng_b.submit(Request(**s))
    done_b = []
    for _ in range(at):
        done_b.extend(eng_b.step())
    assert eng_b.n_active > 0
    snap = snapshot_engine(eng_b)
    if kind == "int8_kv":
        assert any(k.startswith("k_scale") for k in snap["arrays"])

    eng_c = _engine(models, kind)
    restore_engine(eng_c, snap)
    np.testing.assert_array_equal(eng_c.cache["host_len"], eng_b.cache["host_len"])
    np.testing.assert_array_equal(eng_c._mirror_budget, eng_b._mirror_budget)
    assert eng_c.cache["host_len"].max() > 0 and eng_c._mirror_budget.max() > 0
    assert eng_c.steps == eng_b.steps and [r is None for r in eng_c.slots] == [r is None for r in eng_b.slots]
    assert torch.equal(eng_c._rng.get_state(), eng_b._rng.get_state())
    done_c = eng_c.run()
    got = {**_outputs(done_b), **_outputs(done_c)}
    assert got == want
    assert all(s is None for s in eng_c.slots) and not eng_c.queue


def test_snapshot_save_load_roundtrip(models, tmp_path):
    """A bf16 int8-KV engine's snapshot through ``save_snapshot`` /
    ``load_snapshot`` (bf16 leaves kept as their bits): the same arrays and
    metadata, and a restore from the file continues as the uninterrupted
    engine."""
    cfg, _ = models
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16, int8_kv=True)
    params = tdec.params_from_jax(to_numpy(jdec.quantize_params_int8(to_jax(dense_tree(0)))), cfg, device="cpu")

    def engine():
        return ServingEngine(params, cfg, max_batch=2, device="cpu")

    specs = _specs()[:3]
    eng_a = engine()
    for s in specs:
        eng_a.submit(Request(**s))
    want = _outputs(eng_a.run())
    eng_b = engine()
    for s in specs:
        eng_b.submit(Request(**s))
    done_b = eng_b.step() + eng_b.step()
    snap = snapshot_engine(eng_b)
    path = str(tmp_path / "session.npz")
    save_snapshot(snap, path)
    loaded = load_snapshot(path)
    assert loaded["meta"] == snap["meta"] and set(loaded["arrays"]) == set(snap["arrays"])
    for key, arr in snap["arrays"].items():
        np.testing.assert_array_equal(loaded["arrays"][key], arr, err_msg=key)
    eng_c = engine()
    restore_engine(eng_c, loaded)
    assert eng_c.cache["k"][0].dtype == torch.int8 and eng_c.cache["k_scale"][0].dtype == torch.float32
    assert {**_outputs(done_b), **_outputs(eng_c.run())} == want


def test_backend_snapshot_multi_turn_chat(models):
    """A NativeBackend snapshotted after a chat's first turn: the second
    turn (a follow-up chunk of the last token and new prompt tokens as one
    forward, then greedy steps) from a backend restored from the snapshot
    equals the second turn from the original, ``length`` included."""
    cfg, params = models

    def turn(backend, last, follow_up):
        tok = backend.decode(np.array([[last, *follow_up]], np.int32), greedy=True)
        out = [int(tok[0])]
        for _ in range(4):
            out.append(int(backend.decode(np.array([[out[-1]]], np.int32), greedy=True)[0]))
        return out

    first = NativeBackend(params, cfg, max_len=64, device="cpu")
    toks = [int(first.prefill(np.array([[5, 9, 2, 7]], np.int32), greedy=True)[0])]
    for _ in range(3):
        toks.append(int(first.decode(np.array([[toks[-1]]], np.int32), greedy=True)[0]))
    snap = snapshot_backend(first)
    assert snap["meta"]["length"] == first.length == 7
    want = turn(first, toks[-1], [11, 12, 13])

    second = NativeBackend(params, cfg, max_len=64, device="cpu")
    restore_backend(second, snap)
    assert second.length == 7 and second.cache["host_len"].tolist() == [7]
    assert turn(second, toks[-1], [11, 12, 13]) == want and second.length == first.length


def test_restore_refuses_mismatched_targets(models):
    """A snapshot restores only into its own shape: another ``max_batch``,
    an int8 snapshot into a bf16/f32 cache, a backend of another
    ``max_len`` all raise ValueError; the paged engine has no snapshot."""
    cfg, params = models
    eng = _engine(models, "greedy")
    eng.submit(Request(prompt=[1, 2], max_new_tokens=4))
    eng.step()
    snap = snapshot_engine(eng)
    with pytest.raises(ValueError, match="slots"):
        restore_engine(ServingEngine(params, cfg, max_batch=4, device="cpu"), snap)
    with pytest.raises(ValueError, match="cache keys"):
        restore_engine(_engine(models, "int8_kv"), snap)
    with pytest.raises(ValueError, match="does not fit"):
        restore_engine(ServingEngine(params, cfg, max_batch=3, max_len=128, device="cpu"), snap)
    backend = NativeBackend(params, cfg, max_len=64, device="cpu")
    backend.prefill(np.array([[1, 2, 3]], np.int32))
    with pytest.raises(ValueError, match="does not fit"):
        restore_backend(NativeBackend(params, cfg, max_len=32, device="cpu"), snapshot_backend(backend))
    with pytest.raises(TypeError):
        snapshot_engine(PagedServingEngine(params, cfg, max_batch=2, page_size=64, device="cpu"))
