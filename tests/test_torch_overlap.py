"""The port's overlapped collective matmuls (``parallel/overlap.py``) and
ring attention (``kernels/ring_attention.py``) against the JAX package's on
the same seeded numpy inputs: the JAX functions under ``shard_map`` on the
virtual CPU mesh (``tests/test_overlap.py``'s cases), the port's in four
gloo ranks on the CPU (one world for the module, 60 s collective timeout,
a wall limit a run), every rank's result checked.

Tolerance: relative RMS 1e-5 (f32; the same products as the unfused pair,
summed in ring order), and each against the unfused numpy product.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from rten_tpu.parallel import overlap as joverlap
from rten_tpu_torch.parallel.launch import World

P_RANKS = 4


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def world():
    with World(P_RANKS, device="cpu", timeout_s=60) as w:
        yield w


SPECS = {  # name: (M, K, N, in_specs, out_spec)
    "allgather_matmul": (32, 16, 24, (P("model", None), P(None, None)), P(None, None)),
    "matmul_reducescatter": (8, 32, 16, (P(None, "model"), P("model", None)), P(None, "model")),
    "matmul_allreduce": (8, 32, 16, (P(None, "model"), P("model", None)), P(None, None)),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_overlap_matches_jax(world, name):
    m, k, n, in_specs, out_spec = SPECS[name]
    rng = np.random.default_rng(hash(name) % 1000)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:P_RANKS]), axis_names=("model",))
    fn = jax.shard_map(functools.partial(getattr(joverlap, name), axis="model"), mesh=mesh, in_specs=in_specs,
                       out_specs=out_spec, check_vma=False)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))
    res = world.run(ranks.overlap_run, P_RANKS, name, x, w)
    for i, r in enumerate(res):
        got = r["out"]
        if name == "matmul_reducescatter":  # each rank holds its column chunk
            chunk = n // P_RANKS
            got, ref, full = got, want[:, i * chunk:(i + 1) * chunk], (x @ w)[:, i * chunk:(i + 1) * chunk]
        else:
            ref, full = want, x @ w
        assert rel_rms(got, ref) <= 1e-5 and rel_rms(got, full) <= 1e-5
        assert r["routes"].get("ppermute:gloo") == P_RANKS - 1, r["routes"]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax(world, causal):
    from rten_tpu.kernels.attention import attention_reference
    from rten_tpu.kernels.ring_attention import ring_attention_sharded

    rng = np.random.default_rng(3)
    b, h, t, d = 2, 2, 32, 16
    q = (rng.standard_normal((b, h, t, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, h, t, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, h, t, d)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:P_RANKS]), axis_names=("model",))
    want = np.asarray(ring_attention_sharded(mesh, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    full = np.asarray(attention_reference(q, k, v, causal=causal))
    for got in world.run(ranks.ring_run, P_RANKS, q, k, v, causal):
        assert rel_rms(got, want) <= 1e-5 and rel_rms(got, full) <= 1e-5


def test_ring_attention_mask_value_is_jax_s():
    from rten_tpu.kernels import ring_attention as jring
    from rten_tpu_torch.kernels import ring_attention as tring

    assert tring.DEFAULT_MASK_VALUE == jring.DEFAULT_MASK_VALUE
