"""The port's samplers, sampled ``generate_scan`` and sampled serving (on
the CPU) against the JAX package.

- Each sampler: on the same f32 logits, the JAX sampler's
  ``sample(key, logits)`` equals the port's ``choose(logits, noise)`` with
  ``noise = jax.random.gumbel(key, shape, f32)`` (the draw
  ``jax.random.categorical`` makes), for 20 keys; the port's own ``sample``
  is in range and deterministic for one seeded ``torch.Generator``.
- ``generate_scan``: greedy, its tokens equal JAX ``generate_scan``'s over
  32 steps; sampled, the port is fed, step by step, the Gumbel noise of
  JAX's per-step subkeys (``rng, sub = split(rng)``, as JAX's scan body
  splits), and its tokens equal JAX's. The one allowance: a first
  difference at a step whose perturbed top-2 score gap (the port's) is
  under 1e-4, where the two packages' logits (~1e-5 apart) may order the
  two candidates either way.
- The slot and paged engines with a sampler: one seed gives the same
  streams, and a temperature of 1e-4 gives the greedy streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate import sampler as jsampler
from rten_tpu.models import decoder as jdec
from rten_tpu_torch.generate import sampler as tsampler
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine
from torch_port_helpers import configs, dense_tree, to_jax, to_numpy

V = 500
SAMPLERS = {  # name: (class name, arguments), the same in both packages
    "temperature_1e-4": ("TemperatureSampler", (1e-4,)),
    "temperature_0.7": ("TemperatureSampler", (0.7,)),
    "temperature_1.0": ("TemperatureSampler", (1.0,)),
    "topk_1": ("TopKSampler", (1, 0.7)),
    "topk_5": ("TopKSampler", (5, 0.7)),
    "topk_V": ("TopKSampler", (V, 1.0)),
    "topp_0.1": ("TopPSampler", (0.1, 0.7)),
    "topp_0.9": ("TopPSampler", (0.9, 0.7)),
    "topp_1.0": ("TopPSampler", (1.0, 1.0)),
}


def _pair(name):
    cls, args = SAMPLERS[name]
    return getattr(jsampler, cls)(*args), getattr(tsampler, cls)(*args)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("name", SAMPLERS)
def test_choose_matches_jax_sample(name, b):
    jsm, tsm = _pair(name)
    for seed in range(20):
        logits = (np.random.default_rng(seed).standard_normal((b, V)) * 3).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsm.sample(key, jnp.asarray(logits)))
        t_logits = torch.from_numpy(logits)
        noise = np.asarray(jax.random.gumbel(key, tsm.noise_shape(t_logits), jnp.float32))
        got = tsm.choose(t_logits, torch.from_numpy(noise.copy()))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"seed {seed}")


@pytest.mark.parametrize("name", SAMPLERS)
def test_sample_in_range_and_deterministic(name):
    _, tsm = _pair(name)
    logits = torch.from_numpy((np.random.default_rng(5).standard_normal((3, V)) * 3).astype(np.float32))
    draws = [tsm.sample(torch.Generator().manual_seed(11), logits) for _ in range(2)]
    assert draws[0].shape == (3,) and draws[0].dtype == torch.int32
    assert torch.equal(draws[0], draws[1])
    assert bool(((draws[0] >= 0) & (draws[0] < V)).all())
    if name.startswith("topk"):  # a top-k draw is one of the k largest logits
        k = SAMPLERS[name][1][0]
        top = torch.topk(logits, k, dim=-1).indices
        assert bool((top == draws[0][:, None].long()).any(-1).all())
    with pytest.raises(ValueError, match="rng"):
        tsm.sample(None, logits)


def test_samplers_hash_on_configuration():
    assert tsampler.TopPSampler(0.9, 0.7) == tsampler.TopPSampler(0.9, 0.7)
    assert hash(tsampler.TopKSampler(5, 0.7)) == hash(tsampler.TopKSampler(5, 0.7))
    assert tsampler.TopKSampler(5, 0.7) != tsampler.TopKSampler(6, 0.7)
    assert tsampler.TemperatureSampler(0.7) != tsampler.TopPSampler(0.7)
    assert tsampler.ArgMaxSampler() == tsampler.ArgMaxSampler()
    assert len({tsampler.TemperatureSampler(0.8), tsampler.TemperatureSampler(0.8)}) == 1


def test_a_temperature_draw_follows_the_softmax():
    """2048 draws from one row through ``sample``: the histogram is within
    total variation 0.08 of softmax(logits / T) (the noise floor at 13
    categories is about 0.03)."""
    logits = torch.linspace(-2.0, 2.0, 13)[None].repeat(2048, 1)
    got = tsampler.TemperatureSampler(0.7).sample(torch.Generator().manual_seed(3), logits)
    hist = np.bincount(got.numpy(), minlength=13) / 2048
    ref = torch.softmax(logits[0] / 0.7, -1).numpy()
    assert 0.5 * np.abs(hist - ref).sum() < 0.08


# ---------------------------------------------------------------------------
# generate_scan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(0)))
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prefilled(models, prompt):
    """Both packages' caches after ``prompt`` and the JAX first token."""
    jcfg, tcfg, jparams, tparams = models
    jcache = jdec.init_cache(jcfg, prompt.shape[0], 64)
    jlogits, jcache = jdec.prefill(jparams, jcfg, jnp.asarray(prompt), jcache)
    first = np.asarray(jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32))
    tcache = tdec.init_cache(tcfg, prompt.shape[0], 64, device="cpu")
    _, tcache = tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), tcache, last_only=True)
    return jcache, tcache, first


class JaxNoise(tsampler.Sampler):
    """Runs ``inner.choose`` on the Gumbel noise of JAX ``generate_scan``'s
    per-step subkey, and records each step's perturbed top-2 score gap."""

    def __init__(self, inner, key):
        self.inner, self.key, self.gaps = inner, key, []

    def sample(self, rng, logits):
        self.key, sub = jax.random.split(self.key)
        noise = torch.from_numpy(np.asarray(jax.random.gumbel(sub, self.inner.noise_shape(logits), jnp.float32)))
        top2 = torch.topk(self.inner.scores(logits, noise), 2, dim=-1).values
        self.gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        return self.inner.choose(logits, noise)


@pytest.mark.parametrize("name", ["temperature_0.7", "topk_5", "topp_0.9"])
def test_sampled_generate_scan_matches_jax(models, name):
    jcfg, tcfg, jparams, tparams = models
    jsm, tsm = _pair(name)
    prompt = np.random.default_rng(6).integers(0, V, (2, 5)).astype(np.int32)
    jcache, tcache, first = _prefilled(models, prompt)
    key, n = jax.random.PRNGKey(17), 32
    want, _ = jdec.generate_scan(jparams, jcfg, jcache, jnp.asarray(first), key, n_steps=n, sampler=jsm)
    want = np.asarray(want)
    feed = JaxNoise(tsm, key)
    dispatch.reset_counters()
    got, tcache = tdec.generate_scan(tparams, tcfg, tcache, torch.from_numpy(first), torch.Generator(),
                                     n_steps=n, sampler=feed)
    assert got.shape == (2, n) and got.dtype == torch.int32
    assert dispatch.PLAIN["quant_gemv_int8"] and not dispatch.LAUNCHES
    assert tcache["host_len"].tolist() == [5 + n] * 2 and tcache["len"].tolist() == [5 + n] * 2
    diff = np.argwhere(got.numpy() != want)
    if diff.size:  # the allowance: a near-tie of the perturbed scores
        step = diff[:, 1].min()
        rows = diff[diff[:, 1] == step, 0]
        assert all(feed.gaps[step][r] < 1e-4 for r in rows), (step, rows, feed.gaps[step])
    assert len(set(got.numpy().ravel().tolist())) > 2  # the draw is not collapsed onto one token


@pytest.mark.parametrize("b", [1, 3])
def test_greedy_generate_scan_matches_jax(models, b):
    jcfg, tcfg, jparams, tparams = models
    prompt = np.random.default_rng(7 + b).integers(0, V, (b, 5)).astype(np.int32)
    jcache, tcache, first = _prefilled(models, prompt)
    n = 32
    want, _ = jdec.generate_scan(jparams, jcfg, jcache, jnp.asarray(first), jax.random.PRNGKey(0), n_steps=n)
    got, _ = tdec.generate_scan(tparams, tcfg, tcache, torch.from_numpy(first), n_steps=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ArgMaxSampler is the greedy branch (the fused argmax, no logits).
    _, tcache2, _ = _prefilled(models, prompt)
    again, _ = tdec.generate_scan(tparams, tcfg, tcache2, torch.from_numpy(first), None, n_steps=n,
                                  sampler=tsampler.ArgMaxSampler())
    assert torch.equal(again, got)


def test_sampled_generate_scan_same_seed_same_tokens(models):
    _, tcfg, _, tparams = models
    prompt = np.random.default_rng(9).integers(0, V, (2, 5)).astype(np.int32)
    runs = []
    for _ in range(2):
        _, tcache, first = _prefilled(models, prompt)
        toks, _ = tdec.generate_scan(tparams, tcfg, tcache, torch.from_numpy(first), torch.Generator().manual_seed(4),
                                     n_steps=12, sampler=tsampler.TopPSampler(0.9, 0.8))
        runs.append(toks)
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="rng"):
        tdec.generate_scan(tparams, tcfg, tcache, torch.from_numpy(first), n_steps=2,
                           sampler=tsampler.TemperatureSampler(0.8))


# ---------------------------------------------------------------------------
# Serving engines with a sampler
# ---------------------------------------------------------------------------

SPECS = [dict(prompt=[1, 2, 3], max_new_tokens=9), dict(prompt=[7, 8, 9, 10, 11], max_new_tokens=6),
         dict(prompt=[int(t) for t in np.random.default_rng(1).integers(1, V, 12)], max_new_tokens=8)]
ENGINES = {
    "slot": lambda p, c, **kw: ServingEngine(p, c, max_batch=2, device="cpu", **kw),
    "slot_tick3": lambda p, c, **kw: ServingEngine(p, c, max_batch=2, steps_per_tick=3, device="cpu", **kw),
    "paged": lambda p, c, **kw: PagedServingEngine(p, c, max_batch=2, n_pages=6, page_size=64, device="cpu", **kw),
    "paged_int8": lambda p, c, **kw: PagedServingEngine(p, c, max_batch=2, n_pages=6, page_size=64, int8_kv=True,
                                                        device="cpu", **kw),
}


def _streams(engine):
    reqs = [engine.submit(Request(**spec)) for spec in SPECS]
    engine.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("kind", ENGINES)
def test_sampled_engine_same_seed_same_streams(models, kind):
    _, tcfg, _, tparams = models
    make = ENGINES[kind]
    first = _streams(make(tparams, tcfg, sampler=tsampler.TemperatureSampler(0.8), seed=5))
    second = _streams(make(tparams, tcfg, sampler=tsampler.TemperatureSampler(0.8), seed=5))
    assert first == second
    assert [len(s) for s in first] == [spec["max_new_tokens"] for spec in SPECS]
    assert all(0 <= t < V for s in first for t in s)


@pytest.mark.parametrize("kind", ENGINES)
def test_sampled_engine_near_zero_temperature_is_greedy(models, kind):
    _, tcfg, _, tparams = models
    make = ENGINES[kind]
    greedy = _streams(make(tparams, tcfg))
    cold = _streams(make(tparams, tcfg, sampler=tsampler.TemperatureSampler(1e-4), seed=2))
    assert cold == greedy


def test_sampled_engines_refuse_unported_options(models):
    """With a sampler, the engines' remaining refusals: the JAX engines'
    (an unknown ``tp_mode``, ``"shard_map"`` without a mesh, a paged mesh
    with a data axis over 1) and ``max_batch``; a mesh itself is taken
    since the tensor-parallel path was ported (``tests/test_torch_parallel.py``)."""
    import types

    _, tcfg, _, tparams = models
    temp = tsampler.TemperatureSampler(0.8)
    with pytest.raises(ValueError, match="requires a mesh"):
        ServingEngine(tparams, tcfg, tp_mode="shard_map", sampler=temp, device="cpu")
    with pytest.raises(ValueError, match="unknown tp_mode"):
        ServingEngine(tparams, tcfg, tp_mode="gspmd", sampler=temp, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        PagedServingEngine(tparams, tcfg, max_batch=0, page_size=64, sampler=temp, device="cpu")
    with pytest.raises(ValueError, match="model axis only"):
        PagedServingEngine(tparams, tcfg, mesh=types.SimpleNamespace(shape={"data": 2, "model": 1}), page_size=64,
                           sampler=temp, device="cpu")
