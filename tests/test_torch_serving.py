"""The port's serving engines (plain kernel versions, on the CPU) against the
JAX package's engines on the same carried-across int8 parameters and the
same requests: every request's greedy stream must be identical.

The cases are those of ``tests/test_serving.py`` (concurrent requests,
more requests than slots, EOS, streaming, slot reuse, multi-step ticks and
``run_pipelined``; the paged engine's basic, multi-page prompt, inactive
row, preemption and page-pressure cases; both engines with ``int8_kv``),
at the tiny f32 config of ``torch_port_helpers`` (head dim 64) with pages
of 64 positions. The JAX paged engine runs its Pallas kernels in interpret
mode. The HTTP server runs on 127.0.0.1 over the port's engine on the CPU.
"""

import dataclasses
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels.decode_attention import pack_kv_scales
from rten_tpu.models import decoder as jdec
from rten_tpu.serve import Request as JRequest
from rten_tpu.serve import ServingEngine as JServingEngine
from rten_tpu.serve.paged import PagedServingEngine as JPagedServingEngine
from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine, ServingServer
from torch_port_helpers import (
    carry_cache,
    configs,
    dense_tree,
    jax_pages,
    patch_jax_w8a8,
    port_pages,
    to_jax,
    to_numpy,
    unfold,
)

PAGE = 64


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(0)))
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 500, n)]


def _serve(engine, request_cls, specs, mode="run"):
    """Submit ``specs`` (dicts of Request fields) and drive the engine;
    returns the requests in submission order."""
    if mode == "sequential":  # one request at a time, reusing the slot
        reqs = []
        for spec in specs:
            reqs.append(engine.submit(request_cls(**spec)))
            engine.run()
        return reqs
    reqs = [engine.submit(request_cls(**spec)) for spec in specs]
    getattr(engine, "run_pipelined" if mode == "pipelined" else "run")()
    return reqs


# name: (engine kwargs, request specs, drive mode). EOS ids are chosen from
# the JAX engine's own stream in the test (``"eos": k`` → the k-th token).
SLOT_CASES = {
    "concurrent": (dict(max_batch=4), [dict(prompt=p, max_new_tokens=5) for p in
                                       ([1, 2, 3], [7, 8], _prompt(1, 12), [5])], "run"),
    "more_requests_than_slots": (dict(max_batch=2), [dict(prompt=[i + 1, i + 2], max_new_tokens=3 + i % 3)
                                                     for i in range(6)], "run"),
    "eos": (dict(max_batch=2), [dict(prompt=[1, 2, 3], max_new_tokens=8, eos=2),
                                dict(prompt=_prompt(2, 9), max_new_tokens=6)], "run"),
    "slot_reuse": (dict(max_batch=1), [dict(prompt=[9, 9, 9, 9, 9], max_new_tokens=4),
                                       dict(prompt=[1, 2], max_new_tokens=4)], "sequential"),
    "tick4_eos_mid_tick": (dict(max_batch=2, steps_per_tick=4),
                           [dict(prompt=[1, 2, 3], max_new_tokens=8, eos=1),
                            dict(prompt=[9, 8], max_new_tokens=6), dict(prompt=_prompt(3, 14), max_new_tokens=7)],
                           "run"),
    "pipelined": (dict(max_batch=2, steps_per_tick=3),
                  [dict(prompt=p, max_new_tokens=4 + i, eos=(1 if i == 0 else None))
                   for i, p in enumerate(([1, 2, 3], [9, 8], [11, 12, 13, 14], [5], _prompt(4, 10)))],
                  "pipelined"),
}


def _resolve_eos(specs, jcfg, jparams):
    """Turn ``eos=k`` into the k-th token of the request's solo JAX stream."""
    out = []
    for spec in specs:
        spec = dict(spec)
        k = spec.pop("eos", None)
        if k is not None:
            ref = JServingEngine(jparams, jcfg, max_batch=1, seed=0)
            (solo,) = _serve(ref, JRequest, [dict(spec)])
            spec["eos_tokens"] = (solo.output[k],)
        out.append(spec)
    return out


@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_slot_engine_matches_jax(models, case, int8_kv):
    jcfg, tcfg, jparams, tparams = models
    if int8_kv:
        jcfg, tcfg = dataclasses.replace(jcfg, int8_kv=True), dataclasses.replace(tcfg, int8_kv=True)
    kw, specs, mode = SLOT_CASES[case]
    specs = _resolve_eos(specs, jcfg, jparams)
    jreqs = _serve(JServingEngine(jparams, jcfg, seed=0, **kw), JRequest, specs, mode)
    seen = []
    tspecs = [dict(s, on_token=seen.append) if i == 0 else s for i, s in enumerate(specs)]
    engine = ServingEngine(tparams, tcfg, device="cpu", **kw)
    dispatch.reset_counters()
    treqs = _serve(engine, Request, tspecs, mode)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.finished for r in treqs) and all(s is None for s in engine.slots)
    assert seen == treqs[0].output  # streaming, in order
    for spec, r in zip(specs, treqs):
        eos = spec.get("eos_tokens", ())
        assert len(r.output) == spec["max_new_tokens"] or (eos and r.output[-1] == eos[0])
    assert dispatch.PLAIN["decode_attention_int8" if int8_kv else "decode_attention"] > 0
    assert not dispatch.LAUNCHES


def test_slot_engine_matches_solo_generator(models):
    """Batching is invisible: each request's stream equals the port's own
    solo Generator(NativeBackend) stream."""
    _, tcfg, _, tparams = models
    prompts = [[1, 2, 3], [7, 8], _prompt(5, 13), [5]]
    engine = ServingEngine(tparams, tcfg, max_batch=4, steps_per_tick=2, device="cpu")
    reqs = _serve(engine, Request, [dict(prompt=p, max_new_tokens=6) for p in prompts])
    for p, r in zip(prompts, reqs):
        gen = Generator(NativeBackend(tparams, tcfg, max_len=64, device="cpu"), GeneratorConfig(max_tokens=6))
        assert r.output == [int(t[0]) for t in gen.with_prompt(p)], p


PAGED_CASES = {
    # name: (engine kwargs, request specs); pages of 64 positions.
    "basic": (dict(max_batch=3, n_pages=12), [dict(prompt=p, max_new_tokens=6)
                                              for p in ([1, 2, 3, 4, 5], [9, 8, 7], _prompt(6, 11))]),
    "multi_page_prompt": (dict(max_batch=1, n_pages=4), [dict(prompt=_prompt(7, 150), max_new_tokens=6)]),
    "inactive_row": (dict(max_batch=2, n_pages=6), [dict(prompt=[1, 2, 3, 4], max_new_tokens=10),
                                                    dict(prompt=[9, 8], max_new_tokens=2)]),
    # 5 pages for two rows that each grow to 3 (60 prompt + 70 new tokens):
    # one is preempted, re-prefilled and finished after the other.
    "preemption": (dict(max_batch=2, n_pages=5), [dict(prompt=_prompt(8 + i, 60), max_new_tokens=70)
                                                  for i in range(2)]),
    "page_pressure": (dict(max_batch=2, n_pages=2), [dict(prompt=[i + 1, i + 2], max_new_tokens=4)
                                                     for i in range(5)]),
}


@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_engine_matches_jax(models, case, int8_kv):
    jcfg, tcfg, jparams, tparams = models
    kw, specs = PAGED_CASES[case]
    jeng = JPagedServingEngine(jparams, jcfg, page_size=PAGE, seed=0, int8_kv=int8_kv, **kw)
    jreqs = _serve(jeng, JRequest, specs)
    engine = PagedServingEngine(tparams, tcfg, page_size=PAGE, int8_kv=int8_kv, device="cpu", **kw)
    dispatch.reset_counters()
    treqs = _serve(engine, Request, specs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.finished and len(r.output) == s["max_new_tokens"] for r, s in zip(treqs, specs))
    assert engine.pool.n_free == engine.pool.n_pages == jeng.pool.n_free
    assert (engine.preemptions > 0) == (case == "preemption")
    assert dispatch.PLAIN["paged_decode_attention_int8" if int8_kv else "paged_decode_attention"] > 0


# Pages of 16 positions: PAGED_CASES' "basic" and "multi_page_prompt" with
# four times as many pages, and a preempting pool of 3 pages for two rows
# that each grow to 32 positions (2 pages).
SMALL_PAGE_CASES = {
    "basic": (dict(PAGED_CASES["basic"][0], n_pages=48), PAGED_CASES["basic"][1]),
    "multi_page_prompt": (dict(PAGED_CASES["multi_page_prompt"][0], n_pages=16), PAGED_CASES["multi_page_prompt"][1]),
    "preemption": (dict(max_batch=2, n_pages=3), [dict(prompt=_prompt(8 + i, 12), max_new_tokens=20) for i in range(2)]),
}


@pytest.mark.parametrize("case", list(SMALL_PAGE_CASES))
def test_paged_engine_pages_of_16_matches_jax(models, case):
    """Pages of 16 positions (the JAX rule's smallest at head dim 64: 16 ·
    64 = 1024; a 64-position chunk spans four): the streams and the pool's
    free pages of the JAX engine, and a preemption in the preempting case."""
    jcfg, tcfg, jparams, tparams = models
    kw, specs = SMALL_PAGE_CASES[case]
    jeng = JPagedServingEngine(jparams, jcfg, page_size=16, seed=0, **kw)
    jreqs = _serve(jeng, JRequest, specs)
    engine = PagedServingEngine(tparams, tcfg, page_size=16, device="cpu", **kw)
    dispatch.reset_counters()
    treqs = _serve(engine, Request, specs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert engine.pool.n_free == engine.pool.n_pages == jeng.pool.n_free
    assert (engine.preemptions > 0) == (case == "preemption")
    assert dispatch.PLAIN["paged_decode_attention"] > 0


@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
def test_paged_engine_matches_slot_engine(models, int8_kv):
    """Paged against slot (int8 paged against int8 slot), the port alone."""
    _, tcfg, _, tparams = models
    cfg = dataclasses.replace(tcfg, int8_kv=int8_kv)
    specs = [dict(prompt=_prompt(20 + i, n), max_new_tokens=m) for i, (n, m) in enumerate([(3, 9), (70, 5), (12, 12)])]
    slot = _serve(ServingEngine(tparams, cfg, max_batch=3, device="cpu"), Request, specs)
    paged = _serve(PagedServingEngine(tparams, tcfg, max_batch=3, n_pages=8, page_size=PAGE, int8_kv=int8_kv,
                                      device="cpu"), Request, specs)
    assert [r.output for r in paged] == [r.output for r in slot]


def test_engines_refuse_unported_options(models):
    """The JAX engines' refusals (an unknown ``tp_mode``, ``"shard_map"``
    without a mesh, a paged mesh with a data axis over 1) and the port's
    (page size, ``max_batch``); a mesh itself is taken since the
    tensor-parallel path was ported (``tests/test_torch_parallel.py``)."""
    import types

    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="unknown tp_mode"):
        ServingEngine(tparams, tcfg, tp_mode="gspmd", device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        ServingEngine(tparams, tcfg, tp_mode="shard_map", device="cpu")
    with pytest.raises(ValueError, match="model axis only"):
        PagedServingEngine(tparams, tcfg, page_size=PAGE, mesh=types.SimpleNamespace(shape={"data": 2, "model": 1}),
                           device="cpu")
    with pytest.raises(ValueError, match="page_size"):  # 24 · 64 is no multiple of 1024 (the JAX rule)
        PagedServingEngine(tparams, tcfg, page_size=24, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        PagedServingEngine(tparams, tcfg, max_batch=0, page_size=PAGE, device="cpu")


# 14 requests over 12 rows: every decode forward runs at 12 rows, the
# prefill structure with the cache's KV kernel (JAX decoder.py:740-812).
ROWS_12 = [dict(prompt=_prompt(70 + i, 2 + (5 * i) % 19), max_new_tokens=3 + i % 6) for i in range(14)]


@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_engines_at_12_rows_match_jax(models, engine, int8_kv):
    """The slot and paged engines at ``max_batch=12`` against the JAX
    engines on the same params and requests: equal streams, each decode
    forward's attention through the KV kernel (one a layer), never the
    eager int8 branch."""
    jcfg, tcfg, jparams, tparams = models
    if engine == "slot":
        jc, tc = (dataclasses.replace(c, int8_kv=int8_kv) for c in (jcfg, tcfg))
        jeng = JServingEngine(jparams, jc, max_batch=12, seed=0)
        teng = ServingEngine(tparams, tc, max_batch=12, device="cpu")
        kernel = "decode_attention_int8" if int8_kv else "decode_attention:no_wo"
    else:
        jeng = JPagedServingEngine(jparams, jcfg, max_batch=12, n_pages=20, page_size=PAGE, seed=0, int8_kv=int8_kv)
        teng = PagedServingEngine(tparams, tcfg, max_batch=12, n_pages=20, page_size=PAGE, int8_kv=int8_kv,
                                  device="cpu")
        kernel = "paged_decode_attention_int8" if int8_kv else "paged_decode_attention"
    jreqs = _serve(jeng, JRequest, ROWS_12)
    dispatch.reset_counters()
    treqs = _serve(teng, Request, ROWS_12)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.finished and len(r.output) == s["max_new_tokens"] for r, s in zip(treqs, ROWS_12))
    assert dispatch.PLAIN[kernel] == tcfg.n_layers * teng.steps  # every decode forward, every layer


@pytest.mark.parametrize("kind", ["int8", "paged"])
def test_forward_at_12_rows_matches_jax(models, kind):
    """One decode forward at 12 rows of unequal lengths (0 to 70 tokens):
    on an int8 cache (``decode_attention_int8``) and over a paged pool of
    64-position pages (``paged_decode_attention``), against ``jdec.forward``
    on the same cache: logits, lengths and the appended k/v."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(80)
    hd, h, n = tcfg.head_dim, tcfg.n_heads, tcfg.n_layers
    lens = np.array([5, 70, 0, 12, 63, 64, 1, 33, 2, 40, 7, 20], np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, (12, 1)).astype(np.int32)
    if kind == "int8":
        jcfg = dataclasses.replace(jcfg, int8_kv=True)
        shape = (12, h, 128, hd)
        codes = [[rng.integers(-127, 128, shape).astype(np.int8) for _ in range(n)] for _ in range(2)]
        scales = [[rng.uniform(0.005, 0.02, shape[:3]).astype(np.float32) for _ in range(n)] for _ in range(2)]
        jcache = {"k": [jnp.asarray(c) for c in codes[0]], "v": [jnp.asarray(c) for c in codes[1]],
                  "k_scale": [jnp.asarray(pack_kv_scales(jnp.asarray(s[..., None]), hd)) for s in scales[0]],
                  "v_scale": [jnp.asarray(pack_kv_scales(jnp.asarray(s[..., None]), hd)) for s in scales[1]],
                  "len": jnp.asarray(lens)}
        tcache = carry_cache(jcache, hd)
        expect = "decode_attention_int8"
    else:
        n_pages = 2 * 12 + 1  # two pages a row, the last one the scratch page
        shape = (n_pages, h, PAGE, hd)
        pool = {key: [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
                for key in ("k_pages", "v_pages")}
        table = rng.permutation(2 * 12).astype(np.int32).reshape(12, 2)
        jcache = {key: [jnp.asarray(jax_pages(p)) for p in leaves] for key, leaves in pool.items()}
        jcache.update(page_table=jnp.asarray(table), len=jnp.asarray(lens))
        tcache = {key: [torch.from_numpy(p.copy()) for p in leaves] for key, leaves in pool.items()}
        tcache.update(page_table=torch.from_numpy(table), len=torch.from_numpy(lens.copy()))
        expect = "paged_decode_attention"
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(tokens), jcache)
    dispatch.reset_counters()
    tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(tokens), tcache)
    assert dispatch.PLAIN[expect] == n and "flash_attention" not in dispatch.PLAIN
    assert dispatch.PLAIN["quant_matmul_int8"] == 4 * n + 1 and "quant_gemv_int8" not in dispatch.PLAIN
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tcache["len"].numpy(), lens + 1)
    for li in range(n):
        if kind == "int8":
            want = carry_cache(jcache, hd)
            for key in ("k", "v", "k_scale", "v_scale"):
                for r, m in enumerate(lens + 1):
                    got, ref = tcache[key][li][r, :, :m].numpy(), want[key][li][r, :, :m].numpy()
                    if key in ("k", "v"):
                        np.testing.assert_array_equal(got, ref, err_msg=f"{key} {li} row {r}")
                    else:
                        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=f"{key} {li} row {r}")
        else:
            for key in ("k_pages", "v_pages"):
                np.testing.assert_allclose(tcache[key][li].numpy(), port_pages(jcache[key][li], hd), atol=1e-5,
                                           rtol=0)


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_server_matches_engine(models):
    """Three concurrent POST /generate on 127.0.0.1 batch into one engine;
    each reply equals the engine's own output for that request, with the
    JAX server's keys; /healthz and /stats answer."""
    _, tcfg, _, tparams = models
    specs = [dict(prompt=[1, 2, 3], max_new_tokens=5), dict(prompt=_prompt(9, 10), max_new_tokens=7),
             dict(prompt=[4], max_new_tokens=3, eos_tokens=(0,))]
    direct = _serve(ServingEngine(tparams, tcfg, max_batch=4, steps_per_tick=2, device="cpu"), Request, specs)
    server = ServingServer(ServingEngine(tparams, tcfg, max_batch=4, steps_per_tick=2, device="cpu"))
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        health = _http(f"{url}/healthz")
        assert health["status"] == "ok" and {"active", "queued", "steps"} <= set(health)
        replies = [None] * len(specs)

        def post(i, spec):
            body = {"prompt": spec["prompt"], "max_new_tokens": spec["max_new_tokens"],
                    "eos": list(spec.get("eos_tokens", ()))}
            replies[i] = _http(f"{url}/generate", body)

        threads = [threading.Thread(target=post, args=(i, s)) for i, s in enumerate(specs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        for reply, ref in zip(replies, direct):
            assert set(reply) == {"request_id", "tokens", "finished"}
            assert reply["finished"] and reply["tokens"] == ref.output
        stats = _http(f"{url}/stats")
        assert stats["max_batch"] == 4 and stats["max_len"] == tcfg.max_seq and stats["steps"] > 0
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# W8A8 (cfg.w8a8) serving
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_w8a8(monkeypatch):
    """The JAX package's W8A8 path (``patch_jax_w8a8``), with JAX's trace
    caches cleared on entry and on exit: its engines jit ``prefill`` and
    the decode loop keyed on the config alone, so a weight-only trace made
    earlier in this worker would be reused, and a W8A8 one would leak into
    later tests. Returns the calls of the JAX ``quant_matmul_w8a8`` (made
    while tracing, so a reused trace shows as none)."""
    import jax

    from rten_tpu.kernels import quant_matmul as jqm

    jax.clear_caches()
    patch_jax_w8a8(monkeypatch)
    calls = []
    inner = jqm.quant_matmul_w8a8
    monkeypatch.setattr(jqm, "quant_matmul_w8a8", lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    yield calls
    jax.clear_caches()


@pytest.fixture(scope="module")
def w8_tiled_models():
    """JAX params quantized at tile_bn 128 (the lm_head and layer 0's wqkv
    tiled: the JAX prefill keeps them weight-only) and the port's copy."""
    jcfg, tcfg = configs()
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(0)), tile_bn=128)
    return jcfg, dataclasses.replace(tcfg, w8a8=True), jparams, tdec.params_from_jax(to_numpy(jparams), tcfg,
                                                                                   device="cpu")


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_w8a8_engines_match_jax(jax_w8a8, w8_tiled_models, engine):
    """The W8A8 slot and paged engines against the JAX engines in W8A8, with
    prompts of 3, 2 and 5 tokens beside longer ones: the JAX engines admit at
    a bucket of ≥ 32 rows (the prefill structure, tiled packs weight-only),
    and so must the port's exact-length admission. Besides the streams,
    the slot engine's caches hold the prompts' k/v as the JAX engine's do
    (positions 1 on: a finished row's append may land at 0), which the
    tokens alone would not show."""
    jcfg, tcfg, jparams, tparams = w8_tiled_models
    specs = [dict(prompt=p, max_new_tokens=5) for p in ([1, 2, 3], [7, 8], _prompt(30, 12), [4, 5, 6, 7, 9])]
    if engine == "slot":
        jeng = JServingEngine(jparams, jcfg, max_batch=4, seed=0)
        teng = ServingEngine(tparams, tcfg, max_batch=4, steps_per_tick=2, device="cpu")
    else:
        jeng = JPagedServingEngine(jparams, jcfg, max_batch=4, n_pages=8, page_size=PAGE, seed=0)
        teng = PagedServingEngine(tparams, tcfg, max_batch=4, n_pages=8, page_size=PAGE, device="cpu")
    jreqs = _serve(jeng, JRequest, specs)
    assert jax_w8a8, "the JAX engine reused a trace: its W8A8 matmul was never traced"
    dispatch.reset_counters()
    treqs = _serve(teng, Request, specs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert dispatch.PLAIN["quant_matmul_w8a8"] > 0 and dispatch.PLAIN["quant_gemv_int8:w8a8"] > 0
    assert dispatch.PLAIN["quant_mlp_int8:w8a8"] > 0
    if engine == "slot":
        for li in range(tcfg.n_layers):
            for kv in ("k", "v"):
                want = unfold(jeng.cache[kv][li], tcfg.head_dim)
                for slot, spec in enumerate(specs):
                    n = len(spec["prompt"])
                    np.testing.assert_allclose(teng.cache[kv][li][slot, :, 1:n].numpy(), want[slot, :, 1:n],
                                               atol=1e-4, rtol=0, err_msg=f"{kv} layer {li} slot {slot}")


def test_w8a8_slot_engine_matches_solo_generator(w8_tiled_models):
    """Batching is invisible in W8A8 too: per-row codes and exact int32 sums
    make a row's result independent of the batch, so each stream equals
    its solo Generator(NativeBackend) stream (prompts over 8 tokens, which
    both prefill in the prefill structure)."""
    _, tcfg, _, tparams = w8_tiled_models
    prompts = [_prompt(31 + i, n) for i, n in enumerate((9, 13, 20, 11))]
    engine = ServingEngine(tparams, tcfg, max_batch=4, steps_per_tick=2, device="cpu")
    reqs = _serve(engine, Request, [dict(prompt=p, max_new_tokens=6) for p in prompts])
    for p, r in zip(prompts, reqs):
        gen = Generator(NativeBackend(tparams, tcfg, max_len=64, device="cpu"), GeneratorConfig(max_tokens=6))
        assert r.output == [int(t[0]) for t in gen.with_prompt(p)], p
