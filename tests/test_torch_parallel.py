"""The port's ``parallel/`` against the JAX package's on the same seeded
numpy inputs, on the CPU.

The JAX side runs ``tp_prefill`` / ``tp_decode_step`` /
``tp_paged_decode`` / ``sp_prefill`` / ``pp_forward`` and the engines on
the 8-device virtual mesh in this process (``tests/conftest.py``), the
paged kernels interpreted, as ``tests/test_tp.py`` and
``tests/test_serving.py`` run them. The port side runs the same inputs in
four gloo ranks on the CPU (``parallel.launch.World``, one world for the
module; a smaller mesh is made over the first ranks and the others sit it
out), each rank running ``tests/torch_parallel_ranks.py``, which imports no
JAX. Every rank has a 60 s collective timeout and every run a wall limit.

Tolerances: dense f32, relative RMS 1e-5 (the same f32 arithmetic, other
sum orders); int8 packs, rtol / atol 1e-3 as ``tests/test_tp.py:128`` (the
JAX CPU path dequantizes the codes into the activation dtype, the port's
plain ``quant_matmul_int8`` multiplies f32 codes and scales); streams equal.

Also here, without ranks: the mixed int8 / dense trees of the decoder's
per-projection route against ``jdec.forward``, the GPT-2 example's
``--demo --int8``, and the pack slicing rule.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from rten_tpu.models import decoder as jdec
from rten_tpu.parallel import make_mesh as jmake_mesh
from rten_tpu.parallel import shard_cache as jshard_cache
from rten_tpu.parallel import shard_decoder_params as jshard
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.parallel import mesh as pmesh
from rten_tpu_torch.parallel.launch import World
from torch_port_helpers import (
    SLICE_CFG,
    dense_tree,
    jax_pages,
    jax_scale_tiles,
    llama_configs,
    llama_tree,
    port_pages,
    port_scale_pages,
    port_scales,
    to_jax,
    to_numpy,
    unfold,
)

# tests/test_tp.py's configs.
TP_CFG = dict(vocab_size=96, n_layers=2, n_heads=8, n_kv_heads=4, d_model=64, d_ff=128, max_seq=64,
              pos_encoding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False)
GPT2ISH = dict(vocab_size=96, n_layers=2, n_heads=4, d_model=64, d_ff=256, max_seq=64)


def cfgs(**kw):
    return jdec.DecoderConfig(**kw, dtype=jnp.float32), tdec.DecoderConfig(**kw, dtype=torch.float32)


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def close(got, want, int8: bool):
    if int8:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)
    else:
        assert rel_rms(got, want) <= 1e-5


@pytest.fixture(scope="module")
def world():
    with World(4, device="cpu", timeout_s=60) as w:
        yield w


def _jax_tp(jparams, jcfg, prompt, n_steps, shape, overlap=False):
    """The JAX package's explicit TP path (tests/test_tp.py ``_tp_run``) and
    its final cache."""
    from rten_tpu.parallel.tp import tp_decode_step, tp_prefill

    mesh = jmake_mesh(*shape)
    params = jshard(jparams, mesh)
    cache = jshard_cache(jdec.init_cache(jcfg, prompt.shape[0], 64), mesh)
    logits, cache = tp_prefill(params, jcfg, jnp.asarray(prompt), cache, mesh=mesh, use_flash=False, overlap=overlap)
    outs = [logits]
    for _ in range(n_steps):
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        logits, cache = tp_decode_step(params, jcfg, tok, cache, mesh=mesh, use_flash=False, overlap=overlap)
        outs.append(logits)
    return [np.asarray(o) for o in outs], cache


def _check_tp(res, jouts, jcache, jcfg, int8):
    for got, want in zip(res["logits"], jouts):
        close(got, want, int8)
    n = int(np.asarray(jcache["len"]).min())
    for li in range(jcfg.n_layers):
        for key in ("k", "v"):
            got, want = res["cache"][key][li], unfold(jcache[key][li], jcfg.head_dim)
            if jcfg.int8_kv:  # equal codes but where a value sits on a rounding boundary
                assert np.mean(got[:, :, :n] != want[:, :, :n]) < 1e-3
            else:
                close(got[:, :, :n], want[:, :, :n], int8)
        if jcfg.int8_kv:
            close(res["cache"]["k_scale"][li][:, :, :n], port_scales(jcache["k_scale"][li], jcfg.head_dim)[:, :, :n],
                  True)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (1, 4)], ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_tp_dense_matches_jax(world, shape):
    """Dense f32 (tests/test_tp.py's CFG: RoPE, GQA 8/4, SwiGLU) through
    ``tp_prefill`` and three ``tp_decode_step``s on each mesh (the (2, 2)
    mesh: the GPT-2 layout's case below)."""
    jcfg, tcfg = cfgs(**TP_CFG)
    jparams = jdec.init_params(jax.random.PRNGKey(0), jcfg)
    prompt = np.random.default_rng(1234).integers(0, 96, (2, 6)).astype(np.int32)
    jouts, jcache = _jax_tp(jparams, jcfg, prompt, 3, shape)
    res = world.run(ranks.tp_run, shape, tcfg, to_numpy(jparams), prompt, 3)[0]
    _check_tp(res, jouts, jcache, jcfg, int8=False)
    assert not res["plain"].get("quant_matmul_int8")


def test_tp_gpt2_layout_overlap_matches_jax(world):
    """GPT-2's layout (learned positions, LayerNorm, GELU, biases) with the
    overlapped ring on the row-parallel projections, on a (2, 2) mesh."""
    jcfg, tcfg = cfgs(**GPT2ISH)
    jparams = jdec.init_params(jax.random.PRNGKey(1), jcfg)
    prompt = np.random.default_rng(5).integers(0, 96, (2, 5)).astype(np.int32)
    jouts, jcache = _jax_tp(jparams, jcfg, prompt, 3, (2, 2), overlap=True)
    res = world.run(ranks.tp_run, (2, 2), tcfg, to_numpy(jparams), prompt, 3, "bf16", True)[0]
    _check_tp(res, jouts, jcache, jcfg, int8=False)
    assert res["routes"].get("ppermute:gloo") and res["routes"].get("all_gather:gloo")


@pytest.mark.parametrize("case", ["gpt2_int8_1x4", "llama_mixed_int8kv_2x2"])
def test_tp_int8_matches_jax(world, case):
    """int8 packs of ``quantize_params_int8(fuse=False)``: SLICE_CFG (every
    projection a pack) on (1, 4) with a bf16/f32 cache; the Llama slice
    (its 256 x 128 ``wk`` / ``wv`` stay dense: a mixed tree) on (2, 2) with
    an int8 KV cache."""
    if case.startswith("gpt2"):
        jcfg, tcfg = cfgs(**SLICE_CFG)
        tree, shape, kv = dense_tree(3), (1, 4), "bf16"
    else:
        jcfg, tcfg = llama_configs()
        tree, shape, kv = llama_tree(4), (2, 2), "int8"
        jcfg = dataclasses.replace(jcfg, int8_kv=True)
    jparams = jdec.quantize_params_int8(to_jax(tree), fuse=False)
    assert ("wk" in jparams["layers"][0]) and isinstance(jparams["layers"][0]["w_up"], dict)
    if case.startswith("llama"):
        assert not isinstance(jparams["layers"][0]["wk"], dict)  # dense beside the packs
    prompt = np.random.default_rng(6).integers(0, 500, (2, 7)).astype(np.int32)
    jouts, jcache = _jax_tp(jparams, jcfg, prompt, 3, shape)
    res = world.run(ranks.tp_run, shape, tcfg, to_numpy(jparams), prompt, 3, kv)[0]
    _check_tp(res, jouts, jcache, jcfg, int8=True)
    plain = res["plain"]
    assert plain.get("quant_matmul_int8", 0) + plain.get("quant_gemv_int8", 0)  # the GEMV at ≤ 8 local rows
    assert any(k.startswith("decode_attention_int8" if kv == "int8" else "decode_attention:no_wo") for k in plain)


@pytest.mark.parametrize("int8", [True], ids=["int8_pages"])
def test_tp_paged_decode_matches_jax(world, int8):
    """``tp_paged_decode`` on a (1, 2) mesh: 2 steps over a seeded int8
    pool of pages of 64 (two rows at lengths 70 and 5), the JAX paged
    kernels interpreted; the logits and the pool. (Pages in the model dtype
    run through the paged engine's case below.)"""
    from rten_tpu.parallel.tp import tp_paged_decode

    jcfg, tcfg = cfgs(**SLICE_CFG)
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(7)), fuse=False)
    rng = np.random.default_rng(8)
    n_pages, page, hk, hd = 7, 64, jcfg.kv_heads, jcfg.head_dim
    pages = {}
    for key in ("k", "v"):
        if int8:
            pages[key] = [rng.integers(-127, 128, (n_pages, hk, page, hd)).astype(np.int8) for _ in range(2)]
            pages[key + "_scale"] = [rng.uniform(0.005, 0.02, (n_pages, hk, page)).astype(np.float32)
                                     for _ in range(2)]
        else:
            pages[key] = [(rng.standard_normal((n_pages, hk, page, hd)) * 0.5).astype(np.float32) for _ in range(2)]
    table = np.array([[4, 0, 2], [5, 6, 6]], np.int32)
    lens = np.array([70, 5], np.int32)
    tokens = np.array([[3], [11]], np.int32)
    mesh = jmake_mesh(1, 2)
    sp = jshard(jparams, mesh)
    state = {"k_pages": [jnp.asarray(jax_pages(p)) for p in pages["k"]],
             "v_pages": [jnp.asarray(jax_pages(p)) for p in pages["v"]]}
    if int8:
        state["k_scale_pages"] = [jnp.asarray(jax_scale_tiles(s, hd)) for s in pages["k_scale"]]
        state["v_scale_pages"] = [jnp.asarray(jax_scale_tiles(s, hd)) for s in pages["v_scale"]]
    jouts, tok, jlens = [], jnp.asarray(tokens), jnp.asarray(lens)
    for _ in range(2):
        logits, state = tp_paged_decode(sp, jcfg, tok, state, jnp.asarray(table), jlens, mesh=mesh,
                                        interpret_kernels=True)
        jouts.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        jlens = jlens + 1
    res = world.run(ranks.tp_paged_run, (1, 2), tcfg, to_numpy(jparams), pages, table, lens, tokens, 2)[0]
    for got, want in zip(res["logits"], jouts):
        close(got, want, True)
    for li in range(2):
        got, want = res["pool"]["k"][li], port_pages(state["k_pages"][li], hd)
        if int8:
            assert np.mean(got != want) < 1e-3
            close(res["pool"]["k_scale"][li], port_scale_pages(state["k_scale_pages"][li], hd, page), True)
        else:
            close(got, want, True)


@pytest.mark.parametrize("case", ["llama_1x4", "gpt2_1x2"])
def test_sp_prefill_matches_jax(world, case):
    """Sequence-parallel prefill through the ring: the logits and every
    layer's k / v (tests/test_tp.py's two cases)."""
    from rten_tpu.parallel.tp import sp_prefill

    if case.startswith("llama"):
        (jcfg, tcfg), key, shape, (b, t) = cfgs(**TP_CFG), 7, (1, 4), (2, 16)
    else:
        (jcfg, tcfg), key, shape, (b, t) = cfgs(**GPT2ISH), 8, (1, 2), (1, 8)
    jparams = jdec.init_params(jax.random.PRNGKey(key), jcfg)
    prompt = np.random.default_rng(key).integers(0, 96, (b, t)).astype(np.int32)
    logits, ks, vs = sp_prefill(jparams, jcfg, jnp.asarray(prompt), mesh=jmake_mesh(*shape))
    res = world.run(ranks.sp_run, shape, tcfg, to_numpy(jparams), prompt)[0]
    close(res["logits"], logits, False)
    for li in range(jcfg.n_layers):
        close(res["k"][li], ks[li], False)
        close(res["v"][li], vs[li], False)


@pytest.mark.parametrize("stages,microbatches", [(4, 2), (2, 4)])
def test_pp_forward_matches_jax(world, stages, microbatches):
    """The fill-drain pipeline: tests/test_tp.py's CFG at 4 layers over
    ``stages`` stages, 4 sequences of 8 in ``microbatches`` microbatches;
    every rank holds the logits."""
    from jax.sharding import Mesh
    from rten_tpu.parallel.pp import pp_forward, stack_layer_params

    jcfg, tcfg = cfgs(**{**TP_CFG, "n_layers": 4})
    jparams = jdec.init_params(jax.random.PRNGKey(9), jcfg)
    prompt = np.random.default_rng(9).integers(0, 96, (4, 8)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:stages]), ("pipe",))
    want = pp_forward(stack_layer_params(jparams), jcfg, jnp.asarray(prompt), mesh=mesh,
                      n_microbatches=microbatches)
    got = world.run(ranks.pp_run, stages, tcfg, to_numpy(jparams), prompt, microbatches)
    for rank_logits in got[:stages]:
        close(rank_logits, want, False)


SPECS = [dict(prompt=[1, 2, 3, 4], max_new_tokens=6), dict(prompt=[9, 8, 7], max_new_tokens=5),
         dict(prompt=[5, 6], max_new_tokens=4)]


@pytest.mark.parametrize("case", ["slot_pjit_fused_2x2", "slot_shard_map_int8kv_1x2", "paged_1x2"])
def test_engines_with_mesh_match_jax(world, case):
    """The slot engine (``tp_mode`` "pjit" on fused packs, which the port's
    sharding cuts apart itself; "shard_map" on ``fuse=False`` packs with
    int8 KV) and the paged engine with a mesh against the JAX engines with
    the same mesh: equal streams on every rank."""
    from rten_tpu.serve import Request as JRequest
    from rten_tpu.serve import ServingEngine as JServingEngine
    from rten_tpu.serve.paged import PagedServingEngine as JPagedServingEngine

    jcfg, tcfg = cfgs(**SLICE_CFG)
    kind, tp_mode, _ = case.split("_", 2) if case.startswith("slot") else ("paged", "pjit", "")
    if case == "slot_shard_map_int8kv_1x2":
        tp_mode = "shard_map"
    shape = (2, 2) if case.endswith("2x2") else (1, 2)
    int8_kv = "int8kv" in case
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(11)), fuse=case.endswith("fused_2x2"))
    mesh = jmake_mesh(*shape)
    if kind == "slot":
        jeng = JServingEngine(jparams, dataclasses.replace(jcfg, int8_kv=int8_kv), max_batch=2, seed=0, mesh=mesh,
                              tp_mode=tp_mode)
    else:
        jeng = JPagedServingEngine(jparams, jcfg, max_batch=2, n_pages=8, page_size=64, seed=0, mesh=mesh)
    jreqs = [jeng.submit(JRequest(**s)) for s in SPECS]
    jeng.run()
    outs = world.run(ranks.engine_run, shape, tcfg, to_numpy(jparams), kind, SPECS, tp_mode, int8_kv)
    for res in outs[: shape[0] * shape[1]]:
        assert res["outputs"] == [r.output for r in jreqs]
        fused = {"quant_mlp_int8", "decode_block", "decode_attention", "decode_attention:gqa"}
        assert not fused & set(res["plain"]), res["plain"]  # no epilogue across a reduction


def test_row_parallel_reduction_is_f32_rounded_once(world):
    """The port's intended difference: the row-parallel partials are summed
    in f32 and, with the bias and residual, rounded to bf16 once (the JAX
    body psums bf16 partials)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) * 0.2).astype(np.float32)
    bias, resid = rng.standard_normal(32).astype(np.float32), rng.standard_normal((3, 32)).astype(np.float32)
    assert world.run(ranks.row_proj_bf16, x, w, bias, resid)[:2] == [True, True]


def test_ranks_import_no_jax(world):
    assert world.run(ranks.ranks_import_no_jax) == [[]] * 4


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


def test_pack_slice_equals_quantized_slice():
    """Slicing an int8 pack's output columns gives the pack of the sliced
    matrix (scales are per output column); a K slice keeps every scale and
    is zero-padded to a multiple of 16; ``split_fused`` cuts q|k|v and
    gate|up into the packs ``fuse=False`` makes."""
    from rten_tpu_torch.kernels.quant_matmul import int8_pack, quantize_weights_int8

    rng = np.random.default_rng(13)
    w = rng.standard_normal((96, 256)).astype(np.float32)
    full = int8_pack(*quantize_weights_int8(w), device="cpu")
    for lo, hi in ((0, 64), (64, 192), (192, 256)):
        part = int8_pack(*quantize_weights_int8(w[:, lo:hi]), device="cpu")
        cut = pmesh._cols(full, lo, hi)
        assert torch.equal(cut["qt"], part["qt"]) and torch.equal(cut["s"], part["s"])
    rows = pmesh._rows(full, 40, 80)
    assert rows["qt"].shape == (256, 48) and torch.equal(rows["qt"][:, :40], full["qt"][:, 40:80])
    assert not rows["qt"][:, 40:].any() and rows["s"] is full["s"]

    _, tcfg = llama_configs()
    tree = llama_tree(14)
    fused = tdec.quantize_params_int8(tdec.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    apart = tdec.quantize_params_int8(tdec.params_from_jax(tree, tcfg, device="cpu"), device="cpu", fuse=False)
    assert "w_gu" in fused["layers"][0] and "w_gu" not in apart["layers"][0]
    layer = pmesh.split_fused(fused["layers"][0], tcfg)
    for key in ("wq", "w_gate", "w_up"):
        assert torch.equal(layer[key]["qt"], apart["layers"][0][key]["qt"]), key
        assert torch.equal(layer[key]["s"], apart["layers"][0][key]["s"]), key
    for key in ("bq", "bk", "bv"):
        assert torch.equal(layer[key], apart["layers"][0][key]), key


def _mixed_run(jparams, jcfg, tparams, tcfg, prompt, n_steps):
    """Both packages' prefill and greedy decode on the same carried tree
    (the JAX forward jitted, its jnp path)."""
    jforward = jax.jit(functools.partial(jdec.forward, use_flash=False), static_argnums=(1,))
    jcache = jdec.init_cache(jcfg, prompt.shape[0], 64)
    jl, jcache = jforward(jparams, jcfg, jnp.asarray(prompt), jcache)
    tcache = tdec.init_cache(tcfg, prompt.shape[0], 64, device="cpu")
    tl, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(prompt), tcache)
    pairs = [(tl.numpy(), np.asarray(jl))]
    for _ in range(n_steps):
        jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        ttok = tl[:, -1:].argmax(-1).to(torch.int32)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jcache = jforward(jparams, jcfg, jtok, jcache)
        tl, tcache = tdec.forward(tparams, tcfg, ttok, tcache)
        pairs.append((tl.numpy(), np.asarray(jl)))
    return pairs


def test_mixed_demo_tree_matches_jax():
    """The GPT-2 example's demo model (vocab 256, d 128, d_ff 512,
    ``examples/gpt2.py:135-136``) through the JAX quantizer: q|k|v and wo
    dense, up and down int8 packs of exactly 2^16 elements, the tied head
    dense. The port's ``forward`` on the carried tree matches
    ``jdec.forward`` (relative RMS 1e-4 in f32) with equal greedy tokens."""
    kw = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=128, d_ff=512, max_seq=256)
    jcfg, tcfg = cfgs(**kw)
    jparams = jdec.quantize_params_int8(jdec.init_params(jax.random.PRNGKey(0), jcfg))
    layer = jparams["layers"][0]
    assert not isinstance(layer["wqkv"], dict) and not isinstance(layer["wo"], dict)
    assert isinstance(layer["w_up"], dict) and layer["w_up"]["q"].size == 1 << 16
    assert not isinstance(jparams["lm_head_q"], dict)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    assert tdec._is_dense(tparams)
    prompt = np.random.default_rng(15).integers(0, 256, (2, 9)).astype(np.int32)
    for got, want in _mixed_run(jparams, jcfg, tparams, tcfg, prompt, 4):
        assert rel_rms(got, want) <= 1e-4


def test_gpt2_example_demo_int8_runs():
    from rten_tpu_torch.examples import gpt2

    result = {}
    assert gpt2.main(["--demo", "--int8", "--cpu", "-n", "4"], result) == 0
    assert len(result["tokens"]) == 4


def test_unfused_mixed_llama_tree_matches_jax():
    """The Llama slice quantized with ``fuse=False``: ``wk`` / ``wv``
    (256 x 128) stay dense beside the packs. Both packages' prefill and
    decode on the carried tree (int8, rtol / atol 1e-3) with equal greedy
    tokens."""
    jcfg, tcfg = llama_configs()
    jparams = jdec.quantize_params_int8(to_jax(llama_tree(16)), fuse=False)
    assert not isinstance(jparams["layers"][0]["wk"], dict) and isinstance(jparams["layers"][0]["wq"], dict)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    prompt = np.random.default_rng(16).integers(0, 500, (2, 6)).astype(np.int32)
    for got, want in _mixed_run(jparams, jcfg, tparams, tcfg, prompt, 3):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
