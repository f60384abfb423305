"""The port's decoder (plain kernel versions, on the CPU) against the JAX
package's decoder on the same seeded parameters.

JAX runs its jnp path here (no TPU, so no fused kernels); the port runs its
kernels' plain versions, a prompt as one forward: the fused decode
structure at B·T ≤ 8 rows, the prefill structure (quant_matmul_int8 and
flash_attention) above. Both are f32. Tolerances: logits atol 1e-4 (same
f32 arithmetic, another order; exact erf against the erf polynomial,
1.5e-7); caches atol 1e-5; greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels.decode_attention import pack_kv_scales
from rten_tpu.models import decoder as jdec
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.models import decoder as tdec
from torch_port_helpers import (
    carry_cache,
    configs,
    dense_tree,
    jax_pages,
    jax_scale_tiles,
    patch_jax_w8a8,
    port_pages,
    port_scale_pages,
    to_jax,
    to_numpy,
    unfold,
)

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    tree = dense_tree(0)
    jparams = jdec.quantize_params_int8(to_jax(tree), tile_bn=128)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _packs(node, path=""):
    """{path: (qt, s, tiled)} of every int8 pack in a port params tree."""
    out = {}
    if isinstance(node, dict):
        if "qt" in node:
            return {path: (node["qt"].numpy(), node["s"].numpy(), node["tiled"])}
        for k, v in node.items():
            out.update(_packs(v, f"{path}/{k}"))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            out.update(_packs(v, f"{path}/{i}"))
    return out


@pytest.mark.parametrize("tile_bn", ["env", 128])
def test_params_from_jax_equal_port_quantization(tile_bn):
    """JAX-quantized params carried across equal the port's own
    quantization of the carried dense params: int8 bit for bit, scales and
    every other leaf exact."""
    _, tcfg = configs()
    tree = dense_tree(0)
    jq = to_numpy(jdec.quantize_params_int8(to_jax(tree), tile_bn=tile_bn))
    if tile_bn == 128:
        assert jq["lm_head_q"]["q"].ndim == 3  # a tiled [S, K, bn] pack
    assert "slabs" in jq
    carried = tdec.params_from_jax(jq, tcfg, device="cpu")
    own = tdec.quantize_params_int8(tdec.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    if tile_bn == 128:  # the copied JAX rule at a width that tiles the tiny config
        tdec._mark_tiled(own, tile_bn)
    pc, po = _packs(carried), _packs(own)
    assert sorted(pc) == sorted(po) and "/lm_head_q" in pc and "/layers/0/wqkv" in pc
    for key in pc:
        np.testing.assert_array_equal(pc[key][0], po[key][0], err_msg=key)
        np.testing.assert_array_equal(pc[key][1], po[key][1], err_msg=key)
        assert pc[key][0].dtype == np.int8
        # The packs the JAX package tiles (the W8A8 prefill keeps them weight-only).
        assert pc[key][2] == po[key][2] == (key in ("/lm_head_q", "/layers/0/wqkv") and tile_bn == 128), key
    assert "slabs" not in carried
    for li in range(tcfg.n_layers):
        for key in ("bqkv", "bo", "b_up", "b_down"):
            np.testing.assert_array_equal(carried["layers"][li][key], own["layers"][li][key])
        for key in ("scale", "bias"):
            np.testing.assert_array_equal(
                carried["layers"][li]["ln1"][key], own["layers"][li]["ln1"][key]
            )
    np.testing.assert_array_equal(carried["tok_emb"], own["tok_emb"])


def _assert_caches_match(tcache, jcache, tcfg):
    for li in range(tcfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                tcache[kv][li].numpy(), unfold(jcache[kv][li], tcfg.head_dim), atol=1e-5, rtol=0
            )


def test_prefill_matches_jax(models):
    """An 8-token prompt (B·T = 8: the fused decode structure, attention
    through flash_attention over the cache) as one forward: JAX prefill
    against the port's, logits of every position and the caches."""
    jcfg, tcfg, jparams, tparams = models
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 8)).astype(np.int32)
    jcache = jdec.init_cache(jcfg, 1, 64)
    jlogits, jcache = jdec.prefill(jparams, jcfg, jnp.asarray(tokens), jcache)
    tcache = tdec.init_cache(tcfg, 1, 64, device="cpu")
    dispatch.reset_counters()
    tlogits, tcache = tdec.prefill(tparams, tcfg, torch.from_numpy(tokens), tcache)
    assert dispatch.PLAIN["flash_attention"] == tcfg.n_layers and "decode_attention" not in dispatch.PLAIN
    assert tlogits.shape == (1, 8, tcfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    assert int(tcache["len"][0]) == int(jcache["len"][0]) == 8
    _assert_caches_match(tcache, jcache, tcfg)


@pytest.mark.parametrize("b,t", [(1, 20), (2, 12), (1, 5)], ids=["1x20", "2x12", "1x5"])
def test_one_forward_prefill_matches_jax(models, b, t):
    """A prompt as one forward at B·T > 8 (the prefill structure) and ≤ 8
    (the fused decode structure): logits of every position, the caches,
    and the greedy tokens of 4 decode steps after it."""
    jcfg, tcfg, jparams, tparams = models
    tokens = np.random.default_rng(10 + t).integers(0, tcfg.vocab_size, (b, t)).astype(np.int32)
    jcache = jdec.init_cache(jcfg, b, 64)
    jlogits, jcache = jdec.prefill(jparams, jcfg, jnp.asarray(tokens), jcache)
    tcache = tdec.init_cache(tcfg, b, 64, device="cpu")
    dispatch.reset_counters()
    tlogits, tcache = tdec.prefill(tparams, tcfg, torch.from_numpy(tokens), tcache)
    n_matmul = 4 * tcfg.n_layers + (1 if b * t > 8 else 0)  # qkv, wo, up, down; the lm_head
    assert dispatch.PLAIN["quant_matmul_int8"] == (n_matmul if b * t > 8 else 0)
    assert dispatch.PLAIN["flash_attention"] == tcfg.n_layers
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    _assert_caches_match(tcache, jcache, tcfg)

    first = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    jtoks, _ = jdec.generate_scan(jparams, jcfg, jcache, first, jax.random.PRNGKey(0), n_steps=4)
    ttoks, _ = tdec.generate_greedy(tparams, tcfg, tcache, torch.from_numpy(np.array(first)), 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_chunked_prompt_matches_one_prefill(models):
    """12 prompt tokens, then 9 more (a follow-up prompt at q_offset 12),
    against one 21-token prefill: the last 9 positions' logits and the
    caches."""
    _, tcfg, _, tparams = models
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, tcfg.vocab_size, (1, 21)).astype(np.int32))
    whole = tdec.init_cache(tcfg, 1, 64, device="cpu")
    wlogits, whole = tdec.prefill(tparams, tcfg, tokens, whole)
    chunked = tdec.init_cache(tcfg, 1, 64, device="cpu")
    _, chunked = tdec.prefill(tparams, tcfg, tokens[:, :12], chunked)
    clogits, chunked = tdec.prefill(tparams, tcfg, tokens[:, 12:], chunked)
    np.testing.assert_allclose(clogits.numpy(), wlogits[:, 12:].numpy(), atol=LOGIT_ATOL, rtol=0)
    assert chunked["host_len"] == whole["host_len"] == 21
    for li in range(tcfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(chunked[kv][li].numpy(), whole[kv][li].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,t", [(1, 12), (2, 3)], ids=["1x12", "2x3"])
def test_forward_without_cache_matches_jax(models, b, t):
    """``forward(cache=None)``: the plain full-sequence forward (q_offset 0,
    kv_len T), in both structures."""
    jcfg, tcfg, jparams, tparams = models
    tokens = np.random.default_rng(20 + t).integers(0, tcfg.vocab_size, (b, t)).astype(np.int32)
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(tokens))
    tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert jcache is None and tcache is None
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    targmax, _ = tdec.forward(tparams, tcfg, torch.from_numpy(tokens), lm_head_mode="argmax")
    np.testing.assert_array_equal(targmax.numpy(), np.asarray(jlogits).argmax(-1))


def test_greedy_decode_matches_jax(models):
    """16 greedy steps after a prompt: the port's generate_greedy (fused
    argmax) against JAX's generate_scan, and the per-step logits of the
    port's decode_step against JAX's."""
    jcfg, tcfg, jparams, tparams = models
    prompt = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    n = 16

    jcache = jdec.init_cache(jcfg, 2, 64)
    jlogits, jcache = jdec.prefill(jparams, jcfg, jnp.asarray(prompt), jcache)
    first = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    jtoks, _ = jdec.generate_scan(jparams, jcfg, jcache, first, jax.random.PRNGKey(0), n_steps=n)

    tcache = tdec.init_cache(tcfg, 2, 64, device="cpu")
    tfirst, tcache = tdec.prefill(
        tparams, tcfg, torch.from_numpy(prompt), tcache, lm_head_mode="argmax", last_only=True
    )
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(first))
    ttoks, tcache = tdec.generate_greedy(tparams, tcfg, tcache, tfirst, n)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tcache["len"].numpy(), [5 + n, 5 + n])

    # Teacher-forced logits, step by step.
    jcache = jdec.init_cache(jcfg, 2, 64)
    _, jcache = jdec.prefill(jparams, jcfg, jnp.asarray(prompt), jcache)
    tcache = tdec.init_cache(tcfg, 2, 64, device="cpu")
    _, tcache = tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), tcache, last_only=True)
    toks = np.array(jtoks)
    for i in range(4):
        step = toks[:, i : i + 1]
        jl, jcache = jdec.decode_step(jparams, jcfg, jnp.asarray(step), jcache)
        tl, tcache = tdec.decode_step(tparams, tcfg, torch.from_numpy(step), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)


def _random_jax_cache(jcfg, lens, s_max, seed, int8=False):
    """A JAX cache whose rows hold ``lens`` tokens of seeded random k/v
    (int8 codes and scales in the kernel layout with ``int8``)."""
    rng = np.random.default_rng(seed)
    b, hd = len(lens), jcfg.head_dim
    shape = (b, jcfg.n_heads, s_max, hd)
    cache = {"len": jnp.asarray(np.array(lens, np.int32))}
    for key in ("k", "v"):
        if int8:
            cache[key] = [jnp.asarray(rng.integers(-127, 128, shape).astype(np.int8)) for _ in range(jcfg.n_layers)]
            scales = rng.uniform(0.005, 0.02, (*shape[:3], 1)).astype(np.float32)
            cache[key + "_scale"] = [jnp.asarray(pack_kv_scales(jnp.asarray(scales), hd))
                                     for _ in range(jcfg.n_layers)]
        else:
            cache[key] = [jnp.asarray(rng.standard_normal(shape).astype(np.float32)) for _ in range(jcfg.n_layers)]
    return cache


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("t", [1, 3], ids=["decode", "3_tokens"])
def test_forward_rows_of_unequal_lengths(models, kind, t):
    """Rows holding 5, 12 and 0 tokens: each row's new k/v go in at its own
    length. A decode step (the decode kernels) and a 3-token forward (9 rows:
    the prefill structure) against ``jdec.forward`` on the same cache:
    logits, the caches' valid prefixes (int8: codes and scales) and lengths."""
    int8 = kind == "int8"
    kv = ("decode_attention_int8" if int8 else "decode_attention") if t == 1 else "flash_attention"
    _unequal_rows_check(*models, int8, t, kv)


def _unequal_rows_check(jcfg, tcfg, jparams, tparams, int8: bool, t: int, kernel: str):
    """``test_forward_rows_of_unequal_lengths`` on these models: one forward
    of ``t`` tokens a row, ``kernel`` the plain version each layer runs."""
    if int8:
        jcfg = dataclasses.replace(jcfg, int8_kv=True)
    lens, s_max = [5, 12, 0], 64
    jcache = _random_jax_cache(jcfg, lens, s_max, seed=30 + t, int8=int8)
    tcache = carry_cache(jcache, tcfg.head_dim)
    tokens = np.random.default_rng(40 + t).integers(0, tcfg.vocab_size, (3, t)).astype(np.int32)
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(tokens), jcache)
    dispatch.reset_counters()
    tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(tokens), tcache)
    assert dispatch.PLAIN[kernel] == tcfg.n_layers
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    want = carry_cache(jcache, tcfg.head_dim)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.array(lens) + t)
    np.testing.assert_array_equal(tcache["host_len"], np.array(lens) + t)
    for li in range(tcfg.n_layers):
        for key in ("k", "v", "k_scale", "v_scale") if int8 else ("k", "v"):
            for r, n in enumerate(np.array(lens) + t):
                got, ref = tcache[key][li][r, :, :n].numpy(), want[key][li][r, :, :n].numpy()
                if key in ("k", "v") and int8:
                    np.testing.assert_array_equal(got, ref, err_msg=f"{key} {li} row {r}")
                else:
                    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=f"{key} {li} row {r}")


# Head dims beside SLICE_CFG's 64: 32 (8 heads; a KV kernel instance) and
# 96 (4 heads over d_model 384; no KV kernel: a step takes flash_attention
# at Tq 1, as the JAX decoder does at a head dim its decode kernels refuse).
HEAD_DIM_CFGS = {32: dict(n_heads=8), 96: dict(n_heads=4, d_model=384)}


@pytest.fixture(scope="module")
def head_dim_models():
    out = {}
    for hd, kw in HEAD_DIM_CFGS.items():
        jcfg, tcfg = configs(**kw)
        jparams = jdec.quantize_params_int8(to_jax(dense_tree(0, **kw)), tile_bn=128)
        out[hd] = (jcfg, tcfg, jparams, tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("head_dim", list(HEAD_DIM_CFGS))
def test_head_dims_match_jax(head_dim_models, head_dim, kind):
    """A decode step over rows of unequal lengths (as
    ``test_forward_rows_of_unequal_lengths``) at head dims 32 and 96
    against ``jdec.forward``: the KV kernels at 32, and at 96 the cache
    append and ``flash_attention`` at Tq 1; then (f32) the greedy stream of
    a prompt against JAX's ``generate_scan``."""
    jcfg, tcfg, jparams, tparams = head_dim_models[head_dim]
    assert tcfg.head_dim == head_dim
    int8 = kind == "int8"
    kv = ("decode_attention_int8" if int8 else "decode_attention") if head_dim == 32 else "flash_attention"
    _unequal_rows_check(jcfg, tcfg, jparams, tparams, int8, 1, kv)
    if int8:
        return
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    jcache = jdec.init_cache(jcfg, 2, 64)
    jlogits, jcache = jdec.prefill(jparams, jcfg, jnp.asarray(prompt), jcache)
    first = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    jtoks, _ = jdec.generate_scan(jparams, jcfg, jcache, first, jax.random.PRNGKey(0), n_steps=6)
    tcache = tdec.init_cache(tcfg, 2, 64, device="cpu")
    tfirst, tcache = tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), tcache, lm_head_mode="argmax",
                                  last_only=True)
    ttoks, _ = tdec.generate_greedy(tparams, tcfg, tcache, tfirst, 6)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


@pytest.mark.parametrize("int8", [False, True], ids=["f32_pages", "int8_pages"])
def test_paged_forward_matches_jax(models, int8):
    """A decode step over a paged pool (pages of 64; rows at 5, 70 and 0
    tokens, the last on the scratch page): logits and every page after the
    append against ``jdec.forward`` on the same pool (Pallas in interpret
    mode)."""
    _check_paged_step(*models, int8)


def _check_paged_step(jcfg, tcfg, jparams, tparams, int8):
    rng = np.random.default_rng(50 + int8)
    hd, page, n_pages = tcfg.head_dim, 64, 6
    shape = (n_pages, tcfg.n_heads, page, hd)
    lens = np.array([5, 70, 0], np.int32)
    table = np.array([[2, 5], [4, 1], [5, 5]], np.int32)  # page 5 is the scratch page

    def payload():
        if int8:
            return rng.integers(-127, 128, shape).astype(np.int8)
        return rng.standard_normal(shape).astype(np.float32)

    pool = {"k_pages": [payload() for _ in range(tcfg.n_layers)], "v_pages": [payload() for _ in range(tcfg.n_layers)]}
    if int8:
        for key in ("k_scale_pages", "v_scale_pages"):
            pool[key] = [rng.uniform(0.005, 0.02, shape[:3]).astype(np.float32) for _ in range(tcfg.n_layers)]
    jcache = {key: [jnp.asarray(jax_pages(p) if key in ("k_pages", "v_pages") else jax_scale_tiles(p, hd))
                    for p in leaves] for key, leaves in pool.items()}
    jcache.update(page_table=jnp.asarray(table), len=jnp.asarray(lens))
    tcache = {key: [torch.from_numpy(p.copy()) for p in leaves] for key, leaves in pool.items()}
    tcache.update(page_table=torch.from_numpy(table), len=torch.from_numpy(lens.copy()))
    tokens = np.random.default_rng(60).integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(tokens), jcache)
    tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(tokens), tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tcache["len"].numpy(), lens + 1)
    for li in range(tcfg.n_layers):
        for key in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tcache[key][li].numpy(), port_pages(jcache[key][li], hd), atol=1e-5, rtol=0)
        if int8:
            for key in ("k_scale_pages", "v_scale_pages"):
                np.testing.assert_allclose(tcache[key][li].numpy(), port_scale_pages(jcache[key][li], hd, page),
                                           rtol=1e-6, atol=0)  # absmax of k/v equal to ~1e-7


def test_forward_refuses_multi_token():
    """A multi-token forward that would overrun the cache is refused before
    any kernel runs, and the cache is left as it was."""
    _, tcfg = configs()
    params = tdec.quantize_params_int8(tdec.params_from_jax(dense_tree(0), tcfg, device="cpu"),
                                       device="cpu")
    cache = tdec.init_cache(tcfg, 1, 16, device="cpu")
    _, cache = tdec.prefill(params, tcfg, torch.arange(10, dtype=torch.int32)[None], cache)
    k_before = [k.clone() for k in cache["k"]]
    dispatch.reset_counters()
    with pytest.raises(IndexError, match="KV cache full"):
        tdec.forward(params, tcfg, torch.zeros((1, 7), dtype=torch.int32), cache)
    assert not dispatch.PLAIN and not dispatch.LAUNCHES
    assert cache["host_len"] == 10 and int(cache["len"][0]) == 10
    assert all(torch.equal(a, b) for a, b in zip(cache["k"], k_before))


def test_generate_greedy_past_cache_raises():
    """A full cache is refused before any kernel runs, on every device."""
    _, tcfg = configs()
    params = tdec.quantize_params_int8(tdec.params_from_jax(dense_tree(0), tcfg, device="cpu"),
                                       device="cpu")
    cache = tdec.init_cache(tcfg, 1, 8, device="cpu")
    first = torch.zeros((1, 1), dtype=torch.int32)
    dispatch.reset_counters()
    with pytest.raises(IndexError, match="KV cache full"):
        tdec.generate_greedy(params, tcfg, cache, first, 9)  # checked for all 9 steps up front
    assert not dispatch.PLAIN
    assert cache["host_len"] == 0 and int(cache["len"][0]) == 0
    tdec.generate_greedy(params, tcfg, cache, first, 8)
    with pytest.raises(IndexError, match="KV cache full"):
        tdec.generate_greedy(params, tcfg, cache, first, 1)
    assert cache["host_len"] == 8 and int(cache["len"][0]) == 8


def test_dense_params_are_refused():
    """A dense projection among int8 packs is no longer refused (mixed
    trees run since the per-projection route takes each matrix as it
    finds it, as the JAX package's ``_proj`` does): such a tree takes that
    route, and its forward matches the JAX package's on the same tree
    (int8 tolerance, rtol / atol 1e-3)."""
    jcfg, tcfg = configs()
    tree = dense_tree(0)
    jparams = jdec.quantize_params_int8(to_jax(tree))
    jparams["layers"][1]["wo"] = jnp.asarray(tree["layers"][1]["wo"])
    params = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    assert tdec._is_dense(params) and not isinstance(params["layers"][1]["wo"], dict)
    tokens = np.array([[3, 7, 11, 2]], np.int32)
    want, _ = jdec.forward(jparams, jcfg, jnp.asarray(tokens), None, use_flash=False)
    got, _ = tdec.forward(params, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_from_hf_gpt2_matches_jax_and_transformers():
    transformers = pytest.importorskip("transformers")
    jcfg, tcfg = configs()
    torch.manual_seed(0)
    hf_cfg = transformers.GPT2Config(
        vocab_size=tcfg.vocab_size, n_positions=tcfg.max_seq, n_embd=tcfg.d_model,
        n_layer=tcfg.n_layers, n_head=tcfg.n_heads, n_inner=tcfg.d_ff,
        activation_function="gelu", resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        layer_norm_epsilon=1e-5, initializer_range=0.08,
    )
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    state = hf.state_dict()

    tdense = tdec.from_hf_gpt2(state, tcfg, device="cpu")
    jdense = to_numpy(jdec.from_hf_gpt2(state, jcfg))
    assert sorted(tdense["layers"][0]) == sorted(jdense["layers"][0])
    for key in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "w_up", "b_up", "w_down", "b_down"):
        np.testing.assert_array_equal(tdense["layers"][1][key].numpy(), jdense["layers"][1][key])
    np.testing.assert_array_equal(tdense["tok_emb"].numpy(), jdense["tok_emb"])

    # 12 tokens: the one-forward prefill structure (quant_matmul_int8, flash_attention).
    ids = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, 12)).astype(np.int32)
    tparams = tdec.quantize_params_int8(tdense, device="cpu")
    tlogits, _ = tdec.prefill(tparams, tcfg, torch.from_numpy(ids),
                              tdec.init_cache(tcfg, 1, 16, device="cpu"))
    jparams = jdec.quantize_params_int8(jdec.from_hf_gpt2(state, jcfg))
    jlogits, _ = jdec.prefill(jparams, jcfg, jnp.asarray(ids), jdec.init_cache(jcfg, 1, 16))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    # Against the float model: the int8 weights' rounding is the only
    # difference (per-channel int8 keeps ~0.4% per weight).
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids.astype(np.int64))).logits.numpy()
    err = np.abs(tlogits.numpy() - ref).max()
    assert err < 0.05 * np.abs(ref).max(), err


# ---------------------------------------------------------------------------
# W8A8 (cfg.w8a8): the port against the JAX package's RTEN_W_CONVERT=w8a8
# path, its Pallas kernels in interpret mode (patch_jax_w8a8). JAX params
# quantized untiled and at tile_bn 128, which tiles the lm_head and layer
# 0's wqkv: the JAX prefill keeps those weight-only. Tolerances: greedy
# tokens identical and logits within 1e-3 (the gate of ROADMAP queue 1
# item 2); both sum the same int8 codes exactly.
# ---------------------------------------------------------------------------

W8_LOGIT_ATOL = 1e-3
W8_GATE = 0.05  # relative RMS of W8A8 against weight-only logits (measured 0.013-0.019 here)


@pytest.fixture(scope="module")
def w8_models():
    """{tile_bn: (JAX params, port params)} for tile_bn None and 128."""
    tree = to_jax(dense_tree(0))
    _, tcfg = configs()
    out = {}
    for tile_bn in (None, 128):
        jparams = jdec.quantize_params_int8(tree, tile_bn=tile_bn)
        out[tile_bn] = jparams, tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    return out


def _rel_rms(a, b):
    return float(np.sqrt(((a - b) ** 2).mean() / (b**2).mean()))


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("tile_bn", [None, 128], ids=["untiled", "tiled128"])
def test_w8a8_forward_matches_jax(monkeypatch, w8_models, tile_bn, kv):
    """A 12-token prompt (the prefill structure: quant_matmul_w8a8, or
    quant_matmul_int8 for a tiled pack), a 3-token follow-up (the decode
    structure at T > 1: the GEMV and MLP in w8a8 mode, flash_attention, wo
    through the GEMV) and 3 greedy steps (decode_attention with its
    weight-only fused wo, or decode_attention_int8 then the w8a8 wo GEMV),
    on an f32 or int8 cache: logits of every forward and the tokens. The
    prompt's ``last_only`` prefill (the lm_head on one row of a
    prefill-structure forward: ``_norm`` and the prefill projection, as the
    JAX package runs it on every row) equals its last position."""
    patch_jax_w8a8(monkeypatch)
    jparams, tparams = w8_models[tile_bn]
    jcfg, tcfg = configs()
    jcfg, tcfg = (dataclasses.replace(jcfg, int8_kv=kv == "int8"),
                  dataclasses.replace(tcfg, int8_kv=kv == "int8", w8a8=True))
    tokens = np.random.default_rng(70).integers(0, tcfg.vocab_size, (1, 15)).astype(np.int32)
    jcache, tcache = jdec.init_cache(jcfg, 1, 64), tdec.init_cache(tcfg, 1, 64, device="cpu")
    dispatch.reset_counters()
    for step, chunk in enumerate([tokens[:, :12], tokens[:, 12:], None, None, None]):
        if chunk is None:
            chunk = np.array(jlogits[:, -1:].argmax(-1), np.int32)
            np.testing.assert_array_equal(tlogits[:, -1:].argmax(-1).numpy(), chunk)
        jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(chunk), jcache)
        tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(chunk), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=W8_LOGIT_ATOL, rtol=0,
                                   err_msg=f"forward {step}")
    tiled = tile_bn is not None
    assert dispatch.PLAIN["quant_matmul_w8a8"] == 4 * tcfg.n_layers + 1 - 2 * tiled
    assert dispatch.PLAIN["quant_matmul_int8"] == 2 * tiled  # layer 0's wqkv and the lm_head
    assert dispatch.PLAIN["quant_gemv_int8:w8a8"] > 0 and dispatch.PLAIN["quant_mlp_int8:w8a8"] > 0
    assert "quant_gemv_int8" not in dispatch.PLAIN and "quant_mlp_int8" not in dispatch.PLAIN
    last, _ = tdec.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :12]),
                           tdec.init_cache(tcfg, 1, 64, device="cpu"), last_only=True)
    jlast, _ = jdec.forward(jparams, jcfg, jnp.asarray(tokens[:, :12]), jdec.init_cache(jcfg, 1, 64))
    np.testing.assert_allclose(last[:, 0].numpy(), np.asarray(jlast)[:, -1], atol=W8_LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_pages", "int8_pages"])
def test_w8a8_paged_forward_matches_jax(monkeypatch, w8_models, int8):
    """``test_paged_forward_matches_jax`` in W8A8 (tiled packs): wo through
    the w8a8 GEMV after the paged kernel."""
    patch_jax_w8a8(monkeypatch)
    jparams, tparams = w8_models[128]
    jcfg, tcfg = configs()
    dispatch.reset_counters()
    _check_paged_step(jcfg, dataclasses.replace(tcfg, w8a8=True), jparams, tparams, int8)
    assert dispatch.PLAIN["quant_gemv_int8:w8a8"] == tcfg.n_layers + 2  # wo; layer 0's qkv; the lm_head


def test_w8a8_accuracy_gate(w8_models):
    """The accuracy gate the JAX package lacks: W8A8 logits against the
    port's weight-only logits on the same int8 weights, a 12-token prompt
    and 8 teacher-forced steps, relative RMS difference below W8_GATE per
    forward, and not 0 (the mode is on)."""
    _, tparams = w8_models[None]
    _, tcfg = configs()
    tokens = torch.from_numpy(np.random.default_rng(71).integers(0, tcfg.vocab_size, (1, 20)).astype(np.int32))
    logits = {}
    for w8a8 in (False, True):
        cfg = dataclasses.replace(tcfg, w8a8=w8a8)
        cache = tdec.init_cache(cfg, 1, 64, device="cpu")
        out, cache = tdec.prefill(tparams, cfg, tokens[:, :12], cache)
        steps = [out[0]]
        for i in range(12, 20):
            out, cache = tdec.forward(tparams, cfg, tokens[:, i : i + 1], cache)
            steps.append(out[0])
        logits[w8a8] = torch.cat(steps).numpy()
    rms = [_rel_rms(logits[True][i], logits[False][i]) for i in range(len(logits[True]))]
    assert 0 < min(rms) and max(rms) < W8_GATE, rms


# ---------------------------------------------------------------------------
# The decode MLP's routing by the JAX package's whole-MLP budget
# (``mlp_fused_supported``), in bf16, where a rounding in another place
# shows: both budgets monkeypatched (the port's ``_MLP_FUSED_BYTES`` and the
# JAX package's ``MLP_FUSED_VMEM_LIMIT``). At SLICE_CFG the MLP's int8
# weights take 524288 bytes and the next qkv 196608 more: at 600000 the MLP
# fits and the next qkv does not (layer 1's qkv is a GEMV over layer 0's
# block output rounded to bf16); at 400000 neither fits (the up GEMV, its
# output rounded, then the down GEMV with the residual; under W8A8 the down
# GEMV quantizes the rounded rows).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget,w8a8", [(600000, False), (400000, False), (400000, True)],
                         ids=["mlp_fits", "nothing_fits", "nothing_fits_w8a8"])
def test_decode_mlp_routing_matches_jax_bits(monkeypatch, budget, w8a8):
    """One bf16 decode step at kv_len 20 against ``jdec.forward`` under
    ``patch_jax_fused``: layer 1's new k/v and the last block's output (the
    lm_head GEMV's input) bit for bit."""
    import jax

    from rten_tpu.kernels import quant_matmul as jqm
    from torch_port_helpers import SLICE_CFG, patch_jax_fused

    patch_jax_fused(monkeypatch, w8a8=w8a8)
    monkeypatch.setattr(jqm, "MLP_FUSED_VMEM_LIMIT", budget)
    monkeypatch.setattr(tdec, "_MLP_FUSED_BYTES", budget)
    jcfg = jdec.DecoderConfig(**SLICE_CFG, dtype=jnp.bfloat16)
    tcfg = tdec.DecoderConfig(**SLICE_CFG, dtype=torch.bfloat16, w8a8=w8a8)
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), to_jax(dense_tree(0)))
    jparams = jdec.quantize_params_int8(tree, tile_bn=None)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(90)
    shape = (1, tcfg.n_heads, 64, tcfg.head_dim)
    jcache = {key: [jnp.asarray(rng.standard_normal(shape), jnp.bfloat16) for _ in range(tcfg.n_layers)]
              for key in ("k", "v")}
    jcache["len"] = jnp.asarray([20], jnp.int32)
    tcache = carry_cache(jcache, tcfg.head_dim)
    token = np.array([[7]], np.int32)

    seen = {}
    for mod, key in ((jqm, "jax"), (tdec, "port")):
        inner = mod.quant_gemv_int8

        def record(x, *a, inner=inner, key=key, **kw):
            seen[key] = np.asarray(x if key == "jax" else x.float().numpy(), np.float32)  # the last call: the lm_head
            return inner(x, *a, **kw)

        monkeypatch.setattr(mod, "quant_gemv_int8", record)
    dispatch.reset_counters()
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(token), jcache)
    tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(token), tcache)
    mlp = "quant_mlp_int8:w8a8" if w8a8 else "quant_mlp_int8"
    assert dispatch.PLAIN[mlp] == (tcfg.n_layers if budget == 600000 else 0)
    want = carry_cache(jcache, tcfg.head_dim)
    for kv in ("k", "v"):
        np.testing.assert_array_equal(tcache[kv][1][0, :, 20].float().numpy(), want[kv][1][0, :, 20].float().numpy(),
                                      err_msg=f"layer 1's new {kv}")
    np.testing.assert_array_equal(seen["port"], seen["jax"], err_msg="the last block's output")
    # The JAX package's logits are rounded to bf16, the port's are not.
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-3, rtol=2.0**-8)
