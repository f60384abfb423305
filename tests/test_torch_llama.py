"""The port's Llama/Qwen2-class decoder (RoPE, RMSNorm, SwiGLU, grouped-query
attention, an untied lm_head; the kernels' plain versions on the CPU)
against the JAX package's fused decode path (its Pallas kernels in
interpret mode, ``patch_jax_fused``), HuggingFace's ``LlamaForCausalLM``
(with and without ``attention_bias``, the Qwen2 convention) and
``OPTForCausalLM``, and the JAX serving engines.

The config is ``LLAMA_SLICE_CFG`` (vocab 500, 2 layers, 4 query heads over
2 kv heads, d_model 256) at two SwiGLU widths: d_ff 384, whose gate|up fuse
into ``w_gu``, and d_ff 344, whose ``w_gate`` and ``w_up`` stay apart and
whose ``w_down`` is K-padded to 384. Both packages get the same seeded numpy
parameters through ``params_from_jax``. Tolerances: f32 logits within 1e-3
(the same int8 weights and f32 arithmetic, summed in other orders; RoPE's
cos / sin in another library), greedy tokens identical; against the HF
float models 5% of the largest logit (per-channel int8 weights).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.models import decoder as jdec
from rten_tpu.serve import Request as JRequest
from rten_tpu.serve import ServingEngine as JServingEngine
from rten_tpu.serve.paged import PagedServingEngine as JPagedServingEngine
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine
from torch_port_helpers import (
    LLAMA_SLICE_CFG,
    carry_cache,
    jax_pages,
    jax_scale_tiles,
    llama_configs,
    llama_tree,
    patch_jax_fused,
    patch_jax_w8a8,
    port_pages,
    port_scale_pages,
    to_jax,
    to_numpy,
)

LOGIT_ATOL = 1e-3
D_FFS = [344, 384]
HD = LLAMA_SLICE_CFG["d_model"] // LLAMA_SLICE_CFG["n_heads"]


@pytest.fixture(scope="module", params=D_FFS, ids=lambda f: f"ff{f}")
def llama(request):
    """(JAX config, port config, JAX int8 params, the port's copy) at one
    SwiGLU width."""
    jcfg, tcfg = llama_configs(d_ff=request.param)
    jparams = jdec.quantize_params_int8(to_jax(llama_tree(0, request.param)))
    return jcfg, tcfg, jparams, tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")


def _packs(node, path=""):
    """{path: (qt, s, tiled)} of every int8 pack in a port params tree."""
    if isinstance(node, dict):
        if "qt" in node:
            return {path: (node["qt"].numpy(), node["s"].numpy(), node["tiled"])}
        return {k: v for key, child in node.items() for k, v in _packs(child, f"{path}/{key}").items()}
    if isinstance(node, list):
        return {k: v for i, child in enumerate(node) for k, v in _packs(child, f"{path}/{i}").items()}
    return {}


@pytest.mark.parametrize("tile_bn", ["env", 128])
@pytest.mark.parametrize("d_ff", D_FFS)
def test_llama_params_from_jax_equal_port_quantization(d_ff, tile_bn):
    """JAX-quantized Llama params carried across equal the port's own
    quantization of the same dense params: the fused ``wqkv`` and ``bqkv``,
    ``w_gu`` only where 2·d_ff is a multiple of 128, the K-padded
    ``w_down``, the untied ``lm_head`` (no ``lm_head_q``), int8 bit for
    bit, and the packs the JAX package tiles (SwiGLU's gate and up packs
    and every ``wqkv`` at 128, never ``w_down`` or ``wo``)."""
    _, tcfg = llama_configs(d_ff=d_ff)
    tree = llama_tree(0, d_ff)
    carried = tdec.params_from_jax(to_numpy(jdec.quantize_params_int8(to_jax(tree), tile_bn=tile_bn)), tcfg,
                                   device="cpu")
    own = tdec.quantize_params_int8(tdec.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    if tile_bn == 128:
        tdec._mark_tiled(own, tile_bn)
    pc, po = _packs(carried), _packs(own)
    assert sorted(pc) == sorted(po)
    gate_up = {"w_gu"} if d_ff == 384 else {"w_gate", "w_up"}
    assert {k.split("/")[-1] for k in pc if k.startswith("/layers/0/")} == {"wqkv", "wo", "w_down"} | gate_up
    assert "/lm_head" in pc and "/lm_head_q" not in pc
    assert pc["/layers/0/w_down"][0].shape == (256, 384)  # [N, K]: K = d_ff padded to 128
    for key in pc:
        np.testing.assert_array_equal(pc[key][0], po[key][0], err_msg=key)
        np.testing.assert_array_equal(pc[key][1], po[key][1], err_msg=key)
        tiled = tile_bn == 128 and key.split("/")[-1] in {"lm_head", "wqkv", *gate_up}
        assert pc[key][2] == po[key][2] == tiled, key
    np.testing.assert_array_equal(carried["layers"][1]["bqkv"], own["layers"][1]["bqkv"])


def test_llama_init_params_and_cache_layout():
    """``init_params`` takes the JAX package's branches (no ``pos_emb`` under
    RoPE, an ``lm_head`` when untied, SwiGLU weights without biases, k/v of
    the kv heads' width); the cache and a paged pool hold Hk heads;
    ``LLAMA_TINY`` is the JAX package's; a GELU config with GQA and RoPE
    runs its mega decode step through ``decode_block`` in every layer."""
    jcfg, tcfg = llama_configs(d_ff=344)
    jp = to_numpy(jdec.init_params(jax.random.PRNGKey(0), jcfg))
    tp = tdec.init_params(0, tcfg, device="cpu")

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        if isinstance(node, list):
            return [shapes(v) for v in node]
        return tuple(node.shape)

    assert shapes(tp) == shapes(jp)
    cache = tdec.init_cache(dataclasses.replace(tcfg, int8_kv=True), 3, 64, device="cpu")
    assert cache["k"][0].shape == (3, 2, 64, HD) and cache["k_scale"][0].shape == (3, 2, 64)
    pool = PagedServingEngine(tdec.quantize_params_int8(tp, device="cpu"), tcfg, max_batch=2, n_pages=3,
                              page_size=64, device="cpu").pool
    assert pool.k_pages[0].shape == (4, 2, 64, HD)
    tiny = {f.name: getattr(tdec.LLAMA_TINY, f.name) for f in dataclasses.fields(jdec.DecoderConfig)}
    assert tiny == {**{f.name: getattr(jdec.LLAMA_TINY, f.name) for f in dataclasses.fields(jdec.DecoderConfig)},
                    "dtype": torch.bfloat16}
    # d_ff 384: at 344 the int8 packs pad w_up's N, and neither package fuses the block.
    gelu = dataclasses.replace(tcfg, activation="gelu", mega=True, d_ff=384)
    params = tdec.quantize_params_int8(tdec.init_params(0, gelu, device="cpu"), device="cpu")
    cache = tdec.init_cache(gelu, 1, 64, device="cpu")
    _, cache = tdec.prefill(params, gelu, torch.tensor([[5, 7, 11]], dtype=torch.int32), cache)
    dispatch.reset_counters()
    logits, cache = tdec.forward(params, gelu, torch.tensor([[13]], dtype=torch.int32), cache)
    assert dispatch.PLAIN["decode_block"] == dispatch.PLAIN["decode_block:gqa"] == gelu.n_layers
    assert "decode_attention:gqa" not in dispatch.PLAIN and bool(torch.isfinite(logits).all())


def _step(jparams, jcfg, tparams, tcfg, chunk, jcache, tcache, **tkw):
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(chunk), jcache)
    tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(chunk), tcache, **tkw)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    return np.asarray(jlogits), tlogits, jcache, tcache


def _run_chunks(jparams, jcfg, tparams, tcfg, tokens, jcache, tcache, n_greedy):
    """The prompt chunks of ``tokens``, then ``n_greedy`` greedy steps (each
    package's argmax must agree) through both decoders."""
    for chunk in tokens:
        jl, tl, jcache, tcache = _step(jparams, jcfg, tparams, tcfg, chunk, jcache, tcache)
    for _ in range(n_greedy):
        nxt = jl[:, -1:].argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1:].argmax(-1).numpy(), nxt)
        jl, tl, jcache, tcache = _step(jparams, jcfg, tparams, tcfg, nxt, jcache, tcache)
    return jcache, tcache


def _assert_caches_equal(tcache, jcache, lens, int8):
    want = carry_cache(jcache, HD)
    for li in range(len(tcache["k"])):
        for key in ("k", "v", "k_scale", "v_scale") if int8 else ("k", "v"):
            for r, n in enumerate(lens):
                got, ref = tcache[key][li][r, :, :n].numpy(), want[key][li][r, :, :n].numpy()
                if key in ("k", "v") and int8:
                    np.testing.assert_array_equal(got, ref, err_msg=f"{key} {li} row {r}")
                else:
                    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg=f"{key} {li} row {r}")


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_llama_prompt_and_decode_match_jax(monkeypatch, llama, kv):
    """Two rows: a 12-token prompt as one forward (the prefill structure),
    a 3-token follow-up (the decode structure at T > 1: flash_attention, the
    GEMVs) and 3 greedy steps (decode_attention's unpacked GQA mode with the
    fused wo, or decode_attention_int8 in its GQA mode), on an f32 or int8
    cache, against ``jdec.forward`` under ``patch_jax_fused``: logits of
    every forward, the greedy tokens and the caches."""
    patch_jax_fused(monkeypatch)
    jcfg, tcfg, jparams, tparams = llama
    int8 = kv == "int8"
    jcfg, tcfg = dataclasses.replace(jcfg, int8_kv=int8), dataclasses.replace(tcfg, int8_kv=int8)
    tokens = np.random.default_rng(80).integers(0, tcfg.vocab_size, (2, 15)).astype(np.int32)
    jcache = jdec.init_cache(jcfg, 2, 64)
    tcache = carry_cache(jcache, HD)
    dispatch.reset_counters()
    jcache, tcache = _run_chunks(jparams, jcfg, tparams, tcfg, [tokens[:, :12], tokens[:, 12:]], jcache, tcache, 3)
    mode = "decode_attention_int8:gqa" if int8 else "decode_attention:gqa"
    assert dispatch.PLAIN[mode] == 3 * tcfg.n_layers
    assert dispatch.PLAIN["flash_attention"] == 2 * tcfg.n_layers
    assert "quant_mlp_int8" not in dispatch.PLAIN  # SwiGLU runs through no MLP kernel
    _assert_caches_equal(tcache, jcache, [18, 18], int8)


def test_llama_one_token_prompt_and_forward_without_cache(monkeypatch, llama):
    """A 1-token prompt per row (B·T = 2: the decode structure, the
    attention through decode_attention) and a cache-less forward of 3 rows
    of 4 (12 rows: the prefill structure)."""
    patch_jax_fused(monkeypatch)
    jcfg, tcfg, jparams, tparams = llama
    rng = np.random.default_rng(81)
    jcache = jdec.init_cache(jcfg, 2, 64)
    tcache = carry_cache(jcache, HD)
    first = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
    _run_chunks(jparams, jcfg, tparams, tcfg, [first], jcache, tcache, 2)
    tokens = rng.integers(0, tcfg.vocab_size, (3, 4)).astype(np.int32)
    _step(jparams, jcfg, tparams, tcfg, tokens, None, None)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_pages", "int8_pages"])
def test_llama_paged_decode_matches_jax(monkeypatch, llama, int8):
    """A decode step over a paged pool of Hk heads (pages of 64; rows at 5,
    70 and 0 tokens, the last on the scratch page): logits and every page
    after the append against ``jdec.forward`` on the same pool."""
    patch_jax_fused(monkeypatch)
    jcfg, tcfg, jparams, tparams = llama
    rng = np.random.default_rng(82 + int8)
    page, n_pages = 64, 6
    shape = (n_pages, tcfg.kv_heads, page, HD)
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
    jcache = {key: [jnp.asarray(jax_pages(p) if key in ("k_pages", "v_pages") else jax_scale_tiles(p, HD))
                    for p in leaves] for key, leaves in pool.items()}
    jcache.update(page_table=jnp.asarray(table), len=jnp.asarray(lens))
    tcache = {key: [torch.from_numpy(p.copy()) for p in leaves] for key, leaves in pool.items()}
    tcache.update(page_table=torch.from_numpy(table), len=torch.from_numpy(lens.copy()))
    tokens = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
    dispatch.reset_counters()
    _, _, jcache, tcache = _step(jparams, jcfg, tparams, tcfg, tokens, jcache, tcache)
    assert dispatch.PLAIN["paged_decode_attention_int8:gqa" if int8 else "paged_decode_attention:gqa"] == 2
    for li in range(tcfg.n_layers):
        for key in ("k_pages", "v_pages"):
            got, want = tcache[key][li].numpy(), port_pages(jcache[key][li], HD)
            if int8:
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        if int8:
            for key in ("k_scale_pages", "v_scale_pages"):
                np.testing.assert_allclose(tcache[key][li].numpy(), port_scale_pages(jcache[key][li], HD, page),
                                           rtol=1e-5, atol=0)


@pytest.mark.parametrize("fuse", [True, False], ids=["12_rows", "fuse_off"])
def test_llama_unfused_decode_step_matches_jax(monkeypatch, llama, fuse):
    """One token a row where the step is not fused: 12 rows (past the GEMV's
    8), or 2 rows with ``fuse=False`` (the JAX package's
    ``RTEN_DECODE_FUSE=0``). Both take ``decode_attention`` without its
    fused wo (the attention vector), then wo, gate|up and down through the
    prefill projections; rows at lengths 0-40."""
    patch_jax_fused(monkeypatch)
    if not fuse:
        monkeypatch.setenv("RTEN_DECODE_FUSE", "0")
    jcfg, tcfg, jparams, tparams = llama
    rng = np.random.default_rng(84)
    b = 12 if fuse else 2
    lens = rng.integers(0, 41, b).astype(np.int32)
    shape = (b, tcfg.kv_heads, 64, HD)
    jcache = {"k": [jnp.asarray(rng.standard_normal(shape).astype(np.float32)) for _ in range(tcfg.n_layers)],
              "v": [jnp.asarray(rng.standard_normal(shape).astype(np.float32)) for _ in range(tcfg.n_layers)],
              "len": jnp.asarray(lens)}
    tcache = carry_cache(jcache, HD)
    tokens = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    dispatch.reset_counters()
    _, _, jcache, tcache = _step(jparams, jcfg, tparams, tcfg, tokens, jcache, tcache, fuse=fuse)
    assert dispatch.PLAIN["decode_attention:no_wo"] == tcfg.n_layers
    assert "flash_attention" not in dispatch.PLAIN and "decode_attention:gqa" not in dispatch.PLAIN
    # At 2 rows the prefill projections hand off to the GEMV, as quant_matmul_int8 does at ≤ 8 rows.
    assert ("quant_gemv_int8" in dispatch.PLAIN) == (not fuse)
    _assert_caches_equal(tcache, jcache, lens + 1, False)


@pytest.mark.parametrize("tile_bn", [None, 128], ids=["untiled", "tiled128"])
def test_llama_w8a8_matches_jax(monkeypatch, tile_bn):
    """W8A8 at d_ff 384 (``w_gu``) against the JAX package's W8A8 path
    (``patch_jax_w8a8``): a 12-token prompt (``quant_matmul_w8a8``; the
    packs the JAX package tiles at 128, here ``w_gu``, every ``wqkv`` and
    the lm_head, stay weight-only), a 3-token follow-up and 3 greedy steps
    (every GEMV in its w8a8 mode, the wo fused into decode_attention
    weight-only)."""
    patch_jax_w8a8(monkeypatch)
    jcfg, tcfg = llama_configs(d_ff=384)
    tcfg = dataclasses.replace(tcfg, w8a8=True)
    jparams = jdec.quantize_params_int8(to_jax(llama_tree(0, 384)), tile_bn=tile_bn)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(85).integers(0, tcfg.vocab_size, (1, 15)).astype(np.int32)
    jcache = jdec.init_cache(jcfg, 1, 64)
    tcache = carry_cache(jcache, HD)
    dispatch.reset_counters()
    _run_chunks(jparams, jcfg, tparams, tcfg, [tokens[:, :12], tokens[:, 12:]], jcache, tcache, 3)
    tiled = tile_bn is not None
    # The prompt: per layer wqkv, wo, w_gu, w_down, and the lm_head.
    assert dispatch.PLAIN["quant_matmul_w8a8"] == (2 if tiled else 4) * tcfg.n_layers + (0 if tiled else 1)
    assert dispatch.PLAIN["quant_matmul_int8"] == (2 * tcfg.n_layers + 1 if tiled else 0)
    assert dispatch.PLAIN["quant_gemv_int8:w8a8"] > 0 and "quant_gemv_int8" not in dispatch.PLAIN
    assert dispatch.PLAIN["decode_attention:gqa"] == 3 * tcfg.n_layers


def _hf_check(tdense, jdense, tcfg, jcfg, hf, ids):
    """The HF float logits of ``ids`` [1, 12] against the port's int8
    decoder (an 8-token prefill, then 4 tokens one at a time) and the JAX
    package's int8 jnp path on the same state dict."""
    tparams = tdec.quantize_params_int8(tdense, device="cpu")
    cache = tdec.init_cache(tcfg, 1, 64, device="cpu")
    lg, cache = tdec.prefill(tparams, tcfg, torch.from_numpy(ids[:, :8].astype(np.int32)), cache)
    rows = [lg[0]]
    for i in range(8, 12):
        lg, cache = tdec.forward(tparams, tcfg, torch.from_numpy(ids[:, i : i + 1].astype(np.int32)), cache)
        rows.append(lg[0])
    tlogits = torch.cat(rows).numpy()
    jparams = jdec.quantize_params_int8(jdense)
    jlogits, _ = jdec.forward(jparams, jcfg, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(tlogits, np.asarray(jlogits)[0], atol=LOGIT_ATOL, rtol=0)
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids.astype(np.int64))).logits[0].numpy()
    err = np.abs(tlogits - ref).max()
    assert err < 0.05 * np.abs(ref).max(), err  # per-channel int8 keeps ~0.4% per weight


@pytest.mark.parametrize("qwen2", [False, True], ids=["llama", "qwen2_bias_tied"])
def test_from_hf_llama_matches_transformers_and_jax(qwen2):
    """``from_hf_llama`` of a ``LlamaForCausalLM`` built from a config in
    code (d_ff 344: K-padded ``w_down``); with ``qwen2`` the Qwen2
    conventions: q/k/v biases (``attention_bias``) and tied embeddings,
    which the converter copies into an ``lm_head``."""
    transformers = pytest.importorskip("transformers")
    jcfg, tcfg = llama_configs(d_ff=344)
    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=tcfg.vocab_size, hidden_size=tcfg.d_model, intermediate_size=tcfg.d_ff,
        num_hidden_layers=tcfg.n_layers, num_attention_heads=tcfg.n_heads, num_key_value_heads=tcfg.kv_heads,
        max_position_embeddings=tcfg.max_seq, rms_norm_eps=tcfg.layer_norm_eps, rope_theta=tcfg.rope_theta,
        attention_bias=qwen2, tie_word_embeddings=qwen2, initializer_range=0.08, attn_implementation="eager",
    )
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    if qwen2:
        with torch.no_grad():
            for layer in hf.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
                    proj.bias.normal_(0, 0.1)
    state = hf.state_dict()
    if qwen2:
        state = {k: v for k, v in state.items() if k != "lm_head.weight"}  # a tied checkpoint stores none
    tdense = tdec.from_hf_llama(state, tcfg, device="cpu")
    jdense = jdec.from_hf_llama(state, jcfg)
    assert ("bq" in tdense["layers"][0]) == qwen2
    for key in tdense["layers"][1]:
        if key not in ("ln1", "ln2"):
            np.testing.assert_array_equal(tdense["layers"][1][key].numpy(), np.asarray(jdense["layers"][1][key]))
    np.testing.assert_array_equal(tdense["lm_head"].numpy(), np.asarray(jdense["lm_head"]))
    ids = np.random.default_rng(86).integers(0, tcfg.vocab_size, (1, 12))
    _hf_check(tdense, jdense, tcfg, jcfg, hf, ids)


def test_from_hf_opt_matches_transformers_and_jax():
    """``from_hf_opt`` of an ``OPTForCausalLM`` (ReLU, learned positions at
    the offset of 2 rows, the tied head) built from a config in code."""
    transformers = pytest.importorskip("transformers")
    c = dict(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024, max_seq=64, pos_offset=2,
             activation="relu")
    jcfg, tcfg = jdec.DecoderConfig(**c, dtype=jnp.float32), tdec.DecoderConfig(**c, dtype=torch.float32)
    torch.manual_seed(0)
    hf_cfg = transformers.OPTConfig(
        vocab_size=500, hidden_size=256, ffn_dim=1024, num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, do_layer_norm_before=True, dropout=0.0, attention_dropout=0.0,
        activation_function="relu", word_embed_proj_dim=256, init_std=0.08,
    )
    hf = transformers.OPTForCausalLM(hf_cfg).eval()
    tdense = tdec.from_hf_opt(hf.state_dict(), tcfg, device="cpu")
    jdense = jdec.from_hf_opt(hf.state_dict(), jcfg)
    assert tdense["pos_emb"].shape == (66, 256) and "lm_head" not in tdense
    np.testing.assert_array_equal(tdense["layers"][0]["wq"].numpy(), np.asarray(jdense["layers"][0]["wq"]))
    ids = np.random.default_rng(87).integers(0, 500, (1, 12))
    _hf_check(tdense, jdense, tcfg, jcfg, hf, ids)


def _serve(engine, request_cls, specs):
    reqs = [engine.submit(request_cls(**spec)) for spec in specs]
    engine.run()
    return reqs


@pytest.mark.parametrize("engine,int8_kv", [("slot", False), ("paged", True)], ids=["slot_f32", "paged_int8"])
def test_llama_engines_match_jax(llama, engine, int8_kv):
    """Grouped-query streams through the slot engine (f32 KV) and the paged
    engine (int8 KV, pages of 64) against the JAX engines on the same
    requests: every greedy stream identical."""
    jcfg, tcfg, jparams, tparams = llama
    rng = np.random.default_rng(88)
    specs = [dict(prompt=[int(t) for t in rng.integers(1, 500, n)], max_new_tokens=m)
             for n, m in ((3, 6), (12, 5), (70, 4))]
    if engine == "slot":
        jcfg, tcfg = dataclasses.replace(jcfg, int8_kv=int8_kv), dataclasses.replace(tcfg, int8_kv=int8_kv)
        jeng = JServingEngine(jparams, jcfg, max_batch=3, seed=0)
        teng = ServingEngine(tparams, tcfg, max_batch=3, steps_per_tick=2, device="cpu")
    else:
        jeng = JPagedServingEngine(jparams, jcfg, max_batch=3, n_pages=6, page_size=64, seed=0, int8_kv=int8_kv)
        teng = PagedServingEngine(tparams, tcfg, max_batch=3, n_pages=6, page_size=64, int8_kv=int8_kv, device="cpu")
    jreqs = _serve(jeng, JRequest, specs)
    dispatch.reset_counters()
    treqs = _serve(teng, Request, specs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.finished and len(r.output) == s["max_new_tokens"] for r, s in zip(treqs, specs))
    mode = "paged_decode_attention_int8:gqa" if engine == "paged" else "decode_attention:gqa"
    assert dispatch.PLAIN[mode] > 0 and not dispatch.LAUNCHES
