"""The port's decoder (plain kernel versions, on the CPU) against the JAX
package's decoder on the same seeded parameters.

JAX runs its jnp path here (no TPU, so no fused kernels); the port runs the
fused T = 1 structure through its kernels' plain versions, a prompt one
token at a time. Both are f32. Tolerances: logits atol 1e-4 (same f32
arithmetic, another order; exact erf against the erf polynomial, 1.5e-7);
caches atol 1e-5; greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.models import decoder as jdec
from rten_tpu_torch.models import decoder as tdec
from torch_port_helpers import configs, dense_tree, to_jax, to_numpy, unfold

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    tree = dense_tree(0)
    jparams = jdec.quantize_params_int8(to_jax(tree), tile_bn=128)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _packs(node, path=""):
    """{path: (qt, s)} of every int8 pack in a port params tree."""
    out = {}
    if isinstance(node, dict):
        if "qt" in node:
            return {path: (node["qt"].numpy(), node["s"].numpy())}
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
    pc, po = _packs(carried), _packs(own)
    assert sorted(pc) == sorted(po) and "/lm_head_q" in pc and "/layers/0/wqkv" in pc
    for key in pc:
        np.testing.assert_array_equal(pc[key][0], po[key][0], err_msg=key)
        np.testing.assert_array_equal(pc[key][1], po[key][1], err_msg=key)
        assert pc[key][0].dtype == np.int8
    assert "slabs" not in carried
    for li in range(tcfg.n_layers):
        for key in ("bqkv", "bo", "b_up", "b_down"):
            np.testing.assert_array_equal(carried["layers"][li][key], own["layers"][li][key])
        for key in ("scale", "bias"):
            np.testing.assert_array_equal(
                carried["layers"][li]["ln1"][key], own["layers"][li]["ln1"][key]
            )
    np.testing.assert_array_equal(carried["tok_emb"], own["tok_emb"])


def test_prefill_matches_jax(models):
    """An 8-token prompt: JAX prefill (T = 8) against the port's
    token-at-a-time prefill — logits of every position and the caches."""
    jcfg, tcfg, jparams, tparams = models
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 8)).astype(np.int32)
    jcache = jdec.init_cache(jcfg, 1, 64)
    jlogits, jcache = jdec.prefill(jparams, jcfg, jnp.asarray(tokens), jcache)
    tcache = tdec.init_cache(tcfg, 1, 64, device="cpu")
    tlogits, tcache = tdec.prefill(tparams, tcfg, torch.from_numpy(tokens), tcache)
    assert tlogits.shape == (1, 8, tcfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    assert int(tcache["len"][0]) == int(jcache["len"][0]) == 8
    for li in range(tcfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                tcache[kv][li].numpy(), unfold(jcache[kv][li], tcfg.head_dim), atol=1e-5, rtol=0
            )


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


def test_forward_refuses_multi_token():
    _, tcfg = configs()
    params = tdec.quantize_params_int8(tdec.params_from_jax(dense_tree(0), tcfg, device="cpu"),
                                       device="cpu")
    cache = tdec.init_cache(tcfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 2"):
        tdec.forward(params, tcfg, torch.zeros((1, 2), dtype=torch.int32), cache)


def test_generate_greedy_past_cache_raises():
    """A full cache is refused before any kernel runs, on every device."""
    _, tcfg = configs()
    params = tdec.quantize_params_int8(tdec.params_from_jax(dense_tree(0), tcfg, device="cpu"),
                                       device="cpu")
    cache = tdec.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(IndexError, match="KV cache full"):
        tdec.generate_greedy(params, tcfg, cache, torch.zeros((1, 1), dtype=torch.int32), 9)
    assert cache["host_len"] == 8 and int(cache["len"][0]) == 8


def test_dense_params_are_refused():
    _, tcfg = configs()
    params = tdec.params_from_jax(dense_tree(0), tcfg, device="cpu")
    cache = tdec.init_cache(tcfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="quantize_params_int8"):
        tdec.forward(params, tcfg, torch.zeros((1, 1), dtype=torch.int32), cache)


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

    ids = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, 6)).astype(np.int32)
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
