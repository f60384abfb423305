"""The port's kernels (plain versions, on the CPU) against the JAX package's
Pallas kernels run with ``interpret=True``.

Inputs are made once with numpy from a seed and handed to both packages.
Tolerances: f32 cases agree to atol 1e-4 (the same f32 arithmetic in
another summation order); bf16 cases to one bf16 rounding of the output
(rtol 1e-2), since the two round the same f32 value at slightly different
sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import quant_matmul as jqm
from rten_tpu.kernels.attention import flash_attention as jax_flash_attention
from rten_tpu.kernels.decode_attention import decode_attention as jax_decode_attention
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels import quant_matmul as tqm
from rten_tpu_torch.kernels.attention import flash_attention
from rten_tpu_torch.kernels.decode_attention import decode_attention

ATOL = 1e-4


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _quant(rng, k, n, scale=0.2):
    return jqm.quantize_weights_int8(rng.standard_normal((k, n)).astype(np.float32) * scale)


def _port_pack(q, s):
    pack = tqm.int8_pack(q, s)
    return pack["qt"], pack["s"]


def test_quantizer_is_the_same_bits(rng):
    w = rng.standard_normal((256, 384)).astype(np.float32)
    w[:, 7] = 0.0  # an all-zero column gets scale 1
    qj, sj = jqm.quantize_weights_int8(w)
    qt, st = tqm.quantize_weights_int8(w)
    np.testing.assert_array_equal(qj, qt)
    np.testing.assert_array_equal(sj, st)


@pytest.mark.parametrize("epilogue", ["layernorm_bias", "gelu_residual", "rmsnorm", "relu_residual"])
def test_quant_gemv_matches_pallas(rng, epilogue):
    m, k, n = 2, 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) * 0.1
    ns = rng.uniform(0.5, 1.5, k).astype(np.float32)
    nb = rng.standard_normal(k).astype(np.float32) * 0.1
    resid = rng.standard_normal((m, n)).astype(np.float32)
    kw = {
        "layernorm_bias": dict(norm="layernorm", bias=bias),
        "gelu_residual": dict(norm="layernorm", bias=bias, activation="gelu", residual=resid),
        "rmsnorm": dict(norm="rmsnorm", norm_bias=None),
        "relu_residual": dict(norm=None, bias=bias, activation="relu", residual=resid),
    }[epilogue]
    norm = kw["norm"]
    jkw = dict(activation=kw.get("activation"), norm=norm, norm_eps=1e-5)
    tkw = dict(jkw)
    if norm is not None:
        jkw.update(norm_scale=jnp.asarray(ns), norm_bias=jnp.asarray(nb) if "norm_bias" not in kw else None)
        tkw.update(norm_scale=_t(ns), norm_bias=_t(nb) if "norm_bias" not in kw else None)
    if "residual" in kw:
        jkw["residual"] = jnp.asarray(resid)
        tkw["residual"] = _t(resid)
    b = kw.get("bias")
    ref = jqm.quant_gemv_int8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), None if b is None else jnp.asarray(b),
        block_n=128, interpret=True, **jkw,
    )
    qt, st = _port_pack(q, s)
    before = (dispatch.PLAIN["quant_gemv_int8"], dispatch.LAUNCHES["quant_gemv_int8"])
    out = tqm.quant_gemv_int8(_t(x), qt, st, None if b is None else _t(b), **tkw)
    assert (dispatch.PLAIN["quant_gemv_int8"], dispatch.LAUNCHES["quant_gemv_int8"]) == (
        before[0] + 1, before[1]
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_quant_gemv_tiled_pack(rng):
    """A tiled [S, K, bn] pack carries across by un-tiling."""
    k, n = 256, 512
    q, s = _quant(rng, k, n)
    tiled = np.asarray(jqm.tile_gemv_weights(q, 128))
    assert tiled.shape == (4, k, 128)
    x = rng.standard_normal((1, k)).astype(np.float32)
    ns = rng.uniform(0.5, 1.5, k).astype(np.float32)
    ref = jqm.quant_gemv_int8(
        jnp.asarray(x), jnp.asarray(tiled), jnp.asarray(s), norm="layernorm",
        norm_scale=jnp.asarray(ns), norm_bias=jnp.zeros(k), interpret=True,
    )
    qt, st = _port_pack(tiled, s)
    np.testing.assert_array_equal(qt.numpy(), q.T)
    out = tqm.quant_gemv_int8(_t(x), qt, st, norm="layernorm", norm_scale=_t(ns), norm_bias=torch.zeros(k))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_quant_gemv_argmax_tie_and_padded_vocab(rng):
    """Fused greedy argmax: columns ≥ argmax_n (vocab padding) are masked
    even when larger, and a tie between two stripes goes to the lower
    column, as in the TPU kernel's running argmax."""
    m, k, n, vocab = 2, 256, 512, 450
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[1] = 2.0 * x[0]  # both rows see the tie
    q[:, 10] = (np.sign(x[0]) * 100).astype(np.int8)  # a large positive logit...
    q[:, 300] = q[:, 480] = q[:, 10]  # ...tied by column 300 (stripe 2)
    s[10] = s[300] = 1.0
    s[480] = 10.0  # a padding column larger still
    ref = jqm.quant_gemv_int8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), argmax_n=vocab, block_n=128, interpret=True,
    )
    qt, st = _port_pack(q, s)
    out = tqm.quant_gemv_int8(_t(x), qt, st, argmax_n=vocab)
    np.testing.assert_array_equal(np.asarray(ref), [10, 10])
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_quant_gemv_bf16(rng):
    m, k, n = 1, 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ns = rng.uniform(0.5, 1.5, k).astype(np.float32)
    ref = jqm.quant_gemv_int8(
        xb, jnp.asarray(q), jnp.asarray(s), norm="layernorm", norm_scale=jnp.asarray(ns),
        norm_bias=jnp.zeros(k), interpret=True,
    )
    qt, st = _port_pack(q, s)
    out = tqm.quant_gemv_int8(
        _t(np.asarray(xb.astype(jnp.float32)), torch.bfloat16), qt, st, norm="layernorm",
        norm_scale=_t(ns), norm_bias=torch.zeros(k),
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=1e-2, atol=1e-2)


def _mlp_inputs(rng, m, d, ff, nq):
    wu, su = _quant(rng, d, ff)
    wd, sd = _quant(rng, ff, d)
    wq, sq = _quant(rng, d, nq)
    vec = lambda n, s=0.1: rng.standard_normal(n).astype(np.float32) * s  # noqa: E731
    return dict(
        wu=wu, su=su, wd=wd, sd=sd, wq=wq, sq=sq, bu=vec(ff), bd=vec(d), bq=vec(nq),
        ns=rng.uniform(0.5, 1.5, d).astype(np.float32), nb=vec(d),
        qns=rng.uniform(0.5, 1.5, d).astype(np.float32), qnb=vec(d),
        x=rng.standard_normal((m, d)).astype(np.float32),
        resid=rng.standard_normal((m, d)).astype(np.float32),
    )


@pytest.mark.parametrize("with_next_qkv", [False, True])
def test_quant_mlp_matches_pallas(rng, with_next_qkv):
    m, d, ff, nq = 2, 256, 1024, 768
    a = _mlp_inputs(rng, m, d, ff, nq)
    J = jnp.asarray
    jnext = (J(a["wq"]), J(a["sq"]), J(a["bq"]), J(a["qns"]), J(a["qnb"])) if with_next_qkv else None
    ref = jqm.quant_mlp_int8(
        J(a["x"]), J(a["wu"]), J(a["su"]), J(a["wd"]), J(a["sd"]), J(a["bu"]), J(a["bd"]),
        activation="gelu", norm="layernorm", norm_scale=J(a["ns"]), norm_bias=J(a["nb"]),
        residual=J(a["resid"]), next_qkv=jnext, interpret=True,
    )
    wu, su = _port_pack(a["wu"], a["su"])
    wd, sd = _port_pack(a["wd"], a["sd"])
    wq, sq = _port_pack(a["wq"], a["sq"])
    tnext = (wq, sq, _t(a["bq"]), _t(a["qns"]), _t(a["qnb"])) if with_next_qkv else None
    out = tqm.quant_mlp_int8(
        _t(a["x"]), wu, su, wd, sd, _t(a["bu"]), _t(a["bd"]), activation="gelu",
        norm="layernorm", norm_scale=_t(a["ns"]), norm_bias=_t(a["nb"]),
        residual=_t(a["resid"]), next_qkv=tnext,
    )
    if with_next_qkv:
        (out, qkv), (ref, ref_qkv) = out, ref
        assert qkv.shape == (m, nq)
        np.testing.assert_allclose(qkv.numpy(), np.asarray(ref_qkv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_decode_attention_matches_pallas(rng):
    """Packed q|k|v + fused wo + bias + residual at kv_len 0, 5 and 255
    (the last cache slot); the caches are updated in place and equal the
    Pallas kernel's returned caches."""
    lens = np.array([0, 5, 255], np.int32)
    b, h, s_max, d, dm = len(lens), 4, 256, 64, 256
    kc = rng.standard_normal((b, h, s_max, d)).astype(np.float32) * 0.3
    vc = rng.standard_normal((b, h, s_max, d)).astype(np.float32)
    flat = rng.standard_normal((b, 3 * h * d)).astype(np.float32) * 0.5
    wo_q, wo_s = _quant(rng, h * d, dm)
    bo = rng.standard_normal(dm).astype(np.float32) * 0.1
    resid = rng.standard_normal((b, dm)).astype(np.float32)

    ref, ref_k, ref_v = jax_decode_attention(
        None, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens), None, None,
        jnp.asarray(wo_q), jnp.asarray(wo_s), jnp.asarray(bo), jnp.asarray(resid),
        packed_qkv=jnp.asarray(flat).reshape(b, 3, h, 1, d), block_s=128, interpret=True,
    )
    k_cache, v_cache = _t(kc), _t(vc)
    wo_t, wo_st = _port_pack(wo_q, wo_s)
    out = decode_attention(
        _t(flat).view(b, 3, h, 1, d), k_cache, v_cache, _t(lens, torch.int32), wo_t, wo_st,
        _t(bo), residual=_t(resid),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(k_cache.numpy(), np.asarray(ref_k).reshape(b, h, s_max, d))
    np.testing.assert_array_equal(v_cache.numpy(), np.asarray(ref_v).reshape(b, h, s_max, d))


@pytest.mark.parametrize("act", [None, "gelu", "relu"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("m", [9, 130])
def test_quant_matmul_matches_pallas(rng, m, with_bias, act):
    """The prefill matmul at ragged M > 8 (one row past the GEMV's 8; a
    second 128-row block), with and without bias, for each epilogue
    activation."""
    k, n = 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) * 0.1 if with_bias else None
    ref = jqm.quant_matmul_int8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), None if bias is None else jnp.asarray(bias),
        activation=act, block_m=128, block_n=128, block_k=128, interpret=True,
    )
    qt, st = _port_pack(q, s)
    before = dict(dispatch.PLAIN)
    out = tqm.quant_matmul_int8(_t(x), qt, st, None if bias is None else _t(bias), activation=act)
    assert dispatch.PLAIN["quant_matmul_int8"] == before.get("quant_matmul_int8", 0) + 1
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_quant_matmul_hands_small_m_to_gemv(rng):
    """M ≤ 8 goes to the GEMV, as in the TPU function; f32 logits out."""
    m, k, n = 8, 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = jqm.quant_matmul_int8(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), activation="gelu",
                                interpret=True)
    qt, st = _port_pack(q, s)
    before = dict(dispatch.PLAIN)
    out = tqm.quant_matmul_int8(_t(x), qt, st, activation="gelu")
    assert dispatch.PLAIN["quant_gemv_int8"] == before.get("quant_gemv_int8", 0) + 1
    assert dispatch.PLAIN["quant_matmul_int8"] == before.get("quant_matmul_int8", 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


# (b, hq, hk, tq, s, causal, q_offset, kv_len): GPT-2's head dim 64 throughout.
FLASH_CASES = {
    "causal": (2, 2, 2, 64, 128, True, None, None),
    "non_causal": (1, 2, 2, 40, 128, False, None, [97]),
    "gqa": (1, 4, 2, 48, 128, True, None, None),
    "q_offset_kv_len": (2, 2, 2, 24, 256, True, [100, 7], [124, 31]),
    "ragged_tq": (1, 3, 3, 13, 128, True, [50], [63]),
    "kv_len_0_row": (2, 2, 1, 9, 128, True, [0, 60], [0, 69]),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_pallas(rng, case):
    b, hq, hk, tq, s, causal, q_offset, kv_len = FLASH_CASES[case]
    d = 64
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32) * 1.5
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32) * 1.5
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    j_off = None if q_offset is None else jnp.asarray(q_offset, jnp.int32)
    j_len = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              q_offset=j_off, kv_len=j_len, interpret=True)
    t_off = None if q_offset is None else torch.tensor(q_offset, dtype=torch.int32)
    t_len = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    before = dict(dispatch.PLAIN)
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=t_off, kv_len=t_len)
    assert dispatch.PLAIN["flash_attention"] == before.get("flash_attention", 0) + 1
    assert out.shape == (b, hq, tq, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if case == "kv_len_0_row":
        assert not out[0].any()  # l = 0: the row gives 0


def test_flash_attention_bf16_rounds_p(rng):
    """bf16 operands: P is rounded to bf16 before P.V, as in the Pallas
    kernel (one bf16 rounding of the output apart)."""
    b, h, tq, s, d = 1, 2, 16, 128, 64
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32) * 1.5
    k = rng.standard_normal((b, h, s, d)).astype(np.float32) * 1.5
    v = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kv_len = np.array([77], np.int32)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jax_flash_attention(qb, kb, vb, causal=True, q_offset=jnp.asarray([60], jnp.int32),
                              kv_len=jnp.asarray(kv_len), interpret=True)
    tb = [_t(np.asarray(a.astype(jnp.float32)), torch.bfloat16) for a in (qb, kb, vb)]
    out = flash_attention(*tb, causal=True, q_offset=torch.tensor([60], dtype=torch.int32),
                          kv_len=_t(kv_len, torch.int32))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=1e-2, atol=1e-2)


def test_wrappers_reject_mixed_devices(rng):
    q, s = _quant(rng, 256, 128)
    qt, st = _port_pack(q, s)
    with pytest.raises(ValueError):
        tqm.quant_gemv_int8(torch.zeros(1, 256, device="meta"), qt, st)


def test_prefill_wrappers_reject_mixed_devices(rng):
    q, s = _quant(rng, 256, 128)
    qt, st = _port_pack(q, s)
    with pytest.raises(ValueError):
        tqm.quant_matmul_int8(torch.zeros(16, 256, device="meta"), qt, st)
    k = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 2, 8, 64, device="meta"), k, k)
