"""The port's decode kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels run with ``interpret=True``.

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
from rten_tpu.kernels.decode_attention import decode_attention as jax_decode_attention
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels import quant_matmul as tqm
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


def test_wrappers_reject_mixed_devices(rng):
    q, s = _quant(rng, 256, 128)
    qt, st = _port_pack(q, s)
    with pytest.raises(ValueError):
        tqm.quant_gemv_int8(torch.zeros(1, 256, device="meta"), qt, st)
