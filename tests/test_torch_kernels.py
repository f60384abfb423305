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


def head_dim_params(cases, dims, keep=lambda values: True):
    """Parameters of each case (a tuple of values with its id) at head dim
    64, under the case's id, then of the cases ``keep`` selects at each of
    ``dims`` under ``id-d<D>``: the head dim last among the values."""
    return [pytest.param(*values, 64, id=name) for values, name in cases] + [
        pytest.param(*values, d, id=f"{name}-d{d}") for d in dims for values, name in cases if keep(values)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _quant(rng, k, n, scale=0.2):
    return jqm.quantize_weights_int8(rng.standard_normal((k, n)).astype(np.float32) * scale)


def _port_pack(q, s):
    pack = tqm.int8_pack(q, s, device="cpu")
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


# (b, hq, hk, tq, s, causal, q_offset, kv_len), at GPT-2's head dim 64 and
# at 16, 32 (instances of the CUDA kernel), 24 and 96 (run by it zero-filled);
# GQA, q_offset / kv_len and the non-causal case also above the widest
# instance, at 320 and 512 (run by it in slices of 256 columns).
FLASH_CASES = {
    "causal": (2, 2, 2, 64, 128, True, None, None),
    "non_causal": (1, 2, 2, 40, 128, False, None, [97]),
    "gqa": (1, 4, 2, 48, 128, True, None, None),
    "q_offset_kv_len": (2, 2, 2, 24, 256, True, [100, 7], [124, 31]),
    "ragged_tq": (1, 3, 3, 13, 128, True, [50], [63]),
    "kv_len_0_row": (2, 2, 1, 9, 128, True, [0, 60], [0, 69]),
}


@pytest.mark.parametrize("case,d", head_dim_params([((c,), c) for c in FLASH_CASES], [16, 32, 24, 96]) + [
    pytest.param(c, d, id=f"{c}-d{d}") for d in (320, 512) for c in ("gqa", "q_offset_kv_len", "non_causal")])
def test_flash_attention_matches_pallas(rng, case, d):
    b, hq, hk, tq, s, causal, q_offset, kv_len = FLASH_CASES[case]
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


# ---------------------------------------------------------------------------
# The KV kernels of the serving path: decode_attention_int8,
# paged_decode_attention, paged_decode_attention_int8
# ---------------------------------------------------------------------------


def _half_boundary_token(h, d):
    """A new token per head whose codes fall on .5 boundaries: head 0 has
    absmax 127 (scale 1), head 1 absmax 63.5 (scale 0.5); round half to
    even gives 2, -4, 0, 2, 0 where round half away would give 3, -4, 1, 2, -1."""
    x = np.zeros((h, d), np.float32)
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5]
    x[1, :6] = [63.5, 1.25, -1.75, 0.25, 0.75, -0.25]
    return x


def _new_tokens(rng, b, h, d):
    """q, k_new, v_new [B, H, 1, D] with row 1 on .5 boundaries."""
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32) * 1.2
    kn = rng.standard_normal((b, h, 1, d)).astype(np.float32) * 1.2
    vn = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    kn[1, :, 0], vn[1, :, 0] = _half_boundary_token(h, d), _half_boundary_token(h, d)[::-1]
    return q, kn, vn


def _scales_equal(port, jax_scales):
    """absmax / 127 to one f32 ulp: the port divides (IEEE, as numpy does),
    while XLA's CPU backend compiles the jitted division by 127 into a
    multiply by its reciprocal, one ulp off for a few percent of values."""
    np.testing.assert_allclose(port, jax_scales, rtol=1.2e-7, atol=0)


def _packed(q, kn, vn):
    return _t(np.stack([q, kn, vn], axis=1))  # [B, 3, H, 1, D]


def test_decode_attention_int8_matches_pallas(rng):
    """Rows at kv_len 0, 100 (new token on .5 boundaries) and 255 (the last
    position) of an int8 cache: the attention vector, and the appended
    codes and scales, against the Pallas kernel (scales through the JAX
    package's unpack_kv_scales)."""
    from rten_tpu.kernels.decode_attention import decode_attention_int8 as jax_int8, pack_kv_scales

    from rten_tpu_torch.kernels.decode_attention import decode_attention_int8
    from torch_port_helpers import port_scales

    lens = np.array([0, 100, 255], np.int32)
    b, h, s, d = len(lens), 4, 256, 64
    kq = rng.integers(-127, 128, (b, h, s, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, h, s, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, h, s)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, h, s)).astype(np.float32)
    q, kn, vn = _new_tokens(rng, b, h, d)
    out, k2, v2, ks2, vs2 = jax_int8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), pack_kv_scales(jnp.asarray(ks[..., None]), d),
        pack_kv_scales(jnp.asarray(vs[..., None]), d), jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn),
        interpret=True,
    )
    caches = [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)]
    before = dispatch.PLAIN["decode_attention_int8"]
    attn = decode_attention_int8(_packed(q, kn, vn), *caches, _t(lens, torch.int32))
    assert dispatch.PLAIN["decode_attention_int8"] == before + 1
    np.testing.assert_allclose(attn.numpy(), np.asarray(out).reshape(b, h * d), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(caches[0].numpy(), np.asarray(k2).reshape(b, h, s, d))
    np.testing.assert_array_equal(caches[1].numpy(), np.asarray(v2).reshape(b, h, s, d))
    _scales_equal(caches[2].numpy(), port_scales(ks2, d))
    _scales_equal(caches[3].numpy(), port_scales(vs2, d))
    # Round half to even at the boundaries (head 0: scale 1; head 1: scale 0.5).
    np.testing.assert_array_equal(caches[0][1, 0, 100, :6].numpy(), [127, 2, -4, 0, 2, 0])
    np.testing.assert_array_equal(caches[0][1, 1, 100, :6].numpy(), [127, 2, -4, 0, 2, 0])
    assert caches[2][1, 0, 100] == 1.0 and caches[2][1, 1, 100] == 0.5


# Paged case: pages of 64 positions, 3 table columns, a pool of 12 pages
# whose last (11) is the scratch page; rows at kv_len 0 (all scratch), 63
# (last slot of its first page), 64 (first slot of the second), 150 and 191
# (the table's last position), their pages scattered through the pool.
PAGED_LENS = [0, 63, 64, 150, 191]
PAGED_TABLE = [[11, 11, 11], [3, 11, 11], [7, 2, 11], [5, 0, 9], [10, 1, 8]]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_layout_f32", "int8"])
def test_paged_attention_matches_pallas(rng, int8):
    """Paged decode attention (bf16/f32 pages or int8 pages with scale
    pages) against the Pallas kernel: the attention vector, and every page
    after the in-place append (a row at length 0 writes only the scratch
    page)."""
    from rten_tpu.kernels import paged_attention as jpa

    from rten_tpu_torch.kernels import paged_attention as tpa
    from torch_port_helpers import jax_pages, jax_scale_tiles, port_pages, port_scale_pages

    lens, table = np.array(PAGED_LENS, np.int32), np.array(PAGED_TABLE, np.int32)
    b, h, d, page, n_pages = len(lens), 4, 64, 64, 12
    shape = (n_pages, h, page, d)
    q, kn, vn = _new_tokens(rng, b, h, d)
    if int8:
        kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ksp, vsp = (rng.uniform(0.005, 0.02, shape[:3]).astype(np.float32) for _ in range(2))
        out, kp2, vp2, ksp2, vsp2 = jpa.paged_decode_attention_int8(
            jnp.asarray(q), jnp.asarray(jax_pages(kp)), jnp.asarray(jax_pages(vp)),
            jnp.asarray(jax_scale_tiles(ksp, d)), jnp.asarray(jax_scale_tiles(vsp, d)), jnp.asarray(table),
            jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        )
        pool = [torch.from_numpy(a.copy()) for a in (kp, vp, ksp, vsp)]
        fn, name = tpa.paged_decode_attention_int8, "paged_decode_attention_int8"
    else:
        kp = rng.standard_normal(shape).astype(np.float32) * 1.2
        vp = rng.standard_normal(shape).astype(np.float32)
        out, kp2, vp2 = jpa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(jax_pages(kp)), jnp.asarray(jax_pages(vp)), jnp.asarray(table),
            jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        )
        pool = [torch.from_numpy(a.copy()) for a in (kp, vp)]
        fn, name = tpa.paged_decode_attention, "paged_decode_attention"
    before = dispatch.PLAIN[name]
    attn = fn(_packed(q, kn, vn), *pool, _t(table, torch.int32), _t(lens, torch.int32))
    assert dispatch.PLAIN[name] == before + 1
    np.testing.assert_allclose(attn.numpy(), np.asarray(out).reshape(b, h * d), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pool[0].numpy(), port_pages(kp2, d))
    np.testing.assert_array_equal(pool[1].numpy(), port_pages(vp2, d))
    if int8:
        _scales_equal(pool[2].numpy(), port_scale_pages(ksp2, d, page))
        _scales_equal(pool[3].numpy(), port_scale_pages(vsp2, d, page))
        np.testing.assert_array_equal(pool[0][3, 0, 63, :6].numpy(), [127, 2, -4, 0, 2, 0])
    # Only the appended slots changed: the scratch page's slot 0 and each
    # live row's slot of kv_len.
    changed = np.argwhere((pool[0].numpy() != kp).any(-1).any(1))
    assert {tuple(x) for x in changed} <= {(11, 0), (3, 63), (2, 0), (9, 22), (8, 63)}


# ---------------------------------------------------------------------------
# W8A8: quantize_rows_int8, the w8a8 modes of quant_gemv_int8 and
# quant_mlp_int8, quant_matmul_w8a8 (the Pallas kernels at w_convert="w8a8")
# ---------------------------------------------------------------------------

# Both packages sum the same int8 codes exactly, so outputs differ only by
# f32 rounding: the JAX package's sx may sit one ulp off (see
# _scales_equal), and GELU's exp. Where a norm runs first its f32 rows
# differ between the packages in the last bits, which can move a code by
# one: one code's contribution is added, |w| · sx · scale ≤ 127 · max(scale)
# · absmax / 127. bf16 outputs may also round to the neighbouring bf16
# value: 2^-7 of each value.
W8_RTOL = 1e-5
BF16_ULP = 2.0**-7


def _code(scales, rows):
    """One activation code's largest contribution to an output."""
    return float(np.max(scales)) * float(np.abs(rows).max())


def _w8_tol(ref, code=0.0):
    return W8_RTOL * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max())) + code


def _np_norm(x, norm, ns, nb, eps=1e-5):
    x = x.astype(np.float64)
    if norm == "rmsnorm":
        y = x / np.sqrt((x * x).mean(-1, keepdims=True) + eps)
    else:
        xc = x - x.mean(-1, keepdims=True)
        y = xc / np.sqrt((xc * xc).mean(-1, keepdims=True) + eps)
    return y * ns + (0 if nb is None else nb)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_matches_act_quantize(rng, dtype):
    """Codes bit for bit and sx to one ulp against the JAX package's
    ``_act_quantize``; an all-zero row gets sx 1, and codes on .5
    boundaries round half to even (row 0: absmax 127, sx exactly 1)."""
    x = rng.standard_normal((6, 256)).astype(np.float32) * 3
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5]
    x[3] = 0.0
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    jq, jsx = jqm._act_quantize(jnp.asarray(x))
    tx = _t(x, torch.bfloat16 if dtype == "bf16" else torch.float32)
    before = dispatch.PLAIN["quantize_rows_int8"]
    codes, sx = tqm.quantize_rows_int8(tx)
    assert dispatch.PLAIN["quantize_rows_int8"] == before + 1
    assert codes.dtype == torch.int8 and codes.shape == (6, 256) and sx.shape == (6, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jq).astype(np.int8))
    _scales_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(codes[0, :6].numpy(), [127, 2, -4, 0, 2, 0])
    assert sx[0, 0] == 1.0 and sx[3, 0] == 1.0 and not codes[3].any()


# name: (m, activation dtype, norm, bias, activation, residual)
GEMV_W8_CASES = {
    "m1_f32_layernorm_bias": (1, "f32", "layernorm", True, None, False),
    "m3_f32_rmsnorm": (3, "f32", "rmsnorm", False, None, False),
    "m8_f32_bias_relu_residual_zero_row": (8, "f32", None, True, "relu", True),
    "m1_bf16_layernorm_gelu_residual": (1, "bf16", "layernorm", True, "gelu", True),
    "m3_bf16_bias": (3, "bf16", None, True, None, False),
    "m8_bf16_rmsnorm_bias_gelu": (8, "bf16", "rmsnorm", True, "gelu", False),
}


@pytest.mark.parametrize("case", list(GEMV_W8_CASES))
def test_quant_gemv_w8a8_matches_pallas(rng, case):
    """The decode GEMV's w8a8 mode against the Pallas kernel: the f32 rows
    (normalized when a norm runs, never rounded to bf16) quantized per row;
    bf16 outputs to one bf16 rounding (rtol 1e-2)."""
    m, dt, norm, with_bias, act, with_res = GEMV_W8_CASES[case]
    k, n = 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if m == 8:
        x[5] = 0.0  # an all-zero row: sx 1, codes 0
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dt == "bf16" else (jnp.float32, torch.float32)
    x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    bias = rng.standard_normal(n).astype(np.float32) * 0.1 if with_bias else None
    ns = rng.uniform(0.5, 1.5, k).astype(np.float32)
    nb = rng.standard_normal(k).astype(np.float32) * 0.1 if norm == "layernorm" else None
    resid = np.asarray(jnp.asarray(rng.standard_normal((m, n)), jdt).astype(jnp.float32)) if with_res else None
    jkw = dict(activation=act, norm=norm)
    tkw = dict(jkw)
    if norm is not None:
        jkw.update(norm_scale=jnp.asarray(ns), norm_bias=None if nb is None else jnp.asarray(nb))
        tkw.update(norm_scale=_t(ns), norm_bias=None if nb is None else _t(nb))
    if with_res:
        jkw["residual"], tkw["residual"] = jnp.asarray(resid, jdt), _t(resid, tdt)
    ref = jqm.quant_gemv_int8(
        jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s), None if bias is None else jnp.asarray(bias),
        block_n=128, w_convert="w8a8", interpret=True, **jkw,
    )
    before = dispatch.PLAIN["quant_gemv_int8:w8a8"]
    out = tqm.quant_gemv_int8(_t(x, tdt), *_port_pack(q, s), None if bias is None else _t(bias), w8a8=True, **tkw)
    assert dispatch.PLAIN["quant_gemv_int8:w8a8"] == before + 1
    assert out.dtype == tdt and out.shape == (m, n)
    ref = np.asarray(ref.astype(jnp.float32))
    tol = _w8_tol(ref, _code(s, _np_norm(x, norm, ns, nb)) if norm else 0.0)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=BF16_ULP if dt == "bf16" else 0)


@pytest.mark.parametrize("m", [1, 8])
def test_quant_gemv_w8a8_argmax_tiled_padded_vocab(rng, m):
    """w8a8 through the lm_head's configuration: a tiled [S, K, bn] pack
    carried across, the final layernorm fused, and the greedy argmax over
    a padded vocabulary: tokens identical to the Pallas kernel's."""
    k, n, vocab = 256, 512, 450
    q, s = _quant(rng, k, n)
    s[480] = 10.0  # a padding column larger than any logit
    x = rng.standard_normal((m, k)).astype(np.float32)
    ns = rng.uniform(0.5, 1.5, k).astype(np.float32)
    tiled = np.asarray(jqm.tile_gemv_weights(q, 128))
    ref = jqm.quant_gemv_int8(
        jnp.asarray(x), jnp.asarray(tiled), jnp.asarray(s), norm="layernorm", norm_scale=jnp.asarray(ns),
        norm_bias=jnp.zeros(k), argmax_n=vocab, w_convert="w8a8", interpret=True,
    )
    pack = tqm.int8_pack(tiled, s, device="cpu")
    assert pack["tiled"]
    out = tqm.quant_gemv_int8(_t(x), pack["qt"], pack["s"], norm="layernorm", norm_scale=_t(ns),
                              norm_bias=torch.zeros(k), argmax_n=vocab, w8a8=True)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype,with_next_qkv", [("f32", False), ("f32", True), ("bf16", True)])
def test_quant_mlp_w8a8_matches_pallas(rng, dtype, with_next_qkv):
    """The MLP's w8a8 mode against the Pallas kernel: each of up, down and
    the next qkv quantizes its f32 input per row (the normalized rows, the
    f32 up output over FF, the normalized f32 block output). Tolerance:
    one code's contribution per quantized phase feeding the output (the
    f32 rows differ in the last bits between the packages), bf16 one
    rounding more."""
    m, d, ff, nq = 2, 256, 1024, 768
    a = _mlp_inputs(rng, m, d, ff, nq)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    J = jnp.asarray
    x = np.asarray(J(a["x"], jdt).astype(jnp.float32))
    resid = np.asarray(J(a["resid"], jdt).astype(jnp.float32))
    jnext = (J(a["wq"]), J(a["sq"]), J(a["bq"]), J(a["qns"]), J(a["qnb"])) if with_next_qkv else None
    ref = jqm.quant_mlp_int8(
        J(x, jdt), J(a["wu"]), J(a["su"]), J(a["wd"]), J(a["sd"]), J(a["bu"]), J(a["bd"]),
        activation="gelu", norm="layernorm", norm_scale=J(a["ns"]), norm_bias=J(a["nb"]),
        residual=J(resid, jdt), next_qkv=jnext, w_convert="w8a8", interpret=True,
    )
    wu, su = _port_pack(a["wu"], a["su"])
    wd, sd = _port_pack(a["wd"], a["sd"])
    wq, sq = _port_pack(a["wq"], a["sq"])
    tnext = (wq, sq, _t(a["bq"]), _t(a["qns"]), _t(a["qnb"])) if with_next_qkv else None
    before = dispatch.PLAIN["quant_mlp_int8:w8a8"]
    out = tqm.quant_mlp_int8(
        _t(x, tdt), wu, su, wd, sd, _t(a["bu"]), _t(a["bd"]), activation="gelu",
        norm="layernorm", norm_scale=_t(a["ns"]), norm_bias=_t(a["nb"]),
        residual=_t(resid, tdt), next_qkv=tnext, w8a8=True,
    )
    assert dispatch.PLAIN["quant_mlp_int8:w8a8"] == before + 1
    outs, refs = (out, ref) if with_next_qkv else ((out,), (ref,))
    xn = _np_norm(x, "layernorm", a["ns"], a["nb"])
    up = xn @ (a["wu"].astype(np.float64) * a["su"])
    codes = _code(a["su"], xn) + _code(a["sd"], up)
    for o, r, code in zip(outs, refs, (codes, 2 * codes)):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(o.float().numpy(), r, atol=_w8_tol(r, code), rtol=BF16_ULP if dtype == "bf16" else 0)


# (m, bias, activation): M ≤ 8 hands off to the w8a8 GEMV; 9 is one row past
# it; 130 crosses a second 128-row Pallas block.
MATMUL_W8_CASES = [(1, True, "gelu"), (8, False, None), (9, True, "relu"), (9, False, "gelu"),
                   (64, True, None), (64, False, "relu"), (130, True, "gelu"), (130, False, None)]


@pytest.mark.parametrize("m,with_bias,act", MATMUL_W8_CASES,
                         ids=[f"m{m}_{'bias' if b else 'no_bias'}_{a}" for m, b, a in MATMUL_W8_CASES])
def test_quant_matmul_w8a8_matches_pallas(rng, m, with_bias, act):
    """The prefill matmul in W8A8 mode against ``_q8_kernel`` (no norm: the
    same codes, the same exact sums, f32 rounding apart)."""
    k, n = 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) * 0.1 if with_bias else None
    ref = jqm.quant_matmul_w8a8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), None if bias is None else jnp.asarray(bias),
        activation=act, block_m=128, block_n=128, block_k=128, interpret=True,
    )
    name = "quant_gemv_int8:w8a8" if m <= 8 else "quant_matmul_w8a8"
    before = dispatch.PLAIN[name]
    out = tqm.quant_matmul_w8a8(_t(x), *_port_pack(q, s), None if bias is None else _t(bias), activation=act)
    assert dispatch.PLAIN[name] == before + 1
    assert out.shape == (m, n) and out.dtype == torch.float32
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=_w8_tol(ref), rtol=0)


# ---------------------------------------------------------------------------
# The KV kernels' modes of Llama/Qwen2-class models: unpacked q | k_new |
# v_new operands, grouped-query heads (Hq = group · Hk, group 1, 2 and 7),
# and decode_attention without its fused wo. Each plain version against the
# Pallas kernel in interpret mode; caches, pages and scales after the append.
# ---------------------------------------------------------------------------

GROUPS = [1, 2, 7]


def _gqa_tokens(rng, b, hq, hk, d):
    """q [B, Hq, 1, D], k_new and v_new [B, Hk, 1, D], row 1 of k/v on .5
    boundaries (int8 rounding) where Hk ≥ 2."""
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32) * 1.2
    kn = rng.standard_normal((b, hk, 1, d)).astype(np.float32) * 1.2
    vn = rng.standard_normal((b, hk, 1, d)).astype(np.float32)
    if hk >= 2:
        kn[1, :2, 0], vn[1, :2, 0] = _half_boundary_token(2, d), _half_boundary_token(2, d)[::-1]
    return q, kn, vn


def _ops(q, kn, vn):
    """The port's unpacked operands [B, H, D] of [B, H, 1, D] arrays."""
    return _t(q[:, :, 0]), _t(kn[:, :, 0]), _t(vn[:, :, 0])


@pytest.mark.parametrize("group,with_wo,d", head_dim_params(
    [((g, w), f"{g}-{'fused_wo' if w else 'no_wo'}") for w in (True, False) for g in GROUPS], [16, 32, 8],
    keep=lambda values: values[0] != 2))
def test_decode_attention_gqa_matches_pallas(rng, group, with_wo, d):
    """``decode_attention`` on unpacked operands with ``group`` query heads
    a kv head, rows at kv_len 0, 5 and 255: with the fused wo + bias +
    residual (the decode step of every RoPE / GQA model), and without it
    (the attention vector of the unfused step); the caches in place. Head
    dims 64, 16, 32 and 8 (the JAX rule admits each at S 256)."""
    lens = np.array([0, 5, 255], np.int32)
    b, hk, s_max, dm = len(lens), 2, 256, 256
    hq = group * hk
    kc = rng.standard_normal((b, hk, s_max, d)).astype(np.float32) * 0.3
    vc = rng.standard_normal((b, hk, s_max, d)).astype(np.float32)
    q, kn, vn = _gqa_tokens(rng, b, hq, hk, d)
    wo = ()
    if with_wo:
        wo_q, wo_s = _quant(rng, hq * d, dm)
        bo = rng.standard_normal(dm).astype(np.float32) * 0.1
        resid = rng.standard_normal((b, dm)).astype(np.float32)
        wo = (jnp.asarray(wo_q), jnp.asarray(wo_s), jnp.asarray(bo), jnp.asarray(resid))
    ref, ref_k, ref_v = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn),
        *wo, block_s=128, interpret=True,
    )
    k_cache, v_cache = _t(kc), _t(vc)
    port_wo = (*_port_pack(wo_q, wo_s), _t(bo)) if with_wo else ()
    name = "decode_attention" + ("" if group == 1 else ":gqa") if with_wo else "decode_attention:no_wo"
    before = dispatch.PLAIN[name]
    out = decode_attention(_ops(q, kn, vn), k_cache, v_cache, _t(lens, torch.int32), *port_wo,
                           residual=_t(resid) if with_wo else None)
    assert dispatch.PLAIN[name] == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(out.shape), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(k_cache.numpy(), np.asarray(ref_k).reshape(b, hk, s_max, d))
    np.testing.assert_array_equal(v_cache.numpy(), np.asarray(ref_v).reshape(b, hk, s_max, d))


@pytest.mark.parametrize("group,d", head_dim_params([((g,), str(g)) for g in GROUPS], [32, 16],
                                                    keep=lambda values: values[0] != 2))
def test_decode_attention_int8_gqa_matches_pallas(rng, group, d):
    """``decode_attention_int8`` with ``group`` query heads a kv head: the
    attention vector, and the codes and scales appended once per kv head.
    Head dims 64, 32 and 16 at the S and block the JAX rule needs for each
    (its scale tiles: block · D a multiple of 16384)."""
    from rten_tpu.kernels.decode_attention import decode_attention_int8 as jax_int8, pack_kv_scales

    from rten_tpu_torch.kernels.decode_attention import decode_attention_int8
    from torch_port_helpers import port_scales

    s = 16384 // d if d < 64 else 256
    lens = np.array([0, 100, s - 1], np.int32)
    b, hk = len(lens), 2
    hq = group * hk
    kq, vq = (rng.integers(-127, 128, (b, hk, s, d)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, (b, hk, s)).astype(np.float32) for _ in range(2))
    q, kn, vn = _gqa_tokens(rng, b, hq, hk, d)
    out, k2, v2, ks2, vs2 = jax_int8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), pack_kv_scales(jnp.asarray(ks[..., None]), d),
        pack_kv_scales(jnp.asarray(vs[..., None]), d), jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn),
        block_s=min(s, 256 if d == 64 else s), interpret=True,
    )
    caches = [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)]
    name = "decode_attention_int8" + ("" if group == 1 else ":gqa")
    before = dispatch.PLAIN[name]
    attn = decode_attention_int8(_ops(q, kn, vn), *caches, _t(lens, torch.int32))
    assert dispatch.PLAIN[name] == before + 1
    np.testing.assert_allclose(attn.numpy(), np.asarray(out).reshape(b, hq * d), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(caches[0].numpy(), np.asarray(k2).reshape(b, hk, s, d))
    np.testing.assert_array_equal(caches[1].numpy(), np.asarray(v2).reshape(b, hk, s, d))
    _scales_equal(caches[2].numpy(), port_scales(ks2, d))
    _scales_equal(caches[3].numpy(), port_scales(vs2, d))
    np.testing.assert_array_equal(caches[0][1, 0, 100, :6].numpy(), [127, 2, -4, 0, 2, 0])


def _paged_rows(rng, page: int, b: int = 5):
    """(lens, table, n_pages): ``PAGED_LENS`` / ``PAGED_TABLE`` at pages
    of 64; at other pages, rows at 0 (all scratch), page - 1, page, the
    middle and the last position of at least 192 positions, their pages
    scattered through the pool (the last page the scratch page)."""
    if page == 64:
        return np.array(PAGED_LENS, np.int32), np.array(PAGED_TABLE, np.int32), 12
    cols = max(3, -(-192 // page))
    cap = cols * page
    table = rng.permutation(b * cols).astype(np.int32).reshape(b, cols)
    table[0] = b * cols
    return np.array([0, page - 1, page, cap // 2 + 5, cap - 1], np.int32), table, b * cols + 1


# (group, int8, head dim, page): pages of 64 at head dim 64, and the JAX
# rules' smallest pages at 64, 32 and 16 (pages of 16 at 64, 32 at 32), the
# other head dims at MHA and Qwen2's group of 7.
PAGED_GQA = [pytest.param(g, i, 64, 64, id=f"{g}-{'int8' if i else 'f32'}") for i in (False, True) for g in GROUPS] + [
    pytest.param(g, i, d, page, id=f"{g}-{'int8' if i else 'f32'}-d{d}-page{page}")
    for i, d, page in ((False, 64, 16), (False, 32, 32), (False, 16, 64), (True, 32, 128), (True, 16, 256))
    for g in GROUPS if g != 2]


@pytest.mark.parametrize("group,int8,d,page", PAGED_GQA)
def test_paged_attention_gqa_matches_pallas(rng, group, int8, d, page):
    """``paged_decode_attention`` and its int8 twin with ``group`` query
    heads a kv head over pages of 64 (``PAGED_TABLE``) and the smallest
    pages the JAX rules admit at head dims 64, 32 and 16: the attention
    vector and every page after the append."""
    from rten_tpu.kernels import paged_attention as jpa

    from rten_tpu_torch.kernels import paged_attention as tpa
    from torch_port_helpers import jax_pages, jax_scale_tiles, port_pages, port_scale_pages

    lens, table, n_pages = _paged_rows(rng, page)
    b, hk = len(lens), 2
    hq = group * hk
    shape = (n_pages, hk, page, d)
    q, kn, vn = _gqa_tokens(rng, b, hq, hk, d)
    if int8:
        kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ksp, vsp = (rng.uniform(0.005, 0.02, shape[:3]).astype(np.float32) for _ in range(2))
        out, kp2, vp2, ksp2, vsp2 = jpa.paged_decode_attention_int8(
            jnp.asarray(q), jnp.asarray(jax_pages(kp)), jnp.asarray(jax_pages(vp)),
            jnp.asarray(jax_scale_tiles(ksp, d)), jnp.asarray(jax_scale_tiles(vsp, d)), jnp.asarray(table),
            jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        )
        pool = [torch.from_numpy(a.copy()) for a in (kp, vp, ksp, vsp)]
        fn, name = tpa.paged_decode_attention_int8, "paged_decode_attention_int8"
    else:
        kp = rng.standard_normal(shape).astype(np.float32) * 1.2
        vp = rng.standard_normal(shape).astype(np.float32)
        out, kp2, vp2 = jpa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(jax_pages(kp)), jnp.asarray(jax_pages(vp)), jnp.asarray(table),
            jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn), interpret=True,
        )
        pool = [torch.from_numpy(a.copy()) for a in (kp, vp)]
        fn, name = tpa.paged_decode_attention, "paged_decode_attention"
    name += "" if group == 1 else ":gqa"
    before = dispatch.PLAIN[name]
    attn = fn(_ops(q, kn, vn), *pool, _t(table, torch.int32), _t(lens, torch.int32))
    assert dispatch.PLAIN[name] == before + 1
    np.testing.assert_allclose(attn.numpy(), np.asarray(out).reshape(b, hq * d), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pool[0].numpy(), port_pages(kp2, d))
    np.testing.assert_array_equal(pool[1].numpy(), port_pages(vp2, d))
    if int8:
        _scales_equal(pool[2].numpy(), port_scale_pages(ksp2, d, page))
        _scales_equal(pool[3].numpy(), port_scale_pages(vsp2, d, page))


def test_packed_and_unpacked_operands_agree(rng):
    """The packed MHA operand is three views of one tensor: the same call on
    those views, made contiguous, gives the same bits and caches."""
    lens = np.array([3, 40], np.int32)
    b, h, s, d = 2, 4, 64, 64
    flat = _t(rng.standard_normal((b, 3, h, 1, d)).astype(np.float32))
    kc = _t(rng.standard_normal((b, h, s, d)).astype(np.float32))
    vc = _t(rng.standard_normal((b, h, s, d)).astype(np.float32))
    caches = [(kc.clone(), vc.clone()) for _ in range(2)]
    packed = decode_attention(flat, *caches[0], _t(lens, torch.int32))
    ops = tuple(flat[:, i, :, 0].contiguous() for i in range(3))
    unpacked = decode_attention(ops, *caches[1], _t(lens, torch.int32))
    assert torch.equal(packed, unpacked) and packed.shape == (b, h * d)
    assert torch.equal(caches[0][0], caches[1][0]) and torch.equal(caches[0][1], caches[1][1])
    with pytest.raises(ValueError, match="multiple of Hk"):
        decode_attention((ops[0][:, :3], ops[1][:, :2], ops[2][:, :2]), *caches[0], _t(lens, torch.int32))
