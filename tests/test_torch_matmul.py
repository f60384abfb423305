"""``matmul_fused`` and the silu / sigmoid / tanh epilogues of the port's
kernels (plain versions, on the CPU) against the JAX package's Pallas
kernels run with ``interpret=True``.

Inputs are made once with numpy from a seed and handed to both packages.
Tolerances: ``matmul_fused`` 1e-5 relative to the output's largest value
(the same f32 products summed in another order; XLA's and PyTorch's
sigmoid and tanh differ by a few ulp); the epilogues as the existing kernel
tests (f32 atol 1e-4; W8A8 one activation code's contribution).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import quant_matmul as jqm
from rten_tpu.kernels.matmul_pallas import matmul_fused as jax_matmul_fused
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels import quant_matmul as tqm
from rten_tpu_torch.kernels.activations import ACTIVATION_CODES
from rten_tpu_torch.kernels.matmul import matmul_fused

ATOL = 1e-4
NEW_ACTS = ["silu", "sigmoid", "tanh"]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _quant(rng, k, n, scale=0.2):
    return jqm.quantize_weights_int8(rng.standard_normal((k, n)).astype(np.float32) * scale)


def _port_pack(q, s):
    pack = tqm.int8_pack(q, s, device="cpu")
    return pack["qt"], pack["s"]


def _np_layernorm(x, scale, bias, eps=1e-5):
    x = x.astype(np.float64)
    xc = x - x.mean(-1, keepdims=True)
    return xc / np.sqrt((xc * xc).mean(-1, keepdims=True) + eps) * scale + bias


def test_activation_codes_cover_the_tpu_table():
    """The port's table has every activation of the TPU's ``_ACTIVATIONS``,
    each with its own kernel code."""
    from rten_tpu.kernels.matmul_pallas import _ACTIVATIONS

    assert set(ACTIVATION_CODES) == set(_ACTIVATIONS)
    assert sorted(ACTIVATION_CODES.values()) == list(range(len(_ACTIVATIONS)))


# (m, k, n, Pallas blocks): three 128-blocks of K (the JAX test's multi-K
# shape), and an awkward shape that no block divides.
MF_SHAPES = {"multi_k": (128, 384, 128, 128), "awkward_3x300x200": (3, 300, 200, 128)}


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "sigmoid", "tanh"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", list(MF_SHAPES))
def test_matmul_fused_matches_pallas(rng, shape, with_bias, act):
    m, k, n, blk = MF_SHAPES[shape]
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    ref = jax_matmul_fused(jnp.asarray(x), jnp.asarray(w), None if bias is None else jnp.asarray(bias),
                           activation=act, block_m=blk, block_n=blk, block_k=blk, interpret=True)
    before = dispatch.PLAIN["matmul_fused"]
    out = matmul_fused(_t(x), _t(w), None if bias is None else _t(bias), activation=act)
    assert dispatch.PLAIN["matmul_fused"] == before + 1
    assert out.shape == (m, n) and out.dtype == torch.float32
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_matmul_fused_bf16_out_dtype(rng):
    """bf16 operands sum in f32 and round once to bf16 (or stay f32 with
    ``out_dtype``), as the Pallas kernel's f32 accumulator does."""
    x = rng.standard_normal((20, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32) * 0.1
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = jax_matmul_fused(xb, wb, activation="gelu", out_dtype=jnp.float32, block_m=128, block_n=128,
                           block_k=128, interpret=True)
    tx = _t(np.asarray(xb.astype(jnp.float32)), torch.bfloat16)
    tw = _t(np.asarray(wb.astype(jnp.float32)), torch.bfloat16)
    out = matmul_fused(tx, tw, activation="gelu", out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert matmul_fused(tx, tw, activation="gelu").dtype == torch.bfloat16


def test_matmul_fused_refuses_bad_operands():
    with pytest.raises(ValueError):
        matmul_fused(torch.zeros(4, 8), torch.zeros(7, 3))
    with pytest.raises(KeyError):
        matmul_fused(torch.zeros(4, 8), torch.zeros(8, 3), activation="swish")
    with pytest.raises(ValueError):
        matmul_fused(torch.zeros(4, 8, device="meta"), torch.zeros(8, 3))


# ---------------------------------------------------------------------------
# The new epilogues of the int8 kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", NEW_ACTS)
@pytest.mark.parametrize("m", [9, 130])
def test_quant_matmul_new_epilogues(rng, m, act):
    k, n = 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) * 0.1
    ref = jqm.quant_matmul_int8(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(bias),
                                activation=act, block_m=128, block_n=128, block_k=128, interpret=True)
    out = tqm.quant_matmul_int8(_t(x), *_port_pack(q, s), _t(bias), activation=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("act", NEW_ACTS)
@pytest.mark.parametrize("m", [8, 64])
def test_quant_matmul_w8a8_new_epilogues(rng, m, act):
    """M 64 on ``_q8_kernel``; M 8 through the port's hand-off to the w8a8
    GEMV (the same function)."""
    k, n = 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) * 0.1
    ref = jqm.quant_matmul_w8a8(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(bias),
                                activation=act, block_m=128, block_n=128, block_k=128, interpret=True)
    name = "quant_gemv_int8:w8a8" if m <= 8 else "quant_matmul_w8a8"
    before = dispatch.PLAIN[name]
    out = tqm.quant_matmul_w8a8(_t(x), *_port_pack(q, s), _t(bias), activation=act)
    assert dispatch.PLAIN[name] == before + 1
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * max(1.0, float(np.abs(ref).max())), rtol=0)


@pytest.mark.parametrize("act", NEW_ACTS)
@pytest.mark.parametrize("w8a8", [False, True], ids=["weight_only", "w8a8"])
def test_quant_gemv_new_epilogues(rng, w8a8, act):
    """The decode GEMV with a layernorm prologue, bias, the activation and a
    residual (weight-only and w8a8)."""
    m, k, n = 2, 256, 384
    q, s = _quant(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) * 0.1
    ns = rng.uniform(0.5, 1.5, k).astype(np.float32)
    nb = rng.standard_normal(k).astype(np.float32) * 0.1
    resid = rng.standard_normal((m, n)).astype(np.float32)
    jkw = dict(activation=act, norm="layernorm", norm_scale=jnp.asarray(ns), norm_bias=jnp.asarray(nb),
               residual=jnp.asarray(resid))
    if w8a8:
        jkw["w_convert"] = "w8a8"
    ref = jqm.quant_gemv_int8(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(bias), block_n=128,
                              interpret=True, **jkw)
    out = tqm.quant_gemv_int8(_t(x), *_port_pack(q, s), _t(bias), activation=act, norm="layernorm",
                              norm_scale=_t(ns), norm_bias=_t(nb), residual=_t(resid), w8a8=w8a8)
    ref = np.asarray(ref)
    # W8A8: the two norms round in other orders, which can move one code.
    tol = ATOL + (float(s.max()) * float(np.abs(_np_layernorm(x, ns, nb)).max()) if w8a8 else 0.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("w8a8", [False, True], ids=["weight_only", "w8a8"])
def test_quant_mlp_silu(rng, w8a8):
    """The decode MLP with silu (a SiLU MLP block), with the next qkv."""
    m, d, ff, nq = 2, 256, 1024, 768
    wu, su = _quant(rng, d, ff)
    wd, sd = _quant(rng, ff, d)
    wq, sq = _quant(rng, d, nq)
    vec = lambda n, sc=0.1: rng.standard_normal(n).astype(np.float32) * sc  # noqa: E731
    bu, bd, bq, nb, qnb = vec(ff), vec(d), vec(nq), vec(d), vec(d)
    ns, qns = rng.uniform(0.5, 1.5, d).astype(np.float32), rng.uniform(0.5, 1.5, d).astype(np.float32)
    x, resid = rng.standard_normal((m, d)).astype(np.float32), rng.standard_normal((m, d)).astype(np.float32)
    J = jnp.asarray
    ref, ref_qkv = jqm.quant_mlp_int8(
        J(x), J(wu), J(su), J(wd), J(sd), J(bu), J(bd), activation="silu", norm="layernorm", norm_scale=J(ns),
        norm_bias=J(nb), residual=J(resid), next_qkv=(J(wq), J(sq), J(bq), J(qns), J(qnb)),
        w_convert="w8a8" if w8a8 else "direct", interpret=True,
    )
    (twu, tsu), (twd, tsd), (twq, tsq) = _port_pack(wu, su), _port_pack(wd, sd), _port_pack(wq, sq)
    out, qkv = tqm.quant_mlp_int8(
        _t(x), twu, tsu, twd, tsd, _t(bu), _t(bd), activation="silu", norm="layernorm", norm_scale=_t(ns),
        norm_bias=_t(nb), residual=_t(resid), next_qkv=(twq, tsq, _t(bq), _t(qns), _t(qnb)), w8a8=w8a8,
    )
    if w8a8:  # one code per quantized phase, as test_quant_mlp_w8a8_matches_pallas
        xn, yn = _np_layernorm(x, ns, nb), _np_layernorm(np.asarray(ref), qns, qnb)
        up = xn @ (wu.astype(np.float64) * su)
        code = float(su.max()) * float(np.abs(xn).max()) + float(sd.max()) * float(np.abs(up).max())
        tols = (ATOL + code, ATOL + 2 * code + float(sq.max()) * float(np.abs(yn).max()))
    else:
        tols = (ATOL, ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tols[0], rtol=0)
    np.testing.assert_allclose(qkv.numpy(), np.asarray(ref_qkv), atol=tols[1], rtol=0)
