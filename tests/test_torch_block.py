"""The whole-block decode (``decode_block``, ``DecoderConfig(mega=True)``)
and the batched decode-attention modes: the port's plain versions, on the
CPU, against the JAX package's Pallas kernels run with ``interpret=True``
and its decoder under ``RTEN_DECODE_FUSE=mega``.

Tolerances: f32 outputs atol 1e-4 relative to max(1, |ref|) (the same f32
arithmetic in another order); bf16 outputs one bf16 rounding of their
largest value (1e-2 of it); caches after a kernel's append equal, after a
decoder step to atol 1e-5 (the new k/v are f32 sums); logits 1e-3 and
greedy tokens identical (ROADMAP's bars).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import decode_attention as jda
from rten_tpu.kernels import quant_matmul as jqm
from rten_tpu.models import decoder as jdec
from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend
from rten_tpu_torch.kernels import decode_attention as tda
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels import quant_matmul as tqm
from rten_tpu_torch.models import decoder as tdec
from torch_port_helpers import (
    SLICE_CFG,
    carry_cache,
    configs,
    dense_tree,
    patch_jax_fused,
    port_scales,
    to_jax,
    to_numpy,
)

LOGIT_ATOL = 1e-3


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _quant(rng, k, n, scale=0.2):
    return jqm.quantize_weights_int8(rng.standard_normal((k, n)).astype(np.float32) * scale)


def _pack(q, s):
    pack = tqm.int8_pack(q, s, device="cpu")
    return pack["qt"], pack["s"]


def _close(out, ref, bf16: bool):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    top = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, atol=(1e-2 if bf16 else 1e-4) * top, rtol=0)


def _jax_dtype(bf16):
    return jnp.bfloat16 if bf16 else jnp.float32


def _as_port(a, bf16):
    """A JAX-side array as the port's tensor of the same values."""
    return _t(np.asarray(jnp.asarray(a).astype(jnp.float32)), torch.bfloat16 if bf16 else torch.float32)


# ---------------------------------------------------------------------------
# decode_block_ref against the TPU kernel's mega branch
# ---------------------------------------------------------------------------

# (operands, dtype, kv_len, next qkv, activation, norm): every value of each
# axis, each pair of the dtype, kv_len, next qkv and activation at least
# once for the packed MHA row; the grouped-query operands (4 query heads over
# 2, and over 1) unpacked as the JAX decoder hands them over under GQA or RoPE.
BLOCK_CASES = [
    ("packed", "f32", 0, True, "gelu", "layernorm"),
    ("packed", "f32", 5, False, "relu", "rmsnorm"),
    ("packed", "f32", 127, True, "silu", "layernorm"),
    ("packed", "f32", 127, False, "gelu", "rmsnorm"),
    ("packed", "f32", 5, True, "silu", "rmsnorm"),
    ("packed", "bf16", 0, False, "silu", "rmsnorm"),
    ("packed", "bf16", 5, True, "gelu", "layernorm"),
    ("packed", "bf16", 127, True, "relu", "rmsnorm"),
    ("packed", "bf16", 0, True, "relu", "layernorm"),
    ("gqa", "f32", 0, True, "gelu", "layernorm"),
    ("gqa", "bf16", 127, True, "silu", "rmsnorm"),
    ("gqa", "f32", 70, False, "relu", "layernorm"),
    ("mqa", "f32", 5, True, "relu", "rmsnorm"),
    ("mqa", "bf16", 70, True, "gelu", "layernorm"),
    ("mqa", "f32", 127, False, "silu", "layernorm"),
    # Head dims 32 and 16 (4 query heads of 32 or 16; the JAX mega rule
    # admits every divisor of 128, decode_block is built for 16 and up).
    ("packed", "f32", 70, True, "gelu", "layernorm", 32),
    ("packed", "bf16", 127, True, "relu", "rmsnorm", 32),
    ("gqa", "f32", 5, True, "silu", "rmsnorm", 32),
    ("mqa", "bf16", 70, False, "gelu", "layernorm", 32),
    ("packed", "f32", 127, True, "gelu", "rmsnorm", 16),
    ("gqa", "bf16", 70, True, "relu", "layernorm", 16),
]
BLOCK_CASES = [c if len(c) == 7 else (*c, 64) for c in BLOCK_CASES]
KV_HEADS = {"packed": 4, "gqa": 2, "mqa": 1}  # over 4 query heads


def _block_id(c):
    name = f"{c[1]}_len{c[2]}_{'next' if c[3] else 'last'}_{c[4]}_{c[5]}" + ("" if c[6] == 64 else f"_d{c[6]}")
    return name if c[0] == "packed" else f"{c[0]}_{name}"


@pytest.mark.parametrize("ops,dt,kv_len,with_next,act,norm,d", BLOCK_CASES, ids=[_block_id(c) for c in BLOCK_CASES])
def test_decode_block_matches_mega_kernel(rng, ops, dt, kv_len, with_next, act, norm, d):
    """One block of one token (batch 1, S 128, 4 query heads of 64, 32 or
    16 over 4, 2 or 1 kv heads, d_model 256, FF 1024, the next qkv (4 + 2
    Hk) x D): the output, the next qkv and both caches after the append."""
    bf16 = dt == "bf16"
    jdt = _jax_dtype(bf16)
    h, s_max, dm, ff = 4, 128, 256, 1024
    hk = KV_HEADS[ops]
    nq = (h + 2 * hk) * d
    kc = jnp.asarray(rng.standard_normal((1, hk, s_max, d)).astype(np.float32), jdt)
    vc = jnp.asarray(rng.standard_normal((1, hk, s_max, d)).astype(np.float32), jdt)
    if ops == "packed":
        pk = jnp.asarray(rng.standard_normal((1, 3, h, 1, d)).astype(np.float32) * 0.8, jdt)
        q = kn = vn = None
    else:
        pk = None
        q = jnp.asarray(rng.standard_normal((1, h, 1, d)).astype(np.float32) * 0.8, jdt)
        kn, vn = (jnp.asarray(rng.standard_normal((1, hk, 1, d)).astype(np.float32) * 0.8, jdt) for _ in range(2))
    resid = jnp.asarray(rng.standard_normal((1, dm)).astype(np.float32), jdt)
    wo, so = _quant(rng, h * d, dm)
    wu, su = _quant(rng, dm, ff)
    wd, sd = _quant(rng, ff, dm, scale=0.05)
    wq, sq = _quant(rng, dm, nq)
    vec = lambda n, sc=0.1: rng.standard_normal(n).astype(np.float32) * sc  # noqa: E731
    bo, bu, bd, bq = vec(dm), vec(ff), vec(dm), vec(nq)
    ns, qns = rng.uniform(0.8, 1.2, dm).astype(np.float32), rng.uniform(0.8, 1.2, dm).astype(np.float32)
    nb, qnb = (vec(dm), vec(dm)) if norm == "layernorm" else (None, None)
    lens = np.array([kv_len], np.int32)
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    res = jda.decode_attention(
        q, kc, vc, jnp.asarray(lens), kn, vn, J(wo), J(so), J(bo), resid, packed_qkv=pk,
        mlp=(J(wu), J(su), J(wd), J(sd), J(bu), J(bd), J(ns), J(nb)),
        next_qkv=(J(wq), J(sq), J(bq), J(qns), J(qnb)) if with_next else None,
        activation=act, norm=norm, interpret=True,
    )
    (ref, ref_qkv, ref_k, ref_v) = res if with_next else (res[0], None, res[1], res[2])

    T = lambda a: None if a is None else _t(a)  # noqa: E731
    k_cache, v_cache = _as_port(kc, bf16), _as_port(vc, bf16)
    operands = _as_port(pk, bf16) if ops == "packed" else tuple(_as_port(x, bf16)[:, :, 0] for x in (q, kn, vn))
    mlp = (*_pack(wu, su), *_pack(wd, sd), T(bu), T(bd), T(ns), T(nb))
    nxt = (*_pack(wq, sq), T(bq), T(qns), T(qnb)) if with_next else None
    dispatch.reset_counters()
    out = tda.decode_block(operands, k_cache, v_cache, torch.from_numpy(lens), *_pack(wo, so), T(bo),
                           _as_port(resid, bf16), mlp, nxt, activation=act, norm=norm)
    want = {"decode_block": 1, **({"decode_block:gqa": 1} if hk < h else {})}
    assert dict(dispatch.PLAIN) == want
    out, qkv = out if with_next else (out, None)
    assert out.shape == (1, dm) and out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), bf16)
    if with_next:
        assert qkv.shape == (1, nq) and qkv.dtype == out.dtype
        _close(qkv.float(), np.asarray(ref_qkv.astype(jnp.float32)), bf16)
    np.testing.assert_array_equal(k_cache.float().numpy(), np.asarray(ref_k.astype(jnp.float32)).reshape(k_cache.shape))
    np.testing.assert_array_equal(v_cache.float().numpy(), np.asarray(ref_v.astype(jnp.float32)).reshape(v_cache.shape))


def test_decode_block_is_not_the_two_kernel_composition(rng):
    """In bf16 the block keeps its hidden state f32 into ln2 and the down
    projection's residual, so it differs from decode_attention then
    quant_mlp_int8 (which round it to bf16), and in f32 it equals them."""
    h, d, s_max, dm, ff = 4, 64, 128, 256, 1024
    wo, wu, wd = _quant(rng, h * d, dm), _quant(rng, dm, ff), _quant(rng, ff, dm, scale=0.05)
    kc = rng.standard_normal((1, h, s_max, d)).astype(np.float32)
    pk = rng.standard_normal((1, 3, h, 1, d)).astype(np.float32)
    resid = rng.standard_normal((1, dm)).astype(np.float32) * 3
    ns = rng.uniform(0.8, 1.2, dm).astype(np.float32)
    lens = torch.tensor([40], dtype=torch.int32)
    diffs = {}
    for dtype in (torch.float32, torch.bfloat16):
        cache = lambda: _t(kc, dtype)  # noqa: E731
        mlp = (*_pack(*wu), *_pack(*wd), None, None, _t(ns), None)
        block = tda.decode_block(_t(pk, dtype), cache(), cache(), lens, *_pack(*wo), None, _t(resid, dtype), mlp,
                                 activation="gelu", norm="rmsnorm")
        x = tda.decode_attention(_t(pk, dtype), cache(), cache(), lens, *_pack(*wo), residual=_t(resid, dtype))
        two = tqm.quant_mlp_int8(x, *_pack(*wu), *_pack(*wd), activation="gelu", norm="rmsnorm",
                                 norm_scale=_t(ns), residual=x)
        diffs[dtype] = (block.float() - two.float()).abs().max().item()
    assert diffs[torch.float32] < 1e-5 and diffs[torch.bfloat16] > 1e-3, diffs


def test_mega_block_supported_is_the_jax_rule():
    """The copied gate agrees with the JAX package's at GPT-2-small and the
    tiny config, in and out of its 12 MB budget."""
    cases = [(768, 3072, 2304, 12, 64, 768, 2), (768, 3072, 0, 12, 64, 1024, 4), (256, 1024, 768, 4, 64, 64, 4),
             (256, 1024, 768, 4, 64, 100, 4), (1024, 4096, 3072, 16, 64, 1024, 2), (768, 3072, 2304, 12, 64, 768, 4)]
    for c in cases:
        assert tda.mega_block_supported(*c[:6], kv_bytes=c[6]) == jda.mega_block_supported(*c[:6], kv_bytes=c[6]), c
    assert not tda.mega_block_supported(1024, 4096, 3072, 16, 64, 1024, kv_bytes=2)


# ---------------------------------------------------------------------------
# The batched=True modes: the port's all-rows launch against the TPU
# kernels' single-cell batched kernels
# ---------------------------------------------------------------------------

BATCH_LENS = [0, 5, 70]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_matches_batched_kernel(rng, dt):
    """B 3 at lengths 0 / 5 / 70 of S 128, packed q|k|v, fused wo + bias +
    residual: outputs and caches against ``_decode_attn_kernel_batched``."""
    bf16 = dt == "bf16"
    jdt = _jax_dtype(bf16)
    b, h, d, s_max, dm = len(BATCH_LENS), 4, 64, 128, 256
    kc = jnp.asarray(rng.standard_normal((b, h, s_max, d)).astype(np.float32), jdt)
    vc = jnp.asarray(rng.standard_normal((b, h, s_max, d)).astype(np.float32), jdt)
    pk = jnp.asarray(rng.standard_normal((b, 3, h, 1, d)).astype(np.float32), jdt)
    resid = jnp.asarray(rng.standard_normal((b, dm)).astype(np.float32), jdt)
    wo, so = _quant(rng, h * d, dm)
    bo = rng.standard_normal(dm).astype(np.float32) * 0.1
    lens = np.array(BATCH_LENS, np.int32)
    ref, ref_k, ref_v = jda.decode_attention(
        None, kc, vc, jnp.asarray(lens), None, None, jnp.asarray(wo), jnp.asarray(so), jnp.asarray(bo), resid,
        packed_qkv=pk, batched=True, interpret=True,
    )
    k_cache, v_cache = _as_port(kc, bf16), _as_port(vc, bf16)
    out = tda.decode_attention(_as_port(pk, bf16), k_cache, v_cache, torch.from_numpy(lens), *_pack(wo, so), _t(bo),
                               residual=_as_port(resid, bf16))
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), bf16)
    np.testing.assert_array_equal(k_cache.float().numpy(), np.asarray(ref_k.astype(jnp.float32)))
    np.testing.assert_array_equal(v_cache.float().numpy(), np.asarray(ref_v.astype(jnp.float32)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_int8_matches_batched_kernel(rng, dt):
    """The int8 twin against ``_decode_attn_int8_kernel_batched``: B 3 at
    lengths 0 / 5 / 70; S 256, the JAX int8 kernel's smallest cache (its
    scale tiles need 128-lane blocks of 256 positions). The attention
    vector, the codes bit for bit and the scales to one ulp (through
    ``unpack_kv_scales``)."""
    bf16 = dt == "bf16"
    jdt = _jax_dtype(bf16)
    b, h, d, s_max = len(BATCH_LENS), 4, 64, 256
    kq = rng.integers(-127, 128, (b, h, s_max, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, h, s_max, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, h, s_max)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, h, s_max)).astype(np.float32)
    q, kn, vn = (jnp.asarray(rng.standard_normal((b, h, 1, d)).astype(np.float32) * 1.2, jdt) for _ in range(3))
    lens = np.array(BATCH_LENS, np.int32)
    out, k2, v2, ks2, vs2 = jda.decode_attention_int8(
        q, jnp.asarray(kq), jnp.asarray(vq), jda.pack_kv_scales(jnp.asarray(ks[..., None]), d),
        jda.pack_kv_scales(jnp.asarray(vs[..., None]), d), jnp.asarray(lens), kn, vn, batched=True, interpret=True,
    )
    caches = [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)]
    packed = _as_port(jnp.stack([q, kn, vn], axis=1), bf16)  # [B, 3, H, 1, D]
    attn = tda.decode_attention_int8(packed, *caches, torch.from_numpy(lens))
    _close(attn.float(), np.asarray(out.astype(jnp.float32)).reshape(b, h * d), bf16)
    np.testing.assert_array_equal(caches[0].numpy(), np.asarray(k2).reshape(b, h, s_max, d))
    np.testing.assert_array_equal(caches[1].numpy(), np.asarray(v2).reshape(b, h, s_max, d))
    for port, packed_scales in ((caches[2], ks2), (caches[3], vs2)):
        np.testing.assert_allclose(port.numpy(), port_scales(packed_scales, d), rtol=1.2e-7, atol=0)


# ---------------------------------------------------------------------------
# The decoder under DecoderConfig(mega=True) against the JAX decoder under
# RTEN_DECODE_FUSE=mega (its Pallas kernels in interpret mode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(0)), tile_bn=128)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture
def jax_mega(monkeypatch):
    """The JAX decoder's fused path with ``RTEN_DECODE_FUSE=mega``, JAX's
    trace caches cleared around the test (its jitted ``generate_scan`` is
    keyed on the config, which does not carry the mode). Yields
    ``install(w8a8=False)``, which applies ``patch_jax_fused`` and returns
    the list of the ``layer_idx`` of every ``decode_attention`` call that
    passed ``mlp=`` (one per layer each time the decoder is traced under
    mega)."""
    jax.clear_caches()
    calls = []

    def install(w8a8=False):
        patch_jax_fused(monkeypatch, w8a8=w8a8)
        inner = jda.decode_attention

        def spy(*a, **kw):
            if kw.get("mlp") is not None:
                calls.append(kw.get("layer_idx"))
            return inner(*a, **kw)

        monkeypatch.setattr(jda, "decode_attention", spy)
        monkeypatch.setenv("RTEN_DECODE_FUSE", "mega")
        return calls

    yield install
    jax.clear_caches()


def _random_caches(jcfg, tcfg, n, s_max, seed):
    """One row holding ``n`` tokens of seeded random k/v, as a JAX cache and
    the port's copy of it."""
    rng = np.random.default_rng(seed)
    shape = (1, jcfg.kv_heads, s_max, jcfg.head_dim)
    jcache = {"len": jnp.asarray([n], jnp.int32)}
    for key in ("k", "v"):
        jcache[key] = [jnp.asarray(rng.standard_normal(shape).astype(np.float32)) for _ in range(jcfg.n_layers)]
    return jcache, carry_cache(jcache, tcfg.head_dim)


@functools.lru_cache(maxsize=None)
def _models_at(head_dim: int):
    """``models`` at SLICE_CFG's d_model with heads of ``head_dim``."""
    n_heads = SLICE_CFG["d_model"] // head_dim
    jcfg, tcfg = configs(n_heads=n_heads)
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(0, n_heads=n_heads)), tile_bn=128)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


# (w8a8, head dim): SLICE_CFG's 4 heads of 64, and 32 heads of 8 and 64 of
# 4 at the same d_model, each on the smallest cache the JAX rule admits
# there (S · D a multiple of 1024).
MEGA_STEP_CASES = [(False, 64), (True, 64), (False, 8), (False, 4)]


@pytest.mark.parametrize("w8a8,head_dim", MEGA_STEP_CASES,
                         ids=[("w8a8" if w else "weight_only") + ("" if d == 64 else f"_d{d}")
                              for w, d in MEGA_STEP_CASES])
def test_mega_decode_step_matches_jax(models, jax_mega, w8a8, head_dim):
    """A decode step at batch 1 on a cache holding 20 tokens (64
    positions at head dim 64, 128 at 8, 256 at 4): the port's
    ``decode_block`` in every layer against the JAX mega kernel in every
    layer; logits within 1e-3, caches equal to f32 rounding (atol 1e-5, as
    the other decoder tests hold them). Under W8A8 the block stays
    weight-only (the TPU kernel has no W8A8 mode) while layer 0's qkv and
    the lm_head run the w8a8 GEMV, in both packages. At head dims 8 and 4
    the route is what would show a fault: in f32 the two-kernel step
    differs from the block only in the order of its sums."""
    jcfg, tcfg, jparams, tparams = models if head_dim == 64 else _models_at(head_dim)
    calls = jax_mega(w8a8)
    tcfg = dataclasses.replace(tcfg, mega=True, w8a8=w8a8)
    jcache, tcache = _random_caches(jcfg, tcfg, 20, {64: 64, 8: 128, 4: 256}[head_dim], seed=80)
    tok = np.array([[123]], np.int32)
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(tok), jcache)
    assert calls == list(range(jcfg.n_layers))  # the JAX decoder took its mega kernel in every layer
    dispatch.reset_counters()
    tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(tok), tcache)
    gemv = "quant_gemv_int8:w8a8" if w8a8 else "quant_gemv_int8"
    assert dict(dispatch.PLAIN) == {"decode_block": tcfg.n_layers, gemv: 2}  # + layer 0's qkv and the lm_head
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    want = carry_cache(jcache, tcfg.head_dim)
    for li in range(tcfg.n_layers):  # the new k/v come from f32 sums in another order
        for kv in ("k", "v"):
            np.testing.assert_allclose(tcache[kv][li].numpy(), want[kv][li].numpy(), atol=1e-5, rtol=0)
    assert tcache["host_len"][0] == 21 and int(tcache["len"][0]) == 21


def test_mega_greedy_stream_matches_jax(models, jax_mega):
    """A 5-token prompt and 16 greedy steps: the JAX ``generate_scan``
    under mega, the port's ``generate_greedy`` with ``mega=True``, and
    ``Generator(NativeBackend(device="cpu"))`` with ``mega=True``: the same
    tokens, every decode step through ``decode_block``."""
    jcfg, tcfg, jparams, tparams = models
    calls = jax_mega()
    tcfg = dataclasses.replace(tcfg, mega=True)
    prompt = np.random.default_rng(81).integers(0, tcfg.vocab_size, (1, 5)).astype(np.int32)
    n = 16
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(prompt), jdec.init_cache(jcfg, 1, 64))
    first = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    jtoks, _ = jdec.generate_scan(jparams, jcfg, jcache, first, jax.random.PRNGKey(0), n_steps=n)
    assert calls, "the JAX decode loop was not traced under mega"

    tcache = tdec.init_cache(tcfg, 1, 64, device="cpu")
    tfirst, tcache = tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), tcache, lm_head_mode="argmax",
                                  last_only=True)
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(first))
    dispatch.reset_counters()
    ttoks, _ = tdec.generate_greedy(tparams, tcfg, tcache, tfirst, n)
    assert dispatch.PLAIN["decode_block"] == n * tcfg.n_layers and "decode_attention" not in dispatch.PLAIN
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))

    gen = Generator(NativeBackend(tparams, tcfg, max_len=64, device="cpu"),
                    GeneratorConfig(max_tokens=n + 1)).with_prompt(prompt)
    stream = [int(t[0]) for t in gen]
    assert stream == [int(np.asarray(first)[0, 0])] + np.asarray(jtoks)[0].tolist()


# The grouped-query mega configs: SLICE_CFG's block with 4 query heads over
# 1 kv head and learned positions (MQA, tiny_starcoder_py's kind), and over 2
# with RoPE; ``dense_tree``'s wk / wv / bk / bv cut to the kv width.
MEGA_GQA = {"mqa": dict(n_kv_heads=1), "gqa_rope": dict(n_kv_heads=2, pos_encoding="rope")}


@pytest.fixture(scope="module")
def gqa_models():
    out = {}
    for kind, extra in MEGA_GQA.items():
        jcfg = jdec.DecoderConfig(**SLICE_CFG, **extra, dtype=jnp.float32)
        tcfg = tdec.DecoderConfig(**SLICE_CFG, **extra, dtype=torch.float32)
        tree = dense_tree(2)
        hkv = jcfg.kv_heads * jcfg.head_dim
        for layer in tree["layers"]:
            for key in ("wk", "wv"):
                layer[key] = layer[key][:, :hkv]
            for key in ("bk", "bv"):
                layer[key] = layer[key][:hkv]
        if extra.get("pos_encoding") == "rope":
            del tree["pos_emb"]
        jparams = jdec.quantize_params_int8(to_jax(tree), tile_bn=128)
        out[kind] = (jcfg, tcfg, jparams, tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu"))
    return out


def _layer_spy(monkeypatch, caches):
    """The layers whose step runs through the port's ``decode_block``, found
    by the cache it is handed."""
    taken = []
    inner = tdec.decode_block

    def spy(ops, k_cache, *a, **kw):
        taken.append(next(i for i, t in enumerate(caches) if t is k_cache))
        return inner(ops, k_cache, *a, **kw)

    monkeypatch.setattr(tdec, "decode_block", spy)
    return taken


@pytest.mark.parametrize("w8a8", [False, True], ids=["weight_only", "w8a8"])
@pytest.mark.parametrize("kind", list(MEGA_GQA))
def test_mega_gqa_decode_step_matches_jax(gqa_models, jax_mega, monkeypatch, kind, w8a8):
    """A decode step at batch 1 on a 64-position cache holding 20 tokens,
    MQA (learned positions) and GQA with RoPE: the JAX decoder takes its mega
    kernel unpacked in every layer, the port ``decode_block`` on the same
    layers with the RoPE'd q, k and v; logits within 1e-3, caches to atol
    1e-5. W8A8 as in ``test_mega_decode_step_matches_jax``."""
    jcfg, tcfg, jparams, tparams = gqa_models[kind]
    calls = jax_mega(w8a8)
    tcfg = dataclasses.replace(tcfg, mega=True, w8a8=w8a8)
    jcache, tcache = _random_caches(jcfg, tcfg, 20, 64, seed=84)
    taken = _layer_spy(monkeypatch, tcache["k"])
    tok = np.array([[321]], np.int32)
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(tok), jcache)
    assert calls == list(range(jcfg.n_layers))
    dispatch.reset_counters()
    tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(tok), tcache)
    assert taken == calls
    gemv = "quant_gemv_int8:w8a8" if w8a8 else "quant_gemv_int8"
    assert dict(dispatch.PLAIN) == {"decode_block": tcfg.n_layers, "decode_block:gqa": tcfg.n_layers, gemv: 2}
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    want = carry_cache(jcache, tcfg.head_dim)
    for li in range(tcfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tcache[kv][li].numpy(), want[kv][li].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", list(MEGA_GQA))
def test_mega_gqa_greedy_stream_matches_jax(gqa_models, jax_mega, kind):
    """A 5-token prompt and 16 greedy steps under mega, MQA and GQA + RoPE:
    the JAX ``generate_scan`` and the port's ``generate_greedy`` give the
    same tokens, every port step through ``decode_block`` in every layer."""
    jcfg, tcfg, jparams, tparams = gqa_models[kind]
    calls = jax_mega()
    tcfg = dataclasses.replace(tcfg, mega=True)
    prompt = np.random.default_rng(85).integers(0, tcfg.vocab_size, (1, 5)).astype(np.int32)
    n = 16
    jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(prompt), jdec.init_cache(jcfg, 1, 64))
    first = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    jtoks, _ = jdec.generate_scan(jparams, jcfg, jcache, first, jax.random.PRNGKey(0), n_steps=n)
    assert calls, "the JAX decode loop was not traced under mega"
    tcache = tdec.init_cache(tcfg, 1, 64, device="cpu")
    tfirst, tcache = tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), tcache, lm_head_mode="argmax",
                                  last_only=True)
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(first))
    dispatch.reset_counters()
    ttoks, _ = tdec.generate_greedy(tparams, tcfg, tcache, tfirst, n)
    assert dispatch.PLAIN["decode_block:gqa"] == n * tcfg.n_layers and "decode_attention:gqa" not in dispatch.PLAIN
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_mega_layer_takes_the_jax_rule_with_grouped_heads():
    """``_mega_layer`` gives ``mega_block_supported`` the kv heads and the
    next qkv's (Hq + 2 Hk) D columns, as the JAX decoder does
    (``rten_tpu/models/decoder.py:884-907``): at d_model 1024, d_ff 4096, 16
    query heads over 1, head dim 64 and S 1024 the JAX rule admits a layer
    with its next qkv, and so must the port; the last layer, without one."""
    d, ff, h, hk, hd, s_max = 1024, 4096, 16, 1, 64, 1024
    nq = (h + 2 * hk) * hd
    assert jda.mega_block_supported(d, ff, nq, hk, hd, s_max, kv_bytes=2)
    assert tda.mega_block_supported(d, ff, nq, hk, hd, s_max, kv_bytes=2)
    cfg = tdec.DecoderConfig(vocab_size=512, n_layers=2, n_heads=h, n_kv_heads=hk, d_model=d, d_ff=ff,
                             max_seq=s_max, mega=True)

    def pack(n, k):
        return {"qt": torch.zeros((n, k), dtype=torch.int8), "s": torch.ones(n), "tiled": False}

    norm = {"scale": torch.ones(d), "bias": torch.zeros(d)}
    layers = [{"w_up": pack(ff, d), "w_down": pack(d, ff), "wqkv": pack(nq, d), "ln1": norm, "ln2": norm}
              for _ in range(2)]
    cache = {"k": [torch.zeros((1, hk, s_max, hd), dtype=torch.bfloat16) for _ in range(2)]}
    block = tdec._mega_layer({"layers": layers}, cfg, 0, cache)
    assert block is not None and block[1] is not None and tuple(block[1][0].shape) == (nq, d)
    last = tdec._mega_layer({"layers": layers}, cfg, 1, cache)
    assert last is not None and last[1] is None


@pytest.mark.parametrize("mega", [False, True], ids=["two_kernel", "mega"])
def test_silu_decoder_matches_jax(monkeypatch, mega):
    """``DecoderConfig(activation="silu")``: a 12-token prompt (the prefill
    structure, silu in ``quant_matmul_int8``'s epilogue) and 2 greedy
    decode steps (silu in ``quant_mlp_int8``, or in ``decode_block`` with
    mega), against the JAX decoder: its jnp path, or with mega its fused
    path under ``RTEN_DECODE_FUSE=mega``; logits of every forward and the
    tokens."""
    jax.clear_caches()
    jcfg, tcfg = configs()
    jcfg, tcfg = dataclasses.replace(jcfg, activation="silu"), dataclasses.replace(tcfg, activation="silu", mega=mega)
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(1)), tile_bn=128)
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    if mega:
        patch_jax_fused(monkeypatch)
        monkeypatch.setenv("RTEN_DECODE_FUSE", "mega")
    tokens = np.random.default_rng(82).integers(0, tcfg.vocab_size, (1, 12)).astype(np.int32)
    jcache, tcache = jdec.init_cache(jcfg, 1, 64), tdec.init_cache(tcfg, 1, 64, device="cpu")
    chunk = tokens
    dispatch.reset_counters()
    for step in range(3):
        jlogits, jcache = jdec.forward(jparams, jcfg, jnp.asarray(chunk), jcache)
        tlogits, tcache = tdec.forward(tparams, tcfg, torch.from_numpy(chunk), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"forward {step}")
        chunk = np.array(jlogits[:, -1:].argmax(-1), np.int32)
        np.testing.assert_array_equal(tlogits[:, -1:].argmax(-1).numpy(), chunk)
    assert dispatch.PLAIN["quant_matmul_int8"] == 4 * tcfg.n_layers + 1
    assert dispatch.PLAIN["decode_block" if mega else "quant_mlp_int8"] == 2 * tcfg.n_layers
    jax.clear_caches()
