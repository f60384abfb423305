"""The cache attention's whole-S route, which the port's decode paths take
while a CUDA graph is captured (``decoder._attention``: no host length
baked into a launch), against its ``host_len`` prefix route, on the CPU.

Both routes write the new rows' k/v (quantized on an int8 cache) at each
row's device length and bound each row's read by its device ``kv_len``; the
whole-S route reads (and on an int8 cache dequantizes) all S positions,
the prefix route the first ``int(host_len.max()) + T``. Cases: a bf16 and
an int8 cache, one token a row and the speculative verify's K+1, head dim
64 and 96 (one the KV kernels refuse, whose one-token step attends through
this route). The whole forward is held against the JAX decoder too, with
the route forced whole, at the tiny ``SLICE_CFG`` widths.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.models import decoder as jdec
from rten_tpu_torch.models import decoder as tdec
from torch_port_helpers import configs, dense_tree, to_jax, to_numpy

# Head dim 64 (SLICE_CFG: the KV kernels' one-token step) and 96 (4 heads
# over d_model 384: no KV kernel, a one-token step attends through this
# route, as in test_torch_decoder.HEAD_DIM_CFGS).
HEAD_DIMS = {64: dict(), 96: dict(n_heads=4, d_model=384)}
LOGIT_ATOL = 1e-4  # test_torch_decoder's


def _cache(kind: str, dtype, head_dim: int, lens, s_max: int = 96, seed: int = 0) -> dict:
    """A cache of 2 kv heads at ``head_dim`` with random contents and the
    rows' lengths ``lens`` (device and host)."""
    cfg = tdec.DecoderConfig(vocab_size=8, n_layers=1, n_heads=2, d_model=2 * head_dim, d_ff=8, max_seq=s_max,
                             dtype=dtype, int8_kv=kind == "int8")
    cache = tdec.init_cache(cfg, len(lens), s_max, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for key in ("k", "v"):
        if kind == "int8":
            cache[key][0].copy_(torch.randint(-127, 128, cache[key][0].shape, generator=gen, dtype=torch.int8))
            cache[key + "_scale"][0].copy_(torch.rand(cache[key + "_scale"][0].shape, generator=gen) * 0.02)
        else:
            cache[key][0].copy_(torch.randn(cache[key][0].shape, generator=gen).to(dtype))
    cache["len"].copy_(torch.tensor(lens, dtype=torch.int32))
    cache["host_len"][:] = lens
    return cache


@pytest.mark.parametrize("head_dim", list(HEAD_DIMS))
@pytest.mark.parametrize("t", [1, 5], ids=["t1", "verify"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_attention_whole_s_equals_prefix(kind, t, head_dim):
    """``_attention`` over the whole S against the prefix route: the same
    output and the same cache after the append (rows of lengths 3, 17 and
    40 in a 96-position cache; 4 query heads over 2 kv heads)."""
    dtype = torch.bfloat16
    lens = [3, 17, 40]
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(3, t, 4, head_dim, generator=gen).to(dtype)
    k = torch.randn(3, t, 2, head_dim, generator=gen).to(dtype)
    v = torch.randn(3, t, 2, head_dim, generator=gen).to(dtype)
    outs, caches = [], []
    for whole in (False, True):
        cache = _cache(kind, dtype, head_dim, lens)
        start = cache["len"].clone()
        outs.append(tdec._attention(q, k, v, cache, 0, start, start + t, whole=whole))
        caches.append(cache)
    assert outs[0].shape == (3 * t, 4 * head_dim)
    assert torch.equal(outs[0], outs[1])
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in caches[0]:
            assert torch.equal(caches[0][key][0], caches[1][key][0]), key


@pytest.fixture(scope="module")
def models():
    out = {}
    for hd, kw in HEAD_DIMS.items():
        jcfg, tcfg = configs(**kw)
        jparams = jdec.quantize_params_int8(to_jax(dense_tree(0, **kw)), tile_bn=128)
        out[hd] = (jcfg, tcfg, jparams, tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu"))
    return out


@pytest.mark.parametrize("head_dim", list(HEAD_DIMS))
@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
def test_forward_whole_s_matches_jax(models, monkeypatch, head_dim, int8_kv):
    """A 9-token prompt at 2 rows, then one token a row and a 5-token
    verify chunk through ``decoder.forward`` with every cache
    attention on the whole-S route: the prefix route's logits up to the
    order of the plain version's f32 sums over S or over the prefix (4e-6
    of the logits' largest magnitude; the card's kernel plans and sums both
    alike, ``tests/test_torch_cuda.py``); at head dim 96 on the f32 cache
    within ``LOGIT_ATOL`` of the JAX decoder's on the same tokens (the
    prefix route is held against JAX at every case in
    ``test_torch_decoder.py``)."""
    jcfg, tcfg, jparams, tparams = models[head_dim]
    jcfg, tcfg = (dataclasses.replace(c, int8_kv=int8_kv) for c in (jcfg, tcfg))
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 500, (2, 9)).astype(np.int32)
    chunks = [rng.integers(0, 500, (2, 1)).astype(np.int32), rng.integers(0, 500, (2, 5)).astype(np.int32)]

    want = [None] * len(chunks)
    jax_ref = head_dim == 96 and not int8_kv
    if jax_ref:
        jcache = jdec.init_cache(jcfg, 2, 64)
        _, jcache = jdec.forward(jparams, jcfg, jnp.asarray(prompt), jcache)
        for i, c in enumerate(chunks):
            lg, jcache = jdec.forward(jparams, jcfg, jnp.asarray(c), jcache)
            want[i] = np.asarray(lg, np.float32)

    def port(whole):
        cache = tdec.init_cache(tcfg, 2, 64, device="cpu")
        tdec.forward(tparams, tcfg, torch.from_numpy(prompt), cache)
        with monkeypatch.context() as m:
            if whole:
                m.setattr(tdec, "_attention", functools.partial(tdec._attention, whole=True))
            return [tdec.forward(tparams, tcfg, torch.from_numpy(c), cache)[0].numpy() for c in chunks], cache

    got, cache = port(True)
    prefix, prefix_cache = port(False)
    assert cache["host_len"].tolist() == prefix_cache["host_len"].tolist() == [15, 15]
    for g, p, w in zip(got, prefix, want):
        np.testing.assert_allclose(g, p, atol=4e-6 * float(np.abs(p).max()), rtol=0)
        if jax_ref:
            np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)
