"""The port's CUDA kernels against their plain versions on the card, at
small shapes and in both activation dtypes, and the tiny decoder end to end
through the kernels against the plain path.

Needs an NVIDIA card and nvcc: marked ``gpu``; every test skips where
``torch.cuda.is_available()`` is false (decided in a fixture, not at
import). This file imports neither JAX nor the JAX package,
so on a machine without JAX it runs with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: f32 atol 1e-4 relative to max(1, |plain|) (same f32 arithmetic,
another summation order); bf16 outputs 1e-2 relative (one bf16 rounding).
"""

import math

import pytest
import torch

from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels import quant_matmul as qm
from rten_tpu_torch.kernels.decode_attention import decode_attention, decode_attention_ref

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels compile with nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _tol(ref, dtype):
    scale = max(1.0, ref.float().abs().max().item())
    return (1e-4 if dtype == torch.float32 else 1e-2) * scale


def _close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _tol(ref, dtype), (err, _tol(ref, dtype))


def _pack(gen, n, k, dev):
    qt = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand(n, generator=gen, device=dev) * 0.02 + 0.001
    return qt, s


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,act", [(1, 384, None), (3, 9000, "gelu"), (8, 256, "relu")])
def test_gemv_kernel_matches_plain(dev, dtype, m, n, act):
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 256
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    bias = torch.randn(n, generator=gen, device=dev)
    resid = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    ns = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
    kw = dict(activation=act, norm="layernorm", norm_scale=ns, norm_bias=0.1 * ns, residual=resid)
    before = dispatch.LAUNCHES["quant_gemv_int8"]
    out = qm.quant_gemv_int8(x, qt, s, bias, **kw)
    assert dispatch.LAUNCHES["quant_gemv_int8"] == before + 1
    _close(out, qm.quant_gemv_int8_ref(x, qt, s, bias, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemv_argmax_ties_and_mask(dev, dtype):
    """Lowest column among equal maxima across blocks; columns ≥ argmax_n
    masked even when larger."""
    gen = torch.Generator(device=dev).manual_seed(1)
    m, k, n, vocab = 2, 256, 20480, 20000
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    col = torch.where(x[0].float() > 0, 100, -100).to(torch.int8)
    for c in (7, 5000, 19999, 20100):  # ties far apart; 20100 is padding
        qt[c] = col
        s[c] = 1.0
    s[20100] = 2.0
    x[1] = x[0]
    out = qm.quant_gemv_int8(x, qt, s, argmax_n=vocab)
    assert out.tolist() == [7, 7]
    assert qm.quant_gemv_int8_ref(x, qt, s, argmax_n=vocab).tolist() == [7, 7]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_next", [False, True])
def test_mlp_kernel_matches_plain(dev, dtype, with_next):
    gen = torch.Generator(device=dev).manual_seed(2)
    m, d, ff = 2, 256, 1024
    wu, su = _pack(gen, ff, d, dev)
    wd, sd = _pack(gen, d, ff, dev)
    x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    resid = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    ns = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    nxt = None
    if with_next:
        wq, sq = _pack(gen, 3 * d, d, dev)
        nxt = (wq, sq, torch.randn(3 * d, generator=gen, device=dev), ns * 0.9, ns * 0.1)
    args = (x, wu, su * 0.1, wd, sd * 0.1, torch.randn(ff, generator=gen, device=dev),
            torch.randn(d, generator=gen, device=dev))
    kw = dict(activation="gelu", norm="layernorm", norm_scale=ns, norm_bias=0.1 * ns,
              residual=resid, next_qkv=nxt)
    out, ref = qm.quant_mlp_int8(*args, **kw), qm.quant_mlp_int8_ref(*args, **kw)
    if with_next:
        _close(out[1], ref[1], dtype)
        out, ref = out[0], ref[0]
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head_dim", [64, 128])
def test_attention_kernel_matches_plain(dev, dtype, head_dim):
    gen = torch.Generator(device=dev).manual_seed(3)
    lens = torch.tensor([0, 5, 63, 64, 255], dtype=torch.int32, device=dev)
    b, h, s_max, dm = len(lens), 4, 256, 320
    kc = torch.randn(b, h, s_max, head_dim, generator=gen, device=dev).to(dtype)
    vc = torch.randn(b, h, s_max, head_dim, generator=gen, device=dev).to(dtype)
    qkv = (0.3 * torch.randn(b, 3, h, 1, head_dim, generator=gen, device=dev)).to(dtype)
    wo, wos = _pack(gen, dm, h * head_dim, dev)
    bo = torch.randn(dm, generator=gen, device=dev)
    resid = torch.randn(b, dm, generator=gen, device=dev).to(dtype)
    kc2, vc2 = kc.clone(), vc.clone()
    out = decode_attention(qkv, kc, vc, lens, wo, wos, bo, residual=resid)
    ref = decode_attention_ref(qkv, kc2, vc2, lens, wo, wos, bo, residual=resid)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    _close(out, ref, dtype)
    assert math.isfinite(out.float().abs().max().item())


@pytest.mark.parametrize("kv_len", [300, 767])
def test_attention_vector_many_chunks(dev, kv_len):
    """The f32 attention vector over 12 split-KV chunks (S 768), scores
    spread (std ~2) so that a wrong chunk max, combine rescale or dropped
    chunk shows: an identity W_o at scale 1 returns the vector unrounded,
    held against the einsum / softmax in f64 (atol 1e-5)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    h, d, s_max = 12, 64, 768
    kc = 1.5 * torch.randn(1, h, s_max, d, generator=gen, device=dev)
    vc = torch.randn(1, h, s_max, d, generator=gen, device=dev)
    qkv = 1.5 * torch.randn(1, 3, h, 1, d, generator=gen, device=dev)
    lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    eye = torch.eye(h * d, device=dev).to(torch.int8)
    k64 = torch.cat([kc[0, :, :kv_len], qkv[0, 1]], 1).double()
    v64 = torch.cat([vc[0, :, :kv_len], qkv[0, 2]], 1).double()
    scores = torch.einsum("hd,hsd->hs", qkv[0, 0, :, 0].double(), k64) / math.sqrt(d)
    assert scores.std().item() > 2.0
    ref = torch.einsum("hs,hsd->hd", torch.softmax(scores, -1), v64).reshape(1, -1)
    out = decode_attention(qkv, kc, vc, lens, eye, torch.ones(h * d, device=dev))
    assert (out.double() - ref).abs().max().item() <= 1e-5
    assert torch.equal(kc[0, :, kv_len], qkv[0, 1, :, 0])


def test_attention_full_cache_row_is_nan(dev):
    """kv_len = S: the kernel writes nothing and returns NaN for the row
    (the plain version raises IndexError)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    h, d, s_max = 4, 64, 128
    kc = torch.randn(1, h, s_max, d, generator=gen, device=dev)
    vc = torch.randn(1, h, s_max, d, generator=gen, device=dev)
    kc0, vc0 = kc.clone(), vc.clone()
    qkv = torch.randn(1, 3, h, 1, d, generator=gen, device=dev)
    wo, wos = _pack(gen, 256, h * d, dev)
    lens = torch.tensor([s_max], dtype=torch.int32, device=dev)
    out = decode_attention(qkv, kc, vc, lens, wo, wos)
    assert bool(out.isnan().all())
    assert torch.equal(kc, kc0) and torch.equal(vc, vc0)
    with pytest.raises(IndexError):
        decode_attention_ref(qkv, kc, vc, lens, wo, wos)


def test_generate_greedy_past_cache_raises(dev):
    from rten_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024,
                                max_seq=256, dtype=torch.bfloat16)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)
    cache = decoder.init_cache(cfg, 1, 8, device=dev)
    first = torch.tensor([[3]], dtype=torch.int32, device=dev)
    with pytest.raises(IndexError, match="KV cache full"):
        decoder.generate_greedy(params, cfg, cache, first, 9)
    assert cache["host_len"] == 8 and int(cache["len"][0]) == 8


def test_tiny_decoder_kernels_match_plain(dev):
    """Greedy tokens and logits of the tiny f32 decoder: kernels against the
    plain versions, both on the card."""
    from rten_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024,
                                max_seq=256, dtype=torch.float32)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)
    prompt = torch.tensor([[11, 42, 7, 300, 5]], dtype=torch.int32, device=dev)

    def run(plain):
        saved = (decoder.quant_gemv_int8, decoder.quant_mlp_int8, decoder.decode_attention)
        if plain:
            decoder.quant_gemv_int8 = qm.quant_gemv_int8_ref
            decoder.quant_mlp_int8 = qm.quant_mlp_int8_ref
            decoder.decode_attention = decode_attention_ref
        try:
            cache = decoder.init_cache(cfg, 1, 64, device=dev)
            logits, cache = decoder.prefill(params, cfg, prompt, cache)
            first = logits[:, -1:].argmax(-1).to(torch.int32)
            toks, _ = decoder.generate_greedy(params, cfg, cache, first, 8)
            return logits, toks
        finally:
            decoder.quant_gemv_int8, decoder.quant_mlp_int8, decoder.decode_attention = saved

    dispatch.reset_counters()
    k_logits, k_toks = run(False)
    assert dispatch.PLAIN == {} and set(dispatch.LAUNCHES) == {
        "quant_gemv_int8", "quant_mlp_int8", "decode_attention"}
    p_logits, p_toks = run(True)
    _close(k_logits, p_logits, torch.float32)
    assert k_toks.tolist() == p_toks.tolist()
