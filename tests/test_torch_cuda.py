"""The port's CUDA kernels against their plain versions on the card, at
small shapes and in both activation dtypes, and the tiny decoder end to end
through the kernels against the plain path.

Needs an NVIDIA card and nvcc: marked ``gpu``; every test skips where
``torch.cuda.is_available()`` is false (decided in a fixture, not at
import). This file imports neither JAX nor the JAX package,
so on a machine without JAX it runs with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: f32 atol 1e-4 relative to max(1, |plain|) (same f32 arithmetic,
another summation order); bf16 outputs 1e-2 relative (one bf16 rounding);
attention outputs relative to their own max.
"""

import contextlib
import math

import pytest
import torch

from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels import quant_matmul as qm
from rten_tpu_torch.kernels.attention import flash_attention, flash_attention_ref
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


@pytest.mark.parametrize("m", [4, 8])
def test_mlp_kernel_rows_over_48kb_smem(dev, m):
    """GPT-2-small's MLP at 4 and 8 rows (a serving tick, a short prompt):
    the down projection stages m x 3072 f32 rows, over the 48 KB default
    of dynamic shared memory."""
    gen = torch.Generator(device=dev).manual_seed(14)
    d, ff = 768, 3072
    wu, su = _pack(gen, ff, d, dev)
    wd, sd = _pack(gen, d, ff, dev)
    x = torch.randn(m, d, generator=gen, device=dev).to(torch.bfloat16)
    ns = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    args = (x, wu, su * 0.1, wd, sd * 0.1, None, None)
    kw = dict(activation="gelu", norm="layernorm", norm_scale=ns, norm_bias=0.1 * ns, residual=x)
    _close(qm.quant_mlp_int8(*args, **kw), qm.quant_mlp_int8_ref(*args, **kw), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,act,with_bias", [
    (9, 384, 256, None, True),      # one row past the GEMV's 8
    (64, 2304, 768, "gelu", True),  # GPT-2's qkv width, 64 prompt rows
    (130, 200, 256, "relu", False),  # ragged M and N
    (77, 131, 1040, None, True),     # odd N (unpaired stores), K not a multiple of 32
])
def test_matmul_kernel_matches_plain(dev, dtype, m, n, k, act, with_bias):
    gen = torch.Generator(device=dev).manual_seed(6)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    bias = torch.randn(n, generator=gen, device=dev) if with_bias else None
    before = dispatch.LAUNCHES["quant_matmul_int8"]
    out = qm.quant_matmul_int8(x, qt, s, bias, activation=act)
    assert dispatch.LAUNCHES["quant_matmul_int8"] == before + 1
    assert out.shape == (m, n) and out.dtype == dtype
    _close(out, qm.quant_matmul_int8_ref(x, qt, s, bias, activation=act), dtype)


def test_matmul_kernel_f32_logits_and_dtypes(dev):
    """bf16 rows to f32 logits (the lm_head at > 8 rows); other activation
    dtypes are refused."""
    gen = torch.Generator(device=dev).manual_seed(7)
    qt, s = _pack(gen, 1024 + 96, 256, dev)
    x = torch.randn(20, 256, generator=gen, device=dev).to(torch.bfloat16)
    out = qm.quant_matmul_int8(x, qt, s, out_dtype=torch.float32)
    ref = qm.quant_matmul_int8_ref(x, qt, s, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    _close(out, ref, torch.float32)
    with pytest.raises(TypeError):
        qm.quant_matmul_int8(x.half(), qt, s)


# (b, hq, hk, tq, s, causal, q_offset, kv_len), as in test_torch_kernels.py.
FLASH_CASES = {
    "causal": (2, 2, 2, 64, 128, True, None, None),
    "non_causal": (1, 2, 2, 40, 128, False, None, [97]),
    "gqa": (1, 4, 2, 48, 128, True, None, None),
    "q_offset_kv_len": (2, 2, 2, 24, 256, True, [100, 7], [124, 31]),
    "ragged_tq": (1, 3, 3, 13, 128, True, [50], [63]),
    "kv_len_0_row": (2, 2, 1, 9, 128, True, [0, 60], [0, 69]),
    "long": (1, 2, 2, 200, 300, True, [100], [300]),
    # Whisper-tiny's attention shapes: the encoder's (Tq = S = 1500, not
    # causal: 23 tiles of 64 positions and a last one of 28) and the cross
    # attention of one decoder token over the 1500 audio positions.
    "whisper_encoder": (1, 6, 6, 1500, 1500, False, None, None),
    "whisper_cross": (2, 6, 6, 1, 1500, False, None, None),
}


def _flash_inputs(dev, case, dtype, d, seed=8):
    b, hq, hk, tq, s, causal, q_offset, kv_len = FLASH_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    # q, k at std 1.5: scores of std ~2.25, a peaked softmax, so a wrong
    # running max, rescale or dropped tile moves the output by O(1).
    q = (1.5 * torch.randn(b, hq, tq, d, generator=gen, device=dev)).to(dtype)
    k = (1.5 * torch.randn(b, hk, s, d, generator=gen, device=dev)).to(dtype)
    v = torch.randn(b, hk, s, d, generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal)
    if q_offset is not None:
        kw["q_offset"] = torch.tensor(q_offset, dtype=torch.int32, device=dev)
    if kv_len is not None:
        kw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return (q, k, v), kw


def _close_own_max(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel_matches_plain(dev, dtype, case):
    args, kw = _flash_inputs(dev, case, dtype, 64)
    before = dispatch.LAUNCHES["flash_attention"]
    out = flash_attention(*args, **kw)
    assert dispatch.LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention_ref(*args, **kw)
    _close_own_max(out, ref, dtype)
    assert out.transpose(1, 2).is_contiguous()
    if case == "kv_len_0_row":
        assert not out[0].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["q_offset_kv_len", "gqa"])
def test_flash_kernel_head_dim_128(dev, dtype, case):
    args, kw = _flash_inputs(dev, case, dtype, 128)
    _close_own_max(flash_attention(*args, **kw), flash_attention_ref(*args, **kw), dtype)


def test_flash_kernel_against_f64_softmax(dev):
    """f32 operands: the kernel's output against the softmax in f64 (atol
    1e-5 of the output's max), causal at q_offset 100."""
    (q, k, v), kw = _flash_inputs(dev, "long", torch.float32, 64)
    out = flash_attention(q, k, v, **kw).double()
    scores = torch.einsum("bhqd,bhsd->bhqs", q.double(), k.double()) / 8.0
    row = torch.arange(q.shape[2], device=dev)[:, None] + 100
    scores = scores.masked_fill(torch.arange(k.shape[2], device=dev)[None, :] > row, -math.inf)
    ref = torch.einsum("bhqs,bhsd->bhqd", torch.softmax(scores, -1), v.double())
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# f32 flash_attention against the softmax in f64: (b, hq, hk, tq, s, causal,
# q_offset, kv_len, d). Not causal with per-row lengths at 197 x 64 (ViT's
# and the encoders' rows), causal at q_offset 100, GQA 14/2 at a q_offset
# (split over KV), head dims 32 and 128, one query over 1500 positions
# (Whisper's cross attention, split), and 320 (the 128 instance in three
# slices).
F32_F64_CASES = {
    "not_causal_lens_197": (4, 4, 4, 197, 197, False, None, [197, 150, 97, 20], 64),
    "long": (1, 2, 2, 200, 300, True, [100], [300], 64),
    "gqa_14_over_2": (1, 14, 2, 64, 1024, True, [300], [364], 64),
    "d32": (4, 4, 4, 197, 197, False, None, [197, 150, 97, 20], 32),
    "d128": (1, 2, 2, 200, 300, True, [100], [300], 128),
    "tq1_s1500": (2, 6, 6, 1, 1500, False, None, None, 64),
    "d320": (2, 8, 2, 64, 256, True, [100, 100], [164, 164], 320),
}
# max |out - f64| / max |f64| of test_flash_f32_against_f64, its inputs'
# lowest 8 significand bits set (so every lo part of the three-way split is
# near its largest, 2^-15 of the value). Measured over the cases on an
# NVIDIA H100 80GB HBM3, 700 W (PERF.md, section 6): the earlier f32 kernel
# (FMA on the CUDA cores) 6.06e-7 to 1.75e-6; the six-pass kernel 2.52e-7
# to 7.2e-7; the same kernel keeping only hi.hi, hi.mid and mid.hi 5.4e-5
# to 1.32e-4, which fails here.
F32_FLASH_F64_TOL = 1e-5


def _low_bits_set(t):
    """t with its lowest 8 significand bits set: within 2^-15 of t."""
    return (t.view(torch.int32) | 0xFF).view(torch.float32)


@pytest.mark.parametrize("case", list(F32_F64_CASES))
def test_flash_f32_against_f64(dev, case):
    """The f32 kernel (six bf16 products of split operands on the tensor
    cores) against the softmax in f64 (chip_smoke.flash_f64), within
    F32_FLASH_F64_TOL of the output's max."""
    b, hq, hk, tq, s, causal, q_offset, kv_len, d = F32_F64_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(23)
    q = _low_bits_set(1.5 * torch.randn(b, hq, tq, d, generator=gen, device=dev))
    k = _low_bits_set(1.5 * torch.randn(b, hk, s, d, generator=gen, device=dev))
    v = _low_bits_set(torch.randn(b, hk, s, d, generator=gen, device=dev))
    kw = dict(causal=causal)
    if q_offset is not None:
        kw["q_offset"] = torch.tensor(q_offset, dtype=torch.int32, device=dev)
    if kv_len is not None:
        kw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    import chip_smoke

    out = flash_attention(q, k, v, **kw).double()
    ref = chip_smoke.flash_f64(torch, q, k, v, causal, kw.get("q_offset"), kw.get("kv_len"))
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    print(f"f32 flash {case}: {rel:.3g} of the output's max from the f64 softmax")
    assert rel <= F32_FLASH_F64_TOL, rel


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_strided_views(dev, dtype):
    """q, k, v as views of a packed [B, T, 3, H, D] qkv (the decoder's
    no-cache forward), against the plain version on contiguous copies."""
    gen = torch.Generator(device=dev).manual_seed(9)
    b, t, h, d = 2, 37, 3, 64
    qkv = (1.5 * torch.randn(b, t, 3, h, d, generator=gen, device=dev)).to(dtype)
    q, k, v = (p.transpose(1, 2) for p in qkv.unbind(2))
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    _close_own_max(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tq", [1500, 1])
def test_flash_kernel_whisper_views(dev, dtype, tq):
    """The encoder-decoder's operands: q, k, v as [B, H, T, D] views of
    [B·T, H·D] projections (rows 768 or 1536 bytes apart), S 1500, not
    causal; against the plain version on contiguous copies."""
    gen = torch.Generator(device=dev).manual_seed(10)
    b, s, h, d = 1, 1500, 6, 64

    def heads(t):
        return (1.5 * torch.randn(b * t, h * d, generator=gen, device=dev)).to(dtype).view(b, t, h, d).transpose(1, 2)

    q, k, v = heads(tq), heads(s), heads(s)
    out = flash_attention(q, k, v, causal=False)
    ref = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    _close_own_max(out, ref, dtype)


def test_generate_greedy_past_cache_raises(dev):
    from rten_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024,
                                max_seq=256, dtype=torch.bfloat16)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)
    cache = decoder.init_cache(cfg, 1, 8, device=dev)
    first = torch.tensor([[3]], dtype=torch.int32, device=dev)
    with pytest.raises(IndexError, match="KV cache full"):
        decoder.generate_greedy(params, cfg, cache, first, 9)  # checked for all 9 steps before the capture
    assert cache["host_len"] == 0 and int(cache["len"][0]) == 0
    decoder.generate_greedy(params, cfg, cache, first, 8)
    with pytest.raises(IndexError, match="KV cache full"):
        decoder.generate_greedy(params, cfg, cache, first, 1)
    assert cache["host_len"] == 8 and int(cache["len"][0]) == 8


@contextlib.contextmanager
def _plain_decoder(decoder):
    """Route the decoder's seven kernel calls to their plain versions, and
    every captured decode path to its eager steps (the plain versions read
    lengths on the host, which a CUDA graph capture cannot)."""
    from rten_tpu_torch.kernels.decode_attention import decode_block_ref

    names = ("quant_gemv_int8", "quant_mlp_int8", "quant_matmul_int8", "quant_matmul_w8a8", "decode_attention",
             "decode_block", "flash_attention", "_capturable")
    saved = {name: getattr(decoder, name) for name in names}
    decoder._capturable = lambda *args: False
    decoder.quant_gemv_int8 = qm.quant_gemv_int8_ref
    decoder.quant_mlp_int8 = qm.quant_mlp_int8_ref
    decoder.quant_matmul_int8 = qm.quant_matmul_int8_ref
    decoder.quant_matmul_w8a8 = qm.quant_matmul_w8a8_ref
    decoder.decode_attention = decode_attention_ref
    decoder.decode_block = decode_block_ref
    decoder.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(decoder, name, fn)


def _tiny(dtype, dev):
    from rten_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024,
                                max_seq=256, dtype=dtype)
    return decoder, cfg, decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)


def test_tiny_decoder_kernels_match_plain(dev):
    """Greedy tokens and logits of the tiny f32 decoder: kernels against the
    plain versions, both on the card (a 5-token prompt: one forward of the
    fused decode structure, attention through flash_attention)."""
    decoder, cfg, params = _tiny(torch.float32, dev)
    prompt = torch.tensor([[11, 42, 7, 300, 5]], dtype=torch.int32, device=dev)

    def run():
        cache = decoder.init_cache(cfg, 1, 64, device=dev)
        logits, cache = decoder.prefill(params, cfg, prompt, cache)
        first = logits[:, -1:].argmax(-1).to(torch.int32)
        toks, _ = decoder.generate_greedy(params, cfg, cache, first, 8)
        return logits, toks

    dispatch.reset_counters()
    k_logits, k_toks = run()
    assert dispatch.PLAIN == {} and set(dispatch.LAUNCHES) == {
        "quant_gemv_int8", "quant_mlp_int8", "decode_attention", "flash_attention"}
    with _plain_decoder(decoder):
        p_logits, p_toks = run()
    _close(k_logits, p_logits, torch.float32)
    assert k_toks.tolist() == p_toks.tolist()


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiny_decoder_prefill_matches_plain(dev, dtype):
    """A 20-token prompt as one forward (quant_matmul_int8 and
    flash_attention), then a 9-token follow-up at q_offset 20, then 4
    greedy steps: kernels against the plain versions on the card."""
    decoder, cfg, params = _tiny(dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    prompt = torch.randint(0, cfg.vocab_size, (2, 29), generator=gen, device=dev, dtype=torch.int32)

    def run():
        cache = decoder.init_cache(cfg, 2, 64, device=dev)
        first, cache = decoder.prefill(params, cfg, prompt[:, :20], cache)
        second, cache = decoder.prefill(params, cfg, prompt[:, 20:], cache)
        toks, cache = decoder.generate_greedy(params, cfg, cache, prompt[:, -1:], 4)
        return torch.cat([first, second], 1), toks, cache

    dispatch.reset_counters()
    k_logits, k_toks, k_cache = run()
    assert dispatch.PLAIN == {}
    assert dispatch.LAUNCHES["quant_matmul_int8"] == 2 * (4 * cfg.n_layers + 1)
    assert dispatch.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    with _plain_decoder(decoder):
        p_logits, p_toks, p_cache = run()
    assert k_logits.shape == (2, 29, cfg.vocab_size)
    # bf16: the activations are rounded after sums taken in another order,
    # and a flipped rounding in layer 0 carries through the second layer.
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (k_logits - p_logits).abs().max().item() <= tol * max(1.0, p_logits.abs().max().item())
    for li in range(cfg.n_layers):
        _close(k_cache["k"][li], p_cache["k"][li], dtype)
    if dtype == torch.float32:
        assert k_toks.tolist() == p_toks.tolist()


# ---------------------------------------------------------------------------
# The serving path's KV kernels: decode_attention_int8, paged_decode_attention,
# paged_decode_attention_int8
# ---------------------------------------------------------------------------

KV_KINDS = ["int8", "paged", "paged_int8"]


def _kv_case(dev, kind, dtype, d, page=64, seed=11):
    """Inputs of one KV kernel: rows at kv_len 0, 63, 64, 150 and the last
    position (191 of 3 pages, or S - 1), pages scattered through a pool of
    12 (page 11 the scratch page); int8 payloads with scales in [0.005,
    0.02]. Returns (kernel, plain, args); args[0] is the packed qkv."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(seed)
    h, b = 4, 5
    qkv = (1.5 * torch.randn(b, 3, h, 1, d, generator=gen, device=dev)).to(dtype)
    # Row 1's new k/v on .5 code boundaries (head 0 at scale 1, head 1 at
    # 0.5; exact in bf16): round half to even and half away differ there.
    half = torch.tensor([[127.0, 2.5, -3.5, 0.5, 1.5, -0.5], [63.5, 1.25, -1.75, 0.25, 0.75, -0.25]], device=dev)
    qkv[1, 1:, :2, 0] = 0
    qkv[1, 1:, :2, 0, :6] = half.to(dtype)
    int8 = kind.endswith("int8")
    if kind == "int8":
        s_max = 3 * page
        shape = (b, h, s_max, d)
    else:
        shape = (12, h, page, d)
    if int8:
        payload = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8) for _ in range(2)]
        payload += [0.005 + 0.015 * torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
    else:
        payload = [(1.5 * torch.randn(shape, generator=gen, device=dev)).to(dtype),
                   torch.randn(shape, generator=gen, device=dev).to(dtype)]
    lens = torch.tensor([0, 63, 64, 150, 3 * page - 1], dtype=torch.int32, device=dev)
    if kind == "int8":
        return da.decode_attention_int8, da.decode_attention_int8_ref, (qkv, *payload, lens)
    table = torch.tensor([[11, 11, 11], [3, 11, 11], [7, 2, 11], [5, 0, 9], [10, 1, 8]],
                         dtype=torch.int32, device=dev)
    if kind == "paged":
        return pa.paged_decode_attention, pa.paged_decode_attention_ref, (qkv, *payload, table, lens)
    return pa.paged_decode_attention_int8, pa.paged_decode_attention_int8_ref, (qkv, *payload, table, lens)


def _clone_args(args):
    return [a.clone() for a in args]


def _rule_page(kind: str, d: int) -> int:
    """The smallest page of at least 64 positions that the JAX rule of a
    paged kind admits at head dim d (``paged_attention.py:205`` and :213)."""
    return max(64, (4096 if kind.endswith("int8") else 1024) // d) if kind.startswith("paged") else 64


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", KV_KINDS)
def test_kv_kernel_matches_plain(dev, kind, dtype, head_dim):
    """Attention vector against the plain version (own-max tolerance), and
    the caches after the append bit for bit (int8: codes and scales)."""
    kernel, plain, args = _kv_case(dev, kind, dtype, head_dim, page=_rule_page(kind, head_dim))
    k_args, p_args = _clone_args(args), _clone_args(args)
    name = kernel.__name__
    before = dispatch.LAUNCHES[name]
    out = kernel(*k_args)
    assert dispatch.LAUNCHES[name] == before + 1
    ref = plain(*p_args)
    assert out.shape == (5, 4 * head_dim) and out.dtype == dtype
    _close_own_max(out, ref, dtype)
    n_cache = 4 if kind.endswith("int8") else 2
    for a, b in zip(k_args[1 : 1 + n_cache], p_args[1 : 1 + n_cache]):
        assert torch.equal(a, b)
    if kind.endswith("int8"):  # row 1 appends at 63: its own row, or pool page 3
        codes = k_args[1][1 if kind == "int8" else 3, :2, 63, :6]
        assert codes.tolist() == [[127, 2, -4, 0, 2, 0]] * 2


@pytest.mark.parametrize("kind", KV_KINDS)
def test_kv_kernel_page_128_and_f64(dev, kind):
    """Pages (or S) of 3 x 128 positions, f32: the attention vector against
    the softmax in f64 over the dequantized cache the plain version leaves
    (atol 1e-5 of its max)."""
    from rten_tpu_torch.kernels.decode_attention import attend_ref, dequantize_kv

    kernel, plain, args = _kv_case(dev, kind, torch.float32, 64, page=128, seed=12)
    k_args, p_args = _clone_args(args), _clone_args(args)
    out = kernel(*k_args).double()
    plain(*p_args)
    qkv, lens = args[0], args[-1].tolist()
    int8 = kind.endswith("int8")
    rows = []
    for bi, n in enumerate(lens):
        if kind == "int8":
            k, v = p_args[1][bi, :, : n + 1], p_args[2][bi, :, : n + 1]
            if int8:
                k = dequantize_kv(k, p_args[3][bi, :, : n + 1], torch.float64)
                v = dequantize_kv(v, p_args[4][bi, :, : n + 1], torch.float64)
        else:
            pages = p_args[-2][bi, : n // 128 + 1].tolist()
            k, v = p_args[1][pages], p_args[2][pages]
            if int8:
                k = dequantize_kv(k, p_args[3][pages], torch.float64)
                v = dequantize_kv(v, p_args[4][pages], torch.float64)
            k, v = (t.permute(1, 0, 2, 3).reshape(4, -1, 64)[:, : n + 1] for t in (k, v))
        rows.append(attend_ref(qkv[bi, 0, :, 0].double(), k.double(), v.double(), 1 / 8.0))
    ref = torch.stack(rows)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("kind", KV_KINDS)
def test_kv_kernel_full_row_is_nan(dev, kind):
    """kv_len at the row's capacity: the kernel writes nothing and returns
    NaN for that row; the other rows are unchanged. A table entry outside
    the pool gives NaN too (paged)."""
    kernel, _plain, args = _kv_case(dev, kind, torch.float32, 64)
    args = _clone_args(args)
    lens = args[-1]
    lens[4] = 3 * 64
    if kind != "int8":
        args[-2][2, 1] = 99  # row 2's new token lands in its second page: outside the pool
    before = _clone_args(args)
    out = kernel(*args)
    bad = [4] if kind == "int8" else [2, 4]
    assert bool(out[bad].isnan().all()) and bool(out[[0, 1, 3]].isfinite().all())
    n_cache = 4 if kind.endswith("int8") else 2
    for a, b in zip(args[1 : 1 + n_cache], before[1 : 1 + n_cache]):
        changed = (a != b).reshape(a.shape[0], -1).any(1)
        assert not changed[4 if kind == "int8" else 8]  # the full row's (last) page is untouched


def _engine_outputs(engine_cls, params, cfg, specs, dev, **kw):
    from rten_tpu_torch.serve import Request

    engine = engine_cls(params, cfg, device=dev, **kw)
    reqs = [engine.submit(Request(**s)) for s in specs]
    engine.run()
    return [r.output for r in reqs], engine


@pytest.mark.parametrize("engine", ["paged", "int8_slot", "int8_paged", "w8a8_slot"])
def test_tiny_engines_match_cpu(dev, engine):
    """The paged engine, the int8 engines and the W8A8 slot engine at the
    tiny f32 config: the same requests on the card (kernels) and on the CPU
    (plain versions) give the same streams, and the card run launched its
    KV kernel (W8A8: its three kernels)."""
    import dataclasses

    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.serve import PagedServingEngine, ServingEngine

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024,
                                max_seq=256, dtype=torch.float32)
    cpu_params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cpu"), device="cpu")
    gpu_params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)
    gen = torch.Generator().manual_seed(13)
    specs = [dict(prompt=torch.randint(1, 500, (n,), generator=gen).tolist(), max_new_tokens=m)
             for n, m in ((3, 20), (70, 12), (12, 30), (130, 8))]
    if engine in ("int8_slot", "w8a8_slot"):
        cfg8 = dataclasses.replace(cfg, int8_kv=engine == "int8_slot", w8a8=engine == "w8a8_slot")
        run = lambda p, d: _engine_outputs(ServingEngine, p, cfg8, specs, d, max_batch=3, steps_per_tick=4)  # noqa: E731
        name = "decode_attention_int8" if engine == "int8_slot" else "quant_matmul_w8a8"
    else:
        int8 = engine == "int8_paged"
        run = lambda p, d: _engine_outputs(PagedServingEngine, p, cfg, specs, d, max_batch=3,  # noqa: E731
                                           n_pages=6, page_size=64, int8_kv=int8)
        name = "paged_decode_attention_int8" if int8 else "paged_decode_attention"
    dispatch.reset_counters()
    on_card, eng = run(gpu_params, dev)
    assert dispatch.LAUNCHES[name] > 0 and not dispatch.PLAIN
    if engine == "w8a8_slot":
        assert dispatch.LAUNCHES["quant_gemv_int8:w8a8"] > 0 and dispatch.LAUNCHES["quant_mlp_int8:w8a8"] > 0
    on_cpu, _ = run(cpu_params, "cpu")
    assert on_card == on_cpu
    if engine.endswith("paged"):
        assert eng.pool.n_free == eng.pool.n_pages


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["bf16_cache", "int8", "paged", "paged_int8"])
def test_kv_kernels_at_16_rows(dev, kind, dtype):
    """Each KV kernel at 16 rows of mixed lengths (0 to S - 1 of S 448,
    Whisper-tiny's 6 heads of 64; pages of 64 scattered through the pool):
    one launch for all rows, the attention vector against the plain version
    (own-max tolerance) and the caches after the append bit for bit."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(16)
    b, h, d, s, page = 16, 6, 64, 448, 64
    lens = torch.tensor([0, 1, 63, 64, 100, 150, 200, 255, 256, 300, 350, 383, 384, 400, 446, 447],
                        dtype=torch.int32, device=dev)
    ops = tuple((1.5 * torch.randn(b, h, d, generator=gen, device=dev)).to(dtype) for _ in range(3))
    paged = kind.startswith("paged")
    shape = (b * (s // page) + 1, h, page, d) if paged else (b, h, s, d)
    if kind.endswith("int8"):
        cache = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8) for _ in range(2)]
        cache += [0.005 + 0.015 * torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
    else:
        cache = [(1.5 * torch.randn(shape, generator=gen, device=dev)).to(dtype) for _ in range(2)]
    extra = []
    if paged:
        perm = torch.randperm(b * (s // page), generator=gen, device=dev).to(torch.int32)
        extra = [perm.view(b, s // page).contiguous()]
    kernel, plain = {"bf16_cache": (da.decode_attention, da.decode_attention_ref),
                     "int8": (da.decode_attention_int8, da.decode_attention_int8_ref),
                     "paged": (pa.paged_decode_attention, pa.paged_decode_attention_ref),
                     "paged_int8": (pa.paged_decode_attention_int8, pa.paged_decode_attention_int8_ref)}[kind]
    k_args, p_args = [c.clone() for c in cache + extra], [c.clone() for c in cache + extra]
    dispatch.reset_counters()
    out = kernel(ops, *k_args, lens)
    assert sum(dispatch.LAUNCHES.values()) == 1 and not dispatch.PLAIN
    ref = plain(ops, *p_args, lens)
    assert out.shape == (b, h * d)
    _close_own_max(out, ref, dtype)
    for a, c in zip(k_args[: len(cache)], p_args[: len(cache)]):
        assert torch.equal(a, c)


def _tiny_encdec(dev, dtype=torch.float32, int8_kv=False):
    from rten_tpu_torch.models import encoder_decoder as ed

    cfg = ed.EncDecConfig(n_mels=16, n_audio_ctx=32, vocab_size=500, d_model=256, n_heads=4, n_audio_layers=2,
                          n_text_layers=2, d_ff=512, max_text_ctx=64, dtype=dtype, int8_kv=int8_kv)
    return ed, cfg, ed.quantize_params_int8(ed.init_params(0, cfg, device=dev), device=dev)


@contextlib.contextmanager
def _plain_encdec(ed):
    """Route the encoder-decoder's kernel calls (and the decoder's, whose
    ``_attention`` it uses for a prompt) to their plain versions."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.models import decoder

    plain = {ed: dict(quant_gemv_int8=qm.quant_gemv_int8_ref, quant_mlp_int8=qm.quant_mlp_int8_ref,
                      quant_matmul_int8=qm.quant_matmul_int8_ref, decode_attention=decode_attention_ref,
                      decode_attention_int8=da.decode_attention_int8_ref, flash_attention=flash_attention_ref),
             decoder: dict(flash_attention=flash_attention_ref)}
    saved = {(mod, name): getattr(mod, name) for mod, names in plain.items() for name in names}
    for mod, names in plain.items():
        for name, fn in names.items():
            setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
def test_tiny_encdec_kernels_match_plain(dev, int8_kv):
    """The tiny f32 encoder-decoder on the card: the encoder states, a
    3-token prompt and 6 fused one-token steps at 2 rows through the
    kernels against the plain versions on the same card (relative 1e-4 of
    the logits' max; the same greedy tokens), every step launching the
    fused structure's kernels and no plain version."""
    ed, cfg, params = _tiny_encdec(dev, int8_kv=int8_kv)
    mel = torch.randn(2, 16, 64, generator=torch.Generator(device=dev).manual_seed(3), device=dev)

    def run():
        enc = ed.encode(params, cfg, mel)
        state = ed.init_decoder_state(params, cfg, enc)
        tok = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32, device=dev)
        logits = []
        for _ in range(7):
            lg, state = ed.decode(params, cfg, tok, state)
            logits.append(lg[:, -1])
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        return enc, torch.stack(logits)

    dispatch.reset_counters()
    enc, got = run()
    assert not dispatch.PLAIN
    kv = "decode_attention_int8" if int8_kv else "decode_attention:no_wo"
    assert dispatch.LAUNCHES[kv] == 6 * 2 and dispatch.LAUNCHES["quant_mlp_int8"] == 6 * 2
    with _plain_encdec(ed):
        enc_ref, want = run()
    _close(enc, enc_ref, torch.float32)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("engine", ["slot", "int8_slot", "paged", "int8_paged"])
def test_tiny_engines_at_16_rows_match_cpu(dev, engine):
    """Both engines at max_batch 16 (bf16/f32 and int8 KV) on the tiny f32
    config: 18 requests on the card (kernels) and on the CPU (plain
    versions) give the same streams; every decode forward launched the KV
    kernel once a layer and no plain version ran."""
    import dataclasses

    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.serve import PagedServingEngine, ServingEngine

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024,
                                max_seq=256, dtype=torch.float32)
    cpu_params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cpu"), device="cpu")
    gpu_params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)
    gen = torch.Generator().manual_seed(14)
    specs = [dict(prompt=torch.randint(1, 500, (int(n),), generator=gen).tolist(), max_new_tokens=int(m))
             for n, m in zip(torch.randint(1, 40, (18,), generator=gen), torch.randint(4, 20, (18,), generator=gen))]
    int8 = engine.startswith("int8")
    if engine.endswith("slot"):
        run_cfg = dataclasses.replace(cfg, int8_kv=int8)
        run = lambda p, d: _engine_outputs(ServingEngine, p, run_cfg, specs, d, max_batch=16, steps_per_tick=4)  # noqa: E731
        name = "decode_attention_int8" if int8 else "decode_attention:no_wo"
    else:
        run = lambda p, d: _engine_outputs(PagedServingEngine, p, cfg, specs, d, max_batch=16,  # noqa: E731
                                           n_pages=24, page_size=64, int8_kv=int8)
        name = "paged_decode_attention_int8" if int8 else "paged_decode_attention"
    dispatch.reset_counters()
    on_card, eng = run(gpu_params, dev)
    assert not dispatch.PLAIN and dispatch.LAUNCHES[name] == cfg.n_layers * eng.steps
    on_cpu, _ = run(cpu_params, "cpu")
    assert on_card == on_cpu


def test_engine_checkpoint_on_card(dev, tmp_path):
    """A sampled int8-KV slot engine on the card, snapshotted mid-run
    through a file and restored into a fresh engine, continues every
    stream as the uninterrupted engine (the CUDA generator's state
    included)."""
    import dataclasses

    from rten_tpu_torch.generate import TemperatureSampler
    from rten_tpu_torch.serve import (Request, ServingEngine, load_snapshot, restore_engine, save_snapshot,
                                      snapshot_engine)

    _decoder, cfg, params = _tiny(torch.bfloat16, dev)
    cfg = dataclasses.replace(cfg, int8_kv=True)
    specs = [dict(prompt=[1 + i, 2 + i, 3], max_new_tokens=12 + i) for i in range(5)]

    def engine():
        return ServingEngine(params, cfg, max_batch=4, steps_per_tick=2, sampler=TemperatureSampler(0.8), seed=7,
                             device=dev)

    eng_a = engine()
    for s in specs:
        eng_a.submit(Request(**s))
    want = {r.request_id: r.output for r in eng_a.run()}
    eng_b = engine()
    for s in specs:
        eng_b.submit(Request(**s))
    done = eng_b.step() + eng_b.step() + eng_b.step()
    save_snapshot(snapshot_engine(eng_b), str(tmp_path / "s.npz"))
    eng_c = engine()
    restore_engine(eng_c, load_snapshot(str(tmp_path / "s.npz")))
    got = {r.request_id: r.output for r in done + eng_c.run()}
    assert got == want


# ---------------------------------------------------------------------------
# generate_scan: n decode steps captured as one CUDA graph
# ---------------------------------------------------------------------------

SCAN_SAMPLERS = {"greedy": None, "temperature": ("TemperatureSampler", (0.8,)),
                 "topk": ("TopKSampler", (50, 0.8)), "topp": ("TopPSampler", (0.9, 0.8))}


@contextlib.contextmanager
def _eager_scan(decoder):
    """Every captured decode path (``generate_scan``, the backends' step,
    the engines' tick and step, the speculative rounds) runs its steps
    eagerly (no capture)."""
    saved = decoder._capturable
    decoder._capturable = lambda *args: False
    try:
        yield
    finally:
        decoder._capturable = saved


def _sampler(name):
    from rten_tpu_torch.generate import sampler as sm

    spec = SCAN_SAMPLERS[name]
    return None if spec is None else getattr(sm, spec[0])(*spec[1])


def _scan_twice(decoder, cfg, params, dev, b, sampler, n=12):
    """A 7-token prompt, then ``generate_scan`` twice (the second call
    replays the first call's graph) with one seeded generator: the tokens
    [B, 2n], the cache and the launch counts of the two calls."""
    gen = torch.Generator(device=dev).manual_seed(21)
    prompt = torch.randint(0, cfg.vocab_size, (b, 7), generator=gen, device=dev, dtype=torch.int32)
    cache = decoder.init_cache(cfg, b, 64, device=dev)
    first, cache = decoder.prefill(params, cfg, prompt, cache, lm_head_mode="argmax", last_only=True)
    rng = torch.Generator(device=dev).manual_seed(5)
    dispatch.reset_counters()
    a, cache = decoder.generate_scan(params, cfg, cache, first, rng, n_steps=n, sampler=sampler)
    c, cache = decoder.generate_scan(params, cfg, cache, a[:, -1:], rng, n_steps=n, sampler=sampler)
    return torch.cat([a, c], 1), cache, dict(dispatch.LAUNCHES)


@pytest.mark.parametrize("name", SCAN_SAMPLERS)
@pytest.mark.parametrize("kind,b", [("bf16", 1), ("bf16", 3), ("int8", 2), ("bf16", 12)])
def test_generate_scan_captured_equals_eager(dev, kind, b, name):
    """The captured steps give the eager steps' tokens with the same seed
    (the generator advances with each replay), count the same launches,
    and leave the same device and host lengths; a second call replays the
    one graph."""
    import dataclasses

    decoder, cfg, params = _tiny(torch.bfloat16, dev)
    cfg = dataclasses.replace(cfg, int8_kv=kind == "int8")
    sampler = _sampler(name)
    got, cache, launches = _scan_twice(decoder, cfg, params, dev, b, sampler)
    assert len(decoder._GRAPHS[cache["len"]]) == 1
    with _eager_scan(decoder):
        want, eager_cache, eager_launches = _scan_twice(decoder, cfg, params, dev, b, sampler)
    assert got.tolist() == want.tolist()
    assert launches == eager_launches and not dispatch.PLAIN
    assert cache["len"].tolist() == eager_cache["len"].tolist() == [7 + 24] * b
    assert cache["host_len"].tolist() == [7 + 24] * b
    if name != "greedy":
        assert len(set(got.view(-1).tolist())) > 3  # the draws are not collapsed onto one token


def test_generate_scan_int8_cache_past_eight_rows_runs_eagerly(dev):
    """An int8 cache above 8 rows attends through decode_attention_int8,
    which reads the lengths on the device, so its steps are captured too
    (no longer eagerly, as when they took the eager int8 branch): one
    graph, the eager steps' tokens and launches."""
    import dataclasses

    decoder, cfg, params = _tiny(torch.bfloat16, dev)
    cfg = dataclasses.replace(cfg, int8_kv=True)
    got, cache, launches = _scan_twice(decoder, cfg, params, dev, 12, _sampler("temperature"))
    assert len(decoder._GRAPHS[cache["len"]]) == 1
    assert launches["decode_attention_int8"] == 2 * 12 * cfg.n_layers
    with _eager_scan(decoder):
        want, _, eager_launches = _scan_twice(decoder, cfg, params, dev, 12, _sampler("temperature"))
    assert got.tolist() == want.tolist() and launches == eager_launches


def test_generate_scan_two_graphs_on_one_stream(dev):
    """Two caches' graphs (greedy at 1 row, top-p at 2) share the capture
    stream's GEMV argmax buffer; their replays, interleaved in order on one
    stream, give their eager runs' tokens."""
    decoder, cfg, params = _tiny(torch.bfloat16, dev)
    cases = [(1, None), (2, _sampler("topp"))]

    def run():
        states = []
        for b, sampler in cases:
            gen = torch.Generator(device=dev).manual_seed(30 + b)
            prompt = torch.randint(0, cfg.vocab_size, (b, 5), generator=gen, device=dev, dtype=torch.int32)
            cache = decoder.init_cache(cfg, b, 64, device=dev)
            first, cache = decoder.prefill(params, cfg, prompt, cache, lm_head_mode="argmax", last_only=True)
            states.append([cache, first, torch.Generator(device=dev).manual_seed(b), []])
        for _ in range(3):
            for (b, sampler), state in zip(cases, states):
                cache, last, rng, out = state
                toks, _ = decoder.generate_scan(params, cfg, cache, last, rng, n_steps=6, sampler=sampler)
                out.append(toks)
                state[1] = toks[:, -1:]
        return [torch.cat(state[3], 1).tolist() for state in states], [state[0] for state in states]

    got, caches = run()
    assert all(len(decoder._GRAPHS[c["len"]]) == 1 for c in caches)
    with _eager_scan(decoder):
        want, _ = run()
    assert got == want


# ---------------------------------------------------------------------------
# The decode programs as captured graphs: the backends' one-token step, the
# slot engine's tick, the paged engine's step and the speculative rounds,
# each against its eager run (decoder._capturable off) bit for bit
# ---------------------------------------------------------------------------


def _graphs(decoder, anchor) -> int:
    return len(decoder._GRAPHS.get(anchor, ()))


def _captured_and_eager(decoder, run):
    """``run()`` captured, then eagerly, each with the launch counters read
    around it: ((result, launches), (result, launches))."""
    dispatch.reset_counters()
    got = run()
    launches = dict(dispatch.LAUNCHES)
    assert not dispatch.PLAIN
    with _eager_scan(decoder):
        dispatch.reset_counters()
        want = run()
        eager_launches = dict(dispatch.LAUNCHES)
    return (got, launches), (want, eager_launches)


BACKEND_CASES = {"bf16_b1": (torch.bfloat16, False, 1, 64), "bf16_b3": (torch.bfloat16, False, 3, 64),
                 "int8_b2": (torch.bfloat16, True, 2, 64), "bf16_b12": (torch.bfloat16, False, 12, 64),
                 "f32_hd96_b2": (torch.float32, False, 2, 96)}


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "logits"])
@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_native_backend_step_captured_equals_eager(dev, case, greedy):
    """NativeBackend's one-token decode as a graph replay against the eager
    forward: a 9-token prompt (eager), then 20 decode steps each fed the
    step's argmax. The same tokens and (logits mode) the same logits bit
    for bit, the same launches by kernel mode, the same host lengths, one
    graph on the cache, and (head dim 96) flash_attention at Tq 1 over the
    cache's whole S under capture."""
    import numpy as np

    from rten_tpu_torch.generate import NativeBackend
    from rten_tpu_torch.models import decoder

    dtype, int8, b, hd = BACKEND_CASES[case]
    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=384 // hd if hd == 96 else 4,
                                d_model=384 if hd == 96 else 256, d_ff=1024, max_seq=256, dtype=dtype, int8_kv=int8)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)
    prompt = np.random.default_rng(9).integers(0, 500, (b, 9)).astype(np.int32)

    def run():
        backend = NativeBackend(params, cfg, batch=b, max_len=64, device=dev)
        out = backend.prefill(prompt, greedy=greedy)
        steps = []
        for _ in range(20):
            tok = out if greedy else out.argmax(-1).to(torch.int32)
            steps.append(out)
            out = backend.decode(tok.cpu().numpy()[:, None], greedy=greedy)
        steps.append(out)
        return torch.stack(steps), backend

    (got, launches), (want, eager_launches) = _captured_and_eager(decoder, run)
    assert torch.equal(got[0], want[0]) and launches == eager_launches
    assert _graphs(decoder, got[1].cache["len"]) == 1 and _graphs(decoder, want[1].cache["len"]) == 0
    assert got[1].length == want[1].length == 29
    assert got[1].cache["host_len"].tolist() == want[1].cache["host_len"].tolist() == [29] * b
    assert got[1].cache["len"].tolist() == [29] * b
    if hd == 96:
        assert launches["flash_attention:d96"] == 21 * cfg.n_layers


def test_native_backend_graph_per_mode_and_cache(dev):
    """A backend's greedy and logits steps are two graphs on its cache; a
    reset (a new cache) and a second backend (another batch) each capture
    anew, and the old graphs never replay on the new tensors: every stream
    equals its eager run."""
    import numpy as np

    from rten_tpu_torch.generate import NativeBackend
    from rten_tpu_torch.models import decoder

    _, cfg, params = _tiny(torch.bfloat16, dev)

    def run():
        streams, anchors = [], []
        for b in (1, 2):
            backend = NativeBackend(params, cfg, batch=b, max_len=64, device=dev)
            for _ in range(2):
                backend.reset()
                anchors.append(backend.cache["len"])
                tok = backend.prefill(np.full((b, 4), 7, np.int32), greedy=True)
                out = [tok]
                for i in range(8):
                    greedy = i % 2 == 0
                    res = backend.decode(tok.cpu().numpy()[:, None], greedy=greedy)
                    tok = res if greedy else res.argmax(-1).to(torch.int32)
                    out.append(tok)
                streams.append(torch.stack(out).tolist())
        return streams, anchors

    (got, launches), (want, eager_launches) = _captured_and_eager(decoder, run)
    assert got[0] == want[0] and launches == eager_launches
    assert [_graphs(decoder, a) for a in got[1]] == [2, 2, 2, 2]


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "logits"])
@pytest.mark.parametrize("int8_kv", [True, False], ids=["int8_kv", "bf16_kv"])
def test_encdec_backend_step_captured_equals_eager(dev, int8_kv, greedy):
    """EncDecBackend's one-token decode as a graph replay (the tiny
    Whisper-class model, 2 rows, bf16) against the eager decode: a 3-token
    prompt, 16 steps, the same tokens and logits bit for bit, the same
    launches, one graph on the decoder state, the lengths advanced on the
    host."""
    import numpy as np

    from rten_tpu_torch.generate import EncDecBackend

    from rten_tpu_torch.models import decoder

    ed, cfg, params = _tiny_encdec(dev, dtype=torch.bfloat16, int8_kv=int8_kv)
    mel = torch.randn(2, 16, 64, generator=torch.Generator(device=dev).manual_seed(3), device=dev)

    def run():
        backend = EncDecBackend(params, cfg, mel, device=dev)
        out = backend.prefill(np.array([[1, 2, 3], [4, 5, 6]], np.int32), greedy=greedy)
        steps = []
        for _ in range(16):
            tok = out if greedy else out.argmax(-1).to(torch.int32)
            steps.append(out)
            out = backend.decode(tok.cpu().numpy()[:, None], greedy=greedy)
        steps.append(out)
        return torch.stack(steps), backend

    (got, launches), (want, eager_launches) = _captured_and_eager(decoder, run)
    assert torch.equal(got[0], want[0]) and launches == eager_launches
    assert _graphs(decoder, got[1].state["len"]) == 1
    assert got[1].length == 19 and got[1].state["host_len"].tolist() == [19, 19]
    assert got[1].state["len"].tolist() == [19, 19]


def _tick_specs(decoder, cfg, params, dev, engine_cls, sampler, long=False, **kw):
    """Nine requests (prompts 3-40 tokens, 5-23 new tokens: budgets that end
    mid-tick; ``long``: prompts 40-90, 58-71 new tokens, rows of 100-155
    positions) with EOS ids taken from an eager run of the same requests
    without them, so that five rows (``long``: three) stop at an EOS
    mid-tick."""
    from rten_tpu_torch.serve import Request

    gen = torch.Generator().manual_seed(31)
    lens = torch.randint(40, 90, (9,), generator=gen) if long else torch.randint(3, 40, (9,), generator=gen)
    news = (60, 70, 62, 68, 64, 71, 58, 65, 67) if long else (5, 23, 9, 14, 11, 18, 6, 21, 13)
    specs = [dict(prompt=torch.randint(1, 500, (int(n),), generator=gen).tolist(), max_new_tokens=m)
             for n, m in zip(lens, news)]
    with _eager_scan(decoder):
        engine = engine_cls(params, cfg, sampler=sampler, seed=5, device=dev, **kw)
        reqs = [engine.submit(Request(**s)) for s in specs]
        engine.run()
    for i in (2, 6, 8) if long else (1, 3, 5, 7, 8):
        specs[i]["eos_tokens"] = (reqs[i].output[min(6 + i, len(reqs[i].output) - 2)],)
    return specs


def _sampler_of(name):
    from rten_tpu_torch.generate.sampler import TemperatureSampler

    return None if name == "greedy" else TemperatureSampler(0.8)


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
@pytest.mark.parametrize("mode", ["run", "pipelined"])
@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16_kv", "int8_kv"])
def test_slot_engine_tick_captured_equals_eager(dev, int8_kv, mode, sampler):
    """The slot engine's K-step tick (K 4, 4 slots) as one graph replay
    against its eager forwards: nine requests with EOS hits and exhausted
    budgets mid-tick, the same streams (one seed: the generator advances
    with every replay), the same launches, the host mirror (``host_len``,
    the budgets) equal and at least the device lengths, one graph on the
    cache."""
    import dataclasses

    from rten_tpu_torch.serve import Request, ServingEngine

    decoder, cfg, params = _tiny(torch.bfloat16, dev)
    cfg = dataclasses.replace(cfg, int8_kv=int8_kv)
    samp = _sampler_of(sampler)
    specs = _tick_specs(decoder, cfg, params, dev, ServingEngine, samp, max_batch=4, max_len=96, steps_per_tick=4)

    def run():
        engine = ServingEngine(params, cfg, max_batch=4, max_len=96, steps_per_tick=4, sampler=samp, seed=5,
                               device=dev)
        reqs = [engine.submit(Request(**s)) for s in specs]
        engine.run() if mode == "run" else engine.run_pipelined()
        return [r.output for r in reqs], engine

    (got, launches), (want, eager_launches) = _captured_and_eager(decoder, run)
    assert got[0] == want[0] and launches == eager_launches
    assert any(len(o) < s["max_new_tokens"] for o, s in zip(got[0], specs))  # EOS stopped some rows
    eng, ref = got[1], want[1]
    assert _graphs(decoder, eng.cache["len"]) == 1 and eng.steps == ref.steps
    assert eng.cache["host_len"].tolist() == ref.cache["host_len"].tolist()
    assert eng._mirror_budget.tolist() == ref._mirror_budget.tolist()
    assert all(h >= d for h, d in zip(eng.cache["host_len"].tolist(), eng.cache["len"].tolist()))


def test_slot_engine_graph_per_k_and_eos_width(dev):
    """``step(n_steps)`` with another K, and a request with more EOS ids
    than the engine's width, each capture a graph of their own on the
    cache; the streams equal the eager run's."""
    from rten_tpu_torch.serve import Request, ServingEngine

    decoder, cfg, params = _tiny(torch.bfloat16, dev)

    def run():
        engine = ServingEngine(params, cfg, max_batch=3, max_len=96, steps_per_tick=4, device=dev)
        reqs = [engine.submit(Request(prompt=[5, 6, 7 + i], max_new_tokens=20)) for i in range(3)]
        engine.step()
        engine.step(n_steps=3)
        reqs.append(engine.submit(Request(prompt=[9, 9], max_new_tokens=12, eos_tokens=(1, 2, 3, 4, 5, 6))))
        engine.run()
        return [r.output for r in reqs], engine

    (got, launches), (want, eager_launches) = _captured_and_eager(decoder, run)
    assert got[0] == want[0] and launches == eager_launches
    assert _graphs(decoder, got[1].cache["len"]) == 3  # K 4 and 3 at width 4, K 4 at width 6


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16_pages", "int8_pages"])
def test_paged_step_captured_equals_eager(dev, int8_kv, sampler):
    """The paged engine's step as one graph replay against its eager
    forward: pages of 16 (bf16: rows cross page boundaries every 16
    tokens) or 64 (int8, the JAX rule's smallest at head dim 64), a pool
    small enough to preempt (12 / 5 pages for 4 rows of up to 155
    positions), nine requests with EOS hits; the same streams and
    preemptions, the same launches, every page back, one graph on the pool
    over a table as wide as a row can grow."""
    from rten_tpu_torch.serve import PagedServingEngine, Request

    decoder, cfg, params = _tiny(torch.bfloat16, dev)
    samp = _sampler_of(sampler)
    page, n_pages = (64, 5) if int8_kv else (16, 12)
    kw = dict(max_batch=4, n_pages=n_pages, page_size=page, int8_kv=int8_kv)
    specs = _tick_specs(decoder, cfg, params, dev, PagedServingEngine, samp, long=True, **kw)

    def run():
        engine = PagedServingEngine(params, cfg, sampler=samp, seed=5, device=dev, **kw)
        reqs = [engine.submit(Request(**s)) for s in specs]
        engine.run()
        return [r.output for r in reqs], engine

    (got, launches), (want, eager_launches) = _captured_and_eager(decoder, run)
    assert got[0] == want[0] and launches == eager_launches
    eng = got[1]
    assert eng.preemptions == want[1].preemptions > 0 and eng.pool.n_free == eng.pool.n_pages
    assert _graphs(decoder, eng.pool.k_pages[0]) == 1 and eng._table_width() == min(n_pages, 256 // page)


SPEC_CASES = {"bf16_b1": (False, 1), "int8_b2": (True, 2), "bf16_b3": (False, 3)}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "temperature"])
@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_speculative_rounds_captured_equals_eager(dev, case, sampled):
    """``speculative_scan`` / ``speculative_sample_scan`` (K 4, 3 rounds a
    call, a 1-layer draft) as one graph replay a call against the eager
    rounds: three calls from a 12-token prompt, the same tokens, counts and
    next tokens, the same cache lengths on the device and the host, the
    same launches (the verify's flash_attention over the cache's whole S
    and its split plan equal to the prefix route's), one graph on the
    target cache."""
    import dataclasses

    from rten_tpu_torch.generate import speculative

    decoder, cfg, params = _tiny(torch.bfloat16, dev)
    int8, b = SPEC_CASES[case]
    cfg = dataclasses.replace(cfg, int8_kv=int8)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = {**params, "layers": params["layers"][:1]}
    prompt = torch.randint(0, 500, (b, 12), generator=torch.Generator().manual_seed(8)).to(torch.int32)

    def run():
        cache_t, cache_d, logits = speculative._prefill_both(params, cfg, dparams, dcfg, prompt.numpy(), 64, 4,
                                                             None, dev)
        last = logits.argmax(-1, keepdim=True).to(torch.int32)
        rng = torch.Generator(device=dev).manual_seed(3)
        out = []
        for _ in range(3):
            if sampled:
                toks, counts, _, _, last = speculative.speculative_sample_scan(
                    params, cfg, cache_t, dparams, dcfg, cache_d, last, rng, 0.8, k=4, n_rounds=3)
            else:
                toks, counts, _, _, last = speculative.speculative_scan(params, cfg, cache_t, dparams, dcfg,
                                                                        cache_d, last, k=4, n_rounds=3)
            out.append((toks.tolist(), counts.tolist(), last.tolist()))
        return out, cache_t, cache_d

    (got, launches), (want, eager_launches) = _captured_and_eager(decoder, run)
    assert got[0] == want[0] and launches == eager_launches
    for c, w in zip(got[1:], want[1:]):
        assert c["len"].tolist() == w["len"].tolist() and c["host_len"].tolist() == w["host_len"].tolist()
    assert got[1]["host_len"].tolist() == got[1]["len"].tolist()
    assert _graphs(decoder, got[1]["len"]) == 1


def test_sampled_paths_stay_eager_without_generator_registration(dev, monkeypatch):
    """A torch whose CUDAGraph cannot register a generator keeps every
    sampled path eager (decided by ``_capturable`` before any capture):
    the slot engine's tick, the paged step, generate_scan and the
    speculative sample rounds capture nothing and give the captured runs'
    streams; greedy paths still capture."""
    from rten_tpu_torch.generate import speculative
    from rten_tpu_torch.serve import PagedServingEngine, Request, ServingEngine

    decoder, cfg, params = _tiny(torch.bfloat16, dev)
    samp = _sampler_of("temperature")
    specs = [dict(prompt=[3, 4, 5 + i], max_new_tokens=10) for i in range(3)]

    def run():
        out, anchors = [], []
        for cls, kw in ((ServingEngine, dict(max_len=64, steps_per_tick=4)),
                        (PagedServingEngine, dict(n_pages=8, page_size=16))):
            engine = cls(params, cfg, max_batch=3, sampler=samp, seed=2, device=dev, **kw)
            reqs = [engine.submit(Request(**s)) for s in specs]
            engine.run()
            out.append([r.output for r in reqs])
            anchors.append(engine.cache["len"] if cls is ServingEngine else engine.pool.k_pages[0])
        cache = decoder.init_cache(cfg, 1, 64, device=dev)
        first, cache = decoder.prefill(params, cfg, torch.tensor([[7, 8, 9]], dtype=torch.int32, device=dev), cache,
                                       lm_head_mode="argmax", last_only=True)
        rng = torch.Generator(device=dev).manual_seed(4)
        toks, cache = decoder.generate_scan(params, cfg, cache, first, rng, n_steps=6, sampler=samp)
        out.append(toks.tolist())
        anchors.append(cache["len"])
        cache_t, cache_d, logits = speculative._prefill_both(params, cfg, params, cfg, [[7, 8, 9]], 16, 2, None, dev)
        res = speculative.speculative_sample_scan(params, cfg, cache_t, params, cfg, cache_d,
                                                  logits.argmax(-1, keepdim=True).to(torch.int32), rng, 0.8,
                                                  k=2, n_rounds=2)
        out.append(res[0].tolist())
        anchors.append(cache_t["len"])
        return out, anchors

    captured, _ = run()
    real = torch.cuda.CUDAGraph

    class OlderCUDAGraph:
        """This torch's CUDAGraph without ``register_generator_state``."""

        def __init__(self, *args, **kw):
            self._graph = real(*args, **kw)

        def __getattr__(self, name):
            if name == "register_generator_state":
                raise AttributeError(name)
            return getattr(self._graph, name)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", OlderCUDAGraph)
    assert not decoder._capturable(dev, True) and decoder._capturable(dev, False)
    eager, anchors = run()
    assert eager == captured
    assert [_graphs(decoder, a) for a in anchors] == [0, 0, 0, 0]
    cache = decoder.init_cache(cfg, 1, 64, device=dev)
    decoder.generate_scan(params, cfg, cache, torch.tensor([[7]], dtype=torch.int32, device=dev), n_steps=3)
    assert _graphs(decoder, cache["len"]) == 1  # greedy: no generator to register


def test_engines_under_a_mesh_stay_eager(dev):
    """Under a mesh (one rank on the card, a ``(1, 1)`` mesh) the slot
    engine's tick and the paged step run eagerly: no graph on their
    states, where the meshless engines on the same requests capture one;
    every request runs to its budget (the tensor-parallel path's kernels
    are not the fused path's, so the streams are not compared)."""
    import torch_parallel_ranks as ranks

    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.parallel import run_ranks
    from rten_tpu_torch.serve import PagedServingEngine, ServingEngine

    specs = [dict(prompt=[3, 4, 5], max_new_tokens=10), dict(prompt=[9, 8, 7, 6], max_new_tokens=13)]
    ran = run_ranks(ranks.card_mesh_engines, 1, specs, device="cuda", timeout_s=300).results[0]
    _, cfg, params = _tiny(torch.bfloat16, dev)
    for kind, cls, kw in (("slot", ServingEngine, dict(max_len=96, steps_per_tick=4)),
                          ("paged", PagedServingEngine, dict(n_pages=10, page_size=16))):
        outputs, engine = _engine_outputs(cls, params, cfg, specs, dev, max_batch=2, **kw)
        anchor = engine.cache["len"] if kind == "slot" else engine.pool.k_pages[0]
        assert _graphs(decoder, anchor) == 1 and ran[kind]["graphs"] == 0
        assert [len(o) for o in ran[kind]["outputs"]] == [len(o) for o in outputs] == [10, 13]


# ---------------------------------------------------------------------------
# W8A8: quantize_rows_int8, the w8a8 modes of the GEMV and MLP,
# quant_matmul_w8a8
# ---------------------------------------------------------------------------


def _w8_close(out, ref, dtype, code=0.0):
    """Kernel against plain version on the same inputs: both sum the same
    int8 codes exactly and round after each epilogue product, so f32
    outputs agree to GELU's exp (1e-6 of max(1, |plain|)), bf16 outputs to
    one bf16 rounding of each value (2^-7 of it). ``code``: where a norm
    runs first the kernel's and PyTorch's norms round in other orders, which
    can move a code by one; one code's contribution is added."""
    err = (out.float() - ref.float()).abs()
    tol = 1e-6 * max(1.0, ref.float().abs().max().item()) + code
    if dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * ref.float().abs()
    assert bool((err <= tol).all()), (err.max().item(), code)


def _code(scales, rows):
    """One activation code's largest contribution: |w| · sx · scale ≤
    max(scale) · absmax(rows)."""
    return scales.max().item() * rows.float().abs().max().item()


def _normed(x, norm, ns, nb):
    return qm._norm_rows_f32(x.float(), norm, 1e-5, ns, nb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k", [(37, 768), (5, 3072)])
def test_quantize_rows_kernel_matches_plain(dev, dtype, m, k):
    """Codes and sx bit for bit; .5 boundaries round half to even; an
    all-zero row gets sx 1."""
    gen = torch.Generator(device=dev).manual_seed(20)
    x = 3 * torch.randn(m, k, generator=gen, device=dev)
    x[0, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, 1.5, -0.5], device=dev)
    x[3] = 0
    x = x.to(dtype)
    before = dispatch.LAUNCHES["quantize_rows_int8"]
    codes, sx = qm.quantize_rows_int8(x)
    assert dispatch.LAUNCHES["quantize_rows_int8"] == before + 1
    ref_codes, ref_sx = qm.quantize_rows_int8_ref(x)
    assert torch.equal(codes, ref_codes) and torch.equal(sx, ref_sx)
    assert codes[0, :6].tolist() == [127, 2, -4, 0, 2, 0] and sx[3, 0].item() == 1.0 and not codes[3].any()


# (m, n, k, norm, activation): the decode path's shapes at GPT-2 width and
# the CPW 4 instance (n ≥ 8192).
GEMV_W8_CASES = [(1, 2304, 768, "layernorm", None), (3, 9000, 256, None, "gelu"),
                 (8, 768, 768, "rmsnorm", "relu"), (8, 768, 3072, None, None)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,norm,act", GEMV_W8_CASES)
def test_gemv_w8a8_kernel_matches_plain(dev, dtype, m, n, k, norm, act):
    gen = torch.Generator(device=dev).manual_seed(21)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    if m == 8 and norm is None:
        x[5] = 0  # an all-zero row
    x = x.to(dtype)
    bias = torch.randn(n, generator=gen, device=dev)
    resid = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    ns = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
    nb = 0.1 * ns if norm == "layernorm" else None
    kw = dict(activation=act, residual=resid, w8a8=True)
    if norm:
        kw.update(norm=norm, norm_scale=ns, norm_bias=nb)
    before = dispatch.LAUNCHES["quant_gemv_int8:w8a8"]
    out = qm.quant_gemv_int8(x, qt, s, bias, **kw)
    assert dispatch.LAUNCHES["quant_gemv_int8:w8a8"] == before + 1
    code = _code(s, _normed(x, norm, ns, nb)) if norm else 0.0
    _w8_close(out, qm.quant_gemv_int8_ref(x, qt, s, bias, **kw), dtype, code)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemv_w8a8_argmax_ties_and_mask(dev, dtype):
    """The w8a8 argmax: tied columns far apart give the lowest index,
    padding columns are masked (no norm, so the plain logits are the
    kernel's bit for bit)."""
    gen = torch.Generator(device=dev).manual_seed(22)
    m, k, n, vocab = 2, 256, 20480, 20000
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    col = torch.where(x[0].float() > 0, 100, -100).to(torch.int8)
    for c in (7, 5000, 19999, 20100):
        qt[c] = col
        s[c] = 1.0
    s[20100] = 2.0
    x[1] = x[0]
    out = qm.quant_gemv_int8(x, qt, s, argmax_n=vocab, w8a8=True)
    assert out.tolist() == [7, 7]
    assert qm.quant_gemv_int8_ref(x, qt, s, argmax_n=vocab, w8a8=True).tolist() == [7, 7]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("with_next", [False, True])
def test_mlp_w8a8_kernel_matches_plain(dev, dtype, m, with_next):
    """GPT-2-small's MLP in w8a8 mode, with and without the next qkv:
    tolerance one code's contribution per quantized phase feeding the
    output (the up output and the norms round in other orders)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    d, ff = 768, 3072
    wu, su = _pack(gen, ff, d, dev)
    wd, sd = _pack(gen, d, ff, dev)
    su, sd = su * 0.1, sd * 0.1
    x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    resid = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    ns = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    nxt = None
    if with_next:
        wq, sq = _pack(gen, 3 * d, d, dev)
        nxt = (wq, sq * 0.1, torch.randn(3 * d, generator=gen, device=dev), ns * 0.9, ns * 0.1)
    args = (x, wu, su, wd, sd, torch.randn(ff, generator=gen, device=dev), torch.randn(d, generator=gen, device=dev))
    kw = dict(activation="gelu", norm="layernorm", norm_scale=ns, norm_bias=0.1 * ns, residual=resid,
              next_qkv=nxt, w8a8=True)
    before = dispatch.LAUNCHES["quant_mlp_int8:w8a8"]
    out, ref = qm.quant_mlp_int8(*args, **kw), qm.quant_mlp_int8_ref(*args, **kw)
    assert dispatch.LAUNCHES["quant_mlp_int8:w8a8"] == before + 1
    xn = _normed(x, "layernorm", ns, 0.1 * ns)
    codes = _code(su, xn) + _code(sd, qm.quant_gemv_int8_ref(xn, wu, su, args[5], activation="gelu", w8a8=True))
    if with_next:
        _w8_close(out[1], ref[1], dtype, 2 * codes + _code(nxt[1], _normed(ref[0], "layernorm", ns * 0.9, ns * 0.1)))
        out, ref = out[0], ref[0]
    _w8_close(out, ref, dtype, codes)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,act,with_bias", [
    (9, 384, 256, None, True),       # one row past the GEMV's 8
    (64, 2304, 768, "gelu", True),   # GPT-2's qkv width, 64 prompt rows
    (130, 200, 256, "relu", False),  # ragged M and N
    (77, 131, 1040, None, True),     # odd N (unpaired stores), K not a multiple of 64
    (512, 768, 3072, None, True),    # GPT-2's down projection, 512 prompt rows
])
def test_matmul_w8a8_kernel_matches_plain(dev, dtype, m, n, k, act, with_bias):
    gen = torch.Generator(device=dev).manual_seed(24)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    bias = torch.randn(n, generator=gen, device=dev) if with_bias else None
    before = (dispatch.LAUNCHES["quant_matmul_w8a8"], dispatch.LAUNCHES["quantize_rows_int8"])
    out = qm.quant_matmul_w8a8(x, qt, s, bias, activation=act)
    assert (dispatch.LAUNCHES["quant_matmul_w8a8"], dispatch.LAUNCHES["quantize_rows_int8"]) == (
        before[0] + 1, before[1])  # one launch: the rows are quantized inside it
    assert out.shape == (m, n) and out.dtype == dtype
    _w8_close(out, qm.quant_matmul_w8a8_ref(x, qt, s, bias, activation=act), dtype)


@pytest.mark.parametrize("m", [1, 8])
def test_matmul_w8a8_small_m_hands_off(dev, m):
    """M ≤ 8 runs the w8a8 GEMV, the same function; f32 logits out."""
    gen = torch.Generator(device=dev).manual_seed(25)
    qt, s = _pack(gen, 1024 + 96, 256, dev)
    x = torch.randn(m, 256, generator=gen, device=dev).to(torch.bfloat16)
    before = dispatch.LAUNCHES["quant_gemv_int8:w8a8"]
    out = qm.quant_matmul_w8a8(x, qt, s, out_dtype=torch.float32)
    assert dispatch.LAUNCHES["quant_gemv_int8:w8a8"] == before + 1 and out.dtype == torch.float32
    _w8_close(out, qm.quant_matmul_w8a8_ref(x, qt, s, out_dtype=torch.float32), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiny_decoder_w8a8_kernels_match_plain(dev, dtype):
    """The tiny decoder in W8A8: a 20-token prompt (quant_matmul_w8a8), a
    5-token follow-up (the w8a8 GEMV and MLP at T > 1), 6 greedy steps:
    kernels against the plain versions on the card. A code moved by one in
    a layer's norm moves the logits by far less than 1e-2 of their max;
    tokens are compared in f32 (bf16 rounds the activations after sums
    taken in another order). The prompts' flash_attention is held against
    its plain version on the path's own inputs, and both runs keep its
    kernel: W8A8 quantizes each attention row to int8, so one ulp in the
    attention output can move a code, and here moved the f32 logits by
    0.023 of their max 1.30 (the f32 flash kernel within 1.8e-7 of its
    plain version; with flash common to both runs, 1.8e-7)."""
    import dataclasses

    decoder, cfg, params = _tiny(dtype, dev)
    cfg = dataclasses.replace(cfg, w8a8=True)
    gen = torch.Generator(device=dev).manual_seed(26)
    prompt = torch.randint(0, cfg.vocab_size, (2, 25), generator=gen, device=dev, dtype=torch.int32)

    def run():
        cache = decoder.init_cache(cfg, 2, 64, device=dev)
        first, cache = decoder.prefill(params, cfg, prompt[:, :20], cache)
        second, cache = decoder.prefill(params, cfg, prompt[:, 20:], cache)
        toks, _ = decoder.generate_greedy(params, cfg, cache, prompt[:, -1:], 6)
        return torch.cat([first, second], 1), toks

    flash_calls = []

    def flash_recorded(*args, **kw):
        out = flash_attention(*args, **kw)
        flash_calls.append(([a.clone() for a in args], {k: v.clone() if torch.is_tensor(v) else v
                                                       for k, v in kw.items()}, out.clone()))
        return out

    dispatch.reset_counters()
    decoder.flash_attention = flash_recorded
    try:
        k_logits, k_toks = run()
    finally:
        decoder.flash_attention = flash_attention
    assert dispatch.PLAIN == {}
    for name in ("quant_matmul_w8a8", "quant_gemv_int8:w8a8", "quant_mlp_int8:w8a8", "flash_attention"):
        assert dispatch.LAUNCHES[name] > 0, name
    assert dispatch.LAUNCHES["quantize_rows_int8"] == 0  # the prefill quantizes inside quant_matmul_w8a8
    assert len(flash_calls) == 2 * cfg.n_layers
    for args, kw, out in flash_calls:
        _close_own_max(out, flash_attention_ref(*args, **kw), dtype)
    with _plain_decoder(decoder):
        decoder.flash_attention = flash_attention
        p_logits, p_toks = run()
    assert (k_logits - p_logits).abs().max().item() <= 1e-2 * p_logits.abs().max().item()
    if dtype == torch.float32:
        assert k_toks.tolist() == p_toks.tolist()


# ---------------------------------------------------------------------------
# The whole-block decode kernel (decode_block), matmul_fused, and the silu /
# sigmoid / tanh epilogues
# ---------------------------------------------------------------------------

NEW_ACTS = ["silu", "sigmoid", "tanh"]


# decode_block's operands: (query heads, kv heads) and whether the q|k|v
# row comes packed (MHA) or as three tensors (GQA / MQA, RoPE).
BLOCK_OPS = {"packed": (4, 4, True), "gqa4_2": (4, 2, False), "gqa14_2": (14, 2, False), "mqa12_1": (12, 1, False)}


def _block_case(dev, dtype, d, kv_len, with_next, seed=30, h=4, s_max=256, dm=256, ff=1024, norm="layernorm",
                hk=None, packed=None):
    """Inputs of one decode_block call: (args, kwargs); args[1:3] are the
    caches, which the call updates in place. hk: kv heads (default h);
    packed: the [1, 3, H, 1, D] row (default for MHA) or the tuple (q,
    k_new, v_new); the next qkv has (h + 2 hk) d columns."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    hk = h if hk is None else hk
    packed = hk == h if packed is None else packed

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    kc, vc = rn(1, hk, s_max, d, scale=1.5).to(dtype), rn(1, hk, s_max, d).to(dtype)
    if packed:
        qkv = rn(1, 3, h, 1, d, scale=1.5).to(dtype)
    else:
        qkv = (rn(1, h, d, scale=1.5).to(dtype), rn(1, hk, d, scale=1.5).to(dtype), rn(1, hk, d).to(dtype))
    wo, wos = _pack(gen, dm, h * d, dev)
    wu, su = _pack(gen, ff, dm, dev)
    wd, sd = _pack(gen, dm, ff, dev)
    ns = 1 + 0.1 * rn(dm)
    nb = 0.1 * rn(dm) if norm == "layernorm" else None
    mlp = (wu, su * 0.1, wd, sd * 0.1, rn(ff, scale=0.1), rn(dm, scale=0.1), ns, nb)
    nxt = None
    if with_next:
        nq = (h + 2 * hk) * d
        wq, sq = _pack(gen, nq, dm, dev)
        nxt = (wq, sq * 0.1, rn(nq, scale=0.1), ns * 0.9, None if nb is None else nb * 0.5)
    lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    args = (qkv, kc, vc, lens, wo, wos * 0.1, rn(dm, scale=0.1), rn(1, dm).to(dtype), mlp, nxt)
    return args, dict(activation="gelu", norm=norm)


def _block_check(args, kw, dtype, with_next):
    """decode_block against decode_block_ref on copies of the caches: the
    output, the next qkv, and the caches after the append bit for bit."""
    from rten_tpu_torch.kernels.decode_attention import decode_block, decode_block_ref

    p_args = (args[0], args[1].clone(), args[2].clone(), *args[3:])
    out = decode_block(*args, **kw)
    ref = decode_block_ref(*p_args, **kw)
    outs, refs = (out, ref) if with_next else ((out,), (ref,))
    for o, r in zip(outs, refs):
        assert o.dtype == dtype and o.shape == r.shape
        _close(o, r, dtype)
    assert torch.equal(args[1], p_args[1]) and torch.equal(args[2], p_args[2])
    return out


@pytest.mark.parametrize("ops", list(BLOCK_OPS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("kv_len", [0, 1, 63, 64, 65, 767])
@pytest.mark.parametrize("with_next", [False, True])
def test_decode_block_kernel_matches_plain(dev, ops, dtype, head_dim, kv_len, with_next):
    """The whole block against ``decode_block_ref`` at S 768: MHA packed,
    GQA 4 / 2 and 14 / 2, MQA 12 / 1 unpacked; the chunk edges (kv_len 63,
    64, 65) and the last position; one launch, counted under its mode."""
    h, hk, packed = BLOCK_OPS[ops]
    args, kw = _block_case(dev, dtype, head_dim, kv_len, with_next, h=h, hk=hk, packed=packed, s_max=768)
    before = dict(dispatch.LAUNCHES)
    _block_check(args, kw, dtype, with_next)
    assert dispatch.LAUNCHES["decode_block"] == before.get("decode_block", 0) + 1
    assert dispatch.LAUNCHES["decode_block:gqa"] == before.get("decode_block:gqa", 0) + (h > hk)


@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("ops", ["packed", "mqa12_1"])
def test_decode_block_kernel_activations_and_norms(dev, act, norm, ops):
    h, hk, packed = BLOCK_OPS[ops]
    args, kw = _block_case(dev, torch.float32, 64, 100, True, seed=31, norm=norm, h=h, hk=hk, packed=packed)
    kw["activation"] = act
    _block_check(args, kw, torch.float32, True)


def test_decode_block_kernel_gpt2_width(dev):
    """GPT-2-small's block (12 heads of 64, d_model 768, FF 3072) at 767 of
    768 positions in bf16: 12 chunks a head, every SM's weights resident."""
    args, kw = _block_case(dev, torch.bfloat16, 64, 767, True, seed=32, h=12, s_max=768, dm=768, ff=3072)
    _block_check(args, kw, torch.bfloat16, True)


def test_decode_block_kernel_tiny_starcoder_width(dev):
    """tiny_starcoder_py's block (12 query heads over 1 kv head of 64, d_model
    768, FF 3072, the next qkv N 896) at kv_len 1 / 300 / 767 of 1024 in
    bf16."""
    for kv_len in (1, 300, 767):
        args, kw = _block_case(dev, torch.bfloat16, 64, kv_len, True, seed=35, h=12, hk=1, s_max=1024, dm=768,
                               ff=3072)
        _block_check(args, kw, torch.bfloat16, True)


@pytest.mark.parametrize("ops", ["packed", "gqa4_2"])
def test_decode_block_hidden_state_stays_f32(dev, ops):
    """bf16, a residual of 100 and a wo output of ~0.01: the f32 hidden
    state h varies only below bf16's resolution at 100, so ln2 of h rounded
    to bf16 (the two-kernel path's numbers) would be ln2 of a constant, and
    the next qkv of the rounded block output would lose the down
    projection's ~1 against bf16's 0.5 steps. The kernel must keep both
    f32, as the plain version does."""
    from rten_tpu_torch.kernels.decode_attention import decode_block, decode_block_ref

    h, hk, packed = BLOCK_OPS[ops]
    args, kw = _block_case(dev, torch.bfloat16, 64, 100, True, seed=34, h=h, hk=hk, packed=packed)
    qkv, kc, vc, lens, wo, wos, bo, resid, mlp, nxt = args
    wu, su, wd, sd, bu, bd, ns, nb = mlp
    args = (qkv, kc, vc, lens, wo, wos * 0.01, None, torch.full_like(resid, 100.0),
            (wu, su, wd, sd * 0.3, bu, bd, ns, nb), nxt)
    p_args = (qkv, kc.clone(), vc.clone(), *args[3:])
    out, qkv_next = decode_block(*args, **kw)
    ref, ref_next = decode_block_ref(*p_args, **kw)
    _close(out, ref, torch.bfloat16)
    _close(qkv_next, ref_next, torch.bfloat16)
    assert (ref.float() - 100).std().item() > 0.5  # the down projection's share of the output


@pytest.mark.parametrize("ops", ["packed", "mqa12_1"])
def test_decode_block_full_row_is_nan(dev, ops):
    """kv_len = S: the kernel writes nothing and returns NaN (the plain
    version raises IndexError)."""
    from rten_tpu_torch.kernels.decode_attention import decode_block, decode_block_ref

    h, hk, packed = BLOCK_OPS[ops]
    args, kw = _block_case(dev, torch.float32, 64, 256, True, seed=33, h=h, hk=hk, packed=packed)
    k0, v0 = args[1].clone(), args[2].clone()
    out, qkv = decode_block(*args, **kw)
    assert bool(out.isnan().all()) and bool(qkv.isnan().all())
    assert torch.equal(args[1], k0) and torch.equal(args[2], v0)
    with pytest.raises(IndexError):
        decode_block_ref(*args, **kw)


@pytest.mark.parametrize("ops", ["packed", "mqa12_1"])
@pytest.mark.parametrize("grid,region", [(37, 0), (5, 0), (0, 16384), (12, 65536)])
def test_decode_block_same_bits_from_any_grid(dev, monkeypatch, ops, grid, region):
    """GPT-2's widths at kv_len 700 of 768 in bf16: a launch of ``grid``
    blocks (0: one a SM), or with a smaller weight region (16 or 64 KB: the
    weights then come in waves, up to ~40 runs a block), gives the full
    grid's bits: the outputs and caches."""
    from rten_tpu_torch.kernels import decode_attention as da

    hk = 12 if ops == "packed" else 1
    args, kw = _block_case(dev, torch.bfloat16, 64, 700, True, seed=36, h=12, hk=hk, s_max=768, dm=768, ff=3072)
    k0, v0 = args[1].clone(), args[2].clone()
    full = da.decode_block(*args, **kw)
    full_k, full_v = args[1].clone(), args[2].clone()
    if grid:
        monkeypatch.setattr(da, "block_grid", lambda idx: grid)
    if region:
        monkeypatch.setattr(da, "block_region", lambda: region)
    again = (args[0], k0.clone(), v0.clone(), *args[3:])
    out = da.decode_block(*again, **kw)
    assert torch.equal(out[0], full[0]) and torch.equal(out[1], full[1])
    assert torch.equal(again[1], full_k) and torch.equal(again[2], full_v)


@pytest.mark.parametrize("h,hk,s_max,kv_len", [
    (12, 12, 4096, 4095), (12, 12, 4096, 1000), (12, 1, 8192, 8191), (12, 1, 8192, 3000),
])
def test_decode_block_kernel_long_cache(dev, monkeypatch, h, hk, s_max, kv_len):
    """A GPT-2-class MHA block over a 4096-position cache and
    tiny_starcoder_py's MQA block over its published 8192, in bf16: the
    kernel's shared memory does not grow with the cache, so these launch and
    agree with the plain version as the short caches do; a grid of 37 gives
    the same bits."""
    from rten_tpu_torch.kernels import decode_attention as da

    args, kw = _block_case(dev, torch.bfloat16, 64, kv_len, True, seed=39, h=h, hk=hk, s_max=s_max, dm=768,
                           ff=3072)
    again = (args[0], args[1].clone(), args[2].clone(), *args[3:])
    out = _block_check(args, kw, torch.bfloat16, True)
    monkeypatch.setattr(da, "block_grid", lambda idx: 37)
    small = da.decode_block(*again, **kw)
    assert torch.equal(small[0], out[0]) and torch.equal(small[1], out[1])
    assert torch.equal(again[1], args[1]) and torch.equal(again[2], args[2])


def test_decode_block_two_streams(dev):
    """Two launches at once on two streams (MHA and MQA blocks, each on its
    own inputs) equal their launches alone: no state carries between or
    across launches."""
    from rten_tpu_torch.kernels.decode_attention import decode_block

    cases = [_block_case(dev, torch.bfloat16, 64, n, True, seed=37 + i, h=12, hk=hk, s_max=768, dm=768, ff=3072)
             for i, (n, hk) in enumerate(((300, 12), (650, 1)))]
    fresh = [(a[0], a[1].clone(), a[2].clone(), *a[3:]) for a, _ in cases]
    alone = []
    for a, kw in cases:
        a = (a[0], a[1].clone(), a[2].clone(), *a[3:])
        alone.append(decode_block(*a, **kw))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st, a, (_, kw) in zip(streams, fresh, cases):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(decode_block(*a, **kw))
    torch.cuda.synchronize()
    for o, r in zip(outs, alone):
        assert torch.equal(o[0], r[0]) and torch.equal(o[1], r[1])


def test_decode_block_stamps(dev):
    """Through the measurement build (``decode_block_timed``) every block
    records its phases' steps and the grid-wide waits on the %globaltimer,
    in program order: at GPT-2's block with the next qkv, every block
    reaches every stamp but its first attention item's (60 items for 132
    blocks) and the spare last one. Its results are decode_block's bits."""
    from rten_tpu_torch.kernels import decode_attention as da

    args, kw = _block_case(dev, torch.bfloat16, 64, 300, True, seed=38, h=12, s_max=768, dm=768, ff=3072)
    again = (args[0], args[1].clone(), args[2].clone(), *args[3:])
    stamps = torch.zeros((da.block_grid(dev.index or 0), da.BLOCK_STAMPS), dtype=torch.int64, device=dev)
    timed = da.decode_block_timed(stamps, *args, **kw)
    plain = da.decode_block(*again, **kw)
    torch.cuda.synchronize()
    assert torch.equal(timed[0], plain[0]) and torch.equal(timed[1], plain[1])
    s = stamps.cpu()
    always = [i for i in range(19) if i != 1]
    assert bool((s[:, always] > 0).all())
    for row in s.tolist():
        seen = [t for t in row if t > 0]
        assert seen == sorted(seen)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", [(3, 200, 300), (77, 131, 1040), (130, 256, 64), (1, 8, 7)])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "sigmoid", "tanh"])
def test_matmul_fused_kernel_matches_plain(dev, dtype, m, n, k, act):
    """Any M, N, K (rows not 16-byte multiples, odd N, K below one step),
    with bias, each activation."""
    from rten_tpu_torch.kernels.matmul import matmul_fused, matmul_fused_ref

    gen = torch.Generator(device=dev).manual_seed(40)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
    bias = torch.randn(n, generator=gen, device=dev)
    before = dispatch.LAUNCHES["matmul_fused"]
    out = matmul_fused(x, w, bias, activation=act)
    assert dispatch.LAUNCHES["matmul_fused"] == before + 1
    assert out.shape == (m, n) and out.dtype == dtype
    _close(out, matmul_fused_ref(x, w, bias, activation=act), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_fused_kernel_large_and_f32_out(dev, dtype):
    """512 x 768 @ 768 x 3072 + GELU (the up projection's shape), f32 out,
    no bias; the f32 kernel against an f64 product (no TF32: 1e-5)."""
    from rten_tpu_torch.kernels.matmul import matmul_fused, matmul_fused_ref

    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn(512, 768, generator=gen, device=dev).to(dtype)
    w = (torch.randn(768, 3072, generator=gen, device=dev) / 28).to(dtype)
    out = matmul_fused(x, w, activation="gelu", out_dtype=torch.float32)
    assert out.dtype == torch.float32
    _close(out, matmul_fused_ref(x, w, activation="gelu", out_dtype=torch.float32), torch.float32)
    if dtype == torch.float32:
        ref = x.double() @ w.double()
        assert (matmul_fused(x, w) - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", NEW_ACTS)
def test_new_epilogues_on_the_int8_kernels(dev, dtype, act):
    """silu, sigmoid and tanh in the epilogues of the decode GEMV (weight
    only and w8a8), the decode MLP, the prefill matmul and the W8A8 matmul."""
    gen = torch.Generator(device=dev).manual_seed(42)
    k, n = 256, 384
    qt, s = _pack(gen, n, k, dev)
    bias = torch.randn(n, generator=gen, device=dev)
    for m in (2, 64):
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        _close(qm.quant_matmul_int8(x, qt, s, bias, activation=act),
               qm.quant_matmul_int8_ref(x, qt, s, bias, activation=act), dtype)
        _w8_close(qm.quant_matmul_w8a8(x, qt, s, bias, activation=act),
                  qm.quant_matmul_w8a8_ref(x, qt, s, bias, activation=act), dtype)
    x = torch.randn(3, k, generator=gen, device=dev).to(dtype)
    ns = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
    kw = dict(activation=act, norm="layernorm", norm_scale=ns, norm_bias=0.1 * ns)
    _close(qm.quant_gemv_int8(x, qt, s, bias, **kw), qm.quant_gemv_int8_ref(x, qt, s, bias, **kw), dtype)
    _w8_close(qm.quant_gemv_int8(x, qt, s, bias, w8a8=True, **kw),
              qm.quant_gemv_int8_ref(x, qt, s, bias, w8a8=True, **kw), dtype,
              _code(s, _normed(x, "layernorm", ns, 0.1 * ns)))
    wu, su = _pack(gen, 1024, k, dev)
    wd, sd = _pack(gen, k, 1024, dev)
    args = (x, wu, su * 0.1, wd, sd * 0.1, torch.randn(1024, generator=gen, device=dev), None)
    mkw = dict(activation=act, norm="rmsnorm", norm_scale=ns, residual=x)
    _close(qm.quant_mlp_int8(*args, **mkw), qm.quant_mlp_int8_ref(*args, **mkw), dtype)


def _tiny_mega(dtype, dev, w8a8=False):
    import dataclasses

    decoder, cfg, params = _tiny(dtype, dev)
    return decoder, dataclasses.replace(cfg, mega=True, w8a8=w8a8), params


@pytest.mark.parametrize("w8a8", [False, True], ids=["weight_only", "w8a8"])
def test_tiny_decoder_mega_step_launches_decode_block(dev, w8a8):
    """A mega decode step launches ``decode_block`` once per layer and
    neither ``decode_attention`` nor the MLP kernel; its logits and 6 greedy
    tokens equal the plain versions' (f32; W8A8 logits to 1e-2 of their max)
    and, weight-only, the two-kernel step's on the card."""
    decoder, cfg, params = _tiny_mega(torch.float32, dev, w8a8)
    gen = torch.Generator(device=dev).manual_seed(43)
    prompt = torch.randint(0, cfg.vocab_size, (1, 12), generator=gen, device=dev, dtype=torch.int32)

    def run(c):
        cache = decoder.init_cache(c, 1, 64, device=dev)
        _, cache = decoder.prefill(params, c, prompt, cache)
        logits, cache = decoder.forward(params, c, prompt[:, -1:], cache)
        toks, _ = decoder.generate_greedy(params, c, cache, prompt[:, -1:], 6)
        return logits, toks

    run(cfg)
    cache = decoder.init_cache(cfg, 1, 64, device=dev)
    _, cache = decoder.prefill(params, cfg, prompt, cache)
    dispatch.reset_counters()
    decoder.forward(params, cfg, prompt[:, -1:], cache)
    gemv = "quant_gemv_int8:w8a8" if w8a8 else "quant_gemv_int8"
    assert dict(dispatch.LAUNCHES) == {"decode_block": cfg.n_layers, gemv: 2} and not dispatch.PLAIN
    k_logits, k_toks = run(cfg)
    with _plain_decoder(decoder):
        p_logits, p_toks = run(cfg)
    if w8a8:  # a code moved by one in a norm (as test_tiny_decoder_w8a8_kernels_match_plain)
        assert (k_logits - p_logits).abs().max().item() <= 1e-2 * p_logits.abs().max().item()
    else:
        _close(k_logits, p_logits, torch.float32)
    assert k_toks.tolist() == p_toks.tolist()
    if not w8a8:  # f32: the two-kernel step computes the same values (W8A8 quantizes its MLP)
        import dataclasses

        two_logits, two_toks = run(dataclasses.replace(cfg, mega=False))
        _close(k_logits, two_logits, torch.float32)
        assert k_toks.tolist() == two_toks.tolist()


@pytest.mark.parametrize("kind", ["mqa", "gqa_rope"])
def test_tiny_gqa_decoder_mega_step_launches_decode_block(dev, kind):
    """The tiny decoder with 4 query heads over 1 kv head (learned
    positions) or over 2 with RoPE, GELU and ``mega``: a decode step
    launches ``decode_block`` in its grouped mode once per layer and no
    attention or MLP kernel; its logits and 6 greedy tokens equal the plain
    versions' (f32)."""
    import dataclasses

    from rten_tpu_torch.models import decoder

    extra = dict(n_kv_heads=1) if kind == "mqa" else dict(n_kv_heads=2, pos_encoding="rope")
    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024, max_seq=256,
                                dtype=torch.float32, mega=True, **extra)
    params = decoder.quantize_params_int8(decoder.init_params(1, cfg, device=dev), device=dev)
    gen = torch.Generator(device=dev).manual_seed(44)
    prompt = torch.randint(0, cfg.vocab_size, (1, 12), generator=gen, device=dev, dtype=torch.int32)

    def run(c):
        cache = decoder.init_cache(c, 1, 64, device=dev)
        _, cache = decoder.prefill(params, c, prompt, cache)
        logits, cache = decoder.forward(params, c, prompt[:, -1:], cache)
        toks, _ = decoder.generate_greedy(params, c, cache, prompt[:, -1:], 6)
        return logits, toks

    cache = decoder.init_cache(cfg, 1, 64, device=dev)
    _, cache = decoder.prefill(params, cfg, prompt, cache)
    dispatch.reset_counters()
    decoder.forward(params, cfg, prompt[:, -1:], cache)
    n = cfg.n_layers
    assert dict(dispatch.LAUNCHES) == {"decode_block": n, "decode_block:gqa": n, "quant_gemv_int8": 2}
    assert not dispatch.PLAIN
    k_logits, k_toks = run(cfg)
    with _plain_decoder(decoder):
        p_logits, p_toks = run(cfg)
    _close(k_logits, p_logits, torch.float32)
    assert k_toks.tolist() == p_toks.tolist()
    two_logits, two_toks = run(dataclasses.replace(cfg, mega=False))
    _close(k_logits, two_logits, torch.float32)
    assert k_toks.tolist() == two_toks.tolist()


# ---------------------------------------------------------------------------
# The KV kernels' Llama/Qwen2-class modes: unpacked q | k_new | v_new
# operands with grouped-query heads (Hq = group · Hk), and decode_attention
# without its fused wo
# ---------------------------------------------------------------------------

GQA_KINDS = ["fused_wo", "no_wo", "int8", "paged", "paged_int8"]
GROUPS = [1, 2, 7]


def _gqa_case(dev, kind, dtype, d, group, hk=2, seed=40):
    """Inputs of one KV kernel in its unpacked mode: Hk kv heads, group · Hk
    query heads, rows at kv_len 0, 63, 64, 150 and 191 (the last position of
    a 3 x 64 row or of 3 pages scattered through a pool of 12, page 11 the
    scratch page); q and k_new as separate tensors, v_new a strided view.
    Returns (kernel, plain, args, kw); args[0] is the operand tuple."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(seed)
    hq, b, page = group * hk, 5, 64
    q = (1.5 * torch.randn(b, hq, d, generator=gen, device=dev)).to(dtype)
    kv = (1.5 * torch.randn(b, 2 * hk, d, generator=gen, device=dev)).to(dtype)
    ops = (q, kv[:, :hk].contiguous(), kv[:, hk:])
    int8, paged = kind.endswith("int8"), kind.startswith("paged")
    shape = (12, hk, page, d) if paged else (b, hk, 3 * page, d)
    if int8:
        payload = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8) for _ in range(2)]
        payload += [0.005 + 0.015 * torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
    else:
        payload = [(1.5 * torch.randn(shape, generator=gen, device=dev)).to(dtype),
                   torch.randn(shape, generator=gen, device=dev).to(dtype)]
    lens = torch.tensor([0, 63, 64, 150, 3 * page - 1], dtype=torch.int32, device=dev)
    table = torch.tensor([[11, 11, 11], [3, 11, 11], [7, 2, 11], [5, 0, 9], [10, 1, 8]], dtype=torch.int32,
                         device=dev)
    if kind == "fused_wo":
        wo, wos = _pack(gen, 320, hq * d, dev)
        kw = dict(residual=torch.randn(b, 320, generator=gen, device=dev).to(dtype))
        return da.decode_attention, da.decode_attention_ref, [ops, *payload, lens, wo, wos,
                                                               torch.randn(320, generator=gen, device=dev)], kw
    if kind == "no_wo":
        return da.decode_attention, da.decode_attention_ref, [ops, *payload, lens], {}
    if kind == "int8":
        return da.decode_attention_int8, da.decode_attention_int8_ref, [ops, *payload, lens], {}
    fn = (pa.paged_decode_attention_int8, pa.paged_decode_attention_int8_ref) if int8 else (
        pa.paged_decode_attention, pa.paged_decode_attention_ref)
    return (*fn, [ops, *payload, table, lens], {})


def _mode(kind, group):
    base = {"fused_wo": "decode_attention", "no_wo": "decode_attention", "int8": "decode_attention_int8",
            "paged": "paged_decode_attention", "paged_int8": "paged_decode_attention_int8"}[kind]
    if kind == "no_wo":
        return base + ":no_wo"
    return base + (":gqa" if group > 1 else "")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("kind", GQA_KINDS)
def test_gqa_kernel_matches_plain(dev, kind, group, dtype):
    """Each unpacked / grouped-query mode against its plain version:
    the output (own-max tolerance; f32 or bf16 as the kernel writes it),
    the caches or pages after the append bit for bit (int8: codes and
    scales, appended once per kv head), and the launch counted under the
    mode's name."""
    kernel, plain, args, kw = _gqa_case(dev, kind, dtype, 64, group)
    n_cache = 4 if kind.endswith("int8") else 2
    k_args = [args[0], *_clone_args(args[1:])]
    p_args = [args[0], *_clone_args(args[1:])]
    dispatch.reset_counters()
    out = kernel(*k_args, **kw)
    assert dict(dispatch.LAUNCHES) == {_mode(kind, group): 1}
    ref = plain(*p_args, **kw)
    hq = 2 * group
    assert out.dtype == dtype and out.shape == ((5, 320) if kind == "fused_wo" else (5, hq * 64))
    (_close if kind == "fused_wo" else _close_own_max)(out, ref, dtype)
    for a, b in zip(k_args[1 : 1 + n_cache], p_args[1 : 1 + n_cache]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", GQA_KINDS)
def test_gqa_kernel_head_dim_128_qwen2_heads(dev, kind):
    """Qwen2-0.5B's grouping (14 query heads over 2 kv heads) at head dim
    128, bf16, against the plain version; caches bit for bit."""
    kernel, plain, args, kw = _gqa_case(dev, kind, torch.bfloat16, 128, 7, seed=41)
    k_args, p_args = [args[0], *_clone_args(args[1:])], [args[0], *_clone_args(args[1:])]
    out, ref = kernel(*k_args, **kw), plain(*p_args, **kw)
    (_close if kind == "fused_wo" else _close_own_max)(out, ref, torch.bfloat16)
    n_cache = 4 if kind.endswith("int8") else 2
    for a, b in zip(k_args[1 : 1 + n_cache], p_args[1 : 1 + n_cache]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["no_wo", "int8", "paged"])
def test_gqa_kernel_against_f64_softmax(dev, kind):
    """Group 7 in f32: the attention vector against the softmax in f64 over
    the cache the plain version leaves (each query head h over kv head
    h // 7), atol 1e-5 of its max."""
    from rten_tpu_torch.kernels.decode_attention import attend_ref, dequantize_kv

    kernel, plain, args, kw = _gqa_case(dev, kind, torch.float32, 64, 7, seed=42)
    k_args, p_args = [args[0], *_clone_args(args[1:])], [args[0], *_clone_args(args[1:])]
    out = kernel(*k_args).double()
    plain(*p_args)
    q, lens = args[0][0], args[-1].tolist()
    rows = []
    for bi, n in enumerate(lens):
        if kind == "paged":
            pages = p_args[-2][bi, : n // 64 + 1].tolist()
            k, v = (t[pages].permute(1, 0, 2, 3).reshape(2, -1, 64)[:, : n + 1] for t in p_args[1:3])
        else:
            k, v = p_args[1][bi, :, : n + 1], p_args[2][bi, :, : n + 1]
            if kind == "int8":
                k = dequantize_kv(k, p_args[3][bi, :, : n + 1], torch.float64)
                v = dequantize_kv(v, p_args[4][bi, :, : n + 1], torch.float64)
        rows.append(attend_ref(q[bi].double(), k.double(), v.double(), 1 / 8.0))
    ref = torch.stack(rows)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_no_wo_kernel_past_eight_rows(dev):
    """decode_attention without wo takes any row count (12 here, the JAX
    decoder's unfused step past the GEMV's 8 rows); with wo it refuses 9."""
    gen = torch.Generator(device=dev).manual_seed(43)
    b, hk, hq, d, s = 12, 2, 14, 64, 128
    ops = tuple(torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16) for h in (hq, hk, hk))
    caches = [torch.randn(b, hk, s, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2)]
    lens = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    p_caches = _clone_args(caches)
    out = decode_attention(ops, *caches, lens)
    ref = decode_attention_ref(ops, *p_caches, lens)
    _close_own_max(out, ref, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(caches, p_caches))
    wo, wos = _pack(gen, 256, hq * d, dev)
    with pytest.raises(ValueError, match="at most 8 rows"):
        decode_attention(ops, *caches, lens, wo, wos)


def _tiny_llama(dtype, dev, d_ff=344, **kw):
    from rten_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=4, n_kv_heads=2, d_model=256, d_ff=d_ff,
                                max_seq=256, pos_encoding="rope", norm="rmsnorm", activation="swiglu",
                                tie_embeddings=False, layer_norm_eps=1e-6, dtype=dtype, **kw)
    return decoder, cfg, decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)


@pytest.mark.parametrize("d_ff", [344, 384])
def test_tiny_llama_decoder_kernels_match_plain(dev, d_ff):
    """The tiny f32 Llama-class decoder (RoPE, SwiGLU, 4 query heads over 2
    kv heads, an untied lm_head): a 12-token prompt as one forward, then 6
    greedy steps, kernels against the plain versions on the card; every
    decode step launches decode_attention in its GQA mode."""
    decoder, cfg, params = _tiny_llama(torch.float32, dev, d_ff)
    prompt = torch.randint(0, 500, (2, 12), generator=torch.Generator(device=dev).manual_seed(44), device=dev,
                           dtype=torch.int32)

    def run():
        cache = decoder.init_cache(cfg, 2, 64, device=dev)
        logits, cache = decoder.prefill(params, cfg, prompt, cache)
        first = logits[:, -1:].argmax(-1).to(torch.int32)
        toks, _ = decoder.generate_greedy(params, cfg, cache, first, 6)
        return logits, toks

    dispatch.reset_counters()
    k_logits, k_toks = run()
    assert dispatch.PLAIN == {} and dispatch.LAUNCHES["decode_attention:gqa"] == 6 * cfg.n_layers
    assert "quant_mlp_int8" not in dispatch.LAUNCHES
    with _plain_decoder(decoder):
        p_logits, p_toks = run()
    _close(k_logits, p_logits, torch.float32)
    assert k_toks.tolist() == p_toks.tolist()


@pytest.mark.parametrize("engine", ["slot_int8", "paged", "paged_int8"])
def test_tiny_llama_engines_match_cpu(dev, engine):
    """The tiny Llama-class model (f32) behind the engines on the card,
    through the three GQA KV kernels, against the same engine on the CPU."""
    from rten_tpu_torch.serve import PagedServingEngine, ServingEngine

    _decoder, cfg, params = _tiny_llama(torch.float32, dev)
    cpu_params = _decoder.quantize_params_int8(_decoder.init_params(0, cfg, device="cpu"), device="cpu")
    specs = [dict(prompt=[1, 2, 3], max_new_tokens=6), dict(prompt=list(range(5, 75)), max_new_tokens=5)]
    if engine == "slot_int8":
        import dataclasses

        cfg = dataclasses.replace(cfg, int8_kv=True)
        make, kw = ServingEngine, dict(max_batch=2)
    else:
        make, kw = PagedServingEngine, dict(max_batch=2, n_pages=6, page_size=64, int8_kv=engine == "paged_int8")
    dispatch.reset_counters()
    on_card, _ = _engine_outputs(make, params, cfg, specs, dev, **kw)
    mode = {"slot_int8": "decode_attention_int8:gqa", "paged": "paged_decode_attention:gqa",
            "paged_int8": "paged_decode_attention_int8:gqa"}[engine]
    assert dispatch.LAUNCHES[mode] > 0 and not dispatch.PLAIN
    assert on_card == _engine_outputs(make, cpu_params, cfg, specs, "cpu", **kw)[0]


# -- the Hopper prefill kernels: split-K quant_matmul_int8 (wgmma on a TMA
# ring) and split-KV flash_attention (tensor cores on a cp.async ring) --

SPLIT_K_SHAPES = [(768, 3072), (896, 4864)]  # GPT-2-small's and Qwen2-0.5B's down projections


@pytest.mark.parametrize("m", [9, 20, 64, 65, 512])
@pytest.mark.parametrize("n,k", SPLIT_K_SHAPES)
def test_matmul_split_k_matches_plain(dev, m, n, k):
    gen = torch.Generator(device=dev).manual_seed(50)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device=dev)
    split = qm.device_plan(x, n)[1]
    assert split > 1 or m >= 512
    before = dispatch.LAUNCHES["quant_matmul_int8:split_k"]
    out = qm.quant_matmul_int8(x, qt, s, bias)
    assert dispatch.LAUNCHES["quant_matmul_int8:split_k"] == before + (split > 1)
    _close(out, qm.quant_matmul_int8_ref(x, qt, s, bias), torch.bfloat16)


@pytest.mark.parametrize("m,n,k", [
    (9, 200, 16),      # K of one 16-wide piece: one stage, mostly zero-filled
    (40, 131, 400),    # K not a multiple of the 128-deep stage; N not of the 64-channel tile
    (64, 72, 1040),    # 9 K steps over a split that does not divide them
    (300, 1000, 528),  # ragged M over 128-token tiles
])
@pytest.mark.parametrize("with_bias", [False, True])
def test_matmul_ragged_edges_match_plain(dev, m, n, k, with_bias):
    gen = torch.Generator(device=dev).manual_seed(51)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device=dev) if with_bias else None
    for out_dtype in (torch.bfloat16, torch.float32):
        out = qm.quant_matmul_int8(x, qt, s, bias, out_dtype=out_dtype)
        _close(out, qm.quant_matmul_int8_ref(x, qt, s, bias, out_dtype=out_dtype), torch.bfloat16)


@pytest.mark.parametrize("act", [None, "gelu", "relu", "silu", "sigmoid", "tanh"])
@pytest.mark.parametrize("m,n,k", [(64, 768, 3072), (512, 3072, 768)])
def test_matmul_split_and_wide_activations(dev, act, m, n, k):
    gen = torch.Generator(device=dev).manual_seed(52)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device=dev)
    _close(qm.quant_matmul_int8(x, qt, s, bias, activation=act),
           qm.quant_matmul_int8_ref(x, qt, s, bias, activation=act), torch.bfloat16)


@pytest.mark.parametrize("m,n,k", [(64, 768, 3072), (64, 896, 4864), (512, 3072, 768), (20, 1152, 896)])
def test_matmul_bitwise_deterministic(dev, m, n, k):
    """Two launches on the same inputs give the same bits: the split-K sum
    runs over the cluster's ranks in a fixed order, with no atomics."""
    gen = torch.Generator(device=dev).manual_seed(53)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device=dev)
    outs = [qm.quant_matmul_int8(x, qt, s, bias, out_dtype=torch.float32) for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# The f32 route's shapes (PERF.md's f32 rows): the GPT-2 graph's
# projections at its 64-token prompt (c_attn, c_fc, mlp c_proj, lm_head),
# DistilBERT's at 3072 rows (wq / wo, up, down), MobileNetV2's expand conv
# of K 24 at 300 rows and a K-16 project conv at 1568 rows.
F32_ROUTE_SHAPES = [(64, 2304, 768), (64, 3072, 768), (64, 768, 3072), (64, 50257, 768), (3072, 768, 768),
                    (3072, 3072, 768), (3072, 768, 3072), (300, 144, 24), (1568, 96, 16)]


@pytest.mark.parametrize("m,n,k", F32_ROUTE_SHAPES + [(9, 131, 3000), (65, 70, 2056), (200, 1000, 40)])
def test_matmul_f32_route_matches_plain(dev, m, n, k):
    """f32 activations on the tensor cores (three bf16 passes, exact
    products), at the models' shapes and ragged M, N and K (K of 8 mod 16
    by cp.async): one launch, no plain call, split-K counted where
    f32_plan splits, f32 tolerance against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(54)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    bias = torch.randn(n, generator=gen, device=dev)
    split = qm.f32_device_plan(x, n)[1]
    dispatch.reset_counters()
    out = qm.quant_matmul_int8(x, qt, s, bias, activation="gelu")
    assert dispatch.LAUNCHES["quant_matmul_int8"] == 1 and not dispatch.PLAIN
    assert dispatch.LAUNCHES["quant_matmul_int8:split_k"] == (split > 1)
    assert out.shape == (m, n) and out.dtype == torch.float32
    _close(out, qm.quant_matmul_int8_ref(x, qt, s, bias, activation="gelu"), torch.float32)


# The f32 route against an f64 product: x in [1, 2) x 2^e (e in -4..4, mixed
# magnitudes) with its lowest 8 significand bits set, so the lo part of its
# three-way split is near its largest (2^-15 of x), and all-positive int8
# weights, so a dropped part cannot cancel out: max |out - exact| / max
# |exact|. Measured at these shapes on an NVIDIA H100 80GB HBM3, 700 W
# (PERF.md, section 6): the first design's FMA loop (exact products, f32 sums)
# 1.45e-6 to 3.47e-6; this route 1.82e-6 to 1.92e-6; the same route with
# the lo pass dropped (two passes) 1.43e-5 to 1.51e-5, which fails here.
F32_F64_TOL = 7e-6


def _f64_case(dev, m, n, k, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    mant = torch.randint(0, 1 << 23, (m, k), generator=gen, device=dev, dtype=torch.int32) | 0xFF
    expo = torch.randint(-4, 5, (m, k), generator=gen, device=dev, dtype=torch.int32)
    x = ((mant | (127 << 23)).view(torch.float32) * torch.exp2(expo.float())).contiguous()
    qt = torch.randint(1, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand(n, generator=gen, device=dev) * 0.02 + 0.001
    exact = (x.double() @ qt.double().t()) * s.double()
    return x, qt, s, exact


@pytest.mark.parametrize("m,n,k", [(64, 768, 768), (64, 768, 3072), (512, 768, 3072), (3072, 768, 3072)])
def test_matmul_f32_route_against_f64(dev, m, n, k):
    """The f32 route's products are exact: its error against an f64
    product stays within F32_F64_TOL (the sums' order alone), which a
    route that drops the split's lo part exceeds (the numbers above)."""
    x, qt, s, exact = _f64_case(dev, m, n, k, seed=55)
    out = qm.quant_matmul_int8(x, qt, s)
    err = ((out.double() - exact).abs().max() / exact.abs().max()).item()
    assert err <= F32_F64_TOL, err


@pytest.mark.parametrize("m,n,k", [(64, 768, 3072), (64, 2304, 768), (9, 131, 3000), (3072, 768, 768)])
def test_matmul_f32_route_bitwise_deterministic(dev, m, n, k):
    """Three launches of the f32 route on the same inputs give the same
    bits, split-K included (the partials summed in rank order)."""
    gen = torch.Generator(device=dev).manual_seed(56)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    bias = torch.randn(n, generator=gen, device=dev)
    outs = [qm.quant_matmul_int8(x, qt, s, bias) for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def _flash_case(dev, b, hq, hk, tq, s, q_offset, kv_len, d=64, causal=True, seed=60, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (1.5 * torch.randn(b, hq, tq, d, generator=gen, device=dev)).to(dtype)
    k = (1.5 * torch.randn(b, hk, s, d, generator=gen, device=dev)).to(dtype)
    v = torch.randn(b, hk, s, d, generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, q_offset=torch.tensor(q_offset, dtype=torch.int32, device=dev),
              kv_len=torch.tensor(kv_len, dtype=torch.int32, device=dev))
    return (q, k, v), kw


# (b, hq, hk, tq, s, q_offset, kv_len): each a grid of few blocks, so split over KV.
SPLIT_KV_CASES = {
    **{f"tq{t}_chunk": (1, 12, 12, t, 768, [300], [300 + t]) for t in range(1, 9)},
    "tq24_at_300": (1, 12, 12, 24, 768, [300], [324]),
    "kv_len_0_row": (2, 4, 4, 24, 512, [0, 100], [0, 124]),
    "kv_len_on_tile_edge": (2, 4, 4, 8, 512, [120, 248], [128, 256]),
    "kv_len_on_split_edge": (1, 4, 4, 16, 1024, [496], [512]),
    "kv_len_full": (1, 4, 4, 24, 512, [488], [512]),
    "gqa_14_over_2_tq8": (1, 14, 2, 8, 1024, [300], [308]),
    "gqa_14_over_2_tq64": (1, 14, 2, 64, 1024, [0], [64]),
    "gqa_14_over_2_tq24_at_300": (1, 14, 2, 24, 1024, [300], [324]),
}


def _bf16_and_f32(*cases):
    """(case, dtype) parameters: each case in bf16 under its own id, then in
    f32 under the id with ``-f32``."""
    return ([pytest.param(c, torch.bfloat16, id=c) for c in cases]
            + [pytest.param(c, torch.float32, id=f"{c}-f32") for c in cases])


@pytest.mark.parametrize("case,dtype", _bf16_and_f32(*SPLIT_KV_CASES))
def test_flash_split_kv_matches_plain(dev, case, dtype):
    from rten_tpu_torch.kernels.attention import flash_plan
    from rten_tpu_torch.kernels.quant_matmul import _sms

    b, hq, hk, tq, s, q_offset, kv_len = SPLIT_KV_CASES[case]
    args, kw = _flash_case(dev, b, hq, hk, tq, s, q_offset, kv_len, dtype=dtype)
    split = flash_plan(b, hq, hk, tq, s, _sms(args[0]))[1]
    assert split > 1
    before = dispatch.LAUNCHES["flash_attention:split_kv"]
    out = flash_attention(*args, **kw)
    assert dispatch.LAUNCHES["flash_attention:split_kv"] == before + 1
    ref = flash_attention_ref(*args, **kw)
    _close_own_max(out, ref, dtype)
    if case == "kv_len_0_row":
        assert not out[0].any()


@pytest.mark.parametrize("case,dtype", _bf16_and_f32("tq24_at_300", "gqa_14_over_2_tq8", "kv_len_on_split_edge"))
def test_flash_split_kv_head_dim_128(dev, case, dtype):
    b, hq, hk, tq, s, q_offset, kv_len = SPLIT_KV_CASES[case]
    args, kw = _flash_case(dev, b, hq, hk, tq, s, q_offset, kv_len, d=128, dtype=dtype)
    _close_own_max(flash_attention(*args, **kw), flash_attention_ref(*args, **kw), dtype)


@pytest.mark.parametrize("b,hq,hk,tq,s,q_offset,kv_len", [
    (1, 14, 2, 512, 1024, [0], [512]),    # Qwen2-0.5B's heads at a 512-token prompt: no split
    (1, 12, 12, 512, 768, [0], [512]),    # GPT-2-small's
    (2, 14, 2, 100, 256, [20, 0], [120, 77]),
])
def test_flash_gqa_long_prompts_match_plain(dev, b, hq, hk, tq, s, q_offset, kv_len):
    args, kw = _flash_case(dev, b, hq, hk, tq, s, q_offset, kv_len)
    _close_own_max(flash_attention(*args, **kw), flash_attention_ref(*args, **kw), torch.bfloat16)


@pytest.mark.parametrize("case,dtype", _bf16_and_f32("tq24_at_300", "gqa_14_over_2_tq64", "kv_len_0_row"))
def test_flash_bitwise_deterministic(dev, case, dtype):
    """Two launches on the same inputs give the same bits: the split-KV
    partials combine over the cluster's ranks in a fixed order."""
    args, kw = _flash_case(dev, *SPLIT_KV_CASES[case], dtype=dtype)
    outs = [flash_attention(*args, **kw) for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    args, kw = _flash_case(dev, 1, 12, 12, 512, 768, [0], [512], dtype=dtype)
    assert torch.equal(flash_attention(*args, **kw), flash_attention(*args, **kw))


def test_flash_sliced_prefix_caps_the_split(dev):
    """The split-KV plan reads S, so a caller that slices k/v to the prefix
    it knows of (the decoder's ``host_len`` + T, a view with the cache's
    strides) launches one tile's worth unsplit, with the split launch over
    the whole cache giving the same result up to the order of its sums."""
    (q, k, v), kw = _flash_case(dev, 1, 12, 12, 64, 768, [0], [64])
    before = dispatch.LAUNCHES["flash_attention:split_kv"]
    sliced = flash_attention(q, k[:, :, :64], v[:, :, :64], **kw)
    assert dispatch.LAUNCHES["flash_attention:split_kv"] == before
    split = flash_attention(q, k, v, **kw)
    assert dispatch.LAUNCHES["flash_attention:split_kv"] == before + 1
    ref = flash_attention_ref(q, k, v, **kw)
    _close_own_max(sliced, ref, torch.bfloat16)
    _close_own_max(split, ref, torch.bfloat16)


def test_matmul_cluster_capacity(dev):
    """The device's cluster capacity of both matmul blocks: a positive count
    for every cluster size, falling as clusters grow, and the plan of the
    few-tile projections within it."""
    for tok in (64, 128):
        fits = qm.cluster_capacity(0, tok)
        assert len(fits) == qm.MAX_SPLIT and all(n > 0 for n in fits)
        assert all(a >= b for a, b in zip(fits, fits[1:]))
        assert fits[0] >= qm.sm_count(0) // (2 if tok == 128 else 3)
    for m, n, k in [(64, 768, 3072), (512, 768, 3072), (512, 1152, 896), (64, 896, 4864)]:
        tok, split = qm.device_plan(torch.empty(m, k, device=dev, dtype=torch.bfloat16), n)
        tiles = -(-n // tok) * -(-m // tok)
        assert split > 1 and tiles <= qm.cluster_capacity(0, tok)[split - 1]


# -- the Hopper redesigns of quant_matmul_w8a8 (int8 wgmma on a TMA ring,
# split-K) and matmul_fused (bf16 wgmma with an MN-major B, the ragged
# mma.sync route, the f32 FMA ring) --

# (m, n, k): GPT-2 down at 64 rows (split), Qwen2-0.5B w_down at 64 rows
# (split), GPT-2 down and up at 512 (128-token tiles), Qwen2 qkv at 512, a
# ragged M / N / K (1040 is no multiple of the 128-deep stage).
W8_BITWISE_SHAPES = [(64, 768, 3072), (64, 896, 4864), (512, 768, 3072), (512, 3072, 768), (512, 1152, 896),
                     (77, 131, 1040), (20, 1152, 896)]


@pytest.mark.parametrize("m,n,k", W8_BITWISE_SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_matmul_w8a8_f32_equals_plain_bitwise(dev, m, n, k, with_bias):
    """f32 out, no activation: the kernel's int32 sums are exact at every
    split and its epilogue rounds as the plain version does, so the two
    are equal bit for bit; the split-K counter follows the plan."""
    gen = torch.Generator(device=dev).manual_seed(70)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device=dev) if with_bias else None
    split = qm.w8a8_device_plan(x, n)[2]
    before = dispatch.LAUNCHES["quant_matmul_w8a8:split_k"]
    out = qm.quant_matmul_w8a8(x, qt, s, bias, out_dtype=torch.float32)
    assert dispatch.LAUNCHES["quant_matmul_w8a8:split_k"] == before + (split > 1)
    assert (split > 1) == ((m, n, k) in [(64, 768, 3072), (64, 896, 4864), (512, 768, 3072), (512, 3072, 768),
                                         (512, 1152, 896), (77, 131, 1040), (20, 1152, 896)])
    ref = qm.quant_matmul_w8a8_ref(x, qt, s, bias, out_dtype=torch.float32)
    assert torch.equal(out, ref), (out - ref).abs().max().item()


@pytest.mark.parametrize("m,n,k", [(64, 768, 3072), (64, 896, 4864), (512, 3072, 768), (77, 131, 1040)])
def test_matmul_w8a8_bitwise_deterministic(dev, m, n, k):
    """Two launches on the same inputs give the same bits (bf16 out, GELU)."""
    gen = torch.Generator(device=dev).manual_seed(71)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device=dev)
    outs = [qm.quant_matmul_w8a8(x, qt, s, bias, activation="gelu") for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("m", [9, 64, 65, 512])
def test_matmul_w8a8_codes_alone_matches_the_pair(dev, m):
    """The matmul launch alone on quantize_rows_int8's codes gives what the
    two-launch wrapper gives."""
    gen = torch.Generator(device=dev).manual_seed(72)
    qt, s = _pack(gen, 768, 3072, dev)
    x = torch.randn(m, 3072, generator=gen, device=dev).to(torch.bfloat16)
    codes, sx = qm.quantize_rows_int8(x)
    alone = qm.quant_matmul_w8a8_codes(codes, sx, qt, s, out_dtype=torch.bfloat16)
    assert torch.equal(alone, qm.quant_matmul_w8a8(x, qt, s))


def _mf_close(out, ref, operands):
    """matmul_fused against its plain version at the tolerances the chip
    check and the existing card tests use: f32 operands (exact products
    summed in another order) 1e-5 of max(1, |plain|); bf16 operands with an
    f32 output (the tensor cores' f32 sums in another order) 1e-4 of it; a
    bf16 output (one rounding of it) 1e-2 of it."""
    scale = max(1.0, ref.float().abs().max().item())
    if out.dtype == torch.bfloat16:
        tol = 1e-2 * scale
    else:
        tol = (1e-5 if operands == torch.float32 else 1e-4) * scale
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, (err, tol)


def _mf_inputs(dev, m, k, n, dtype, seed=73, offset=0):
    """x [m, k] (starting ``offset`` elements into its buffer), w [k, n] at
    std k^-0.5, an f32 bias."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m * k + offset, generator=gen, device=dev).to(dtype)[offset:].view(m, k)
    w = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
    return x, w, 0.1 * torch.randn(n, generator=gen, device=dev)


MF_COUNTERS = ("matmul_fused", "matmul_fused:ragged", "matmul_fused:split_k")


def _mf_run(x, w, bias, act):
    """matmul_fused against its plain version in both output dtypes; the
    counters' increase."""
    from rten_tpu_torch.kernels.matmul import matmul_fused, matmul_fused_ref

    before = [dispatch.LAUNCHES[key] for key in MF_COUNTERS]
    for out_dtype in (x.dtype, torch.float32 if x.dtype == torch.bfloat16 else torch.bfloat16):
        out = matmul_fused(x, w, bias, activation=act, out_dtype=out_dtype)
        assert out.dtype == out_dtype and out.shape == (x.shape[0], w.shape[1])
        _mf_close(out, matmul_fused_ref(x, w, bias, activation=act, out_dtype=out_dtype), x.dtype)
    return [dispatch.LAUNCHES[key] - b for key, b in zip(MF_COUNTERS, before)]


# (m, k, n): N and K that cross the 64-column boxes and 64-deep stages (and
# a swizzle atom's 8 rows), one stage, split-K at 64 rows, the up
# projection's shape, ragged M over 128-row tiles.
MF_WGMMA_SHAPES = [(1, 64, 64), (77, 136, 200), (130, 64, 256), (129, 1040, 520), (64, 3072, 768),
                   (300, 4864, 896), (512, 768, 3072)]


@pytest.mark.parametrize("m,k,n", MF_WGMMA_SHAPES)
@pytest.mark.parametrize("act", [None, "gelu"])
def test_matmul_fused_wgmma_route_matches_plain(dev, m, k, n, act):
    from rten_tpu_torch.kernels.matmul import device_fused_plan

    x, w, bias = _mf_inputs(dev, m, k, n, torch.bfloat16)
    route, _bn, split = device_fused_plan(x, w)
    assert route == "wgmma"
    assert (split > 1) == ((m, k, n) in [(77, 136, 200), (129, 1040, 520), (64, 3072, 768), (300, 4864, 896)])
    assert _mf_run(x, w, bias, act) == [2, 0, 2 * (split > 1)]


# (m, k, n, offset): K or N not a multiple of 8, or x's base 2 bytes past a
# 16-byte boundary: rows TMA cannot address.
MF_RAGGED_SHAPES = [(3, 300, 200, 0), (77, 1040, 131, 0), (1, 7, 8, 0), (130, 64, 256, 1), (64, 3070, 768, 0)]


@pytest.mark.parametrize("m,k,n,offset", MF_RAGGED_SHAPES)
def test_matmul_fused_ragged_route_matches_plain(dev, m, k, n, offset):
    from rten_tpu_torch.kernels.matmul import device_fused_plan

    x, w, bias = _mf_inputs(dev, m, k, n, torch.bfloat16, offset=offset)
    assert device_fused_plan(x, w)[::2] == ("ragged", 1)
    assert _mf_run(x, w, bias, "gelu") == [2, 2, 0]


# (m, k, n): 1024^3 (64 tiles: split-K 2), rows that are not 16-byte
# multiples (copied 4 bytes at a time), one K step, ragged M.
MF_F32_SHAPES = [(1024, 1024, 1024), (77, 1040, 131), (1, 7, 8), (130, 64, 256), (3, 300, 200), (300, 4864, 896)]


@pytest.mark.parametrize("m,k,n", MF_F32_SHAPES)
def test_matmul_fused_f32_route_matches_plain(dev, m, k, n):
    """The f32 route against its plain version, and against an f64 product
    (exact f32 products, no TF32: 1e-5)."""
    from rten_tpu_torch.kernels.matmul import device_fused_plan, matmul_fused

    x, w, bias = _mf_inputs(dev, m, k, n, torch.float32)
    route, _bn, split = device_fused_plan(x, w)
    assert route == "f32" and (split > 1) == ((m, k, n) != (1, 7, 8))
    assert _mf_run(x, w, bias, None) == [2, 0, 2 * (split > 1)]
    ref = x.double() @ w.double() + bias.double()
    assert (matmul_fused(x, w, bias) - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("m,k,n,dtype", [(64, 3072, 768, torch.bfloat16), (512, 768, 3072, torch.bfloat16),
                                         (1024, 1024, 1024, torch.float32), (77, 1040, 131, torch.bfloat16)])
def test_matmul_fused_bitwise_deterministic(dev, m, k, n, dtype):
    """Two launches give the same bits on every route (the split-K partials
    sum over the cluster's ranks in a fixed order)."""
    from rten_tpu_torch.kernels.matmul import matmul_fused

    x, w, bias = _mf_inputs(dev, m, k, n, dtype)
    outs = [matmul_fused(x, w, bias, activation="gelu", out_dtype=torch.float32) for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_w8a8_and_fused_cluster_capacity(dev):
    """The cluster capacity of the W8A8 blocks and of matmul_fused's two
    split routes: positive, falling as clusters grow; the W8A8 M 64 block
    (a 64 KB ring) fits more clusters than quant_matmul_int8's."""
    from rten_tpu_torch.kernels.matmul import fused_capacity

    caps = [qm.cluster_capacity(0, tok, "w8a8", ch) for tok, ch in ((64, 64), (128, 64), (128, 128))]
    caps += [fused_capacity(0, route, bn) for route, bn in (("wgmma", 128), ("wgmma", 256), ("f32", 128))]
    for fits in caps:
        assert len(fits) == qm.MAX_SPLIT and all(n > 0 for n in fits)
        assert all(a >= b for a, b in zip(fits, fits[1:]))
    assert caps[0][0] > qm.cluster_capacity(0, 64)[0]


@pytest.mark.parametrize("tok_m,ch", [(64, 64), (512, 64), (512, 128)])
@pytest.mark.parametrize("n,k", [(768, 3072), (3072, 768), (131, 1040)])
def test_matmul_w8a8_block_variants_bitwise(dev, monkeypatch, tok_m, ch, n, k):
    """Every block of the W8A8 kernel (64 tokens by 64 output channels a
    warpgroup, 128 tokens by 64 or 128), whatever the plan would pick: f32
    out, no
    activation, bit for bit the plain version (split or not)."""
    monkeypatch.setattr(qm, "w8a8_channels", lambda m, n, sms: ch)
    qm.w8a8_plan.cache_clear()
    try:
        gen = torch.Generator(device=dev).manual_seed(74)
        qt, s = _pack(gen, n, k, dev)
        m = tok_m + 3  # a ragged last token tile
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn(n, generator=gen, device=dev)
        assert qm.w8a8_device_plan(x, n)[1] == ch
        out = qm.quant_matmul_w8a8(x, qt, s, bias, out_dtype=torch.float32)
        ref = qm.quant_matmul_w8a8_ref(x, qt, s, bias, out_dtype=torch.float32)
        assert torch.equal(out, ref), (out - ref).abs().max().item()
    finally:
        qm.w8a8_plan.cache_clear()


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("m,k,n", [(77, 136, 200), (512, 768, 3072), (300, 4864, 896), (2048, 512, 1032)])
def test_matmul_fused_wgmma_widths(dev, monkeypatch, bn, m, k, n):
    """Both block widths of the wgmma route (128 or 256 columns: two or
    four 64-column boxes of w a stage), whatever the plan would pick."""
    from rten_tpu_torch.kernels import matmul as mf

    monkeypatch.setattr(mf, "fused_columns", lambda route, m, n, sms: bn if route == "wgmma" else 128)
    mf.fused_plan.cache_clear()
    try:
        x, w, bias = _mf_inputs(dev, m, k, n, torch.bfloat16, seed=75)
        assert mf.device_fused_plan(x, w)[:2] == ("wgmma", bn)
        assert _mf_run(x, w, bias, "gelu")[:2] == [2, 0]
    finally:
        mf.fused_plan.cache_clear()


@pytest.mark.parametrize("m,n,k", [(64, 768, 3072), (512, 3072, 768)])
def test_matmul_w8a8_pair_in_cuda_graph(dev, m, n, k):
    """The one-launch matmul (its plan, tensor maps and cluster launch) and
    the two-launch pair captured into a CUDA graph and replayed on new
    rows: the same bits as each other and as the eager call on those rows,
    one launch each call."""
    gen = torch.Generator(device=dev).manual_seed(76)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    qm.quant_matmul_w8a8(x, qt, s)  # build, plan and warm up outside the capture
    qm.quant_matmul_w8a8_codes(*qm.quantize_rows_int8(x), qt, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    names = ("quant_matmul_w8a8", "quantize_rows_int8")
    with torch.cuda.graph(graph):
        before = [dispatch.LAUNCHES[name] for name in names]
        out = qm.quant_matmul_w8a8(x, qt, s, out_dtype=torch.float32)
        one = [dispatch.LAUNCHES[name] - b for name, b in zip(names, before)]
        pair = qm.quant_matmul_w8a8_codes(*qm.quantize_rows_int8(x), qt, s, out_dtype=torch.float32)
    assert one == [1, 0]  # the pair's matmul also counts under quant_matmul_w8a8
    for _ in range(3):
        x.copy_(torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
        graph.replay()
        assert torch.equal(out, pair)
        assert torch.equal(out, qm.quant_matmul_w8a8(x, qt, s, out_dtype=torch.float32))


# -- the one-launch W8A8 matmul (the rows quantized inside it) against the
# two-launch pair it replaced, quantize_rows_int8 then
# quant_matmul_w8a8_codes: the same codes, sx and int32 sums, so the same
# bits for every plan, dtype and edge --

def _w8_rows(gen, m, k, dev, dtype):
    """Rows with the quantizer's edges: row 0 all zero (sx 1, codes 0);
    row 1 with absmax 127 and every other value on a .5 boundary of its
    scale (half to even); row 2's absmax only in its last K column (the
    last rank's range) and row 3's only in its first (rank 0's), the rest
    of both small."""
    x = torch.randn(m, k, generator=gen, device=dev)
    x[0] = 0
    x[1] = torch.randint(-126, 126, (k,), generator=gen, device=dev).float() + 0.5
    x[1, k // 2] = 127.0
    x[2:4] = 0.01 * torch.randn(2, k, generator=gen, device=dev)
    x[2, k - 1] = -50.0
    x[3, 0] = 50.0
    return x.to(dtype)


def _w8_pair(x, qt, s, bias, **kw):
    return qm.quant_matmul_w8a8_codes(*qm.quantize_rows_int8(x), qt, s, bias, **kw)


def _w8_forced(monkeypatch, tok, ch, split, resident):
    """Route quant_matmul_w8a8 through one forced plan: its block, split and
    a resident layout (a slot a step of the longest rank) or one that reads
    the rows twice (two slots), or, where the resident one does not fit,
    the most slots that do."""
    def plan(x, n):
        m, k = x.shape
        most = -(-(-(-k // qm.QW_BK)) // split)
        stages = min(most, qm.W8A8_STAGES_REREAD)
        slots = most if resident else min(2, most)
        while qm.w8a8_smem(tok, ch, stages, slots, x.element_size()) > qm.W8A8_SMEM_BLOCK:
            slots -= 1
        assert slots >= 1 and stages >= min(most, 2)
        return qm.W8A8Plan(tok, ch, split, stages, slots, qm.w8a8_smem(tok, ch, stages, slots, x.element_size()),
                           slots >= most)

    monkeypatch.setattr(qm, "w8a8_device_plan", plan)


W8_PLANS = ([(64, 64, c, r) for c in range(1, 9) for r in (True, False)]
            + [(128, 64, c, r) for c in (1, 2, 3, 4, 8) for r in (True, False)]
            + [(128, 128, c, r) for c in (1, 2, 4) for r in (True, False)])


@pytest.mark.parametrize("tok,ch,split,resident", W8_PLANS)
def test_matmul_w8a8_every_plan_equals_pair(dev, monkeypatch, tok, ch, split, resident):
    """Every block (64 tokens x 64 channels a warpgroup, 128 x 64, 128 x
    128), every split 1-8 and both layouts, forced whatever the plan would
    pick: f32 rows to f32 out and bf16 rows to bf16 out with GELU and a
    bias, at a ragged M (a token past the block), N and K (1040: 9 steps,
    the last 16 deep): torch.equal to the pair, one launch a call."""
    _w8_forced(monkeypatch, tok, ch, split, resident)
    gen = torch.Generator(device=dev).manual_seed(77)
    m, n, k = tok + 1, 200, 1040
    qt, s = _pack(gen, n, k, dev)
    bias = torch.randn(n, generator=gen, device=dev)
    for dtype, kw in ((torch.float32, dict(out_dtype=torch.float32)),
                      (torch.bfloat16, dict(activation="gelu", out_dtype=torch.bfloat16))):
        x = _w8_rows(gen, m, k, dev, dtype)
        before = (dispatch.LAUNCHES["quant_matmul_w8a8"], dispatch.LAUNCHES["quantize_rows_int8"])
        out = qm.quant_matmul_w8a8(x, qt, s, bias, **kw)
        assert (dispatch.LAUNCHES["quant_matmul_w8a8"], dispatch.LAUNCHES["quantize_rows_int8"]) == (
            before[0] + 1, before[1])
        pair = _w8_pair(x, qt, s, bias, **kw)
        assert torch.equal(out, pair), (dtype, (out.float() - pair.float()).abs().max().item())


@pytest.mark.parametrize("m", [65, 129, 513])
@pytest.mark.parametrize("n,k", [(333, 784), (896, 4864)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_w8a8_one_launch_edges(dev, dtype, m, n, k):
    """The plan's own choice at a ragged M, N and K (784: 6 steps and 16;
    Qwen2-0.5B's w_down K 4864), f32 and bf16 out, with the quantizer's
    edge rows (_w8_rows): torch.equal to the pair."""
    gen = torch.Generator(device=dev).manual_seed(78)
    qt, s = _pack(gen, n, k, dev)
    bias = torch.randn(n, generator=gen, device=dev)
    x = _w8_rows(gen, m, k, dev, dtype)
    for out_dtype in (torch.float32, torch.bfloat16):
        out = qm.quant_matmul_w8a8(x, qt, s, bias, out_dtype=out_dtype)
        assert torch.equal(out, _w8_pair(x, qt, s, bias, out_dtype=out_dtype))
    assert torch.equal(qm.quant_matmul_w8a8(x, qt, s, out_dtype=torch.float32),
                       qm.quant_matmul_w8a8_ref(x, qt, s, out_dtype=torch.float32))


def test_matmul_w8a8_fused_smem_and_capacity(dev):
    """The kernel's shared memory a block equals w8a8_smem's count; the
    one-launch blocks' cluster capacity is positive and falls as clusters
    grow; a 64-token block at the two-a-SM budget fits more clusters than
    one alone on its SM."""
    lib = qm._build.library()
    for tok, ch in ((64, 64), (128, 64), (128, 128)):
        for stages, slots, bf16 in ((1, 1, 1), (3, 2, 0), (4, 5, 1), (2, 9, 1)):
            assert lib.rt_quant_matmul_w8a8_fused_smem(tok, ch, stages, slots, bf16) == qm.w8a8_smem(
                tok, ch, stages, slots, 2 if bf16 else 4)
        for smem in {qm.w8a8_base_smem(tok), qm.W8A8_SMEM_BLOCK}:
            fits = qm.cluster_capacity(0, tok, "w8a8_fused", ch, smem)
            assert len(fits) == qm.MAX_SPLIT and all(f > 0 for f in fits)
            assert all(a >= b for a, b in zip(fits, fits[1:]))
    pair = qm.cluster_capacity(0, 64, "w8a8_fused", 64, qm.W8A8_SMEM_PAIR)
    assert pair[0] >= 2 * qm.cluster_capacity(0, 64, "w8a8_fused", 64, qm.W8A8_SMEM_BLOCK)[0]



# -- the KV engine as one clustered launch (csrc/kv_attention.cuh): a
# cluster of C ranks a (kv head, head tile, row), rank r walking chunks r,
# r + C, ...; the group's heads scored in one pass; the ranks' states
# combined through distributed shared memory --

KV_ENGINE_KINDS = ["fused_wo", "no_wo", "int8", "paged", "paged_int8"]
# Chunk, page (64) and rank edges, and the last position of a 6-chunk row.
EDGE_LENS = [0, 1, 63, 64, 65, 127, 128, 300, 383]


def _engine_case(dev, kind, dtype, d, group, lens, hk=2, cap=384, page=64, seed=90):
    """Inputs of one KV kernel, rows at ``lens`` (each below ``cap``): Hk kv
    heads, group · Hk query heads, q and k_new separate and v_new a strided
    view; paged rows scattered through a pool with a scratch page last.
    Returns (kernel, plain, args, kw, n_cache)."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(seed)
    hq, b, per_row = group * hk, len(lens), cap // page
    q = (1.5 * torch.randn(b, hq, d, generator=gen, device=dev)).to(dtype)
    kv = (1.5 * torch.randn(b, 2 * hk, d, generator=gen, device=dev)).to(dtype)
    ops = (q, kv[:, :hk].contiguous(), kv[:, hk:])
    int8, paged = kind.endswith("int8"), kind.startswith("paged")
    shape = (b * per_row + 1, hk, page, d) if paged else (b, hk, cap, d)
    if int8:
        payload = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8) for _ in range(2)]
        payload += [0.005 + 0.015 * torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
    else:
        payload = [(1.5 * torch.randn(shape, generator=gen, device=dev)).to(dtype),
                   torch.randn(shape, generator=gen, device=dev).to(dtype)]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    n_cache = len(payload)
    if kind in ("fused_wo", "no_wo"):
        args, kw = [ops, *payload, lens_t], {}
        if kind == "fused_wo":
            wo, wos = _pack(gen, 256, hq * d, dev)
            args += [wo, wos, torch.randn(256, generator=gen, device=dev)]
            kw = dict(residual=torch.randn(b, 256, generator=gen, device=dev).to(dtype))
        return da.decode_attention, da.decode_attention_ref, args, kw, n_cache
    if kind == "int8":
        return da.decode_attention_int8, da.decode_attention_int8_ref, [ops, *payload, lens_t], {}, n_cache
    table = torch.randperm(b * per_row, generator=gen, device=dev).to(torch.int32).view(b, per_row).contiguous()
    fn = (pa.paged_decode_attention_int8, pa.paged_decode_attention_int8_ref) if int8 else (
        pa.paged_decode_attention, pa.paged_decode_attention_ref)
    return (*fn, [ops, *payload, table, lens_t], {}, n_cache)


def _engine_check(kernel, plain, args, kw, n_cache, dtype, kind):
    """The kernel against its plain version (fused wo: the output's own
    rule; else the attention vector against its own max), the caches or
    pages after the append bit for bit, and a second launch on the same
    inputs giving the same bits. Returns the kernel's output."""
    k_args = [args[0], *_clone_args(args[1:])]
    p_args = [args[0], *_clone_args(args[1:])]
    again = [args[0], *_clone_args(args[1:])]
    out = kernel(*k_args, **kw)
    ref = plain(*p_args, **kw)
    (_close if kind == "fused_wo" else _close_own_max)(out, ref, dtype)
    for a, b in zip(k_args[1 : 1 + n_cache], p_args[1 : 1 + n_cache]):
        assert torch.equal(a, b)
    assert torch.equal(kernel(*again, **kw), out)
    return out


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("kind", KV_ENGINE_KINDS)
def test_kv_engine_chunk_and_page_edges(dev, kind, group, dtype, head_dim):
    """Rows at kv_len 0, 1, 63, 64, 65, 127, 128, 300 and 383 (the last of
    6 chunks or pages of 64; int8 pages at head dims 16 and 32 are the JAX
    rule's 256 and 128), MHA and Qwen2's group of 7, both dtypes, head dims
    16, 32, 64 and 128: one launch of the kernel (the fused wo, at most 8
    rows, in two calls) against its plain version, the append bit for bit,
    two launches bit for bit."""
    dispatch.reset_counters()
    page = _rule_page(kind, head_dim)
    kernel, plain, args, kw, n_cache = _engine_case(dev, kind, dtype, head_dim, group, EDGE_LENS,
                                                    cap=-(-384 // page) * page, page=page)
    if kind == "fused_wo":  # rows 0-7, then the last
        for rows in (slice(0, 8), slice(8, 9)):
            part = [tuple(t[rows] for t in args[0]), *(t[rows] for t in args[1:4]), *args[4:]]
            _engine_check(kernel, plain, part, dict(residual=kw["residual"][rows].contiguous()), n_cache,
                          dtype, kind)
    else:
        _engine_check(kernel, plain, args, kw, n_cache, dtype, kind)


@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("kind", KV_ENGINE_KINDS)
def test_kv_engine_every_cluster_size(dev, monkeypatch, kind, group, split):
    """Every cluster size 1-8, forced over the plan, on the edge rows (6
    chunks, so 6 virtual ranks: at 7 and 8 some ranks run none), bf16:
    against the plain version, the append and a second launch bit for bit,
    and the same bits as at C 1 (a row's sums are ordered by its virtual
    ranks, not by C)."""
    from rten_tpu_torch.kernels import decode_attention as da

    lens = EDGE_LENS[:8] if kind == "fused_wo" else EDGE_LENS
    kernel, plain, args, kw, n_cache = _engine_case(dev, kind, torch.bfloat16, 64, group, lens, seed=91)
    monkeypatch.setattr(da, "kv_plan", lambda *a: 1)
    at_1 = kernel(args[0], *_clone_args(args[1:]), **kw)
    monkeypatch.setattr(da, "kv_plan", lambda *a: split)
    out = _engine_check(kernel, plain, args, kw, n_cache, torch.bfloat16, kind)
    assert torch.equal(out, at_1)


@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("kind", KV_ENGINE_KINDS)
def test_kv_engine_eight_mixed_rows_at_s768(dev, kind, group):
    """8 rows of mixed lengths (1-767) at S 768 (pages of 128), GPT-2's 12
    heads or Qwen2-0.5B's 14 over 2, bf16, the plan's own cluster size:
    against the plain version, the append and a second launch bit for bit;
    one kernel launch a call, counted under the mode's name."""
    from rten_tpu_torch.kernels.attention import kv_plan

    lens = [1, 100, 200, 300, 400, 500, 640, 767]
    hk = 12 if group == 1 else 2
    kernel, plain, args, kw, n_cache = _engine_case(dev, kind, torch.bfloat16, 64, group, lens, hk=hk, cap=768,
                                                    page=128, seed=92)
    dispatch.reset_counters()
    _engine_check(kernel, plain, args, kw, n_cache, torch.bfloat16, kind)
    assert sum(dispatch.LAUNCHES.values()) == 2
    assert 1 <= kv_plan(8, hk, group, 768, qm.sm_count(0)) <= 8


@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("kind", ["no_wo", "int8", "paged", "paged_int8"])
def test_kv_engine_row_bits_do_not_depend_on_the_batch(dev, kind, group):
    """Each of 8 rows (S 768, pages of 128) alone gives the bits it gives
    among the 8, though the plan gives the two launches other cluster sizes
    (the serving engines' streams are held against their solo streams)."""
    lens = [1, 100, 200, 300, 400, 500, 640, 767]
    hk = 12 if group == 1 else 2
    kernel, _plain, args, kw, n_cache = _engine_case(dev, kind, torch.bfloat16, 64, group, lens, hk=hk, cap=768,
                                                    page=128, seed=95)
    paged = kind.startswith("paged")
    out = kernel(args[0], *_clone_args(args[1:]), **kw)
    for i in range(len(lens)):
        ops = tuple(t[i : i + 1] for t in args[0])
        caches = _clone_args(args[1 : 1 + n_cache])
        if not paged:
            caches = [t[i : i + 1].contiguous() for t in caches]
        rest = [args[1 + n_cache][i : i + 1].contiguous()] if paged else []
        alone = kernel(ops, *caches, *rest, args[-1][i : i + 1].contiguous(), **kw)
        assert torch.equal(alone[0], out[i]), i


@pytest.mark.parametrize("group", [9, 16])
@pytest.mark.parametrize("kind", ["no_wo", "int8", "paged_int8"])
def test_kv_engine_groups_past_a_tile(dev, kind, group):
    """Groups of 9 and 16 query heads a kv head (two head tiles, each its
    own cluster; the append by the first alone), f32: against the plain
    version, the append and a second launch bit for bit."""
    kernel, plain, args, kw, n_cache = _engine_case(dev, kind, torch.float32, 64, group, EDGE_LENS, seed=93)
    _engine_check(kernel, plain, args, kw, n_cache, torch.float32, kind)


@pytest.mark.parametrize("kind", KV_ENGINE_KINDS)
def test_kv_engine_full_row_and_bad_page_are_nan(dev, kind):
    """Group 7: a row at its capacity gives NaN and (contiguous) writes
    nothing; a paged row whose table names a page outside the pool for a
    chunk it needs gives NaN; the other rows match the plain version on
    the untouched inputs."""
    kernel, plain, args, kw, n_cache = _engine_case(dev, kind, torch.float32, 64, 7, [5, 64, 383, 200], seed=94)
    paged = kind.startswith("paged")
    k_args, p_args = [args[0], *_clone_args(args[1:])], [args[0], *_clone_args(args[1:])]
    k_args[1 + n_cache + paged][2] = 384  # row 2 at its capacity
    bad = [2]
    if paged:
        k_args[1 + n_cache][3, 1] = 999  # row 3's second page (positions 64-127) outside the pool
        bad.append(3)
    before = _clone_args(k_args[1 : 1 + n_cache])
    out = kernel(*k_args, **kw)
    assert bool(out[bad].isnan().all()) and bool(out[[0, 1]].isfinite().all())
    if not paged:
        for a, b in zip(k_args[1 : 1 + n_cache], before):
            assert torch.equal(a[2], b[2])
    ref = plain(*p_args, **kw)
    (_close if kind == "fused_wo" else _close_own_max)(out[:2], ref[:2], torch.float32)


def test_kv_cluster_capacity(dev):
    """The KV kernels' cluster capacity: a positive count for every cluster
    size, falling as clusters grow, and the plan within it."""
    from rten_tpu_torch.kernels import decode_attention as da
    from rten_tpu_torch.kernels.attention import kv_plan

    for entry, variant in (("rt_decode_attention", (1, 64, 1, 1)), ("rt_decode_attention", (1, 64, 0, 0)),
                           ("rt_decode_attention_int8", (1, 128, 1)), ("rt_paged_attention", (0, 128, 0)),
                           ("rt_paged_attention_int8", (1, 64, 1))):
        fits = da.kv_cluster_capacity(0, entry, *variant)
        assert len(fits) == 8 and all(n > 0 for n in fits)
        assert all(a >= b for a, b in zip(fits, fits[1:]))
        split = kv_plan(8, 2, 7, 768, qm.sm_count(0), fits)
        assert 16 <= fits[split - 1] or split == 1


# ---------------------------------------------------------------------------
# The decode GEMV engine (csrc/gemv.cuh): quant_gemv_int8 and quant_mlp_int8
# on tensor cores, weights streamed by TMA, one launch a call
# ---------------------------------------------------------------------------

# (n, k): a partial tile and a partial chunk (K 16 x 3); N not a multiple of
# 16 and K = 16 x 17; K = 16 x 49; GPT-2's qkv width plus a ragged tile; a
# few-tile matrix whose tiles are split over a cluster of 6 blocks (K = 16
# x 305); the wo's shape (unsplit); a many-tile matrix whose K outgrows a
# slot (two pieces a tile, run in order by one block); Qwen2's down
# projection, split over clusters of 3.
GEMV_ENGINE_SHAPES = [(7, 48), (333, 272), (1000, 784), (2309, 768), (40, 4880), (768, 768), (1040, 3200),
                      (896, 4864)]
ENGINE_NORMS = [None, "layernorm", "rmsnorm"]
ENGINE_ACTS = [None, "gelu", "relu", "silu", "sigmoid", "tanh"]


def _engine_gemv_case(dev, m, n, k, dtype, norm, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    bias = torch.randn(n, generator=gen, device=dev)
    resid = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    ns = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
    kw = dict(residual=resid)
    if norm:
        kw.update(norm=norm, norm_scale=ns, norm_bias=0.1 * ns if norm == "layernorm" else None)
    return (x, qt, s, bias), kw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("n,k", GEMV_ENGINE_SHAPES)
def test_gemv_engine_matches_plain(dev, n, k, m, dtype):
    """Every edge of the engine's tiles, chunks and splits, at 1-8 rows, in
    both activation dtypes, with the norm and activation varying by shape:
    against the plain version, one launch a call."""
    i = GEMV_ENGINE_SHAPES.index((n, k))
    norm, act = ENGINE_NORMS[i % 3], ENGINE_ACTS[(i + m) % 6]
    args, kw = _engine_gemv_case(dev, m, n, k, dtype, norm, 70 + i)
    before = dispatch.LAUNCHES["quant_gemv_int8"]
    out = qm.quant_gemv_int8(*args, activation=act, **kw)
    assert dispatch.LAUNCHES["quant_gemv_int8"] == before + 1
    _close(out, qm.quant_gemv_int8_ref(*args, activation=act, **kw), dtype)


@pytest.mark.parametrize("act", ENGINE_ACTS)
@pytest.mark.parametrize("norm", ENGINE_NORMS)
def test_gemv_engine_norms_and_activations(dev, norm, act):
    """Every norm with every epilogue activation, f32 output of bf16 rows
    (the lm_head's logits mode), no bias, no residual."""
    args, _kw = _engine_gemv_case(dev, 3, 520, 256, torch.bfloat16, norm, 77)
    kw = dict(norm=norm, norm_scale=_kw.get("norm_scale"), norm_bias=_kw.get("norm_bias"), activation=act,
              out_dtype=torch.float32)
    x, qt, s, _bias = args
    out, ref = qm.quant_gemv_int8(x, qt, s, **kw), qm.quant_gemv_int8_ref(x, qt, s, **kw)
    _close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k", GEMV_ENGINE_SHAPES)
def test_gemv_engine_w8a8(dev, n, k, dtype):
    """W8A8 on the s8 tensor cores: without a norm the outputs equal the
    plain version's bit for bit (f32 out) or to its bf16 rounding (the same
    f32 value rounded once); with a norm within one code's contribution
    (_w8_close)."""
    args, kw = _engine_gemv_case(dev, 8, n, k, dtype, None, 80)
    x, qt, s, bias = args
    x[5] = 0  # an all-zero row: sx 1
    out = qm.quant_gemv_int8(x, qt, s, bias, w8a8=True, out_dtype=torch.float32, **kw | {"residual": None})
    ref = qm.quant_gemv_int8_ref(x, qt, s, bias, w8a8=True, out_dtype=torch.float32)
    assert torch.equal(out, ref)
    out = qm.quant_gemv_int8(x, qt, s, bias, w8a8=True, activation="relu", **kw)
    ref = qm.quant_gemv_int8_ref(x, qt, s, bias, w8a8=True, activation="relu", **kw)
    assert torch.equal(out, ref)
    norm = "rmsnorm" if n % 2 else "layernorm"
    args, kw = _engine_gemv_case(dev, 8, n, k, dtype, norm, 81)
    out = qm.quant_gemv_int8(*args, w8a8=True, **kw)
    ref = qm.quant_gemv_int8_ref(*args, w8a8=True, **kw)
    _w8_close(out, ref, dtype, _code(args[2], _normed(args[0], norm, kw["norm_scale"], kw["norm_bias"])))


@pytest.mark.parametrize("w8a8", [False, True], ids=["weight_only", "w8a8"])
def test_gemv_engine_argmax_ties_across_blocks_and_grids(dev, w8a8):
    """Tied maxima in columns far apart (other blocks) give the lowest
    index, columns past argmax_n are masked even when larger; over launches
    whose grids differ (the vocabulary of 20480 columns, then 1000, then
    20480 again), so a ticket left anywhere but 0 would show."""
    gen = torch.Generator(device=dev).manual_seed(82)
    m, k = 3, 256

    def case(n, ties, pad):
        qt, s = _pack(gen, n, k, dev)
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        col = torch.where(x[0].float() > 0, 100, -100).to(torch.int8)
        for c in (*ties, pad):
            qt[c] = col
            s[c] = 1.0
        s[pad] = 2.0
        x[1] = x[0]
        return x, qt, s

    for n, ties, pad, vocab in ((20480, (7, 5000, 19999), 20100, 20000), (1000, (300, 301, 990), 999, 998),
                                (20480, (64, 640, 12800), 20479, 20000)):
        x, qt, s = case(n, ties, pad)
        out = qm.quant_gemv_int8(x, qt, s, argmax_n=vocab, w8a8=w8a8)
        ref = qm.quant_gemv_int8_ref(x, qt, s, argmax_n=vocab, w8a8=w8a8)
        assert out[:2].tolist() == [ties[0], ties[0]]
        if w8a8:  # exact sums: the whole argmax equals the plain version's
            assert torch.equal(out, ref)


@pytest.mark.parametrize("dot", ["bf16", "f32", "w8a8"])
@pytest.mark.parametrize("n,k", [(2309, 768), (40, 4880), (51200, 768), (768, 768), (1040, 3200), (896, 4864)])
def test_gemv_engine_row_alone_equals_row_among_8(dev, n, k, dot):
    """A row computed alone gives the bits it gives among 8 (a column's sum
    order depends on (n, k) alone), with a norm, and its argmax."""
    dtype = torch.float32 if dot == "f32" else torch.bfloat16
    args, kw = _engine_gemv_case(dev, 8, n, k, dtype, "layernorm", 83)
    x, qt, s, bias = args
    w8 = dot == "w8a8"
    kw.pop("residual")
    out = qm.quant_gemv_int8(x, qt, s, bias, w8a8=w8, **kw)
    tok = qm.quant_gemv_int8(x, qt, s, argmax_n=n - 5, w8a8=w8, **kw)
    for r in range(8):
        assert torch.equal(qm.quant_gemv_int8(x[r : r + 1].contiguous(), qt, s, bias, w8a8=w8, **kw)[0], out[r]), r
        alone = qm.quant_gemv_int8(x[r : r + 1].contiguous(), qt, s, argmax_n=n - 5, w8a8=w8, **kw)
        assert alone[0] == tok[r], r


def test_gemv_engine_argmax_on_two_streams(dev):
    """Argmax GEMVs on two streams at once, each on its own stream's work
    buffer: every launch's tokens equal those of the same call alone on the
    default stream (the kernel is deterministic; a shared ticket would mix
    the launches' partials)."""
    gen = torch.Generator(device=dev).manual_seed(88)
    cases = []
    for n in (20480, 51200):
        qt, s = _pack(gen, n, 768, dev)
        x = torch.randn(4, 768, generator=gen, device=dev).to(torch.bfloat16)
        cases.append((x, qt, s, n - 100, qm.quant_gemv_int8(x, qt, s, argmax_n=n - 100)))
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    outs = [[], []]
    torch.cuda.synchronize()
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                x, qt, s, vocab, _ref = cases[i]
                outs[i].append(qm.quant_gemv_int8(x, qt, s, argmax_n=vocab))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, cases[i][4]) for o in outs[i]), i


def _engine_mlp_case(dev, m, d, ff, nq, dtype, seed, w8a8=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    wu, su = _pack(gen, ff, d, dev)
    wd, sd = _pack(gen, d, ff, dev)
    x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    resid = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    ns = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    nxt = None
    if nq:
        wq, sq = _pack(gen, nq, d, dev)
        nxt = (wq, sq * 0.1, torch.randn(nq, generator=gen, device=dev), ns * 0.9, ns * 0.1)
    args = (x, wu, su * 0.1, wd, sd * 0.1, torch.randn(ff, generator=gen, device=dev),
            torch.randn(d, generator=gen, device=dev))
    kw = dict(activation="gelu", norm="layernorm", norm_scale=ns, norm_bias=0.1 * ns, residual=resid,
              next_qkv=nxt, w8a8=w8a8)
    return args, kw


# (d, ff, nq): GPT-2-small's MLP with and without the next qkv (every
# block's weights resident in shared memory); MLP_STREAMING is past the
# fused budget (19 MB: its later units stream through the ring).
MLP_ENGINE_SHAPES = [(768, 3072, 2304), (768, 3072, 0)]
MLP_STREAMING = (1024, 8192, 3072)


def _mlp_engine_check(dev, d, ff, nq, m, dtype):
    args, kw = _engine_mlp_case(dev, m, d, ff, nq, dtype, 84)
    before = dispatch.LAUNCHES["quant_mlp_int8"]
    out, ref = qm.quant_mlp_int8(*args, **kw), qm.quant_mlp_int8_ref(*args, **kw)
    assert dispatch.LAUNCHES["quant_mlp_int8"] == before + 1
    outs, refs = (out, ref) if nq else ((out,), (ref,))
    for o, r in zip(outs, refs):
        _close(o, r, dtype)
    alone = qm.quant_mlp_int8(args[0][-1:].contiguous(), *args[1:], **kw | {"residual": kw["residual"][-1:]})
    for o, a in zip(outs, (alone,) if not nq else alone):
        assert torch.equal(o[-1:], a)
    phases = ((ff, d, True, args[0].element_size()), (d, ff, False, 4)) + (((nq, d, True, 4),) if nq else ())
    return qm.gemv_plan(m, qm.gemv_dot(args[0]), phases, qm.sm_count(0), True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("d,ff,nq", MLP_ENGINE_SHAPES)
def test_mlp_engine_resident(dev, d, ff, nq, m, dtype):
    """The MLP in one cooperative launch, its weights resident in shared
    memory, against the plain version; a row alone equal to itself among
    the rows."""
    plan = _mlp_engine_check(dev, d, ff, nq, m, dtype)
    assert plan.resident or dtype == torch.float32


@pytest.mark.parametrize("m", [1, 8])
def test_mlp_engine_streams_past_the_budget(dev, m):
    """An MLP past the fused budget (bf16): its later units streamed
    through the ring, against the plain version, and a row alone equal to
    itself among the rows."""
    plan = _mlp_engine_check(dev, *MLP_STREAMING, m, torch.bfloat16)
    assert not plan.resident


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("d,ff,nq", MLP_ENGINE_SHAPES + [MLP_STREAMING])
def test_mlp_engine_w8a8(dev, d, ff, nq, m):
    """The W8A8 MLP in one launch, resident and streaming, within one code's
    contribution per quantized phase (as test_mlp_w8a8_kernel_matches_plain)."""
    args, kw = _engine_mlp_case(dev, m, d, ff, nq, torch.bfloat16, 85, w8a8=True)
    out, ref = qm.quant_mlp_int8(*args, **kw), qm.quant_mlp_int8_ref(*args, **kw)
    x, wu, su, _wd, sd, bu, _bd = args
    xn = _normed(x, "layernorm", kw["norm_scale"], kw["norm_bias"])
    codes = _code(su, xn) + _code(sd, qm.quant_gemv_int8_ref(xn, wu, su, bu, activation="gelu", w8a8=True))
    if nq:
        nxt = kw["next_qkv"]
        _w8_close(out[1], ref[1], torch.bfloat16,
                  2 * codes + _code(nxt[1], _normed(ref[0], "layernorm", nxt[3], nxt[4])))
        out, ref = out[0], ref[0]
    _w8_close(out, ref, torch.bfloat16, codes)


def test_gemv_engine_one_launch_a_call(dev):
    """quant_gemv_int8 (the argmax included), quant_mlp_int8 and its W8A8
    mode each launch one kernel a call: the profiler's launch calls on the
    host (its device records can miss a kernel), all of gemv_kernel."""
    args, kw = _engine_gemv_case(dev, 2, 51200, 768, torch.bfloat16, "layernorm", 86)
    x, qt, s, _bias = args
    kw.pop("residual")
    margs, mkw = _engine_mlp_case(dev, 2, 768, 3072, 2304, torch.bfloat16, 87)
    calls = {"argmax": lambda: qm.quant_gemv_int8(x, qt, s, argmax_n=50257, **kw),
             "gemv": lambda: qm.quant_gemv_int8(x, qt, s, **kw),
             "mlp": lambda: qm.quant_mlp_int8(*margs, **mkw),
             "mlp_w8a8": lambda: qm.quant_mlp_int8(*margs, **mkw | {"w8a8": True})}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        launches = sum(e.count for e in events if e.key.startswith("cudaLaunch"))
        kernels = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CUDA}
        assert launches == 4 and kernels and all("gemv_kernel" in k for k in kernels), (name, launches, kernels)


# ---------------------------------------------------------------------------
# The encoders and vision models: the kernel modes they add, the IEEE-f32
# helper, and each model's forward through the kernels against its plain run.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", [(300, 144, 24), (9, 20, 8), (130, 96, 40), (4, 144, 24), (1568, 16, 32)])
def test_matmul_kernel_k_multiple_of_8(dev, dtype, m, n, k):
    """A K of 8 mod 16 (MobileNetV2's K-24 expands; weight rows only 8-byte
    aligned) in one quant_matmul_int8 launch and no plain call, at every
    row count: at M ≤ 8 too, where the GEMV (K a multiple of 16) is not
    taken. K 32 at N 16 is MobileNetV2's first project convolution's shape."""
    gen = torch.Generator(device=dev).manual_seed(90)
    qt, s = _pack(gen, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    bias = torch.randn(n, generator=gen, device=dev)
    dispatch.reset_counters()
    out = qm.quant_matmul_int8(x, qt, s, bias, activation="relu")
    assert dict(dispatch.LAUNCHES) == {"quant_matmul_int8": 1} or k % 16 == 0 and m <= 8
    assert not dispatch.PLAIN
    assert out.shape == (m, n) and out.dtype == dtype
    _close(out, qm.quant_matmul_int8_ref(x, qt, s, bias, activation="relu"), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d", [(64, 64), (197, 64), (130, 128)])
def test_flash_kernel_per_row_lengths_tq_eq_s(dev, dtype, t, d):
    """Non-causal attention at Tq = S over B 8 rows of their own valid
    lengths (the BERT and wav2vec2 batches), views of [B·T, H·D]
    projections; valid query rows against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(91)
    b, h = 8, 2
    lens = torch.tensor([t, 1, t // 2, 17, t - 1, 64, 3, t // 3], dtype=torch.int32, device=dev)

    def heads():
        return (1.5 * torch.randn(b * t, h * d, generator=gen, device=dev)).to(dtype).view(b, t, h, d).transpose(1, 2)

    q, k, v = heads(), heads(), heads()
    dispatch.reset_counters()
    out = flash_attention(q, k, v, causal=False, kv_len=lens)
    assert dict(dispatch.LAUNCHES).get("flash_attention") == 1 and not dispatch.PLAIN
    ref = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=False, kv_len=lens)
    _close_own_max(out, ref, dtype)


def test_ieee_conv_helper_with_tf32_flags_on(dev):
    """With both TF32 flags on (cuDNN's default, and cuBLAS's set), the
    helper's f32 convolutions and matmul stay within 1e-5 relative RMS of
    f64; the flags are the caller's again afterwards."""
    from rten_tpu_torch.models import ieee

    gen = torch.Generator(device=dev).manual_seed(92)
    x = torch.randn(4, 64, 56, 56, generator=gen, device=dev)
    w = torch.randn(128, 64, 3, 3, generator=gen, device=dev) * 0.05
    x1 = torch.randn(2, 64, 4000, generator=gen, device=dev)
    w1 = torch.randn(64, 4, 128, generator=gen, device=dev) * 0.05
    a, b = torch.randn(512, 768, generator=gen, device=dev), torch.randn(768, 1024, generator=gen, device=dev)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cases = [(ieee.conv2d(x, w, padding=1), torch.nn.functional.conv2d(x.double(), w.double(), padding=1)),
                 (ieee.conv1d(x1, w1, padding=64, groups=16),
                  torch.nn.functional.conv1d(x1.double(), w1.double(), padding=64, groups=16)),
                 (ieee.matmul(a, b), a.double() @ b.double())]
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for got, want in cases:
        rel = ((got.double() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()
        assert rel <= 1e-5, rel


@contextlib.contextmanager
def _plain_encoders():
    """Route the encoders' and vision models' kernel calls to their plain
    versions on the card."""
    from rten_tpu_torch.models import bert, mobilenet, vit  # wav2vec2's layers are bert's

    plain = [(bert, "quant_matmul_int8", qm.quant_matmul_int8_ref), (mobilenet, "quant_matmul_int8",
             qm.quant_matmul_int8_ref)] + [(mod, "flash_attention", flash_attention_ref) for mod in (bert, vit)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in plain]
    for mod, name, fn in plain:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def _model_runs(dev, name, dtype):
    """(kernel output, plain output, launches) of one model at the CPU
    tests' sizes, random weights from seed 0, on the card."""
    from rten_tpu_torch.models import bert, mobilenet, resnet, vit, wav2vec2

    gen = torch.Generator(device=dev).manual_seed(93)
    if name == "bert":
        cfg = bert.BertConfig(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=512, max_seq=64, dtype=dtype)
        params = bert.quantize_params_int8(bert.init_params(0, cfg, device=dev), device=dev)
        ids = torch.randint(0, 500, (3, 48), generator=gen, device=dev)
        lens = torch.tensor([48, 31, 9], dtype=torch.int32, device=dev)
        head = {"w": torch.randn(256, 2, generator=gen, device=dev), "b": torch.zeros(2, device=dev)}

        def fn():
            hidden = bert.encode(params, cfg, ids, lengths=lens)
            valid = torch.arange(48, device=dev)[None, :] < lens[:, None].long()
            return torch.cat([hidden[valid].float().reshape(-1), bert.pool(hidden, lens).float().reshape(-1),
                              bert.qa_logits(hidden, head, lens)[0][valid].float()])
    elif name == "wav2vec2":
        cfg = wav2vec2.Wav2Vec2Config(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), d_model=256,
                                      n_layers=2, n_heads=4, d_ff=512)
        params = wav2vec2.quantize_params_int8(wav2vec2.init_params(0, cfg, device=dev), device=dev)
        wav = torch.randn(2, 490, generator=gen, device=dev)
        frames = torch.tensor([48, 29], dtype=torch.int32, device=dev)

        def fn():
            logits = wav2vec2.ctc_logits(params, cfg, wav, lengths=frames)
            return torch.cat([logits[0], logits[1, :29]]).reshape(-1)
    elif name == "vit":
        cfg = vit.ViTConfig(image_size=32, patch_size=8, n_layers=2, n_heads=4, d_model=256, d_ff=1024, n_classes=10)
        params = vit.init_params(0, cfg, device=dev)
        img = torch.randn(2, 3, 32, 32, generator=gen, device=dev)

        def fn():
            return torch.cat([vit.encode(params, cfg, img).reshape(-1), vit.classify(params, cfg, img).reshape(-1)])
    elif name == "mobilenet":
        cfg = mobilenet.MobileNetConfig(blocks=((1, 16, 1, 1), (6, 24, 2, 2)), last_channels=64, num_classes=10)
        params = mobilenet.quantize_params_int8(mobilenet.init_params(0, cfg, device=dev), device=dev)
        img = torch.randn(2, 3, 32, 32, generator=gen, device=dev)

        def fn():
            return mobilenet.forward(params, cfg, img).reshape(-1)
    else:
        cfg = resnet.ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=8)
        params = resnet.init_params(0, cfg, device=dev)
        img = torch.randn(2, 3, 32, 32, generator=gen, device=dev)

        def fn():
            return torch.cat([resnet.forward(params, cfg, img).reshape(-1),
                              resnet.forward(params, cfg, img, features=True).reshape(-1)])
    dispatch.reset_counters()
    out = fn()
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    with _plain_encoders():
        ref = fn()
    return out, ref, launches, plain


MODEL_LAUNCHES = {"bert": {"quant_matmul_int8": 12, "flash_attention": 2},
                  "wav2vec2": {"quant_matmul_int8": 12, "flash_attention": 2},
                  "vit": {"flash_attention": 4}, "mobilenet": {"quant_matmul_int8": 6}, "resnet": {}}


@pytest.mark.parametrize("name,dtype", [("bert", torch.float32), ("bert", torch.bfloat16), ("wav2vec2", torch.float32),
                                        ("vit", torch.float32), ("mobilenet", torch.float32),
                                        ("resnet", torch.float32)])
def test_encoder_models_match_plain(dev, name, dtype):
    """Each model's forward through the kernels against the same forward
    through the plain versions on the card: relative RMS ≤ 1e-4 in f32
    (0.05 for BERT in bf16), every kernel launch counted, no plain call."""
    out, ref, launches, plain = _model_runs(dev, name, dtype)
    assert not plain, plain
    assert {k: v for k, v in launches.items() if ":" not in k} == MODEL_LAUNCHES[name]
    assert bool(torch.isfinite(out).all())
    assert _rel_rms(out, ref) <= (1e-4 if dtype == torch.float32 else 0.05)


# ---------------------------------------------------------------------------
# The graph runtime on the card
# ---------------------------------------------------------------------------


def _gate_specs():
    """``SPECS`` and ``build_model`` of the JAX package's execute-every-op
    gate (``tests/test_all_ops_execute.py``), imported as they are. The
    card's machine has no JAX, so there the names that file imports from
    the JAX package come from stand-ins while it loads: its ``Graph`` is the
    port's (the same API), and nothing else of them is used here."""
    import importlib
    import sys
    import types

    try:
        gate = importlib.import_module("test_all_ops_execute")
        return gate.SPECS, gate.build_model
    except ImportError:
        pass
    from rten_tpu_torch import graph as tgraph
    from rten_tpu_torch.ops import registry as tregistry
    from rten_tpu_torch.runtime import session as tsession

    stand_ins = {
        "rten_tpu": types.ModuleType("rten_tpu"),
        "rten_tpu.optimize": types.ModuleType("rten_tpu.optimize"),
        "rten_tpu.optimize.quantize": types.ModuleType("rten_tpu.optimize.quantize"),
        "rten_tpu.format": types.ModuleType("rten_tpu.format"),
        "rten_tpu.format.fbs": types.ModuleType("rten_tpu.format.fbs"),
        "rten_tpu.format.rten_io": types.ModuleType("rten_tpu.format.rten_io"),
        "rten_tpu.graph": tgraph, "rten_tpu.ops": types.ModuleType("rten_tpu.ops"),
        "rten_tpu.ops.registry": tregistry, "rten_tpu.runtime": types.ModuleType("rten_tpu.runtime"),
        "rten_tpu.runtime.session": tsession,
    }
    stand_ins["rten_tpu.format"].fbs = stand_ins["rten_tpu.format.fbs"]
    stand_ins["rten_tpu.format.rten_io"].load_rten = stand_ins["rten_tpu.format.rten_io"].save_rten = None
    saved = {name: sys.modules.get(name) for name in stand_ins}
    sys.modules.update(stand_ins)
    try:
        gate = importlib.import_module("test_all_ops_execute")
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
    return gate.SPECS, gate.build_model


GATE_SPECS, GATE_BUILD = _gate_specs()


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("op_type", sorted(GATE_SPECS))
def test_graph_op_on_card_matches_cpu(dev, op_type):
    """Every op of the execute-every-op gate on the card in both modes (the
    compile mode captured and replayed) against the port's CPU interpret
    run: the gate's rtol 1e-4 / atol 1e-5 for floats, integers exactly;
    data-dependent ops raise CompileError in compile mode."""
    import numpy as np

    import rten_tpu_torch.optimize.quantize  # noqa: F401 — registers QuantMatMul
    from rten_tpu_torch.ops.registry import CompileError
    from rten_tpu_torch.runtime.executor import RunError
    from rten_tpu_torch.runtime.session import Model, ModelOptions, RunOptions

    spec = GATE_SPECS[op_type]
    g, inputs = GATE_BUILD(op_type, spec)
    opts = ModelOptions(enable_optimization=False)
    want = [_host(o) for o in Model(g, options=opts, device="cpu").run(inputs, opts=RunOptions(mode="interpret",
                                                                                             seed=0))]
    model = Model(g, options=opts, device=dev)
    runs = [[_host(o) for o in model.run(inputs, opts=RunOptions(mode="interpret", seed=0))]]
    if spec.get("dd"):
        with pytest.raises((CompileError, RunError)) as exc:
            model.run(inputs, opts=RunOptions(mode="compile", seed=0))
        assert isinstance(exc.value, CompileError) or isinstance(exc.value.__cause__, CompileError)
    else:
        for _ in range(3):  # the capture, then two replays
            runs.append([_host(o) for o in model.run(inputs, opts=RunOptions(mode="compile", seed=0))])
        assert len(model._compiled) == 1
    for got in runs:
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, (op_type, a.shape, b.shape, a.dtype, b.dtype)
            if spec.get("nd"):
                continue
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
            else:
                np.testing.assert_array_equal(a, b)
    for run in runs[2:]:  # replays equal the warm-up bit for bit (random ops too)
        for a, b in zip(run, runs[1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [2, 8, 64])
@pytest.mark.parametrize("k", [8, 20, 24, 768])
def test_graph_quant_matmul_launches_its_kernels(dev, m, k):
    from rten_tpu_torch.ops.registry import OpContext, get_op
    import rten_tpu_torch.optimize.quantize  # noqa: F401

    gen = torch.Generator(device=dev).manual_seed(m * 1000 + k)
    n = 72
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand(n, generator=gen, device=dev) * 0.01 + 0.001
    dispatch.reset_counters()
    out = get_op("QuantMatMul").fn(OpContext(device=dev), {}, x, w, s)
    want = {"quant_gemv_int8" if m <= 8 else "quant_matmul_int8": 1}
    if m > 8 and qm.f32_device_plan(x, n)[1] > 1:  # the f32 route splits K where its tiles are few
        want["quant_matmul_int8:split_k"] = 1
    assert dict(dispatch.LAUNCHES) == want
    assert not dispatch.PLAIN
    ref = (x.double() @ w.double()) * s.double()
    assert ((out.double() - ref).pow(2).mean() / ref.pow(2).mean()).sqrt().item() < 1e-4
    assert out.shape == (m, n) and out.dtype == torch.float32


def _tiny_gpt2_model(dev, **kw):
    from rten_tpu_torch.graph import Graph
    from rten_tpu_torch.models.gpt2_graph import Gpt2GraphConfig, build_gpt2_graph
    from rten_tpu_torch.optimize.quantize import quantize_graph_int8
    from rten_tpu_torch.runtime.session import Model

    cfg = Gpt2GraphConfig(vocab_size=500, n_positions=256, d_model=128, n_layers=2, n_heads=2, d_ff=512)
    graph, _ = quantize_graph_int8(build_gpt2_graph(Graph, cfg, seed=0))
    return Model(graph, device=dev, **kw), cfg


def _feed(t, cfg, past=0):
    import numpy as np

    rng = np.random.default_rng(t)
    feed = {"input_ids": rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32),
            "attention_mask": np.ones((1, past + t), np.int32),
            "position_ids": np.arange(past, past + t, dtype=np.int32)[None]}
    for i in range(cfg.n_layers):
        for kind in ("key", "value"):
            feed[f"past_key_values.{i}.{kind}"] = rng.standard_normal(
                (1, cfg.n_heads, past, cfg.d_model // cfg.n_heads)).astype(np.float32)
    return feed


def test_graph_compiled_replay_equals_warm_up(dev):
    """A signature's first compile call runs eagerly (the warm-up) and
    captures; its replays give the same bits, valid after the next call;
    one CUDAGraph per signature."""
    from rten_tpu_torch.runtime.session import RunOptions

    model, cfg = _tiny_gpt2_model(dev)
    feed = _feed(12, cfg, past=5)
    opts = RunOptions(mode="compile")
    dispatch.reset_counters()
    warm = model.run(feed, opts=opts)
    assert dispatch.LAUNCHES["quant_matmul_int8"] == 9 and not dispatch.PLAIN
    replay = model.run(feed, opts=opts)
    again = model.run(_feed(12, cfg, past=5) | {"input_ids": feed["input_ids"][:, ::-1].copy()}, opts=opts)
    assert dispatch.LAUNCHES["quant_matmul_int8"] == 27 and not dispatch.PLAIN  # replays count their launches
    for a, b in zip(warm, replay):
        assert torch.equal(a, b)  # and ``again`` did not overwrite ``replay``
    assert not torch.equal(again[0], replay[0])
    (entry,) = model._compiled.values()
    assert isinstance(entry.cuda_graph, torch.cuda.CUDAGraph)
    interp = model.run(feed, opts=RunOptions(mode="interpret"))
    for a, b in zip(replay, interp):
        _close(a, b, torch.float32)
    model.run(_feed(3, cfg, past=5), opts=opts)
    assert len(model._compiled) == 2


def test_graph_donated_input_read_in_place(dev):
    from rten_tpu_torch.graph import Graph
    from rten_tpu_torch.runtime.session import Model, ModelOptions, RunOptions

    g = Graph()
    x = g.add_value("x")
    g.inputs, g.outputs = [x], [g.add_simple_op("Mul", [x, g.add_constant("c", torch.tensor(2.0).numpy())])]
    model = Model(g, options=ModelOptions(enable_optimization=False), device=dev)
    buf = torch.ones(4, 4, device=dev)
    opts = RunOptions(mode="compile", donate_inputs=True)
    assert torch.equal(model.run([buf], opts=opts)[0], 2 * buf)
    buf.fill_(3.0)  # the entry reads the caller's tensor in place
    assert torch.equal(model.run([buf], opts=opts)[0], torch.full_like(buf, 6.0))
    other = torch.full((4, 4), 5.0, device=dev)  # another tensor: an entry of its own, buf untouched
    assert torch.equal(model.run([other], opts=opts)[0], torch.full_like(buf, 10.0))
    assert torch.equal(buf, torch.full_like(buf, 3.0)) and len(model._compiled) == 2


def test_graph_backend_on_card(dev):
    """The tiny GPT-2 graph through GraphBackend on the card: the compiled
    path's tokens equal the legacy interpret path's and the CPU's, one
    captured entry a bucket, QuantMatMul on its kernels (no plain call)."""
    import numpy as np

    from rten_tpu_torch.generate import Generator, GeneratorConfig, GraphBackend

    model, cfg = _tiny_gpt2_model(dev)
    cpu_model, _ = _tiny_gpt2_model("cpu")
    prompt = list(range(3, 40))

    def tokens(backend, n=30):
        return [int(t[0]) for t in Generator(backend, GeneratorConfig(max_tokens=n)).with_prompt(prompt)]

    dispatch.reset_counters()
    got = tokens(GraphBackend(model))
    assert dispatch.LAUNCHES["quant_matmul_int8"] == 9 and dispatch.LAUNCHES["quant_gemv_int8"] == 9 * 29
    assert not dispatch.PLAIN
    assert len(model._compiled) == 3  # prompt bucket 64, decode buckets 64 and 128
    be = GraphBackend(model)
    assert tokens(be) == got and len(model._compiled) == 5  # a backend's buffers: entries of its own
    be.reset()
    assert tokens(be) == got and len(model._compiled) == 5
    assert tokens(GraphBackend(model, mode="interpret")) == got
    assert tokens(GraphBackend(cpu_model)) == got
    logits = GraphBackend(model).prefill(np.asarray([prompt], np.int32))
    ref = GraphBackend(cpu_model).prefill(np.asarray([prompt], np.int32))
    _close(logits.cpu(), ref, torch.float32)


# ---------------------------------------------------------------------------
# Model files and the dense-weight route (the lifted decoders)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_offset,tq", [(0, 64), (64, 8), (300, 1)])
def test_lift_f32_causal_flash_matches_plain(dev, q_offset, tq):
    """f32 causal flash_attention at GPT-2's attention (12 heads of 64) as
    the dense route calls it: q a view of the [B, T, H, D] projection, k and
    v views of the valid prefix of a 1024-position cache."""
    gen = torch.Generator(device=dev).manual_seed(41)
    h, d, s = 12, 64, 1024
    q = (torch.randn(1, tq, h * d, generator=gen, device=dev) * 1.5).view(1, tq, h, d).transpose(1, 2)
    k_cache = torch.randn(1, h, s, d, generator=gen, device=dev) * 1.5
    v_cache = torch.randn(1, h, s, d, generator=gen, device=dev)
    n = q_offset + tq
    kw = dict(causal=True, q_offset=torch.tensor([q_offset], dtype=torch.int32, device=dev),
              kv_len=torch.tensor([n], dtype=torch.int32, device=dev))
    args = (q, k_cache[:, :, :n], v_cache[:, :, :n])
    before = dispatch.LAUNCHES["flash_attention"]
    out = flash_attention(*args, **kw)
    assert dispatch.LAUNCHES["flash_attention"] == before + 1
    _close_own_max(out, flash_attention_ref(*args, **kw), torch.float32)


@pytest.mark.parametrize("kv_len", [0, 64, 263, 1023])
def test_lift_f32_no_wo_decode_matches_plain(dev, kv_len):
    """f32 decode_attention without its wo over a 1024-position cache at
    GPT-2's attention: the attention vector against the plain version, the
    caches after the append bit for bit, one launch under its mode name."""
    gen = torch.Generator(device=dev).manual_seed(kv_len)
    h, d, s = 12, 64, 1024
    ops = tuple(torch.randn(1, h, d, generator=gen, device=dev) * 1.5 for _ in range(3))
    caches = [torch.randn(1, h, s, d, generator=gen, device=dev) for _ in range(2)]
    lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    k_caches, p_caches = [c.clone() for c in caches], [c.clone() for c in caches]
    before = dispatch.LAUNCHES["decode_attention:no_wo"]
    out = decode_attention(ops, *k_caches, lens)
    assert dispatch.LAUNCHES["decode_attention:no_wo"] == before + 1
    _close_own_max(out, decode_attention_ref(ops, *p_caches, lens), torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(k_caches, p_caches))


def _tiny_file(tied=False, quantize=True):
    """The tiny GPT-2 graph (head dim 64) as `.rten` bytes: int8 with its
    dead f32 constants swept, or f32."""
    from rten_tpu_torch.format import save_rten
    from rten_tpu_torch.graph import Graph
    from rten_tpu_torch.models.gpt2_graph import Gpt2GraphConfig, build_gpt2_graph
    from rten_tpu_torch.optimize import passes
    from rten_tpu_torch.optimize.quantize import quantize_graph_int8

    cfg = Gpt2GraphConfig(vocab_size=500, n_positions=256, d_model=128, n_layers=2, n_heads=2, d_ff=512)
    graph = build_gpt2_graph(Graph, cfg, seed=0, tied=tied)
    if quantize:
        graph = passes.sweep_dead_constants(quantize_graph_int8(graph)[0])
    return save_rten(graph), cfg


def test_load_mmap_and_load_file_on_card(dev, tmp_path):
    """Both loaders put the file's model on the card: a compiled forward
    equals the in-memory model's bit for bit and the CPU's within f32
    tolerance; the mapped constants stay read-only and unchanged."""
    import numpy as np

    from rten_tpu_torch.format import load_rten
    from rten_tpu_torch.runtime.session import Model

    data, cfg = _tiny_file()
    path = tmp_path / "tiny.rten"
    path.write_bytes(data)
    feed = _feed(9, cfg, past=4)
    want = Model(load_rten(data)[0], device=dev).run(feed, ["logits"])[0]
    mapped = Model.load_mmap(path, device=dev)
    consts = [n.value for n in mapped.graph.nodes if getattr(n, "value", None) is not None and n.value.size > 1000]
    before = [c.copy() for c in consts]
    for model in (Model.load_file(path, device=dev), mapped):
        for _ in range(2):  # the capture, then a replay
            assert torch.equal(model.run(feed, ["logits"])[0], want)
    assert all(not c.flags.writeable and np.array_equal(c, b) for c, b in zip(consts, before))
    _close(want.cpu(), Model.load(data, device="cpu").run(feed, ["logits"])[0], torch.float32)


def test_dense_route_generate_scan_captured(dev):
    """The tiny f32 GPT-2 file lifted onto the dense-weight route on the
    card: generate_scan captured equals its eager steps (one graph, the
    same launches: decode_attention without wo a layer a step, no int8
    kernel, no plain call) and the CPU's dense route token for token."""
    import numpy as np

    from rten_tpu_torch.generate import backend_for_model
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.runtime.session import Model

    data, _ = _tiny_file(tied=True, quantize=False)
    params = {dv: backend_for_model(Model.load(data, device=dv), n_heads=2, device=dv).params for dv in (dev, "cpu")}
    cfg = backend_for_model(Model.load(data, device="cpu"), n_heads=2, device="cpu").cfg
    prompt = np.arange(3, 20, dtype=np.int32)[None]

    def run(device, eager=False):
        p = params[device]
        cache = decoder.init_cache(cfg, 1, 128, device=device)
        first, cache = decoder.prefill(p, cfg, torch.from_numpy(prompt).to(device), cache, lm_head_mode="argmax",
                                       last_only=True)
        dispatch.reset_counters()
        with _eager_scan(decoder) if eager else contextlib.nullcontext():
            toks, cache = decoder.generate_scan(p, cfg, cache, first, n_steps=24)
        return [int(first[0, 0])] + toks[0].tolist(), dict(dispatch.LAUNCHES), cache

    got, launches, cache = run(dev)
    assert len(decoder._GRAPHS[cache["len"]]) == 1
    assert launches == {"decode_attention:no_wo": 24 * cfg.n_layers} and not dispatch.PLAIN
    eager, eager_launches, _ = run(dev, eager=True)
    assert got == eager and launches == eager_launches
    assert run("cpu")[0] == got


def test_dense_encoder_decoder_on_card(dev):
    """The encoder-decoder on dense f32 weights (head dim 64) on the card
    against the CPU's plain versions: encoder states and a prompt plus two
    steps of logits within f32 tolerance; flash_attention and
    decode_attention without wo, nothing else of the kernels."""
    from rten_tpu_torch.models import encoder_decoder as ed

    cfg = ed.EncDecConfig(n_mels=16, n_audio_ctx=32, vocab_size=500, d_model=256, n_heads=4, n_audio_layers=2,
                          n_text_layers=2, d_ff=512, max_text_ctx=64, dtype=torch.float32)
    params = {dv: ed.init_params(0, cfg, device=dv) for dv in (dev, "cpu")}
    mel = torch.randn(1, 16, 64, generator=torch.Generator().manual_seed(3))
    dispatch.reset_counters()
    outs = {}
    for dv in (dev, "cpu"):
        enc = ed.encode(params[dv], cfg, mel.to(dv))
        state = ed.init_decoder_state(params[dv], cfg, enc)
        rows = [ed.decode(params[dv], cfg, torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dv), state)[0]]
        for t in (7, 9):
            rows.append(ed.decode(params[dv], cfg, torch.tensor([[t]], dtype=torch.int32, device=dv), state)[0])
        outs[dv] = (enc.cpu(), [r.cpu() for r in rows])
    assert set(dispatch.LAUNCHES) == {"flash_attention", "decode_attention:no_wo"}
    _close_own_max(outs[dev][0], outs["cpu"][0], torch.float32)
    for got, want in zip(outs[dev][1], outs["cpu"][1]):
        _close_own_max(got, want, torch.float32)


# ---------------------------------------------------------------------------
# The example apps: text in, text out on the card
# ---------------------------------------------------------------------------


def _app_inputs(tmp_path):
    """A README-learned BPE and WordPiece tokenizer, tiny HF GPT-2 and BERT
    QA states (head dim 64) as .npz, and README's texts."""
    import json
    from pathlib import Path

    import numpy as np

    import chip_smoke

    readme = (Path(chip_smoke.ROOT) / "README.md").read_text(encoding="utf-8")
    paths = {k: tmp_path / name for k, name in (("bpe", "bpe.json"), ("wordpiece", "wp.json"),
                                                 ("gpt2", "gpt2.npz"), ("bert", "bert.npz"))}
    paths["bpe"].write_text(json.dumps(chip_smoke.bpe_tokenizer_spec(chip_smoke.train_bpe(readme, 200))))
    paths["wordpiece"].write_text(json.dumps(chip_smoke.wordpiece_tokenizer_spec(readme, 3000)))
    np.savez(paths["gpt2"], **chip_smoke.gpt2_hf_state(0, 500, 2, 256, 1024, 256))
    np.savez(paths["bert"], **chip_smoke.bert_qa_hf_state(0, 3000, 2, 256, 512, 128))
    paras = chip_smoke.readme_paragraphs(readme)
    return paths, paras


def test_gpt2_app_on_card(dev, tmp_path):
    """gpt2.py --int8 --top-k 1 on the card: its prompt ids equal its --cpu
    run's, its tokens the greedy stream of Generator(NativeBackend) on the
    card on the same params and ids, the prefill and decode kernels
    launched and no plain call."""
    import contextlib as cl
    import io

    from rten_tpu_torch.examples import gpt2
    from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend
    from rten_tpu_torch.models import decoder

    paths, paras = _app_inputs(tmp_path)
    argv = ["--model", str(paths["gpt2"]), "--int8", "--tokenizer", str(paths["bpe"]), "--top-k", "1", "-n", "16",
            "--prompt", paras[0]]
    cpu, card = {}, {}
    with cl.redirect_stdout(io.StringIO()):
        assert gpt2.main([*argv, "--cpu"], result=cpu) == 0
        dispatch.reset_counters()
        assert gpt2.main(argv, result=card) == 0
    launches, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN)
    assert card["prompt_ids"] == cpu["prompt_ids"] and len(card["tokens"]) == 16
    assert not plain and all(launches.get(k) for k in ("quant_matmul_int8", "flash_attention", "quant_gemv_int8",
                                                       "decode_attention", "quant_mlp_int8")), launches
    import numpy as np

    state = dict(np.load(paths["gpt2"]))
    cfg = gpt2.infer_gpt2_config(state, decoder)
    params = decoder.quantize_params_int8(decoder.from_hf_gpt2(state, cfg, device=dev), device=dev)
    ref = [int(t[0]) for t in Generator(NativeBackend(params, cfg, device=dev),
                                        GeneratorConfig(max_tokens=16)).with_prompt(card["prompt_ids"])]
    assert card["tokens"] == ref


def test_bert_qa_app_on_card(dev, tmp_path):
    """bert_qa.py (f32) on the card against its --cpu run: the same ids,
    span and answer, start and end logits within f32 tolerance;
    flash_attention once a layer (split over KV where flash_plan splits
    the f32 launch: 4 heads of 64 over the question and context's
    tokens), no plain call."""
    import contextlib as cl
    import io

    import numpy as np

    from rten_tpu_torch.examples import bert_qa
    from rten_tpu_torch.kernels.attention import flash_plan, flash_slices

    paths, paras = _app_inputs(tmp_path)
    argv = ["--model", str(paths["bert"]), "--tokenizer", str(paths["wordpiece"]), "--question",
            paras[1].split(". ")[0], "--context", paras[0].split(". ")[0]]
    cpu, card = {}, {}
    with cl.redirect_stdout(io.StringIO()):
        assert bert_qa.main([*argv, "--cpu"], result=cpu) == 0
        dispatch.reset_counters()
        assert bert_qa.main(argv, result=card) == 0
    t = len(card["ids"])
    expect = {"flash_attention": 2}
    if flash_plan(1, 4, 4, t, t, qm._sms(torch.empty(1, device=dev)), flash_slices(64, False))[1] > 1:
        expect["flash_attention:split_kv"] = 2
    assert dict(dispatch.LAUNCHES) == expect and not dispatch.PLAIN
    assert (card["ids"], card["span"], card["answer"]) == (cpu["ids"], cpu["span"], cpu["answer"])
    for k in ("start", "end"):
        _close(torch.from_numpy(card[k]), torch.from_numpy(cpu[k]), torch.float32)
    assert np.isfinite(card["start"]).all()


# ---------------------------------------------------------------------------
# parallel/: one rank's share of the Qwen2-0.5B shape over a model axis of 2
# (7 query heads over 1 kv head, q 448, k / v 64, gate / up 2432, the wo
# and down partials at K 448 and 2432 in f32, the lm_head's 76288 columns),
# and the collectives on CUDA tensors.
# ---------------------------------------------------------------------------

TP_GEMV = [("q", 896, 448, "bias"), ("k", 896, 64, "bias"), ("gate", 896, 2432, None), ("wo", 448, 896, "f32"),
           ("down", 2432, 896, "f32"), ("lm_head", 896, 76288, "f32")]


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("name,k,n,mode", TP_GEMV, ids=[c[0] for c in TP_GEMV])
def test_tp_rank_projection_shapes(dev, m, name, k, n, mode):
    """quant_matmul_int8 (the GEMV at ≤ 8 rows) at each per-rank projection
    of the tensor-parallel path, bf16 rows, against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(k + n + m)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    qt, s = _pack(gen, n, k, dev)
    bias = 0.1 * torch.randn(n, generator=gen, device=dev) if mode == "bias" else None
    out_dtype = torch.float32 if mode == "f32" else None
    out = qm.quant_matmul_int8(x, qt, s, bias, out_dtype=out_dtype)
    ref = qm.quant_matmul_int8_ref(x, qt, s, bias, out_dtype=out_dtype or torch.bfloat16)
    _close(out, ref, out.dtype)


@pytest.mark.parametrize("kind", ["bf16", "int8", "paged", "paged_int8"])
def test_tp_rank_kv_kernels_7_over_1(dev, kind):
    """The KV kernels at one rank's heads (7 query heads over 1 kv head,
    the group of 7 under a tile of 8), 4 rows of mixed lengths in an S 1024
    cache (pages of 128), against their plain versions."""
    from rten_tpu_torch.kernels import paged_attention as pa
    from rten_tpu_torch.kernels.decode_attention import decode_attention_int8, decode_attention_int8_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    b, hq, hk, d, s_max, page = 4, 7, 1, 64, 1024, 128
    lens = torch.tensor([0, 5, 300, 1000], dtype=torch.int32, device=dev)
    ops = tuple(torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16) for h in (hq, hk, hk))
    if kind.startswith("paged"):
        shape = (b * s_max // page + 1, hk, page, d)
        extra = [torch.randperm(b * s_max // page, generator=gen, device=dev).to(torch.int32).view(b, -1)]
    else:
        shape, extra = (b, hk, s_max, d), []
    if kind.endswith("int8"):
        cache = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8) for _ in range(2)]
        cache += [0.005 + 0.015 * torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
    else:
        cache = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2)]
    fns = {"bf16": (decode_attention, decode_attention_ref), "int8": (decode_attention_int8, decode_attention_int8_ref),
           "paged": (pa.paged_decode_attention, pa.paged_decode_attention_ref),
           "paged_int8": (pa.paged_decode_attention_int8, pa.paged_decode_attention_int8_ref)}[kind]
    k_cache, p_cache = [t.clone() for t in cache], [t.clone() for t in cache]
    out = fns[0](ops, *k_cache, *extra, lens)
    ref = fns[1](ops, *p_cache, *extra, lens)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err
    assert all(torch.equal(a, c) for a, c in zip(k_cache, p_cache))


def test_tp_rank_flash_attention_7_over_1(dev):
    """The prompt's causal flash_attention at one rank's 7 / 1 heads (64
    tokens into a 1024-position cache), against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(1, 7, 64, 64, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(1, 1, 1024, 64, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, q_offset=torch.zeros(1, dtype=torch.int32, device=dev),
              kv_len=torch.full((1,), 64, dtype=torch.int32, device=dev))
    out = flash_attention(q, k[:, :, :64], v[:, :, :64], **kw)
    ref = flash_attention_ref(q, k[:, :, :64], v[:, :, :64], **kw)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()


def test_collectives_on_cuda_tensors(dev):
    """Two ranks on the card (gloo on one card, every collective staged
    through host memory; NCCL with a card each): psum, all_gather, ppermute
    and broadcast of tensors a kernel has just written equal what they
    must, and each collective counts under its route."""
    import torch_parallel_ranks as ranks
    from rten_tpu_torch.parallel import run_ranks

    ran = run_ranks(ranks.card_collectives, 2, 3.0, device="cuda", timeout_s=120)
    route = "nccl" if ran.backend == "nccl" else "gloo-host"
    for res in ran.results:
        assert res["ok"] == [True] * 4 and res["backend"] == ran.backend
        assert {k.split(":")[1] for k in res["routes"]} == {route}, res["routes"]


# -- every head dim and page size the JAX kernels take: flash_attention at
# any head dim (instances at 16, 32, 64, 128 and 256, the head dims between
# them zero-filled, above 256 in slices of 256 output columns), the KV
# kernels and decode_block at every divisor of 128, pages under 64
# positions, and the C entry points' refusal of a head dim they have no
# instance for --

FLASH_HEAD_DIM_CASES = ["causal", "gqa", "q_offset_kv_len", "kv_len_0_row", "long"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_HEAD_DIM_CASES)
@pytest.mark.parametrize("d", [8, 16, 24, 32, 80, 96, 256, 300, 320, 512])
def test_flash_kernel_every_head_dim(dev, dtype, case, d):
    """Head dims 16, 32 and (bf16) 256 on their own instances, 8, 24, 80
    and 96 on the next one up (columns past d zero), and 300, 320 and 512
    on the widest in slices of its columns (bf16: two of 256; f32: 256 in
    two of 128, 300 and 320 in three, 512 in four; the last slice's columns
    past d zero): against the plain version (own-max tolerance), one launch
    counted under flash_attention:d<D>."""
    args, kw = _flash_inputs(dev, case, dtype, d)
    before = dispatch.LAUNCHES[f"flash_attention:d{d}"]
    out = flash_attention(*args, **kw)
    assert dispatch.LAUNCHES[f"flash_attention:d{d}"] == before + 1
    assert out.shape == args[0].shape
    _close_own_max(out, flash_attention_ref(*args, **kw), dtype)


ABOVE_256_SPLIT_CASES = ["tq8_chunk", "gqa_14_over_2_tq24_at_300", "kv_len_0_row", "kv_len_on_split_edge"]


@pytest.mark.parametrize("case,d,dtype", [
    pytest.param(c, d, dt, id=f"{c}-{d}" + ("-f32" if dt == torch.float32 else ""))
    for dt in (torch.bfloat16, torch.float32) for d in (300, 320, 512) for c in ABOVE_256_SPLIT_CASES])
def test_flash_split_kv_above_256(dev, case, d, dtype):
    """Above head dim 256 (f32: above 128) on a grid of few blocks: each
    slice's cluster splits the KV tiles (flash_plan over the slices'
    blocks), every rank recomputing the scores over the whole d; against
    the plain version, one launch counted under split_kv when the plan
    splits."""
    from rten_tpu_torch.kernels.attention import _sms, flash_plan, flash_slices

    args, kw = _flash_case(dev, *SPLIT_KV_CASES[case], d=d, dtype=dtype)
    b, hq, tq, _ = args[0].shape
    slices = flash_slices(d, dtype == torch.bfloat16)
    split = flash_plan(b, hq, args[1].shape[1], tq, args[1].shape[2], _sms(args[0]), slices)[1]
    before = dispatch.LAUNCHES["flash_attention:split_kv"]
    out = flash_attention(*args, **kw)
    assert dispatch.LAUNCHES["flash_attention:split_kv"] == before + (split > 1)
    assert split > 1 or case == "kv_len_0_row"
    _close_own_max(out, flash_attention_ref(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [300, 320, 512])
def test_flash_kernel_above_256_views(dev, dtype, d):
    """Above head dim 256, q, k and v as views of one packed [B, T, 3, H, d]
    buffer (rows 8-byte aligned at 300, 16 at 320 and 512), causal at a
    q_offset, GQA-free and non-causal per-row lengths: against the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(18)
    b, h, t = 2, 3, 70
    qkv = (1.5 * torch.randn(b, t, 3, h, d, generator=gen, device=dev)).to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    for kw in (dict(causal=True, q_offset=torch.tensor([0, 3], dtype=torch.int32, device=dev),
                    kv_len=torch.tensor([70, 66], dtype=torch.int32, device=dev)),
               dict(causal=False, kv_len=torch.tensor([41, 70], dtype=torch.int32, device=dev))):
        _close_own_max(flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [5, 12, 20, 36, 100])
def test_flash_kernel_reads_unaligned_rows(dev, dtype, d):
    """q, k and v as views of one packed [B, T, 3, H, d] buffer, whose row
    starts are 2, 4 or 8 bytes aligned at these head dims (read in the
    pieces they allow), causal at a q_offset: against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(17)
    b, h, t = 2, 3, 70
    qkv = (1.5 * torch.randn(b, t, 3, h, d, generator=gen, device=dev)).to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    kw = dict(causal=True, q_offset=torch.tensor([0, 3], dtype=torch.int32, device=dev),
              kv_len=torch.tensor([70, 66], dtype=torch.int32, device=dev))
    _close_own_max(flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("d", [8, 4, 2, 1])
@pytest.mark.parametrize("kind", ["no_wo", "int8", "paged"])
def test_kv_engine_small_head_dims(dev, kind, d, group, dtype):
    """Head dims 8, 4, 2 and 1 (the JAX rule's other divisors of 128) on the
    16 instance, rows 2 to 16 bytes wide landing in zero-filled stage rows:
    against the plain version, the append and a second launch bit for bit,
    counted under name:d<D>. Pages: the JAX rule's smallest, 1024 / d."""
    page = 1024 // d if kind == "paged" else 64
    cap = 2 * max(page, 256)
    lens = [0, 1, 63, 64, 65, 127, 128, 300, cap - 1]
    kernel, plain, args, kw, n_cache = _engine_case(dev, kind, dtype, d, group, lens, cap=cap, page=page, seed=95)
    dispatch.reset_counters()
    _engine_check(kernel, plain, args, kw, n_cache, dtype, kind)
    assert dispatch.LAUNCHES[f"{kernel.__name__}:d{d}"] == 2  # the kernel twice; PLAIN counts the reference


# (query heads, kv heads, packed) at head dims 8, 4, 2 and 1: 16 query
# heads, so that wo's K (16 d) is whole 16-byte pieces at every one.
SMALL_BLOCK_OPS = {"packed": (16, 16, True), "gqa16_4": (16, 4, False), "mqa16_1": (16, 1, False)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 4, 2, 1])
@pytest.mark.parametrize("ops", list(SMALL_BLOCK_OPS))
@pytest.mark.parametrize("kv_len,with_next", [(0, True), (63, False), (64, True), (65, True), (767, False)])
def test_decode_block_small_head_dims(dev, dtype, d, ops, kv_len, with_next):
    """decode_block at head dims 8, 4, 2 and 1 (the JAX mega rule's other
    divisors of 128) on the 16 instance, its narrow rows staged in pieces:
    against decode_block_ref at S 768 (the chunk edges and the last
    position), the caches after the append bit for bit, one launch counted
    under decode_block:d<D>."""
    h, hk, packed = SMALL_BLOCK_OPS[ops]
    args, kw = _block_case(dev, dtype, d, kv_len, with_next, h=h, hk=hk, packed=packed, s_max=768)
    dispatch.reset_counters()
    _block_check(args, kw, dtype, with_next)
    assert dispatch.LAUNCHES["decode_block"] == 1 and dispatch.LAUNCHES[f"decode_block:d{d}"] == 1


def test_decode_block_small_head_dims_any_grid(dev, monkeypatch):
    """Head dim 4 over a grid of 16 blocks with the weights in waves gives
    the same bits as the full grid."""
    from rten_tpu_torch.kernels import decode_attention as da

    args, kw = _block_case(dev, torch.bfloat16, 4, 300, True, h=16, hk=4, packed=False, s_max=768)
    caches = (args[1].clone(), args[2].clone())
    full = da.decode_block(*args, **kw)
    monkeypatch.setattr(da, "block_grid", lambda _i: 16)
    monkeypatch.setattr(da, "block_region", lambda: 32 << 10)
    small = da.decode_block(args[0], *caches, *args[3:], **kw)
    assert all(torch.equal(a, b) for a, b in zip(full, small))


def _gather_pages(pages, table, cap):
    """A pool's pages [P, Hk, page, ...] gathered along each row's table into
    the dense layout [B, Hk, cap, ...]."""
    g = pages[table.long()]  # [B, per_row, Hk, page, ...]
    g = g.transpose(1, 2)
    return g.reshape(g.shape[0], g.shape[1], cap, *g.shape[4:]).contiguous()


# (kind, head dim, page): pages under 64 positions, and 48 and 80, which
# 64-position chunks cross unevenly, as the JAX rules admit them.
SMALL_PAGES = [("paged", 64, 16), ("paged", 64, 32), ("paged", 64, 48), ("paged", 64, 80), ("paged", 128, 8),
               ("paged", 128, 16), ("paged", 32, 32), ("paged_int8", 128, 32), ("paged_int8", 64, 64)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("kind,d,page", SMALL_PAGES)
def test_kv_engine_small_pages_equal_dense_rows(dev, kind, d, page, group, dtype):
    """Pages of 8 to 80 positions: the paged kernel against its plain
    version (the append and a second launch bit for bit), and each row's
    attention vector bit for bit the one the dense kernel gives over the
    same positions gathered into a [B, Hk, cap, D] cache."""
    from rten_tpu_torch.kernels import decode_attention as da

    cap = -(-384 // page) * page
    kernel, plain, args, kw, n_cache = _engine_case(dev, kind, dtype, d, group, EDGE_LENS, cap=cap, page=page,
                                                    seed=96)
    dispatch.reset_counters()
    out = _engine_check(kernel, plain, args, kw, n_cache, dtype, kind)
    if page % 64:
        assert dispatch.LAUNCHES[f"{kernel.__name__}:page{page}"] == 2
    table, lens = args[-2], args[-1]
    dense = [_gather_pages(t, table, cap) for t in args[1 : 1 + n_cache]]
    twin = da.decode_attention_int8 if kind.endswith("int8") else da.decode_attention
    assert torch.equal(twin(args[0], *dense, lens), out)


@pytest.mark.parametrize("heads", [4, 2])
def test_tiny_paged_engine_pages_of_16_match_cpu(dev, heads):
    """PagedServingEngine with pages of 16 at head dim 64 (4 heads) and 128
    (2 heads) on the tiny f32 config: the same requests on the card and on
    the CPU give the same streams; the card launched
    paged_decode_attention:page16 and no plain version."""
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.serve import PagedServingEngine

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=heads, d_model=256, d_ff=1024,
                                max_seq=256, dtype=torch.float32)
    cpu_params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cpu"), device="cpu")
    gpu_params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)
    gen = torch.Generator().manual_seed(15)
    specs = [dict(prompt=torch.randint(1, 500, (n,), generator=gen).tolist(), max_new_tokens=m)
             for n, m in ((3, 20), (40, 12), (12, 30), (70, 8))]

    def run(p, d):
        return _engine_outputs(PagedServingEngine, p, cfg, specs, d, max_batch=3, n_pages=24, page_size=16)

    dispatch.reset_counters()
    on_card, eng = run(gpu_params, dev)
    assert dispatch.LAUNCHES["paged_decode_attention:page16"] > 0 and not dispatch.PLAIN
    on_cpu, _ = run(cpu_params, "cpu")
    assert on_card == on_cpu and eng.pool.n_free == eng.pool.n_pages


@pytest.mark.parametrize("head_dim", [32, 96])
def test_tiny_decoder_head_dims_match_plain(dev, head_dim):
    """The tiny f32 decoder at head dim 32 (the KV kernels' 32 instance) and
    96 (no KV kernel: each step appended and attended through
    flash_attention at Tq 1, in generate_scan's graph over the cache's
    whole S): prompt logits and 8 greedy tokens, kernels against the plain
    versions on the card."""
    from rten_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(vocab_size=500, n_layers=2, n_heads=384 // head_dim, d_model=384, d_ff=1024,
                                max_seq=256, dtype=torch.float32)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device=dev), device=dev)
    prompt = torch.tensor([[11, 42, 7, 300, 5, 9, 77]], dtype=torch.int32, device=dev)

    def run():
        cache = decoder.init_cache(cfg, 1, 64, device=dev)
        logits, cache = decoder.prefill(params, cfg, prompt, cache)
        toks, _ = decoder.generate_greedy(params, cfg, cache, logits[:, -1:].argmax(-1).to(torch.int32), 8)
        return logits, toks

    dispatch.reset_counters()
    k_logits, k_toks = run()
    kv = "decode_attention"
    assert not dispatch.PLAIN and dispatch.LAUNCHES[f"flash_attention:d{head_dim}"] > 0
    assert (dispatch.LAUNCHES[kv] > 0) == (head_dim == 32)
    with _plain_decoder(decoder):
        p_logits, p_toks = run()
    _close(k_logits, p_logits, torch.float32)
    assert k_toks.tolist() == p_toks.tolist()


def test_entry_points_refuse_other_head_dims(dev, monkeypatch):
    """A head dim a C entry point has no instance for (one the JAX rules
    refuse) launches nothing and returns cudaErrorInvalidValue (the
    wrappers raise before it: their checks are lifted here): the four KV
    kernels' launch and cluster-count entries and decode_block at 48. The
    caches are left as they were."""
    from rten_tpu_torch.kernels import _build
    from rten_tpu_torch.kernels import decode_attention as da

    lib = _build.library()
    for entry in ("rt_decode_attention_int8", "rt_paged_attention", "rt_paged_attention_int8"):
        assert getattr(lib, entry + "_clusters")(1, 48, 0, 1) == -1
    assert lib.rt_decode_attention_clusters(1, 48, 1, 0, 1) == -1
    monkeypatch.setattr(da, "kv_head_dim_supported", lambda d: True)
    monkeypatch.setattr(da, "kv_device_plan", lambda *a: 1)
    for kind in ("no_wo", "int8"):
        kernel, _plain, args, kw, n_cache = _engine_case(dev, kind, torch.bfloat16, 48, 1, [0, 5], cap=128)
        before = _clone_args(args[1:])
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            kernel(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(args[1:], before))
    monkeypatch.setattr(da, "BLOCK_HEAD_DIMS", (48,))
    args, kw = _block_case(dev, torch.bfloat16, 48, 5, False)
    kc = args[1].clone()
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        da.decode_block(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(args[1], kc)
