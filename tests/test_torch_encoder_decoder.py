"""The port's Whisper-class encoder-decoder (plain kernel versions, on the
CPU) against the JAX package's (``rten_tpu/models/encoder_decoder.py``) on
the same seeded int8 parameters, at the small f32 config of
``torch_port_helpers.ED_SLICE_CFG``.

The JAX side runs its jnp path or, under ``patch_jax_encdec``, every
Pallas kernel it reaches in interpret mode (the encoder's and the cross
attention's flash attention, the GEMV, the MLP, the KV kernels).
Tolerances: encoder states and logits within 1e-3 of their largest
magnitude (BASELINE's bar; f32 on both sides, the sums in other orders, the
erf polynomial against the exact erf), greedy tokens identical. The
intended differences in bf16 rounding are each held by a test at the end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.generator import EncDecBackend as JEncDecBackend
from rten_tpu.generate.generator import Generator as JGenerator
from rten_tpu.generate.generator import GeneratorConfig as JGeneratorConfig
from rten_tpu.kernels.quant_matmul import untile_gemv_weights
from rten_tpu.models import encoder_decoder as jed
from rten_tpu_torch.generate import EncDecBackend, EncDecBackendFactory, Generator, GeneratorConfig
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels.activations import gelu_erf
from rten_tpu_torch.kernels.decode_attention import quantize_kv
from rten_tpu_torch.kernels.quant_matmul import int8_pack, quantize_weights_int8
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.models import encoder_decoder as ted
from torch_port_helpers import ed_configs, ed_tree, patch_jax_encdec, to_jax, to_numpy

REL = 1e-3


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = ed_configs()
    jparams = jed.quantize_params_int8(to_jax(ed_tree(0)))  # the JAX default: lm_head_q tiled
    tparams = ted.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    mel = np.random.default_rng(1).standard_normal((2, jcfg.n_mels, 2 * jcfg.n_audio_ctx)).astype(np.float32)
    enc = np.asarray(jed.encode(jparams, jcfg, jnp.asarray(mel)))
    return jcfg, tcfg, jparams, tparams, mel, enc


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("jax_path", ["jnp", "pallas"])
def test_encode_matches_jax(models, monkeypatch, jax_path):
    """The encoder states of a [2, 16, 64] mel: the port's (F.conv1d, the
    quant_matmul_int8 projections, non-causal flash attention) against the
    JAX package's jnp path and its Pallas kernels."""
    jcfg, tcfg, jparams, tparams, mel, enc = models
    if jax_path == "pallas":
        patch_jax_encdec(monkeypatch)
        enc = np.asarray(jed.encode(jparams, jcfg, jnp.asarray(mel)))
    dispatch.reset_counters()
    got = ted.encode(tparams, tcfg, torch.from_numpy(mel))
    assert got.shape == (2, jcfg.n_audio_ctx, jcfg.d_model) and got.dtype == torch.float32
    assert _rel(got.numpy(), enc) <= REL
    assert dispatch.PLAIN["flash_attention"] == jcfg.n_audio_layers
    assert dispatch.PLAIN["quant_matmul_int8"] == 6 * jcfg.n_audio_layers


def _decode_run(jcfg, tcfg, jparams, tparams, enc, b, fused, n_steps=3, **jkw):
    """A 3-token prompt then ``n_steps`` greedy one-token steps (each fed
    JAX's token) through both decoders over the same encoder states:
    [(port logits, JAX logits)] per forward, and the port's plain calls of
    its last step."""
    enc = enc[:b]
    jstate = jed.init_decoder_state(jparams, jcfg, jnp.asarray(enc))
    tstate = ted.init_decoder_state(tparams, tcfg, torch.from_numpy(enc.copy()))
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (b, 3)).astype(np.int32)
    pairs = []
    for _ in range(1 + n_steps):
        jl, jstate = jed.decode(jparams, jcfg, jnp.asarray(tokens), jstate, fused=fused, **jkw)
        dispatch.reset_counters()
        tl, tstate = ted.decode(tparams, tcfg, torch.from_numpy(tokens), tstate, fuse=fused)
        pairs.append((tl.numpy(), np.asarray(jl)))
        tokens = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert tstate["len"].tolist() == [3 + n_steps] * b and tstate["host_len"].tolist() == [3 + n_steps] * b
    return pairs, dict(dispatch.PLAIN)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
def test_decode_matches_jax(models, monkeypatch, int8_kv, fused, b):
    """The decoder step by step against ``ed.decode(fused=…)`` with its
    Pallas kernels (``use_flash``: flash attention and the KV kernels),
    prompt included: logits within REL, the same greedy tokens, and the
    kernels of the port's structure (fused: four GEMVs a layer and the
    lm_head, the KV kernel, flash attention at Tq 1 and the MLP kernel; not
    fused: the prefill projections and the KV kernel, no MLP kernel)."""
    jcfg, tcfg, jparams, tparams, _mel, enc = models
    jcfg, tcfg = (dataclasses.replace(c, int8_kv=int8_kv) for c in (jcfg, tcfg))
    patch_jax_encdec(monkeypatch)
    pairs, plain = _decode_run(jcfg, tcfg, jparams, tparams, enc, b, fused, n_steps=2)
    for got, want in pairs:
        assert _rel(got, want) <= REL
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    n = tcfg.n_text_layers
    kv = "decode_attention_int8" if int8_kv else "decode_attention:no_wo"
    assert plain[kv] == n and plain["flash_attention"] == n
    if fused:
        assert plain["quant_gemv_int8"] == 4 * n + 1 and plain["quant_mlp_int8"] == n
    else:  # six projections a layer and the lm_head, handed to the GEMV at 8 rows or fewer
        assert plain["quant_gemv_int8"] == 6 * n + 1 and "quant_mlp_int8" not in plain


@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
def test_decode_above_8_rows_matches_jax(models, monkeypatch, int8_kv):
    """10 rows take the unfused structure (the JAX package's ``b <= 8``
    rule) with the KV kernel a layer at each one-token step; against the
    JAX package's Pallas path, whose int8 products are the port's ``(x @ q)
    · s`` (its jnp path's dequantized weights round otherwise, and a k or v
    one f32 ulp away can take the next int8 code)."""
    jcfg, tcfg, jparams, tparams, _mel, enc = models
    jcfg, tcfg = (dataclasses.replace(c, int8_kv=int8_kv) for c in (jcfg, tcfg))
    patch_jax_encdec(monkeypatch)
    enc10 = np.concatenate([enc] * 5)
    pairs, plain = _decode_run(jcfg, tcfg, jparams, tparams, enc10, 10, True, n_steps=2)
    for got, want in pairs:
        assert _rel(got, want) <= REL
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    n = tcfg.n_text_layers
    assert plain["decode_attention_int8" if int8_kv else "decode_attention:no_wo"] == n
    assert plain["quant_matmul_int8"] == 6 * n + 1 and "quant_mlp_int8" not in plain


def _packs(node, path=""):
    out = {}
    if isinstance(node, dict):
        if "qt" in node:
            return {path: node}
        for k, v in node.items():
            out.update(_packs(v, f"{path}/{k}"))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            out.update(_packs(v, f"{path}/{i}"))
    return out


def _leaves(node, path=""):
    if isinstance(node, dict):
        return {k2: v2 for k, v in node.items() for k2, v2 in _leaves(v, f"{path}/{k}").items()}
    if isinstance(node, list):
        return {k2: v2 for i, v in enumerate(node) for k2, v2 in _leaves(v, f"{path}/{i}").items()}
    return {path: node}


def test_quantize_params_matches_jax(models):
    """The port's quantize_params_int8 of the dense tree against the JAX
    package's (its tiled packs untiled, its padding past the port's N
    dropped): the same packs, the fused wqkv and bqkv (zeros for k)
    included, the same dense leaves and f32 vectors."""
    jcfg, tcfg, jparams, _tparams, _mel, _enc = models
    tree = ed_tree(0)
    mine = ted.quantize_params_int8(ted.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    packs = _packs(mine)
    assert set(packs) == {p for p in _packs(ted.params_from_jax(to_numpy(jparams), tcfg, device="cpu"))}
    assert "/dec_layers/0/self_attn/wqkv" in packs and "/lm_head_q" in packs and "/enc_layers/1/mlp/w_up" in packs
    jleaves = _leaves(to_numpy(jparams))
    for path, pack in packs.items():
        q, s = jleaves[path + "/q"], jleaves[path + "/s"].reshape(-1)
        q = np.asarray(untile_gemv_weights(jnp.asarray(q))) if q.ndim == 3 else q
        n = pack["qt"].shape[0]
        np.testing.assert_array_equal(pack["qt"].numpy().T, q[:, :n], err_msg=path)
        np.testing.assert_array_equal(pack["s"].numpy(), s[:n], err_msg=path)
    assert mine["lm_head_q"]["qt"].shape == (512, 256)  # vocab 500 padded to 128s
    for li, layer in enumerate(mine["dec_layers"]):
        a = layer["self_attn"]
        assert not {"wq", "wk", "wv", "bq", "bv"} & set(a)
        want = np.concatenate([tree["dec_layers"][li]["self_attn"]["bq"], np.zeros(256, np.float32),
                               tree["dec_layers"][li]["self_attn"]["bv"]])
        np.testing.assert_array_equal(a["bqkv"].numpy(), want)
        np.testing.assert_array_equal(a["bqkv"].numpy(), jleaves[f"/dec_layers/{li}/self_attn/bqkv"].reshape(-1))
    for path, leaf in _leaves(mine).items():
        if path.rsplit("/", 1)[0] in packs:
            continue
        np.testing.assert_array_equal(leaf.numpy(), jleaves[path].reshape(leaf.shape), err_msg=path)
        assert leaf.dtype == torch.float32


def test_params_from_jax_matches_init_params():
    """A dense JAX tree carries across into the tree ``init_params`` makes:
    the same keys, shapes and dtypes (bf16), the values the tree's."""
    _, tcfg = ed_configs()
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    tree = ed_tree(0)
    carried = _leaves(ted.params_from_jax(tree, tcfg, device="cpu"))
    made = _leaves(ted.init_params(0, tcfg, device="cpu"))
    assert set(carried) == set(made)
    for path, leaf in made.items():
        assert carried[path].shape == leaf.shape and carried[path].dtype == leaf.dtype == torch.bfloat16, path
    want = _leaves(tree)
    for path, leaf in carried.items():
        np.testing.assert_array_equal(leaf.float().numpy(), torch.from_numpy(want[path]).to(torch.bfloat16).float()
                                      .numpy().reshape(leaf.shape), err_msg=path)


def _hf_state(tree: dict) -> dict:
    """A HuggingFace Whisper state dict (nn.Linear weights [out, in]) of the
    JAX tree, under ``model.`` as WhisperForConditionalGeneration saves it."""
    hf = {}

    def put(name, arr):
        hf["model." + name] = arr

    def attn(p, a):
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            put(f"{p}{theirs}.weight", a["w" + ours].T.copy())
            if "b" + ours in a:
                put(f"{p}{theirs}.bias", a["b" + ours])

    def ln(p, n):
        put(p + "weight", n["scale"])
        put(p + "bias", n["bias"])

    def mlp(p, m):
        put(p + "fc1.weight", m["w_up"].T.copy())
        put(p + "fc1.bias", m["b_up"])
        put(p + "fc2.weight", m["w_down"].T.copy())
        put(p + "fc2.bias", m["b_down"])

    for name in ("conv1", "conv2"):
        put(f"encoder.{name}.weight", tree[f"enc_{name}"])
        put(f"encoder.{name}.bias", tree[f"enc_{name}_b"])
    ln("encoder.layer_norm.", tree["enc_ln_post"])
    put("decoder.embed_tokens.weight", tree["tok_emb"])
    put("decoder.embed_positions.weight", tree["pos_emb"])
    ln("decoder.layer_norm.", tree["dec_ln"])
    for i, layer in enumerate(tree["enc_layers"]):
        p = f"encoder.layers.{i}."
        ln(p + "self_attn_layer_norm.", layer["ln1"])
        attn(p + "self_attn.", layer["attn"])
        ln(p + "final_layer_norm.", layer["ln2"])
        mlp(p, layer["mlp"])
    for i, layer in enumerate(tree["dec_layers"]):
        p = f"decoder.layers.{i}."
        ln(p + "self_attn_layer_norm.", layer["ln1"])
        attn(p + "self_attn.", layer["self_attn"])
        ln(p + "encoder_attn_layer_norm.", layer["ln_x"])
        attn(p + "encoder_attn.", layer["cross_attn"])
        ln(p + "final_layer_norm.", layer["ln2"])
        mlp(p, layer["mlp"])
    return hf


def test_from_hf_whisper_matches_jax(models):
    """A HuggingFace-named state dict built from the tree: the port's
    from_hf_whisper gives back the tree, and the two packages' models made
    from it give equal logits for a prompt."""
    jcfg, tcfg, _jparams, _tparams, mel, _enc = models
    tree = ed_tree(0)
    hf = _hf_state(tree)
    mine = ted.from_hf_whisper({k: torch.from_numpy(v) for k, v in hf.items()}, tcfg, device="cpu")
    want = _leaves(tree)
    for path, leaf in _leaves(mine).items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    jq = jed.quantize_params_int8(jed.from_hf_whisper(hf, jcfg))
    tq = ted.quantize_params_int8(mine, device="cpu")
    prompt = np.array([[3, 1, 4, 1]], np.int32)
    jl, _ = jed.decode(jq, jcfg, jnp.asarray(prompt),
                       jed.init_decoder_state(jq, jcfg, jed.encode(jq, jcfg, jnp.asarray(mel[:1]))), use_flash=False)
    enc = ted.encode(tq, tcfg, torch.from_numpy(mel[:1]))
    tl, _ = ted.decode(tq, tcfg, torch.from_numpy(prompt), ted.init_decoder_state(tq, tcfg, enc))
    assert _rel(tl.numpy(), np.asarray(jl)) <= REL


@pytest.mark.parametrize("int8_kv", [False, True], ids=["f32_kv", "int8_kv"])
def test_generator_stream_matches_jax(models, int8_kv):
    """Generator(EncDecBackend) greedy over two utterances: a 3-token prompt
    as one prefill, then 8 tokens, equal to the JAX package's
    Generator(EncDecBackend) stream; the factory makes the same backend."""
    jcfg, tcfg, jparams, tparams, mel, _enc = models
    jcfg, tcfg = (dataclasses.replace(c, int8_kv=int8_kv) for c in (jcfg, tcfg))
    prompt = [[5, 6, 7], [8, 9, 10]]
    jgen = JGenerator(JEncDecBackend(jparams, jcfg, mel), JGeneratorConfig(max_tokens=8)).with_prompt(prompt)
    want = [np.asarray(t).tolist() for t in jgen]
    backend = EncDecBackend(tparams, tcfg, mel, device="cpu")
    got = [t.tolist() for t in Generator(backend, GeneratorConfig(max_tokens=8)).with_prompt(prompt)]
    assert got == want and backend.length == 3 + 7 and backend.max_len == tcfg.max_text_ctx
    made = EncDecBackendFactory(tparams, tcfg)(mel, device="cpu")
    again = [t.tolist() for t in Generator(made, GeneratorConfig(max_tokens=8)).with_prompt(prompt)]
    assert again == want
    made.reset()
    assert made.length == 0 and int(made.state["len"].max()) == 0


def test_lm_head_argmax_skips_the_padded_columns():
    """Every real logit below 0 and the padded columns (vocab 500 of 512) at
    0: the greedy token is the best real one, through the GEMV's bounded
    argmax (≤ 8 rows) and the prefill projection (> 8 rows)."""
    _, tcfg = ed_configs()
    d, vocab = tcfg.d_model, tcfg.vocab_size
    w = np.full((d, 512), 0.0, np.float32)
    w[:, :vocab] = -np.linspace(1.0, 2.0, vocab, dtype=np.float32)[None]
    w[:, 7] = -0.5  # the best real column
    params = {"lm_head_q": int8_pack(*quantize_weights_int8(w, axis=-1), device="cpu"),
              "dec_ln": {"scale": torch.zeros(d), "bias": torch.ones(d)}}  # every normalized row all ones
    for rows in (3, 12):
        x = torch.randn(rows, d)
        tokens = ted._lm_head(params, tcfg, x, "argmax")
        assert tokens.tolist() == [7] * rows
        logits = ted._lm_head(params, tcfg, x, "logits")
        assert logits.shape == (rows, vocab) and float(logits.max()) < 0


def test_decode_refuses_a_full_cache(models):
    """Tokens past max_text_ctx are refused before any kernel runs."""
    _jcfg, tcfg, _jparams, tparams, _mel, enc = models
    state = ted.init_decoder_state(tparams, tcfg, torch.from_numpy(enc[:1]), max_len=4)
    ted.decode(tparams, tcfg, torch.zeros((1, 3), dtype=torch.int32), state)
    dispatch.reset_counters()
    with pytest.raises(IndexError, match="KV cache full"):
        ted.decode(tparams, tcfg, torch.zeros((1, 2), dtype=torch.int32), state)
    assert not dispatch.PLAIN and int(state["len"][0]) == 3


# ---------------------------------------------------------------------------
# Intended differences from the JAX package's rounding (bf16)
# ---------------------------------------------------------------------------


def _bf16_ulps(got, want) -> float:
    """|got - want| in units of bf16's relative spacing (2^-8) of |want|'s max."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() * 2.0 ** -8))


def test_layer_norm_rounds_once_after_scale_and_shift():
    """The port's norm rounds the normalized rows to bf16, then scales and
    shifts them in f32 (its params are f32) and rounds once; the JAX
    ``_layer_norm`` rounds after the scale and after the shift too. The two
    stay within two bf16 roundings."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 256)).astype(np.float32) * 3 + 1
    scale, bias = rng.uniform(0.5, 1.5, 256).astype(np.float32), rng.standard_normal(256).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tdec._norm(xt, {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}, ted.WHISPER_TINY)
    y = torch.nn.functional.layer_norm(xt.float(), (256,), eps=1e-5).to(torch.bfloat16).float()
    want_port = (y * torch.from_numpy(scale) + torch.from_numpy(bias)).to(torch.bfloat16)
    assert torch.equal(got, want_port)
    p = {"scale": jnp.asarray(scale, jnp.bfloat16), "bias": jnp.asarray(bias, jnp.bfloat16)}
    jax_out = np.asarray(jed._layer_norm(jnp.asarray(x, jnp.bfloat16), p, 1e-5), np.float32)
    assert _bf16_ulps(got.float().numpy(), jax_out) <= 2.0


def test_projection_bias_in_the_epilogue(monkeypatch):
    """A projection's bias is added in f32 before the one rounding to bf16
    (the kernels' epilogue); the JAX ``_mm(x, w) + b`` (its Pallas matmul
    in interpret mode) rounds the product, adds in bf16 and rounds again:
    within two bf16 roundings."""
    patch_jax_encdec(monkeypatch)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((256, 256)).astype(np.float32) * 0.05
    b = rng.standard_normal(256).astype(np.float32)
    x = rng.standard_normal((12, 256)).astype(np.float32)
    qw, s = quantize_weights_int8(w, axis=-1)
    pack = int8_pack(qw, s, device="cpu")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = ted._proj(xt, pack, torch.from_numpy(b))
    acc = (xt.float() @ pack["qt"].float().t()) * pack["s"]
    assert torch.equal(got, (acc + torch.from_numpy(b)).to(torch.bfloat16))
    jout = jed._mm(jnp.asarray(x, jnp.bfloat16), {"q": jnp.asarray(qw), "s": jnp.asarray(s).reshape(1, -1)})
    jout = np.asarray(jout + jnp.asarray(b, jnp.bfloat16), np.float32)
    assert _bf16_ulps(got.float().numpy(), jout) <= 2.0


def test_gelu_erf_polynomial_against_exact_erf():
    """The kernels' GELU (the MLP's, in the matmul epilogue) takes erf from
    a polynomial within 1.5e-7 of the exact erf the JAX package's jnp path
    uses (and the port's convolution stem, ``F.gelu``): the two GELUs differ
    by at most 0.5·|x|·1.5e-7, plus three f32 roundings of |x|."""
    x = torch.linspace(-8, 8, 20001, dtype=torch.float64).float()
    poly = gelu_erf(x).double()
    exact = torch.nn.functional.gelu(x.double())
    ax = x.double().abs()
    assert bool(((poly - exact).abs() <= 0.5 * ax * 1.5e-7 + 3 * 2.0 ** -24 * ax + 1e-12).all())
    jexact = np.asarray(jnp.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False)), np.float64)
    # Two f32 exact-erf GELUs (torch's and XLA's on the CPU) differ by up to 1e-6 in the negative tail.
    np.testing.assert_allclose(ted._gelu(x, torch.float32).double().numpy(), jexact, rtol=2e-6, atol=2e-6)


def test_kv_scales_by_ieee_division():
    """The int8 KV scales are ``absmax / 127`` by IEEE f32 division (the
    port keeps a tensor divisor, so the card's division is IEEE too): equal
    to numpy's f32 division and, on the CPU, to the JAX package's
    ``quantize_kv`` bit for bit, codes included."""
    x = np.random.default_rng(4).standard_normal((2, 4, 9, 64)).astype(np.float32) * 3
    codes, scales = quantize_kv(torch.from_numpy(x))
    absmax = np.abs(x).max(-1)
    np.testing.assert_array_equal(scales.numpy(), absmax / np.float32(127.0))
    jq, js = jed.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js)[..., 0])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jq))
