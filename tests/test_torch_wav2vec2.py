"""The port's wav2vec2 encoder with its CTC head
(``rten_tpu_torch/models/wav2vec2.py``, plain kernel versions on the CPU),
its CTC decoder (``rten_tpu_torch/ctc.py``) and its .wav I/O
(``rten_tpu_torch/audio/io.py``) against the JAX package's on the same
inputs.

The JAX model runs its TPU branch (``patch_jax_encoders``: int8
projections through ``quant_matmul_int8``, ``flash_attention`` with each
row's valid frames, in interpret mode). Sizes: the conv stack of
``tests/test_audio_wav2vec2.py`` (``conv_dim`` (32, 32), kernels (10, 3),
strides (5, 2)), d_model 256 (4 heads of 64), d_ff 512, 2 layers, the base
model's positional convolution (K 128 in 16 groups); 2 waveforms of 490 and
300 samples, padded to 490 (48 and 29 frames). Tolerances: logits within
1e-4 of their largest magnitude at valid frames; equal CTC text; the
decoders and the .wav I/O equal to the JAX package's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu import ctc as jctc
from rten_tpu.audio import io as jaudio
from rten_tpu.models import wav2vec2 as jw2v
from rten_tpu_torch import ctc as tctc
from rten_tpu_torch.audio import io as taudio
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.models import wav2vec2 as tw2v
from torch_port_helpers import patch_jax_encoders, rel_err, to_jax, to_numpy

CFG = dict(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), conv_bias=True, d_model=256, n_layers=2,
           n_heads=4, d_ff=512)
SAMPLES = (490, 300)
TOL = 1e-4
ALPHABET = "abcdefghijklmnopqrstuvwxyz' .,-"  # 31 labels after the blank


def w2v_tree(seed: int = 0) -> dict:
    """Dense numpy params in the JAX package's layout, random biases and
    norms, a CTC head large enough for clear per-frame winners."""
    rng = np.random.default_rng(seed)
    c = jw2v.Wav2Vec2Config(**CFG)
    d, ff = c.d_model, c.d_ff

    def w(*shape, scale=0.06):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln(n):
        return {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32), "bias": w(n, scale=0.05)}

    convs, c_in = [], 1
    for i, (ch, k) in enumerate(zip(c.conv_dim, c.conv_kernel)):
        layer = {"conv": w(ch, c_in, k, scale=0.3), "conv_b": w(ch, scale=0.05)}
        if i == 0:
            layer["gn"] = ln(ch)
        convs.append(layer)
        c_in = ch
    tree = {"convs": convs, "fp_ln": ln(c_in), "fp_w": w(c_in, d, scale=0.15), "fp_b": w(d, scale=0.05),
            "pos_conv": w(d, d // c.num_conv_pos_groups, c.num_conv_pos_embeddings, scale=0.02),
            "pos_conv_b": w(d, scale=0.05), "enc_ln": ln(d), "layers": [],
            "lm_head_w": w(d, c.vocab_size, scale=0.5), "lm_head_b": w(c.vocab_size, scale=0.1)}
    for _ in range(c.n_layers):
        tree["layers"].append({
            "wq": w(d, d), "bq": w(d, scale=0.05), "wk": w(d, d), "bk": w(d, scale=0.05),
            "wv": w(d, d), "bv": w(d, scale=0.05), "wo": w(d, d), "bo": w(d, scale=0.05), "attn_ln": ln(d),
            "w_up": w(d, ff), "b_up": w(ff, scale=0.05), "w_down": w(ff, d, scale=0.04), "b_down": w(d, scale=0.05),
            "ffn_ln": ln(d),
        })
    return tree


def _wav():
    rng = np.random.default_rng(2)
    wav = np.zeros((2, max(SAMPLES)), np.float32)
    for i, n in enumerate(SAMPLES):
        wav[i, :n] = np.sin(np.arange(n) * (0.05 + 0.03 * i)) * 0.5 + rng.standard_normal(n) * 0.1
    return wav


def _frames():
    jcfg = jw2v.Wav2Vec2Config(**CFG)
    return np.array([jw2v.feat_extract_output_length(jcfg, n) for n in SAMPLES], np.int32)


@pytest.fixture(scope="module")
def run():
    """The JAX package's TPU branch on the int8 params: CTC logits of the
    padded batch with each row's frame lengths."""
    jcfg = jw2v.Wav2Vec2Config(**CFG)
    quant = jw2v.quantize_params_int8(to_jax(w2v_tree(0)))
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_encoders(mp)
        logits = jw2v.ctc_logits(quant, jcfg, jnp.asarray(_wav()), lengths=jnp.asarray(_frames()))
    return to_numpy(quant), np.asarray(logits)


def _port_logits(tree):
    cfg = tw2v.Wav2Vec2Config(**CFG)
    params = tw2v.params_from_jax(tree, cfg, device="cpu")
    dispatch.reset_counters()
    logits = tw2v.ctc_logits(params, cfg, torch.from_numpy(_wav()), lengths=torch.from_numpy(_frames()))
    return logits, dict(dispatch.PLAIN)


def test_frame_lengths_match_jax():
    jcfg, tcfg = jw2v.Wav2Vec2Config(**CFG), tw2v.Wav2Vec2Config(**CFG)
    for n in (10, 11, 300, 490, 16000):
        assert tw2v.feat_extract_output_length(tcfg, n) == jw2v.feat_extract_output_length(jcfg, n)
    assert tw2v.feat_extract_output_length(tw2v.WAV2VEC2_BASE, 160000) == 499
    assert list(_frames()) == [48, 29]


def test_ctc_logits_match_jax(run):
    """Logits at each row's valid frames; 6 plain quant_matmul_int8 and 1
    flash attention a layer."""
    tree, want = run
    got, counts = _port_logits(tree)
    frames = _frames()
    valid = np.arange(got.shape[1])[None, :] < frames[:, None]
    assert got.shape == want.shape == (2, 48, 32)
    assert rel_err(got.numpy(), want, valid) <= TOL
    assert counts["quant_matmul_int8"] == 6 * CFG["n_layers"] and counts["flash_attention"] == CFG["n_layers"]


def test_features_match_jax(run):
    """The conv stack alone (group norm, GELU, IEEE-f32 convolutions)."""
    tree, _ = run
    tcfg, jcfg = tw2v.Wav2Vec2Config(**CFG), jw2v.Wav2Vec2Config(**CFG)
    got = tw2v.extract_features(tw2v.params_from_jax(tree, tcfg, device="cpu"), tcfg, torch.from_numpy(_wav()))
    want = np.asarray(jw2v.extract_features(to_jax(tree), jcfg, jnp.asarray(_wav())))
    assert got.shape == want.shape and rel_err(got.numpy(), want) <= TOL


def test_ctc_text_matches_jax(run):
    """Greedy CTC text of each row's valid frames, from the port's logits
    through the port's decoder and from JAX's through JAX's."""
    tree, want = run
    got, _ = _port_logits(tree)
    for row, n in enumerate(_frames()):
        t_hyp = tctc.CtcDecoder().decode_greedy(torch.log_softmax(got[row, :n], -1).numpy())
        j_hyp = jctc.CtcDecoder().decode_greedy(np.asarray(jnp.asarray(want[row, :n]) - jnp.log(
            jnp.exp(want[row, :n]).sum(-1, keepdims=True))))
        assert t_hyp.labels == j_hyp.labels and t_hyp.text(ALPHABET) == j_hyp.text(ALPHABET)
        assert len(t_hyp.labels) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_decoder_matches_jax(seed):
    """Greedy, beam and n-best on seeded log-probabilities (and on
    probabilities): the same hypotheses and scores as the JAX package's."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, 8)) * 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    for probs in (lp, np.exp(lp)):
        t, j = tctc.CtcDecoder(), jctc.CtcDecoder()
        tg, jg = t.decode_greedy(probs), j.decode_greedy(probs)
        assert (tg.steps, tg.log_prob) == (jg.steps, jg.log_prob)
        tn, jn = t.decode_beam_nbest(probs, 6, 3), j.decode_beam_nbest(probs, 6, 3)
        assert [h.steps for h in tn] == [h.steps for h in jn]
        assert np.allclose([h.log_prob for h in tn], [h.log_prob for h in jn], rtol=0, atol=1e-12)
        beam = t.decode_beam(probs, 6)  # the native library's, as the JAX package's decode_beam
        jbeam = j.decode_beam(probs, 6)
        assert (beam.steps, beam.log_prob) == (jbeam.steps, jbeam.log_prob) and beam.steps == tn[0].steps


def test_ctc_decode_beam_without_native_library(monkeypatch):
    """decode_beam tries the native library first, as the JAX package's
    does: with the port's library its labels, steps and log-prob equal the
    JAX package's native result; with the port's library switched off
    (``load_library`` patched to None) they equal the prefix beam search
    and the JAX package's own fallback."""
    import rten_tpu.native.bindings as nb

    import rten_tpu_torch.native.bindings as tnb

    rng = np.random.default_rng(7)
    logits = rng.standard_normal((30, 6)) * 3.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    native = tctc.CtcDecoder().decode_beam(lp, 8)
    want = jctc.CtcDecoder().decode_beam(lp, 8)  # the JAX package's native library
    assert (native.steps, native.log_prob) == (want.steps, want.log_prob)
    monkeypatch.setattr(tnb, "load_library", lambda auto_build=True: None)  # the port's Python path
    got = tctc.CtcDecoder().decode_beam(lp, 8)
    assert got == tctc.CtcDecoder().decode_beam_nbest(lp, 8, 1)[0]
    assert got.labels == native.labels
    monkeypatch.setattr(nb, "load_library", lambda: None)  # the JAX package's own fallback
    want = jctc.CtcDecoder().decode_beam(lp, 8)
    assert (got.steps, got.log_prob) == (want.steps, want.log_prob)


@pytest.mark.parametrize("bits,tag", [(16, 1), (24, 1), (32, 1), (8, 1), (32, 3)])
def test_read_wav_matches_jax(tmp_path, bits, tag):
    """PCM 8/16/24/32-bit and float32 files, stereo: the same samples and
    rate from both readers, mono and not."""
    import struct

    rng = np.random.default_rng(bits + tag)
    n, ch, sr = 300, 2, 22050
    if tag == 3:
        payload = (rng.uniform(-1, 1, n * ch)).astype("<f4").tobytes()
    elif bits == 8:
        payload = rng.integers(0, 256, n * ch).astype(np.uint8).tobytes()
    elif bits == 24:
        payload = rng.integers(0, 256, n * ch * 3).astype(np.uint8).tobytes()
    else:
        payload = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), n * ch).astype(f"<i{bits // 8}").tobytes()
    block = ch * bits // 8
    fmt = struct.pack("<HHIIHH", tag, ch, sr, sr * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(payload)) + payload
    path = tmp_path / "x.wav"
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    for mono in (True, False):
        (tw, tsr), (jw, jsr) = taudio.read_wav(str(path), mono=mono), jaudio.read_wav(str(path), mono=mono)
        assert tsr == jsr == sr and tw.dtype == np.float32 and np.array_equal(tw, jw)


def test_write_wav_and_resample_match_jax(tmp_path):
    """write_wav's bytes and resample's samples equal the JAX package's; a
    16 kHz resample of a 22.05 kHz clip reads back as itself."""
    rng = np.random.default_rng(5)
    wav = rng.uniform(-1, 1, (2, 441)).astype(np.float32)
    taudio.write_wav(str(tmp_path / "t.wav"), wav, 22050)
    jaudio.write_wav(str(tmp_path / "j.wav"), wav, 22050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for sr, target in ((22050, 16000), (8000, 16000), (16000, 16000)):
        assert np.array_equal(taudio.resample(wav, sr, target), jaudio.resample(wav, sr, target))
    down = taudio.resample(wav[0], 22050, 16000)
    taudio.write_wav(str(tmp_path / "d.wav"), down, 16000)
    back, sr = taudio.read_wav(str(tmp_path / "d.wav"))
    assert sr == 16000 and np.abs(back - down).max() <= 1 / 32767


def _hf_state(seed: int = 6):
    """A HuggingFace ``Wav2Vec2ForCTC`` at the test widths (weight-normed
    positional convolution), in eval mode, seeded."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    hf_cfg = transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=CFG["d_model"], num_hidden_layers=CFG["n_layers"],
        num_attention_heads=CFG["n_heads"], intermediate_size=CFG["d_ff"], conv_dim=CFG["conv_dim"],
        conv_kernel=CFG["conv_kernel"], conv_stride=CFG["conv_stride"], conv_bias=True,
        feat_extract_norm="group", do_stable_layer_norm=False, hidden_act="gelu", feat_extract_activation="gelu",
        num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16, layer_norm_eps=1e-5,
        apply_spec_augment=False, attn_implementation="eager")
    model = transformers.Wav2Vec2ForCTC(hf_cfg).eval()
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_from_hf_wav2vec2_matches_jax_and_transformers():
    """``infer_config`` and ``from_hf_wav2vec2`` on a HuggingFace
    Wav2Vec2ForCTC's state dict equal the JAX package's (the weight norm
    resolved), and ``ctc_logits`` equals the model's logits (f32, 1e-4;
    unpadded rows, as HF's group-norm stack has no padding mask)."""
    model, state = _hf_state()
    npstate = {k: v.numpy() for k, v in state.items()}
    tcfg = tw2v.infer_config(state, n_heads=CFG["n_heads"], conv_stride=CFG["conv_stride"])
    jcfg = jw2v.infer_config(npstate, n_heads=CFG["n_heads"], conv_stride=CFG["conv_stride"])
    assert tcfg == tw2v.Wav2Vec2Config(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "conv_dim", "conv_kernel", "conv_stride", "conv_bias", "d_model", "n_layers", "n_heads", "d_ff",
        "num_conv_pos_embeddings", "num_conv_pos_groups")})
    tp = tw2v.from_hf_wav2vec2(state, tcfg, device="cpu")
    jp = jw2v.from_hf_wav2vec2(npstate, jcfg)
    pairs = []

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            pairs.append((a.numpy(), np.asarray(b)))

    walk(tp, jp)
    assert all(np.array_equal(a, b) for a, b in pairs)
    wav = _wav()[:1]
    with torch.no_grad():
        want = model(torch.from_numpy(wav)).logits.numpy()
    got = tw2v.ctc_logits(tp, tcfg, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape and rel_err(got, want) <= TOL
