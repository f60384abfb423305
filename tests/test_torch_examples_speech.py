"""The port's speech apps (rten_tpu_torch.examples: wav2vec2, silero,
piper) on the CPU against the JAX package's (examples/) on the same files:
.wav files (wav2vec2 reads one at 8 kHz and resamples it), a seeded
HF-named Wav2Vec2ForCTC .npz (head dim 64) and the .rten VAD and TTS
graphs of the JAX package's tests. Printed lines equal (numbers within
1e-4 relative / 1e-5 absolute), the written WAV equal but for at most 0.1%
of samples off by one code. Also: wav2vec2's ``_encode_features`` and
silero's ``extract_features`` and ``segment`` against the JAX ones."""

import numpy as np
import pytest
import torch
from torch_app_helpers import check_port_app, jax_app, jax_runs, port_app

import chip_smoke

APPS = ("wav2vec2", "silero", "piper")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return chip_smoke.write_app_files(tmp_path_factory.mktemp("speech_files"))


@pytest.fixture(scope="module")
def jax_lines(files, tmp_path_factory):
    return jax_runs(APPS, files, tmp_path_factory.mktemp("speech_jax"))


@pytest.mark.parametrize("name", APPS)
def test_app_matches_jax(name, files, jax_lines, tmp_path):
    res = check_port_app(name, files, jax_lines[name], tmp_path)
    assert res


def test_encode_features_matches_jax():
    """wav2vec2.py's demo encoder (post-LN BERT layers over feature
    vectors, tanh GELU) on the same input and params (carried across by
    ``bert.params_from_jax``): within 1e-5."""
    import jax

    from rten_tpu.models import bert as jbert
    from rten_tpu_torch.models import bert

    jw, w = jax_app("wav2vec2"), port_app("wav2vec2")
    kw = dict(vocab_size=4, n_layers=2, n_heads=2, d_model=64, d_ff=128, max_seq=56, n_segments=0)
    jcfg, cfg = jbert.BertConfig(**kw), bert.BertConfig(**kw)
    jparams = jbert.init_params(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(0).standard_normal((1, 48, 64)).astype(np.float32)
    want = np.asarray(jw._encode_features(jparams, jcfg, x))
    got = w._encode_features(bert.params_from_jax(jparams, cfg, device="cpu"), cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_silero_features_and_segments_match_jax():
    """silero.py's framed features, energies and hysteresis segments on
    the same waveform: equal."""
    from rten_tpu_torch.examples import common

    js, s = jax_app("silero"), port_app("silero")
    wav, _ = common.synthetic_audio(2.0, seed=4)
    (jf, je), (f, e) = js.extract_features(wav), s.extract_features(wav)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(e, je)
    probs = np.random.default_rng(5).random(len(f))
    for on, off in ((0.6, 0.4), (0.5, 0.5), (0.9, 0.1)):
        assert s.segment(probs, on, off, len(f)) == js.segment(probs, on, off, len(f))
