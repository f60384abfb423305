"""Voice activity detection (Silero-style streaming VAD).

The port's copy of ``examples/silero.py`` (reference:
rten-examples/src/silero.rs): .wav waveform → framed features → VAD model →
per-frame speech probability → hysteresis thresholding into speech
segments with start/end timestamps — the reference's exact
post-processing. The reference reads real .wav input and runs an exported
.rten model (silero.rs); both paths exist here, on the card (``--cpu``: on
the host):

    python -m rten_tpu_torch.examples.silero --demo               # inline GRU demo
    python -m rten_tpu_torch.examples.silero --audio rec.wav --model vad.rten

``--model`` takes a .rten graph whose first input is per-frame features
[T, 1, D] and whose first output is a per-frame speech probability (any
shape squeezing to [T]) — run through ``Model`` like the reference's
Model::run. ``--audio`` takes any .wav (resampled to 16 kHz).
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def extract_features(wav, hop=320):
    """Per-frame features: log-energy + zero-crossing rate + 7 band
    energies → [T, 9] float32 (normalized)."""
    import numpy as np

    n_frames = len(wav) // hop
    frames = wav[: n_frames * hop].reshape(n_frames, hop)
    energy = np.log1p((frames**2).sum(-1))
    zcr = (np.abs(np.diff(np.sign(frames), axis=-1)) > 0).mean(-1)
    spec = np.abs(np.fft.rfft(frames, axis=-1))
    bands = np.log1p(spec[:, : 7 * (spec.shape[1] // 7)].reshape(n_frames, 7, -1).sum(-1))
    feats = np.concatenate([energy[:, None], zcr[:, None], bands], -1).astype(np.float32)
    feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
    return feats, energy


def segment(probs, on, off, n_frames):
    """Hysteresis segmentation (silero.rs post-processing)."""
    segments, active, start = [], False, 0
    for i, prob_i in enumerate(probs):
        if not active and prob_i >= on:
            active, start = True, i
        elif active and prob_i < off:
            segments.append((start, i))
            active = False
    if active:
        segments.append((start, n_frames))
    return segments


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the per-frame
    ``probs`` and the ``segments``."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--on", type=float, default=0.6, help="speech-start threshold")
    p.add_argument("--off", type=float, default=0.4, help="speech-end threshold")
    p.add_argument("--audio", help=".wav file (any rate; resampled to 16 kHz)")
    p.add_argument("--model", help="VAD model as .rten ([T,1,D] feats → [T] probs)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from rten_tpu_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    if args.audio:
        from rten_tpu_torch.audio import read_wav, resample

        wav, sr = read_wav(args.audio)
        if sr != 16000:
            wav = resample(wav, sr, 16000)
            sr = 16000
    else:
        wav, sr = common.synthetic_audio(2.0, seed=args.seed)

    hop = 320  # 20 ms frames
    feats, energy = extract_features(wav, hop)
    n_frames, d_in = feats.shape

    if args.model:
        from rten_tpu_torch.runtime.session import Model

        m = Model.load_file(args.model, device=dev)
        decl = m.input_shape(m.input_ids[0])
        if decl is not None and isinstance(decl[-1], int) and decl[-1] != d_in:
            raise SystemExit(
                f"model expects feature dim {decl[-1]}, extractor produces {d_in}"
            )
        out = m.run([feats[:, None, :]])[0]
        probs = common.to_numpy(out).reshape(-1)[:n_frames]
        print(f"loaded {args.model}: {n_frames} frames through Model.run")
    else:
        probs = _demo_probs(feats, energy, args.seed, dev)

    segments = segment(probs, args.on, args.off, n_frames)
    print(f"{n_frames} frames, {len(segments)} speech segment(s):")
    for s, e in segments:
        print(f"  {s * hop / sr:6.2f}s – {e * hop / sr:6.2f}s  ({e - s} frames)")
    if result is not None:
        result.update(probs=probs, segments=segments)
    return 0


def _demo_probs(feats, energy, seed, dev):
    """Seeded inline GRU through the operator library (the reference runs
    the Silero ONNX graph whose core is exactly this GRU op)."""
    import numpy as np
    import torch

    from rten_tpu_torch.ops.registry import OpContext, get_op

    n_frames, d_in = feats.shape
    d_h = 16
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((1, 3 * d_h, d_in)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((1, 3 * d_h, d_h)) * 0.5).astype(np.float32)
    b = np.zeros((1, 6 * d_h), np.float32)
    gru = get_op("GRU").fn
    out = gru(
        OpContext(device=dev),
        {"hidden_size": d_h, "direction": "forward"},
        *(torch.from_numpy(a).to(dev) for a in (feats[:, None, :], w, r, b)),  # x [T, B, D]
    )
    hidden = common.to_numpy(out[0])[:, 0, 0, :]  # [T, H]

    w_cls = (rng.standard_normal(d_h) * 0.8).astype(np.float32)
    probs = 1.0 / (1.0 + np.exp(-(hidden @ w_cls)))
    # Mix in normalized energy so the demo weights track actual activity.
    e_norm = (energy - energy.min()) / max(energy.max() - energy.min(), 1e-9)
    return 0.3 * probs + 0.7 * e_norm


if __name__ == "__main__":
    common.run_main(main)
