"""Text-to-speech synthesis (Piper-style) writing a .wav file.

The port's copy of ``examples/piper.py`` (reference:
rten-examples/src/piper.rs): text → phoneme-ish id sequence → acoustic
model → waveform → 16-bit PCM WAV via ``audio`` (the reference writes WAV
via hound); on the card (``--cpu``: on the host).

    python -m rten_tpu_torch.examples.piper --demo --out speech.wav     # inline demo model
    python -m rten_tpu_torch.examples.piper --model tts.rten --text "hi" --out speech.wav

``--model`` takes a .rten graph whose first input is the phoneme id
sequence [1, N] int32 and whose first output is the waveform (any shape
flattening to samples) — run through ``Model`` like the reference's VITS
export through Model::run.
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the phoneme ``ids``
    and the ``wav`` samples."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--text", default="hello world")
    p.add_argument("--out", help="output .wav path")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--model", help="TTS model as .rten ([1,N] ids → waveform)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import bert

    dev = resolve_device(device)
    # "Phonemization": characters as phoneme ids.
    charset = " abcdefghijklmnopqrstuvwxyz"
    ids = np.asarray(
        [charset.index(c) for c in args.text.lower() if c in charset], np.int32
    )
    print(f"text {args.text!r} -> {len(ids)} phonemes")

    sr = args.sr
    if args.model:
        from rten_tpu_torch.runtime.session import Model

        m = Model.load_file(args.model, device=dev)
        out = m.run([ids[None]])[0]
        wav = common.to_numpy(out).reshape(-1)
        print(f"loaded {args.model}: {len(wav) / sr:.2f}s through Model.run")
        if args.out:
            from rten_tpu_torch.audio import write_wav

            write_wav(args.out, np.clip(wav, -1.0, 1.0), sr)
            print(f"wrote {args.out}")
        if result is not None:
            result.update(ids=ids, wav=wav)
        return 0

    # Acoustic model: encoder over phonemes → per-phoneme (duration, f0, amp).
    cfg = bert.BertConfig(
        vocab_size=len(charset), n_layers=2, n_heads=2, d_model=32, d_ff=64,
        max_seq=128, n_segments=0,
    )
    params = bert.init_params(args.seed, cfg, device=dev)
    hidden = bert.encode(params, cfg, torch.from_numpy(ids[None]).to(dev))
    w_out = torch.randn((cfg.d_model, 3), generator=torch.Generator().manual_seed(args.seed + 1)) * 0.3
    acoustics = common.to_numpy(hidden[0] @ w_out.to(dev))  # [N, 3]

    dur = 0.06 + 0.04 * (1 / (1 + np.exp(-acoustics[:, 0])))  # 60–100 ms
    f0 = 120.0 * np.exp(0.3 * np.tanh(acoustics[:, 1]))  # around 120 Hz
    amp = 0.2 + 0.6 * (1 / (1 + np.exp(-acoustics[:, 2])))

    # Harmonic synthesis per phoneme.
    chunks = []
    for di, fi, ai in zip(dur, f0, amp):
        n = int(di * sr)
        t = np.arange(n) / sr
        env = np.hanning(n)
        chunk = ai * env * (
            np.sin(2 * np.pi * fi * t)
            + 0.3 * np.sin(4 * np.pi * fi * t)
            + 0.1 * np.sin(6 * np.pi * fi * t)
        )
        chunks.append(chunk.astype(np.float32))
    wav = np.concatenate(chunks) if chunks else np.zeros(1, np.float32)
    print(f"synthesized {len(wav) / sr:.2f}s of audio")

    if args.out:
        from rten_tpu_torch.audio import write_wav

        write_wav(args.out, np.clip(wav, -1.0, 1.0), sr)
        print(f"wrote {args.out}")
    if result is not None:
        result.update(ids=ids, wav=wav)
    return 0


if __name__ == "__main__":
    common.run_main(main)
