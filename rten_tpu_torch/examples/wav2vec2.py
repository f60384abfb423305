"""Speech-to-text with CTC decoding (wav2vec2-style).

The port's copy of ``examples/wav2vec2.py`` (reference:
rten-examples/src/wav2vec2.rs): .wav waveform → wav2vec2 acoustic model →
per-frame character logits → CTC beam-search decode (``ctc``, ≙ src/ctc.rs
CtcDecoder::decode_beam). The reference reads the .wav via hound
(wav2vec2.rs:25-40); here ``audio`` does. On the card (``--cpu``: on the
host).

    python -m rten_tpu_torch.examples.wav2vec2 --demo                 # synthetic
    python -m rten_tpu_torch.examples.wav2vec2 --audio speech.wav --model wav2vec2.npz

``--model`` takes a HuggingFace ``Wav2Vec2ForCTC`` state dict saved as .npz
(np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()}))
routed through ``models.wav2vec2.from_hf_wav2vec2``. ``--vocab`` takes the
matching HF vocab.json; the base-960h character set is the default.
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common

CHARSET = "_ abcdefghijklmnopqrstuvwxyz'"  # _ = CTC blank at index 0

# facebook/wav2vec2-base-960h vocab (vocab.json order): id → token.
W2V2_BASE_VOCAB = (
    ["<pad>", "<s>", "</s>", "<unk>", "|"]
    + list("ETAONIHSRDLUMWCFGYPBVK'XJQZ")
)


def _n_params(tree) -> int:
    """The number of values in a params tree's tensors."""
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_params(v) for v in tree)
    return int(tree.numel())


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the ``log_probs``
    [T, C] and the beam and greedy ``labels``."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--audio", help=".wav file (any rate; resampled to 16 kHz)")
    p.add_argument("--model", help="Wav2Vec2ForCTC state dict as .npz")
    p.add_argument("--vocab", help="HF vocab.json (token → id) for --model")
    p.add_argument("--heads", type=int, default=12, help="attention heads (--model)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.ctc import CtcDecoder
    from rten_tpu_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    if args.audio:
        from rten_tpu_torch.audio import read_wav, resample

        wav, sr = read_wav(args.audio)
        if sr != 16000:
            wav = resample(wav, sr, 16000)
            print(f"resampled {sr} Hz -> 16000 Hz")
            sr = 16000
    else:
        wav, sr = common.synthetic_audio(1.0, seed=args.seed)
    print(f"audio: {len(wav)} samples @ {sr} Hz")

    if args.model:
        from rten_tpu_torch.models import wav2vec2 as w2v

        state = common.load_state_npz(args.model)
        cfg = w2v.infer_config(state, n_heads=args.heads)
        params = w2v.from_hf_wav2vec2(state, cfg, device=dev)
        n_params = _n_params(params)
        print(
            f"loaded wav2vec2: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"vocab {cfg.vocab_size} ({n_params / 1e6:.1f}M params)"
        )
        if args.vocab:
            import json

            with open(args.vocab) as f:
                tok2id = json.load(f)
            id2tok = {v: k for k, v in tok2id.items()}
            vocab = [id2tok.get(i, "<unk>") for i in range(cfg.vocab_size)]
        else:
            vocab = (W2V2_BASE_VOCAB + ["<unk>"] * cfg.vocab_size)[: cfg.vocab_size]
        wav_t = torch.from_numpy(np.ascontiguousarray(wav, np.float32)[None]).to(dev)
        logits = common.to_numpy(w2v.ctc_logits(params, cfg, wav_t))[0]

        def render(labels):
            out = []
            for i in labels:
                t = vocab[i]
                out.append(" " if t == "|" else t if len(t) == 1 else "")
            return "".join(out)

    else:
        logits = _demo_logits(wav, args.seed, dev)
        vocab = list(CHARSET)

        def render(labels):
            return "".join(CHARSET[i] for i in labels)

    log_probs = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    dec = CtcDecoder(blank=0)
    hyp = dec.decode_beam(log_probs, beam_size=args.beam)
    greedy = dec.decode_greedy(log_probs)
    print(f"beam   ({args.beam}): {render(hyp.labels)!r}")
    print(f"greedy     : {render(greedy.labels)!r}")
    if result is not None:
        result.update(log_probs=log_probs, beam=list(hyp.labels), greedy=list(greedy.labels))
    return 0


def _demo_logits(wav, seed, dev):
    """Seeded synthetic pipeline (no checkpoint): framed waveform → BERT-class
    encoder over frames → per-frame character logits [T, C] (host f32). The
    feature and head matrices come from a ``torch.Generator`` seeded by
    ``seed`` (the JAX app's ``jax.random`` draws differ)."""
    import numpy as np
    import torch

    from rten_tpu_torch.models import bert
    from rten_tpu_torch.models.ieee import matmul

    win, hop, d = 400, 320, 64
    n_frames = (len(wav) - win) // hop + 1
    frames = np.stack([wav[i * hop : i * hop + win] for i in range(n_frames)]).astype(np.float32)
    gen = torch.Generator().manual_seed(seed)
    w_feat = torch.randn((win, d), generator=gen) * 0.1
    feats = matmul(torch.from_numpy(frames).to(dev), w_feat.to(dev))  # [T, d]

    cfg = bert.BertConfig(
        vocab_size=4, n_layers=2, n_heads=2, d_model=d, d_ff=128,
        max_seq=n_frames + 8, n_segments=0,
    )
    params = bert.init_params(seed + 1, cfg, device=dev)
    params["tok_emb"] = torch.zeros_like(params["tok_emb"])
    x = feats[None] + params["pos_emb"][None, :n_frames]
    hidden = _encode_features(params, cfg, x)

    w_head = torch.randn((d, len(CHARSET)), generator=gen) * 0.3
    return common.to_numpy(matmul(hidden[0], w_head.to(dev)))  # [T, C]


def _encode_features(params, cfg, x):
    """The post-LN BERT layers over feature vectors x [B, T, D] (f32), the
    attention written out (softmax of the scaled scores) and the tanh GELU
    (``jax.nn.gelu``'s default, which the JAX app's block takes)."""
    import torch
    import torch.nn.functional as F

    from rten_tpu_torch.models.bert import _ln_f, _proj
    from rten_tpu_torch.models.ieee import matmul

    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    x = _ln_f(x, params["emb_ln"], cfg.layer_norm_eps)
    for layer in params["layers"]:
        q = _proj(x, layer["wq"], layer["bq"]).reshape(b, t, h, hd).transpose(1, 2)
        k = _proj(x, layer["wk"], layer["bk"]).reshape(b, t, h, hd).transpose(1, 2)
        v = _proj(x, layer["wv"], layer["bv"]).reshape(b, t, h, hd).transpose(1, 2)
        s = torch.softmax(matmul(q, k.transpose(-1, -2)) / (hd**0.5), -1)
        attn = matmul(s, v).transpose(1, 2).reshape(b, t, h * hd)
        x = _ln_f(x + _proj(attn, layer["wo"], layer["bo"]), layer["attn_ln"], cfg.layer_norm_eps)
        up = F.gelu(_proj(x, layer["w_up"], layer["b_up"]), approximate="tanh")
        x = _ln_f(x + _proj(up, layer["w_down"], layer["b_down"]), layer["ffn_ln"], cfg.layer_norm_eps)
    return x


if __name__ == "__main__":
    common.run_main(main)
