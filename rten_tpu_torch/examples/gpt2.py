"""GPT-2 text generation with the native decoder + Generator pipeline.

The port's copy of ``examples/gpt2.py`` (reference: rten-examples/src/gpt2.rs,
generator chain at :112-118): prompt → byte-level BPE tokenizer →
Generator(.with_prompt .with_sampler .profile) → streamed decode with
throughput metrics, on the card (``--cpu``: the kernels' plain versions).

    python -m rten_tpu_torch.examples.gpt2 --demo --prompt "the quick brown" -n 16
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def build_demo_tokenizer():
    """Byte-level BPE over raw bytes (GPT-2's scheme with an empty merge
    table: every byte is a token — demo-sized but the real code path)."""
    from rten_tpu_torch.text.models import bytes_to_unicode
    from rten_tpu_torch.text.pretokenizer import ByteLevel
    from rten_tpu_torch.text.tokenizer import ByteLevelBPE, Tokenizer

    byte_vocab = {u: b for b, u in bytes_to_unicode().items()}
    model = ByteLevelBPE(vocab=byte_vocab, merges=[])
    return Tokenizer(model, pre_tokenizer=ByteLevel(), byte_level_decode=True)


def infer_gpt2_config(state: dict, decoder, n_heads: int | None = None):
    """Derive a DecoderConfig from an HF GPT-2 state dict's shapes (the
    checkpoint carries no config object; head count follows GPT-2's fixed
    head_dim=64 unless overridden)."""

    def key(name):
        return name if name in state else "transformer." + name

    vocab, d_model = state[key("wte.weight")].shape
    max_seq = state[key("wpe.weight")].shape[0]
    n_layers = 0
    while key(f"h.{n_layers}.ln_1.weight") in state or (
        "transformer." + f"h.{n_layers}.ln_1.weight" in state
    ):
        n_layers += 1
    d_ff = state[key("h.0.mlp.c_fc.weight")].shape[-1]
    return decoder.DecoderConfig(
        vocab_size=vocab,
        n_layers=n_layers,
        n_heads=n_heads or max(1, d_model // 64),
        d_model=d_model,
        d_ff=d_ff,
        max_seq=max_seq,
    )


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the run's
    ``prompt_ids``, generated ``tokens`` and ``text``."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--prompt", default="the quick brown fox")
    p.add_argument("-n", "--max-tokens", type=int, default=16)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--int8", action="store_true", help="INT8 weight-only quantization")
    p.add_argument(
        "--model",
        help="real weights: .npz of an HF GPT-2 state dict (via "
        "decoder.from_hf_gpt2) or a .rten graph (lifted onto the "
        "decoder's dense-weight route, models/lift.py); --demo uses seeded weights",
    )
    p.add_argument("--heads", type=int, help="override inferred head count (--model .npz)")
    p.add_argument(
        "--tokenizer", help="HF tokenizer.json (defaults to the byte-level demo tokenizer)"
    )
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import itertools

    from rten_tpu_torch.generate import Generator, GeneratorConfig, Metrics, NativeBackend, TopKSampler
    from rten_tpu_torch.models import decoder

    if args.tokenizer:
        from rten_tpu_torch.text.tokenizer import Tokenizer

        with open(args.tokenizer, encoding="utf-8") as f:
            tok = Tokenizer.from_json(f.read())
    else:
        tok = build_demo_tokenizer()
    prompt_ids = tok.encode(args.prompt).ids
    print(f"prompt: {args.prompt!r} -> {len(prompt_ids)} tokens")

    if args.model and args.model.endswith(".rten"):
        # Exported graph path: load the .rten, lift HF-named decoder graphs
        # onto the decoder via backend_for_model, else the generic
        # GraphBackend (reference analog: gpt2.rs loads the exported model
        # file, rten-examples/src/gpt2.rs:112-118).
        from rten_tpu_torch.generate import EncDecBackendFactory, backend_for_model
        from rten_tpu_torch.runtime.session import Model

        model = Model.load_file(args.model, device=device)
        backend = backend_for_model(model, n_heads=args.heads, device=device)
        if isinstance(backend, EncDecBackendFactory):
            raise SystemExit(
                "--model .rten resolved to an encoder-decoder graph; "
                "gpt2.py drives decoder-only models"
            )
        print(f"backend: {type(backend).__name__}")
    else:
        if args.model:
            state = common.load_state_npz(args.model)
            cfg = infer_gpt2_config(state, decoder, args.heads)
            print(
                f"loaded {args.model}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
                f"vocab {cfg.vocab_size}"
            )
            params = decoder.from_hf_gpt2(state, cfg, device=device)
        else:
            cfg = decoder.DecoderConfig(
                vocab_size=256, n_layers=2, n_heads=4, d_model=128, d_ff=512, max_seq=256
            )
            params = decoder.init_params(args.seed, cfg, device=device)
        if args.int8:
            params = decoder.quantize_params_int8(params, device=device)
        backend = NativeBackend(params, cfg, device=device)

    metrics = Metrics()
    gen = (
        Generator(backend, GeneratorConfig(max_tokens=args.max_tokens, seed=args.seed))
        .with_prompt(prompt_ids)
        .with_sampler(TopKSampler(args.top_k, temperature=0.8))
        .profile(metrics)
    )
    out_ids = [int(t[0]) for t in itertools.islice(gen, args.max_tokens)]
    text = tok.decode(out_ids)
    print(f"generated: {text!r}")
    print(metrics.summary())
    if result is not None:
        result.update(prompt_ids=prompt_ids, tokens=out_ids, text=text, metrics=metrics)
    return 0


if __name__ == "__main__":
    common.run_main(main)
