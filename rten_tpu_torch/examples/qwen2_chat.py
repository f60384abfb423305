"""Multi-turn chat with a Llama/Qwen2-class decoder (RoPE, RMSNorm, SwiGLU,
GQA).

The port's copy of ``examples/qwen2_chat.py`` (reference:
rten-examples/src/qwen2_chat.rs, multi-turn via append_prompt at
:149-178): a chat template wraps each user turn, the Generator keeps the KV
cache alive across turns, and follow-up prompts are appended without
re-prefilling history; on the card (``--cpu``: on the host).

    python -m rten_tpu_torch.examples.qwen2_chat --demo
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def infer_llama_config(state: dict, decoder, n_heads: int | None = None,
                       max_seq: int = 512):
    """Derive a Llama/Qwen2-class DecoderConfig from an HF state dict's
    shapes (GQA head split follows the fixed head_dim=64 convention unless
    --heads overrides)."""

    def key(name):
        return name if name in state else "model." + name

    vocab, d_model = state[key("embed_tokens.weight")].shape
    n_layers = 0
    while key(f"layers.{n_layers}.input_layernorm.weight") in state or (
        "model." + f"layers.{n_layers}.input_layernorm.weight" in state
    ):
        n_layers += 1
    d_ff = state[key("layers.0.mlp.gate_proj.weight")].shape[0]
    kv_dim = state[key("layers.0.self_attn.k_proj.weight")].shape[0]
    n_heads = n_heads or max(1, d_model // 64)
    head_dim = d_model // n_heads
    return decoder.DecoderConfig(
        vocab_size=vocab,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=max(1, kv_dim // head_dim),
        d_model=d_model,
        d_ff=d_ff,
        max_seq=max_seq,
        pos_encoding="rope",
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=False,
    )


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives each turn's appended
    prompt ids (``prompts``), its tokens (``turns``) and text (``texts``),
    the run's ``params``, ``cfg`` and the Generator's ``metrics``."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("-n", "--max-tokens", type=int, default=8)
    p.add_argument(
        "--model",
        help="real weights: .npz of an HF Llama/Qwen2 state dict (via "
        "decoder.from_hf_llama; Qwen2 attention biases supported); "
        "--demo uses seeded weights",
    )
    p.add_argument("--heads", type=int, help="override inferred head count (--model)")
    p.add_argument("--int8", action="store_true", help="INT8 weight-only quantization")
    p.add_argument(
        "--tokenizer", help="HF tokenizer.json (defaults to the byte-level demo tokenizer)"
    )
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import itertools

    from rten_tpu_torch.examples.gpt2 import build_demo_tokenizer
    from rten_tpu_torch.generate import Generator, GeneratorConfig, Metrics, NativeBackend, TopKSampler
    from rten_tpu_torch.models import decoder

    if args.tokenizer:
        from rten_tpu_torch.text.tokenizer import Tokenizer

        with open(args.tokenizer, encoding="utf-8") as f:
            tok = Tokenizer.from_json(f.read())
    else:
        tok = build_demo_tokenizer()
    if args.model:
        state = common.load_state_npz(args.model)
        cfg = infer_llama_config(state, decoder, args.heads)
        print(
            f"loaded {args.model}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}q/{cfg.n_kv_heads}kv heads, vocab {cfg.vocab_size}"
        )
        params = decoder.from_hf_llama(state, cfg, device=device)
        del state
    else:
        cfg = decoder.DecoderConfig(
            vocab_size=256,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,  # GQA
            d_model=128,
            d_ff=256,
            max_seq=512,
            pos_encoding="rope",
            norm="rmsnorm",
            activation="swiglu",
            tie_embeddings=False,
        )
        params = decoder.init_params(args.seed, cfg, device=device)
    if args.int8:
        params = decoder.quantize_params_int8(params, device=device)

    metrics = Metrics()
    gen = Generator(
        NativeBackend(params, cfg, device=device),
        GeneratorConfig(max_tokens=10**9, seed=args.seed),
    ).with_sampler(TopKSampler(20, temperature=0.8)).profile(metrics)

    def chat_template(user_text: str) -> list[int]:
        # Qwen2-style turn wrapping (<|im_start|> ... <|im_end|>), rendered
        # through the byte-level tokenizer.
        return tok.encode(f"<|im_start|>user\n{user_text}<|im_end|>\nassistant\n").ids

    questions = ["hello there", "and a follow-up question"][: args.turns]
    prompts, turns, texts = [], [], []
    for turn, q in enumerate(questions):
        prompts.append(chat_template(q))
        gen.append_prompt(prompts[-1])
        out = [int(t[0]) for t in itertools.islice(gen, args.max_tokens)]
        turns.append(out)
        texts.append(tok.decode(out))
        print(f"turn {turn}: user={q!r}")
        print(f"  assistant ({len(out)} tokens): {texts[-1]!r}")
    if result is not None:
        result.update(prompts=prompts, turns=turns, texts=texts, params=params, cfg=cfg, metrics=metrics)
    return 0


if __name__ == "__main__":
    common.run_main(main)
