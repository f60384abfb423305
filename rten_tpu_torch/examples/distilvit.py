"""Image captioning (DistilViT-style: ViT encoder → text decoder with
cross-attention).

The port's copy of ``examples/distilvit.py`` (reference:
rten-examples/src/distilvit.rs): image → ViT patch encoder → encoder states
feed the encoder-decoder's cross-attention KV cache (precomputed once) →
autoregressive greedy caption decode; on the card (``--cpu``: on the
host).

    python -m rten_tpu_torch.examples.distilvit --demo
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the encoder
    ``memory`` and the ``caption`` tokens."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("-n", "--max-tokens", type=int, default=8)
    p.add_argument("--image", help="input image file (PNG/BMP/…)")
    p.add_argument("--encoder", help="ViT encoder as .rten ([1,3,H,W] → [1,N,D])")
    p.add_argument("--decoder", help="HF-Optimum-convention caption decoder as .rten")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import torch

    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import encoder_decoder as ed
    from rten_tpu_torch.models import vit

    dev = resolve_device(device)
    size, d = 32, 64
    if args.image:
        chw = common.load_image_arg(args.image, size)
        print(f"image: {args.image} -> {chw.shape}")
    else:
        chw = common.synthetic_image(size, size, args.seed)

    if args.encoder and args.decoder:
        from rten_tpu_torch.generate import Generator, GeneratorConfig, GraphBackend
        from rten_tpu_torch.runtime.session import Model

        enc_m = Model.load_file(args.encoder, device=dev)
        enc_states = common.to_numpy(enc_m.run([chw[None]])[0])
        dec_m = Model.load_file(args.decoder, device=dev)
        be = GraphBackend(
            dec_m, constant_inputs={"encoder_hidden_states": enc_states}
        )
        print(
            f"loaded encoder+decoder: memory {enc_states.shape}, "
            f"decoder mode {be.mode}"
        )
        gen = Generator(be, GeneratorConfig(max_tokens=args.max_tokens)).with_prompt([0])
        words = [f"w{i}" for i in range(9999)]
        caption = [words[int(t[0])] for t in gen]
        print("caption tokens:", " ".join(caption))
        if result is not None:
            result.update(memory=enc_states, caption=caption)
        return 0

    vit_cfg = vit.ViTConfig(
        image_size=size, patch_size=8, n_layers=2, n_heads=2,
        d_model=d, d_ff=128, use_cls_token=False,
    )
    vit_params = vit.init_params(args.seed, vit_cfg, device=dev)
    enc_states = vit.encode(vit_params, vit_cfg, torch.from_numpy(chw[None]).to(dev))  # [1, N, d]

    ed_cfg = ed.EncDecConfig(
        n_mels=d, vocab_size=64, d_model=d, n_heads=2,
        n_audio_layers=1, n_text_layers=2, d_ff=128,
        max_text_ctx=32, dtype=torch.float32,
    )
    ed_params = ed.init_params(args.seed + 1, ed_cfg, device=dev)
    # The ViT output IS the encoder memory: init the decoder's cross-attention
    # KV straight from it (no audio encoder pass — same mechanism trocr uses).
    state = ed.init_decoder_state(ed_params, ed_cfg, enc_states.to(ed_cfg.dtype))

    words = [f"w{i}" for i in range(64)]
    bos = 0
    tokens = torch.tensor([[bos]], dtype=torch.int32, device=dev)
    caption = []
    for _ in range(args.max_tokens):
        logits, state = ed.decode(ed_params, ed_cfg, tokens, state)
        nxt = int(torch.argmax(logits[0, -1]))
        caption.append(words[nxt])
        tokens = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
    print("caption tokens:", " ".join(caption))
    if result is not None:
        result.update(memory=common.to_numpy(enc_states), caption=caption)
    return 0


if __name__ == "__main__":
    common.run_main(main)
