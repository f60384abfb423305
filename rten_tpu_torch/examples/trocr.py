"""Printed-text OCR (TrOCR-style: image line encoder → char decoder).

The port's copy of ``examples/trocr.py`` (reference:
rten-examples/src/trocr.rs): text-line image → ViT-style line encoder →
encoder-decoder cross-attention → autoregressive character decode until
EOS; on the card (``--cpu``: on the host).

    python -m rten_tpu_torch.examples.trocr --demo
    python -m rten_tpu_torch.examples.trocr --image line.png --encoder enc.rten --decoder dec.rten

``--encoder``/``--decoder`` take the exported .rten graph PAIR the reference
runs (trocr.rs loads encoder + decoder models): the encoder maps
[1, 3, H, W] → [1, N, D] memory; the decoder follows HF-Optimum decoder
conventions (input_ids, encoder_hidden_states, past_key_values.0.decoder.*)
and is driven by ``generate.GraphBackend`` with the encoder memory as a
hoisted constant input.
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common

CHARSET = "<> abcdefghijklmnopqrstuvwxyz0123456789"


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the encoder
    ``memory`` and the recognized ``text``."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("-n", "--max-chars", type=int, default=12)
    p.add_argument("--image", help="text-line image file (PNG/BMP/…)")
    p.add_argument("--encoder", help="line encoder as .rten ([1,3,H,W] → [1,N,D])")
    p.add_argument("--decoder", help="HF-Optimum-convention decoder as .rten")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import encoder_decoder as ed
    from rten_tpu_torch.models import vit

    dev = resolve_device(device)
    # A text line is a wide, short strip.
    h, w, d = 16, 64, 64
    if args.image:
        from rten_tpu_torch.image.io import read_image

        line = read_image(args.image)
        if line.shape[1:] != (h, w):
            line = common.resize_bilinear(line, (h, w)).numpy()
        print(f"image: {args.image} -> {line.shape}")
    else:
        rng = np.random.default_rng(args.seed)
        line = np.clip(
            0.9 - 0.8 * (rng.random((3, h, w)) < 0.2), 0.0, 1.0
        ).astype(np.float32)

    if args.encoder and args.decoder:
        from rten_tpu_torch.generate import Generator, GeneratorConfig, GraphBackend
        from rten_tpu_torch.runtime.session import Model

        enc_m = Model.load_file(args.encoder, device=dev)
        enc_states = common.to_numpy(enc_m.run([line[None]])[0])
        dec_m = Model.load_file(args.decoder, device=dev)
        be = GraphBackend(
            dec_m, constant_inputs={"encoder_hidden_states": enc_states}
        )
        print(
            f"loaded encoder+decoder: memory {enc_states.shape}, "
            f"decoder mode {be.mode}"
        )
        eos = CHARSET.index(">")
        gen = Generator(
            be, GeneratorConfig(max_tokens=args.max_chars, eos_tokens=(eos,))
        ).with_prompt([CHARSET.index("<")])
        out = [CHARSET[int(t[0])] for t in gen if int(t[0]) != eos]
        print(f"recognized: {''.join(out)!r}")
        if result is not None:
            result.update(memory=enc_states, text="".join(out))
        return 0

    vit_cfg = vit.ViTConfig(
        image_size=None, patch_size=8, n_layers=2, n_heads=2,
        d_model=d, d_ff=128, use_cls_token=False,
    )
    # Rectangular input: patchify directly, bypass the square-image helper.
    patches = vit.patchify(torch.from_numpy(line[None]).to(dev), 8)  # [1, (h/8)(w/8), 192]
    vit_params = vit.init_params(args.seed, _square_cfg(vit_cfg, patches), device=dev)
    enc_states = _encode_patches(vit_params, vit_cfg, patches)

    ed_cfg = ed.EncDecConfig(
        n_mels=d, vocab_size=len(CHARSET), d_model=d, n_heads=2,
        n_audio_layers=1, n_text_layers=2, d_ff=128,
        max_text_ctx=32, dtype=torch.float32,
    )
    ed_params = ed.init_params(args.seed + 1, ed_cfg, device=dev)
    state = ed.init_decoder_state(ed_params, ed_cfg, enc_states.to(ed_cfg.dtype))

    tokens = torch.tensor([[0]], dtype=torch.int32, device=dev)  # '<' = BOS
    out = []
    for _ in range(args.max_chars):
        logits, state = ed.decode(ed_params, ed_cfg, tokens, state)
        nxt = int(torch.argmax(logits[0, -1]))
        if CHARSET[nxt] == ">":
            break
        out.append(CHARSET[nxt])
        tokens = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
    print(f"recognized: {''.join(out)!r}")
    if result is not None:
        result.update(memory=common.to_numpy(enc_states), text="".join(out))
    return 0


def _square_cfg(cfg, patches):
    import dataclasses

    n = patches.shape[1]
    side = int(round(n**0.5))
    # init_params only uses n_patches/patch_dim via image_size — fabricate a
    # square config with the same token count and patch dim.
    return dataclasses.replace(
        cfg, image_size=side * cfg.patch_size
    )


def _encode_patches(params, cfg, patches):
    """ViT encode over pre-patchified tokens (rectangular inputs): the
    attention written out (softmax of the scaled scores), the dense matmuls
    in IEEE f32 (``ieee.matmul``, the JAX app's ``dispatch.matmul``) and
    the tanh GELU (``jax.nn.gelu``'s default, which the JAX app takes)."""
    import torch
    import torch.nn.functional as F

    from rten_tpu_torch.models.bert import _ln_f
    from rten_tpu_torch.models.ieee import matmul

    x = matmul(patches.to(cfg.dtype), params["patch_w"]) + params["patch_b"]
    n = x.shape[1]
    x = x + params["pos_emb"][None, :n]
    b, t, dm = x.shape
    h, hd = cfg.n_heads, dm // cfg.n_heads
    for layer in params["layers"]:
        xn = _ln_f(x, layer["ln1"], cfg.layer_norm_eps)
        qkv = matmul(xn, layer["wqkv"]) + layer["bqkv"]
        q, k, v = torch.split(qkv, dm, dim=-1)
        q = q.reshape(b, t, h, hd).transpose(1, 2)
        k = k.reshape(b, t, h, hd).transpose(1, 2)
        v = v.reshape(b, t, h, hd).transpose(1, 2)
        s = torch.softmax(matmul(q, k.transpose(-1, -2)) / (hd**0.5), -1)
        attn = matmul(s, v).transpose(1, 2).reshape(b, t, dm)
        x = x + matmul(attn, layer["wo"]) + layer["bo"]
        xn = _ln_f(x, layer["ln2"], cfg.layer_norm_eps)
        up = F.gelu(matmul(xn, layer["w_up"]) + layer["b_up"], approximate="tanh")
        x = x + matmul(up, layer["w_down"]) + layer["b_down"]
    return _ln_f(x, params["final_ln"], cfg.layer_norm_eps)


if __name__ == "__main__":
    common.run_main(main)
