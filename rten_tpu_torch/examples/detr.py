"""DETR-style end-to-end detection (query-based, no NMS).

The port's copy of ``examples/detr.py`` (reference:
rten-examples/src/detr.rs): image → CNN backbone → transformer encoder over
flattened feature tokens → learned object queries cross-attending (here: a
light dot-product decoder head) → per-query class softmax + cxcywh box
regression; "no object" class filtered out, boxes scaled back to pixels —
exactly the reference's post-processing; on the card (``--cpu``: on the
host).

    python -m rten_tpu_torch.examples.detr --demo
    python -m rten_tpu_torch.examples.detr --image street.png --model detr.rten

``--model`` takes an exported .rten DETR (the reference loads converted
facebook/detr exports, detr.rs): input [1, 3, H, W]; outputs per-query
class logits [1, Q, C+1] (last class = "no object") and boxes [1, Q, 4]
cxcywh normalized to [0, 1] — exactly the upstream output contract.
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the per-query class
    probabilities ``cls`` [Q, C+1] and ``boxes`` [Q, 4]."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--image", help="input image file (PNG/BMP/…)")
    p.add_argument(
        "--model", help="DETR as .rten ([1,3,H,W] → logits [1,Q,C+1], boxes [1,Q,4])"
    )
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import torch

    from rten_tpu_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    size = 64
    if args.image:
        chw = common.load_image_arg(args.image, size)
        print(f"image: {args.image} -> {chw.shape}")
    else:
        chw = common.synthetic_image(size, size, args.seed)

    if args.model:
        from rten_tpu_torch.runtime.session import Model

        m = Model.load_file(args.model, device=dev)
        logits, boxes = m.run([chw[None]])[:2]
        cls_np = common.to_numpy(torch.softmax(logits.float(), dim=-1))[0]
        box_np = common.to_numpy(boxes)[0]
        n_queries = cls_np.shape[0]
        print(f"loaded {args.model}: {n_queries} queries through Model.run")
    else:
        n_queries = 8
        cls_np, box_np = _demo_queries(chw, args.seed, n_queries, dev)
    kept = 0
    for qi in range(n_queries):
        cls = int(cls_np[qi, :-1].argmax())
        score = float(cls_np[qi, cls])
        if score < args.threshold or cls_np[qi, -1] > score:
            continue
        cx, cy, w, h = box_np[qi] * size
        print(
            f"query {qi}: class {cls} score {score:.3f} "
            f"box ({cx - w / 2:.0f},{cy - h / 2:.0f})-({cx + w / 2:.0f},{cy + h / 2:.0f})"
        )
        kept += 1
    print(f"{kept}/{n_queries} queries above threshold {args.threshold}")
    if result is not None:
        result.update(cls=cls_np, boxes=box_np)
    return 0


def _demo_queries(chw, seed, n_queries, dev):
    """Seeded backbone + encoder + query head (no checkpoint), its random
    queries and heads drawn from ``torch.Generator``s (the JAX app's
    ``jax.random`` draws differ); host f32 class probabilities [Q, C+1]
    and boxes [Q, 4]."""
    import torch

    from rten_tpu_torch.models import resnet, vit
    from rten_tpu_torch.models.ieee import matmul

    n_classes = 4
    cfg = resnet.ResNetConfig(block="basic", stage_sizes=(1, 1), width=8)
    params = resnet.init_params(seed, cfg, device=dev)
    feats = resnet.forward(params, cfg, torch.from_numpy(chw[None]).to(dev), features=True)
    b, c, gh, gw = feats.shape
    tokens = feats.reshape(b, c, gh * gw).permute(0, 2, 1)  # [B, N, C]

    # Transformer encoder over feature tokens (ViT blocks, no cls token).
    enc_cfg = vit.ViTConfig(
        image_size=gh * 8, patch_size=8, n_layers=2, n_heads=2,
        d_model=c, d_ff=4 * c, use_cls_token=False,
    )
    enc_params = vit.init_params(seed + 1, enc_cfg, device=dev)
    x = tokens + enc_params["pos_emb"][None, : tokens.shape[1]]
    for layer in enc_params["layers"]:
        x = _block(x, layer, enc_cfg)

    # Object queries attend to encoder memory (single cross-attention read).
    gen = torch.Generator().manual_seed(seed + 2)
    queries = (torch.randn((n_queries, c), generator=gen) * 0.5).to(dev)
    attn = torch.softmax(matmul(queries, x[0].T) / c**0.5, dim=-1)
    q_feats = matmul(attn, x[0])  # [n_queries, C]

    w_cls = (torch.randn((c, n_classes + 1), generator=gen) * 0.5).to(dev)
    w_box = (torch.randn((c, 4), generator=gen) * 0.5).to(dev)
    cls_p = torch.softmax(matmul(q_feats, w_cls), dim=-1)  # last col = "no object"
    boxes = torch.sigmoid(matmul(q_feats, w_box))  # cxcywh in [0,1]
    return common.to_numpy(cls_p), common.to_numpy(boxes)


def _block(x, layer, cfg):
    """One pre-LN ViT block over x [B, T, D] in f32, attention written out
    (softmax of the scaled scores) and the tanh GELU (``jax.nn.gelu``'s
    default, which the JAX app's block takes)."""
    import torch
    import torch.nn.functional as F

    from rten_tpu_torch.models.bert import _ln_f
    from rten_tpu_torch.models.ieee import matmul

    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    xn = _ln_f(x, layer["ln1"], cfg.layer_norm_eps)
    qkv = matmul(xn, layer["wqkv"]) + layer["bqkv"]
    q, k, v = torch.split(qkv, d, dim=-1)
    q = q.reshape(b, t, h, hd).transpose(1, 2)
    k = k.reshape(b, t, h, hd).transpose(1, 2)
    v = v.reshape(b, t, h, hd).transpose(1, 2)
    s = torch.softmax(matmul(q, k.transpose(-1, -2)) / (hd**0.5), -1)
    attn = matmul(s, v).transpose(1, 2).reshape(b, t, d)
    x = x + matmul(attn, layer["wo"]) + layer["bo"]
    xn = _ln_f(x, layer["ln2"], cfg.layer_norm_eps)
    up = F.gelu(matmul(xn, layer["w_up"]) + layer["b_up"], approximate="tanh")
    return x + matmul(up, layer["w_down"]) + layer["b_down"]


if __name__ == "__main__":
    common.run_main(main)
