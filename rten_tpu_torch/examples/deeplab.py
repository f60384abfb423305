"""DeepLab-style semantic segmentation.

The port's copy of ``examples/deeplab.py`` (reference:
rten-examples/src/deeplab.rs): image → backbone features → per-pixel class
logits → argmax → PASCAL-style color mask (deeplab.rs paints per-class
colors) upsampled back to the input size; on the card (``--cpu``: on the
host).

    python -m rten_tpu_torch.examples.deeplab --demo [--out mask.png]
    python -m rten_tpu_torch.examples.deeplab --image scene.png --model deeplab.rten

``--model`` takes an exported .rten segmenter (the reference loads
converted torchvision deeplabv3 exports, deeplab.rs): input [1, 3, H, W],
output per-pixel class logits [1, K, h, w] (any grid size — the example
bilinearly upsamples to the input resolution, like the in-graph Resize the
reference's export carries).
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common

PALETTE = [
    (0, 0, 0), (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240),
]


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the ``mask`` [H, W]
    and the upsampled ``logits``."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--out", help="write the color mask to this PNG")
    p.add_argument("--image", help="input image file (PNG/BMP/…)")
    p.add_argument("--model", help="segmenter as .rten ([1,3,H,W] → [1,K,h,w])")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.image.io import write_image
    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import resnet

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
        logits = m.run([chw[None]])[0].float()
        n_classes = logits.shape[1]
        print(f"loaded {args.model}: {n_classes} classes through Model.run")
    else:
        n_classes = 8
        cfg = resnet.ResNetConfig(block="basic", stage_sizes=(1, 1), width=8)
        params = resnet.init_params(args.seed, cfg, device=dev)
        feats = resnet.forward(params, cfg, torch.from_numpy(chw[None]).to(dev), features=True)

        # 1x1 conv segmentation head (the real head lives inside --model
        # graphs; the upsample below matches their in-graph Resize), drawn
        # from a torch.Generator (the JAX app's jax.random head differs).
        c = feats.shape[1]
        w_head = torch.randn((c, n_classes), generator=torch.Generator().manual_seed(args.seed + 1)) * 0.5
        logits = torch.einsum("bchw,ck->bkhw", feats, w_head.to(dev))
    logits = common.resize_bilinear(logits, (size, size))
    mask = common.to_numpy(torch.argmax(logits, dim=1))[0].astype(np.int64)  # [H, W]

    counts = np.bincount(mask.ravel(), minlength=n_classes)
    for cls, cnt in enumerate(counts):
        if cnt:
            print(f"class {cls}: {cnt} px ({100.0 * cnt / mask.size:.1f}%)")

    if args.out:
        color = np.zeros((3, size, size), np.float32)
        for cls in range(n_classes):
            r, g, b = PALETTE[cls % len(PALETTE)]
            m = mask == cls
            color[0][m], color[1][m], color[2][m] = r / 255.0, g / 255.0, b / 255.0
        write_image(args.out, color)
        print(f"wrote {args.out}")
    if result is not None:
        result.update(mask=mask, logits=common.to_numpy(logits))
    return 0


if __name__ == "__main__":
    common.run_main(main)
