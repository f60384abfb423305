"""Monocular depth estimation (Depth-Anything-style ViT + dense head).

The port's copy of ``examples/depth_anything.py`` (reference:
rten-examples/src/depth_anything.rs): image → ViT encoder → patch feature
map → upsampling head → relative depth map, normalized to [0, 1] and
written as a grayscale image (the reference's post-processing does exactly
this normalize + save); on the card (``--cpu``: on the host).

    python -m rten_tpu_torch.examples.depth_anything --demo [--out depth.png]
    python -m rten_tpu_torch.examples.depth_anything --image room.png --model depth.rten

``--model`` takes an exported .rten monodepth model (the reference loads
converted Depth-Anything exports, depth_anything.rs): input [1, 3, H, W],
output a depth grid [1, 1, h, w] (or [1, h, w]) — upsampled and normalized
by the example.
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the normalized
    ``depth`` map [H, W]."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--out", help="write normalized depth to this PNG")
    p.add_argument("--image", help="input image file (PNG/BMP/…)")
    p.add_argument(
        "--model", help="depth model as .rten ([1,3,H,W] → [1,1,h,w] or [1,h,w])"
    )
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.image.io import write_image
    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import vit

    dev = resolve_device(device)
    size = 32
    if args.image:
        chw = common.load_image_arg(args.image, size)
        print(f"image: {args.image} -> {chw.shape}")
    else:
        chw = common.synthetic_image(size, size, args.seed)

    if args.model:
        from rten_tpu_torch.runtime.session import Model

        m = Model.load_file(args.model, device=dev)
        out = m.run([chw[None]])[0].float()
        coarse = out.reshape(1, out.shape[-2], out.shape[-1])
        print(f"loaded {args.model}: depth grid {tuple(coarse.shape[1:])} through Model.run")
    else:
        cfg = vit.ViTConfig(
            image_size=size, patch_size=8, n_layers=2, n_heads=2,
            d_model=64, d_ff=128, use_cls_token=True,
        )
        params = vit.init_params(args.seed, cfg, device=dev)
        hidden = vit.encode(params, cfg, torch.from_numpy(chw[None]).to(dev))
        fm = vit.feature_map(hidden, cfg)  # [1, D, g, g]

        w_depth = torch.randn((fm.shape[1],), generator=torch.Generator().manual_seed(args.seed + 1)) * 0.3
        coarse = torch.einsum("bdhw,d->bhw", fm, w_depth.to(dev))
    depth = common.resize_bilinear(coarse, (size, size))[0]
    d = common.to_numpy(depth)
    d = (d - d.min()) / max(d.max() - d.min(), 1e-9)

    print(f"depth map {d.shape}: min 0.0 max 1.0 mean {d.mean():.3f}")
    hist, _ = np.histogram(d, bins=5, range=(0, 1))
    print("histogram (5 bins):", hist.tolist())
    if args.out:
        write_image(args.out, np.repeat(d[None], 3, 0).astype(np.float32))
        print(f"wrote {args.out}")
    if result is not None:
        result.update(depth=d)
    return 0


if __name__ == "__main__":
    common.run_main(main)
