"""Promptable segmentation (Segment-Anything-style).

The port's copy of ``examples/segment_anything.py`` (reference:
rten-examples/src/segment_anything.rs): image → ViT image encoder (run
once) → point prompt embedding → mask head → binary mask → contour
extraction + polygon simplification with ``image.contours`` / ``poly`` (≙
rten-imageproc contours.rs / poly_algos.rs, the reference's mask
post-processing toolkit); on the card (``--cpu``: on the host).

    python -m rten_tpu_torch.examples.segment_anything --demo --point 40,20
    python -m rten_tpu_torch.examples.segment_anything --image cat.png --model sam_enc.rten

``--model`` takes an exported .rten SAM-class image encoder (the reference
loads converted SAM exports, segment_anything.rs): input [1, 3, H, W],
output patch embeddings [1, D, g, g]; the prompt-similarity mask head and
contour post-processing run on the embeddings, as in the demo.
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the ``mask`` [H, W],
    the ``mask_logits`` and each printed contour's vertex count
    (``vertices``)."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--point", default="40,20", help="prompt point as x,y")
    p.add_argument("--image", help="input image file (PNG/BMP/…)")
    p.add_argument(
        "--model", help="SAM image encoder as .rten ([1,3,H,W] → [1,D,g,g])"
    )
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.image.contours import find_contours
    from rten_tpu_torch.image.poly import simplify_polygon
    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import vit

    dev = resolve_device(device)
    size = 32
    px, py = (int(v) for v in args.point.split(","))
    if args.image:
        chw = common.load_image_arg(args.image, size)
        print(f"image: {args.image} -> {chw.shape}")
    else:
        chw = common.synthetic_image(size, size, args.seed)

    if args.model:
        from rten_tpu_torch.runtime.session import Model

        m = Model.load_file(args.model, device=dev)
        fm = m.run([chw[None]])[0].float()
        print(
            f"loaded {args.model}: embeddings {tuple(fm.shape)} through Model.run"
        )
    else:
        cfg = vit.ViTConfig(
            image_size=size, patch_size=4, n_layers=2, n_heads=2,
            d_model=64, d_ff=128, use_cls_token=False,
        )
        params = vit.init_params(args.seed, cfg, device=dev)
        hidden = vit.encode(params, cfg, torch.from_numpy(chw[None]).to(dev))
        fm = vit.feature_map(hidden, cfg)  # [1, D, g, g]
    g = fm.shape[-1]

    # Point prompt → the prompt token is the image embedding at that location;
    # mask logits = similarity of every patch embedding to the prompt token
    # (the SAM decoder reduced to its dot-product core).
    # An index past the grid takes its last row or column, as JAX's
    # indexing clamps (the default point 40,20 lies outside a 32² image).
    prompt = fm[0, :, min(py * g // size, fm.shape[-2] - 1), min(px * g // size, g - 1)]  # [D]
    sim = torch.einsum("dhw,d->hw", fm[0], prompt) / float(np.sqrt(fm.shape[1] * 1.0))
    mask_logits = common.resize_bilinear(sim, (size, size))
    # jnp.percentile's default (linear) is torch.quantile's.
    mask = common.to_numpy(mask_logits > torch.quantile(mask_logits, 0.75)).astype(np.uint8)

    print(f"mask covers {mask.sum()} px ({100.0 * mask.mean():.1f}%)")
    contours = find_contours(mask)
    print(f"{len(contours)} contour(s)")
    vertices = []
    for i, contour in enumerate(contours[:3]):
        poly = simplify_polygon(contour, epsilon=1.5)
        pts = getattr(poly, "points", poly)
        vertices.append(len(pts))
        print(f"  contour {i}: {len(pts)} vertices after simplification")
    if result is not None:
        result.update(mask=mask, mask_logits=common.to_numpy(mask_logits), vertices=vertices)
    return 0


if __name__ == "__main__":
    common.run_main(main)
