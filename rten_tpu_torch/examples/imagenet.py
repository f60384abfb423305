"""ImageNet classification with a ResNet.

The port's copy of ``examples/imagenet.py`` (reference:
rten-examples/src/imagenet.rs, preprocessing at :56-100): image → CHW f32 →
ImageNet mean/std normalization → ResNet → softmax top-5, on the card
(``--cpu``: on the host).

    python -m rten_tpu_torch.examples.imagenet --demo [--image path.png]
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the run's ``probs``
    and ``top`` classes."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--image", help="image file (PNG/BMP); synthetic if omitted")
    p.add_argument(
        "--model",
        help="real weights: .npz of a torchvision resnet18/resnet50 state "
        "dict (BN folded at load, models/resnet.load_torchvision_state_dict);"
        " --demo uses seeded weights",
    )
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.image.io import IMAGENET_MEAN, IMAGENET_STD, normalize_image, read_image
    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import resnet

    dev = resolve_device(device)
    if args.image:
        chw = read_image(args.image)
    else:
        chw = common.synthetic_image(64, 64, args.seed)
    chw = normalize_image(chw, IMAGENET_MEAN, IMAGENET_STD)

    if args.model:
        state = common.load_state_npz(args.model)
        # resnet50 blocks have conv3 (bottleneck); resnet18 does not.
        cfg = (
            resnet.RESNET50
            if "layer1.0.conv3.weight" in state
            else resnet.RESNET18
        )
        n_cls = state["fc.weight"].shape[0]
        if n_cls != cfg.num_classes:
            import dataclasses

            cfg = dataclasses.replace(cfg, num_classes=n_cls)
        print(f"loaded {args.model}: {cfg.block} blocks, {n_cls} classes")
        params = resnet.load_torchvision_state_dict(state, cfg, device=dev)
    else:
        cfg = resnet.ResNetConfig(
            block="basic", stage_sizes=(1, 1, 1, 1), width=16, num_classes=10
        )
        params = resnet.init_params(args.seed, cfg, device=dev)
    logits = resnet.forward(params, cfg, torch.from_numpy(chw[None]).to(dev))
    probs = common.to_numpy(torch.softmax(logits.float(), -1))[0]
    top = np.argsort(probs)[::-1][:5]
    for rank, cls in enumerate(top, 1):
        print(f"top-{rank}: class {cls}  p={probs[cls]:.4f}")
    if result is not None:
        result.update(probs=probs, top=[int(c) for c in top])
    return 0


if __name__ == "__main__":
    common.run_main(main)
