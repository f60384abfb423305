"""YOLO-style object detection: grid head decode + NMS + box drawing.

The port's copy of ``examples/yolo.py`` (reference:
rten-examples/src/yolo.rs): image → backbone → per-cell (box, objectness,
class) predictions → confidence filter → NonMaxSuppression
(``ops.nms``, ≙ src/ops/non_max_suppression.rs) → boxes drawn with
``image.drawing`` (≙ rten-imageproc drawing.rs); on the card (``--cpu``:
on the host).

    python -m rten_tpu_torch.examples.yolo --demo [--out boxes.png]
    python -m rten_tpu_torch.examples.yolo --image street.png --model yolo.rten

``--model`` takes an exported .rten detector (the reference loads converted
ultralytics exports, yolo.rs): input [1, 3, H, W], output [1, N, 5+C] raw
per-candidate predictions — absolute-pixel (cx, cy, w, h), objectness
logit, class logits. The example applies sigmoid/softmax, NMS, and drawing.
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the selected
    ``(batch, class, box)`` rows, the ``boxes`` [N, 4] and ``scores``
    [N, C]."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--out", help="write detections over the image to this PNG")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--image", help="input image file (PNG/BMP/…)")
    p.add_argument("--model", help="detector as .rten ([1,3,H,W] → [1,N,5+C])")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.image.drawing import Rect, stroke_rect
    from rten_tpu_torch.image.io import write_image
    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.ops.nms import non_max_suppression
    from rten_tpu_torch.ops.registry import OpContext

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
        preds = torch.from_numpy(common.to_numpy(m.run([chw[None]])[0]))  # [1, N, 5+C]
        print(f"loaded {args.model}: {preds.shape[1]} candidates through Model.run")
        obj = torch.sigmoid(preds[..., 4:5])
        cls_p = torch.softmax(preds[..., 5:], dim=-1) * obj
        cxy, wh = preds[..., :2], preds[..., 2:4]
        boxes_xyxy = torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)
    else:
        boxes_xyxy, cls_p = _demo_head(chw, size, args.seed, dev)

    # ONNX NMS layout: boxes [B, N, 4] (y1,x1,y2,x2), scores [B, C, N].
    x1, y1, x2, y2 = torch.split(boxes_xyxy, 1, dim=-1)
    nms_boxes = torch.cat([y1, x1, y2, x2], dim=-1)
    scores = cls_p.permute(0, 2, 1)
    sel = non_max_suppression(
        OpContext(),
        {"box_order": "corners"},
        nms_boxes.numpy(),
        scores.numpy(),
        np.int64(10),
        np.float32(args.iou),
        np.float32(args.conf),
    )
    sel = np.asarray(sel)  # [n, 3] (batch, class, box)
    print(f"{len(sel)} detections (conf>{args.conf}, iou<{args.iou})")
    boxes_np = boxes_xyxy.numpy()[0]
    scores_np = cls_p.numpy()[0]
    for bi, ci, ni in sel:
        bx = boxes_np[ni]
        print(
            f"  class {ci}  score {scores_np[ni, ci]:.3f}  "
            f"box ({bx[0]:.0f},{bx[1]:.0f})-({bx[2]:.0f},{bx[3]:.0f})"
        )

    if args.out:
        canvas = (chw.copy() * 255).astype(np.uint8)
        for bi, ci, ni in sel:
            x1_, y1_, x2_, y2_ = boxes_np[ni]
            r = Rect(
                int(max(0, y1_)), int(max(0, x1_)),
                int(min(size - 1, y2_)), int(min(size - 1, x2_)),
            )
            for ch in range(3):
                stroke_rect(canvas[ch], r, 255 if ch == ci % 3 else 0)
        write_image(args.out, canvas.astype(np.float32) / 255.0)
        print(f"wrote {args.out}")
    if result is not None:
        result.update(selected=sel, boxes=boxes_np, scores=scores_np)
    return 0


def _demo_head(chw, size, seed, dev):
    """Seeded tiny backbone + detection head (no checkpoint); host f32
    boxes [1, N, 4] (x1, y1, x2, y2) and class scores [1, N, C]. The head
    is drawn from a ``torch.Generator`` seeded by ``seed + 1`` (the JAX
    app draws its own with ``jax.random``: the two heads differ)."""
    import numpy as np
    import torch

    from rten_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig(block="basic", stage_sizes=(1, 1), width=8, num_classes=8)
    params = resnet.init_params(seed, cfg, device=dev)
    feats = common.to_numpy(resnet.forward(params, cfg, torch.from_numpy(chw[None]).to(dev), features=True))
    feats = torch.from_numpy(feats)
    b, c, g = feats.shape[0], feats.shape[1], feats.shape[2]

    n_classes = 3
    w_head = torch.randn((c, 5 + n_classes), generator=torch.Generator().manual_seed(seed + 1)) * 0.5
    head = torch.einsum("bcgh,co->bgho", feats, w_head).reshape(b, g * g, 5 + n_classes)

    # Decode: cell-relative center + size, sigmoid objectness/class scores.
    cell = size / g
    gy, gx = np.mgrid[0:g, 0:g].astype(np.float32)
    cxy = torch.sigmoid(head[..., 0:2]) + torch.from_numpy(np.stack([gx.ravel(), gy.ravel()], -1)[None])
    wh = torch.exp(torch.clamp(head[..., 2:4], -4, 2))
    boxes_xyxy = torch.cat([(cxy - wh / 2) * cell, (cxy + wh / 2) * cell], dim=-1)
    obj = torch.sigmoid(head[..., 4:5])
    cls_p = torch.softmax(head[..., 5:], dim=-1) * obj  # [B, N, n_classes]
    return boxes_xyxy, cls_p


if __name__ == "__main__":
    common.run_main(main)
