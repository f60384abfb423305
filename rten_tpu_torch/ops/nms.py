"""NonMaxSuppression: counterpart of ``rten_tpu/ops/nms.py``.

Data-dependent output shape → host (numpy) execution, interpret-mode only,
as in the JAX package; the result is a host int32 array [n, 3].
"""

from __future__ import annotations

import numpy as np

from rten_tpu_torch.ops.registry import CompileError, register, require_static


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    # boxes as [y1, x1, y2, x2] normalized to min/max order
    ay1, ax1, ay2, ax2 = a
    by1, bx1, by2, bx2 = b
    inter_h = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter_w = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    inter = inter_h * inter_w
    area_a = (ay2 - ay1) * (ax2 - ax1)
    area_b = (by2 - by1) * (bx2 - bx1)
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


@register("NonMaxSuppression", data_dependent=True)
def non_max_suppression(
    ctx, attrs, boxes, scores, max_output_boxes_per_class=None,
    iou_threshold=None, score_threshold=None,
):
    if ctx.mode != "eager":
        raise CompileError("NonMaxSuppression is interpret-mode only")
    boxes = np.asarray(require_static(boxes), dtype=np.float32)  # [batch, num_boxes, 4]
    scores = np.asarray(require_static(scores), dtype=np.float32)  # [batch, num_classes, num_boxes]
    max_out = int(require_static(max_output_boxes_per_class).item()) if max_output_boxes_per_class is not None else 0
    iou_thr = float(require_static(iou_threshold).item()) if iou_threshold is not None else 0.0
    score_thr = float(require_static(score_threshold).item()) if score_threshold is not None else -np.inf

    box_order = attrs.get("box_order", "top_left_bottom_right")
    if box_order == "center_width_height":
        cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
        boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=-1)
    else:
        # Normalize possibly-flipped coordinates to (min, max) per axis.
        y1 = np.minimum(boxes[..., 0], boxes[..., 2])
        y2 = np.maximum(boxes[..., 0], boxes[..., 2])
        x1 = np.minimum(boxes[..., 1], boxes[..., 3])
        x2 = np.maximum(boxes[..., 1], boxes[..., 3])
        boxes = np.stack([y1, x1, y2, x2], axis=-1)

    selected: list[tuple[int, int, int]] = []
    n_batch, n_classes, _ = scores.shape
    for bi in range(n_batch):
        for ci in range(n_classes):
            order = np.argsort(-scores[bi, ci])
            kept: list[int] = []
            for idx in order:
                if scores[bi, ci, idx] <= score_thr:
                    break
                if max_out and len(kept) >= max_out:
                    break
                if all(_iou(boxes[bi, idx], boxes[bi, k]) <= iou_thr for k in kept):
                    kept.append(int(idx))
            selected.extend((bi, ci, k) for k in kept)

    return np.asarray(selected, dtype=np.int32).reshape(-1, 3)
