"""Image pre- and post-processing (reference: rten-imageio + rten-imageproc),
the port's copy of ``rten_tpu/image``.

``io``: image file ⇄ CHW float tensor + ImageNet normalization
(reference: rten-imageio/src/lib.rs:26 normalize_image, read_image).
``shapes``/``contours``/``poly``/``drawing``: geometry and detection/OCR
post-processing (reference: rten-imageproc shapes.rs, contours.rs,
poly_algos.rs, drawing.rs). All host-side numpy; ``find_contours`` traces
with the native library (``rten_tpu_torch.native``) where it is available.
"""

from rten_tpu_torch.image.io import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    chw_to_hwc,
    hwc_to_chw,
    normalize_image,
    read_image,
    write_image,
)
from rten_tpu_torch.image.shapes import BoundingRect, Line, Point, Polygon, Rect, RotatedRect
from rten_tpu_torch.image.contours import find_contours
from rten_tpu_torch.image.poly import convex_hull, min_area_rect, simplify_polygon
from rten_tpu_torch.image.drawing import draw_polygon, fill_rect, stroke_rect

__all__ = [
    "IMAGENET_MEAN", "IMAGENET_STD", "normalize_image", "read_image",
    "write_image", "hwc_to_chw", "chw_to_hwc",
    "Point", "Rect", "RotatedRect", "Line", "Polygon", "BoundingRect",
    "find_contours", "simplify_polygon", "convex_hull", "min_area_rect",
    "draw_polygon", "fill_rect", "stroke_rect",
]
