"""Simple raster drawing (reference: rten-imageproc/src/drawing.rs —
polygon stroke/fill, rects) for visualizing detection/OCR outputs."""

from __future__ import annotations

import numpy as np

from rten_tpu_torch.image.shapes import Point, Polygon, Rect


def draw_line(img: np.ndarray, a: Point, b: Point, value=1.0) -> None:
    """Bresenham line on a 2-D (or leading-channel) image, in place."""
    y0, x0, y1, x1 = int(round(a.y)), int(round(a.x)), int(round(b.y)), int(round(b.x))
    dy = abs(y1 - y0)
    dx = abs(x1 - x0)
    sy = 1 if y0 < y1 else -1
    sx = 1 if x0 < x1 else -1
    err = dx - dy
    h, w = img.shape[-2:]
    while True:
        if 0 <= y0 < h and 0 <= x0 < w:
            img[..., y0, x0] = value
        if y0 == y1 and x0 == x1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy


def draw_polygon(img: np.ndarray, poly: Polygon, value=1.0) -> None:
    pts = poly.points
    for i in range(len(pts)):
        draw_line(img, pts[i], pts[(i + 1) % len(pts)], value)


def stroke_rect(img: np.ndarray, rect: Rect, value=1.0) -> None:
    draw_polygon(img, Polygon(rect.corners()), value)


def fill_rect(img: np.ndarray, rect: Rect, value=1.0) -> None:
    h, w = img.shape[-2:]
    t = max(0, int(round(rect.top)))
    l = max(0, int(round(rect.left)))
    b = min(h, int(round(rect.bottom)) + 1)
    r = min(w, int(round(rect.right)) + 1)
    img[..., t:b, l:r] = value


def fill_polygon(img: np.ndarray, poly: Polygon, value=1.0) -> None:
    """Scanline polygon fill, in place (reference: drawing.rs FillIter /
    Polygon::fill_iter — used to rasterize detection masks)."""
    pts = [(p.y, p.x) for p in poly.points]
    if len(pts) < 3:
        return
    h, w = img.shape[-2:]
    ys = [y for y, _ in pts]
    y_lo = max(0, int(np.floor(min(ys))))
    y_hi = min(h - 1, int(np.ceil(max(ys))))
    n = len(pts)
    for y in range(y_lo, y_hi + 1):
        xs: list[float] = []
        for i in range(n):
            (y0, x0), (y1, x1) = pts[i], pts[(i + 1) % n]
            if y0 == y1:
                continue
            lo, hi = (y0, y1) if y0 < y1 else (y1, y0)
            # half-open rule [lo, hi) avoids double-counting shared vertices
            if lo <= y < hi:
                xs.append(x0 + (y - y0) * (x1 - x0) / (y1 - y0))
        xs.sort()
        for a, b in zip(xs[0::2], xs[1::2]):
            l = max(0, int(np.ceil(a)))
            r = min(w - 1, int(np.floor(b)))
            if l <= r:
                img[..., y, l : r + 1] = value
