"""Contour extraction from binary masks (reference:
rten-imageproc/src/contours.rs find_contours — Suzuki-Abe style border
following; here the outer-borders-only variant the detection examples use).
A copy of ``rten_tpu/image/contours.py``; the native tracer runs wherever
the library is available.
"""

from __future__ import annotations

import numpy as np

from rten_tpu_torch.image.shapes import Point, Polygon

# 8-connected neighborhood in clockwise order starting east.
_NEIGHBORS = [(0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1)]


def find_contours(mask: np.ndarray) -> list[Polygon]:
    """Outer borders of connected components in a binary mask, as polygons of
    (y, x) pixel points in traversal order."""
    from rten_tpu_torch.native.bindings import find_contours_native

    mask = np.asarray(mask) != 0
    native = find_contours_native(mask)  # None only without a C++ compiler
    if native is not None:
        return [
            Polygon([Point(float(y), float(x)) for y, x in pts]) for pts in native
        ]
    h, w = mask.shape
    visited = np.zeros_like(mask, dtype=bool)
    contours: list[Polygon] = []

    padded = np.zeros((h + 2, w + 2), dtype=bool)
    padded[1:-1, 1:-1] = mask

    for y in range(h):
        for x in range(w):
            if not mask[y, x] or visited[y, x]:
                continue
            # Border start: foreground pixel whose west neighbor is
            # background (every component's leftmost-in-row pixel is on its
            # border, so re-traces are suppressed by the visited mark).
            if x > 0 and mask[y, x - 1]:
                continue
            contour = _trace_border(padded, y + 1, x + 1)
            for py, px in contour:
                visited[py - 1, px - 1] = True
            contours.append(
                Polygon([Point(float(py - 1), float(px - 1)) for py, px in contour])
            )
    return contours


def _trace_border(mask: np.ndarray, y0: int, x0: int) -> list[tuple[int, int]]:
    """Moore neighborhood border following from the start pixel, entering
    from the west."""
    contour = [(y0, x0)]
    # direction index of the backtrack (we came from the west → start search
    # from west, clockwise)
    prev_dir = 4  # west
    y, x = y0, x0
    while True:
        found = False
        for i in range(1, 9):
            d = (prev_dir + i) % 8
            dy, dx = _NEIGHBORS[d]
            ny, nx = y + dy, x + dx
            if mask[ny, nx]:
                # backtrack direction = direction pointing back to (y, x)
                prev_dir = (d + 4) % 8
                y, x = ny, nx
                found = True
                break
        if not found:
            break  # isolated pixel
        if (y, x) == (y0, x0) and len(contour) > 1:
            break
        contour.append((y, x))
        if len(contour) > mask.size:
            break  # safety
    return contour
