"""Polygon algorithms (reference: rten-imageproc/src/poly_algos.rs —
simplify_polygon (Douglas-Peucker), convex_hull (Andrew monotone chain),
min_area_rect (rotating calipers over the hull)).
"""

from __future__ import annotations

import math

import numpy as np

from rten_tpu_torch.image.shapes import Line, Point, Polygon, RotatedRect


def simplify_polygon(poly: Polygon, epsilon: float) -> Polygon:
    """Douglas-Peucker simplification: drop points closer than ``epsilon`` to
    the chord."""
    pts = poly.points
    if len(pts) < 3:
        return Polygon(list(pts))

    def rec(lo: int, hi: int, keep: set[int]) -> None:
        line = Line(pts[lo], pts[hi])
        max_d = -1.0
        max_i = -1
        for i in range(lo + 1, hi):
            d = line.distance_to_point(pts[i])
            if d > max_d:
                max_d, max_i = d, i
        if max_d > epsilon:
            keep.add(max_i)
            rec(lo, max_i, keep)
            rec(max_i, hi, keep)

    keep = {0, len(pts) - 1}
    rec(0, len(pts) - 1, keep)
    return Polygon([pts[i] for i in sorted(keep)])


def convex_hull(points: list[Point] | Polygon) -> Polygon:
    """Andrew's monotone chain; counter-clockwise hull."""
    if isinstance(points, Polygon):
        points = points.points
    pts = sorted(set((p.x, p.y) for p in points))
    if len(pts) <= 2:
        return Polygon([Point(y, x) for x, y in pts])

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list = []
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    hull = lower[:-1] + upper[:-1]
    return Polygon([Point(y, x) for x, y in hull])


def min_area_rect(points: list[Point] | Polygon) -> RotatedRect:
    """Minimum-area oriented bounding rectangle via rotating calipers: the
    optimal rectangle has one side collinear with a hull edge."""
    hull = convex_hull(points)
    pts = hull.as_array()  # (y, x)
    n = len(pts)
    if n == 0:
        return RotatedRect(Point(0, 0), (1.0, 0.0), 0.0, 0.0)
    if n == 1:
        return RotatedRect(Point(*pts[0]), (1.0, 0.0), 0.0, 0.0)

    best = None
    for i in range(n):
        a = pts[i]
        b = pts[(i + 1) % n]
        edge = b - a
        norm = math.hypot(*edge)
        if norm == 0:
            continue
        uy, ux = edge / norm  # edge direction
        # perpendicular
        py, px = -ux, uy
        proj_e = pts[:, 0] * uy + pts[:, 1] * ux
        proj_p = pts[:, 0] * py + pts[:, 1] * px
        w = float(proj_e.max() - proj_e.min())
        h = float(proj_p.max() - proj_p.min())
        area = w * h
        if best is None or area < best[0]:
            ce = (proj_e.max() + proj_e.min()) / 2
            cp = (proj_p.max() + proj_p.min()) / 2
            center = Point(ce * uy + cp * py, ce * ux + cp * px)
            best = (area, center, (py, px), w, h)

    _, center, up, w, h = best
    return RotatedRect(center, up, w, h)


def simplify_polyline(points: list[Point], epsilon: float) -> list[Point]:
    """Douglas-Peucker over an OPEN polyline (reference:
    poly_algos.rs simplify_polyline — simplify_polygon's non-closing
    counterpart, used for stroke paths)."""
    if len(points) < 3:
        return list(points)
    return list(simplify_polygon(Polygon(list(points)), epsilon).points)
