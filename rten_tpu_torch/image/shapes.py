"""2-D geometry for detection/OCR post-processing (reference:
rten-imageproc/src/shapes.rs — Point, Rect, RotatedRect, Line, Polygon).
Coordinates are (y, x) like the reference (row-major image convention).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Point:
    y: float
    x: float

    def translate(self, dy: float, dx: float) -> "Point":
        return Point(self.y + dy, self.x + dx)

    def distance(self, other: "Point") -> float:
        return math.hypot(self.y - other.y, self.x - other.x)

    def as_tuple(self) -> tuple[float, float]:
        return (self.y, self.x)


@dataclasses.dataclass(frozen=True)
class Line:
    start: Point
    end: Point

    def length(self) -> float:
        return self.start.distance(self.end)

    def distance_to_point(self, p: Point) -> float:
        """Perpendicular distance from p to the infinite line (segment
        endpoints used when the projection falls outside)."""
        y0, x0 = p.y, p.x
        y1, x1 = self.start.y, self.start.x
        y2, x2 = self.end.y, self.end.x
        dy, dx = y2 - y1, x2 - x1
        seg_len_sq = dy * dy + dx * dx
        if seg_len_sq == 0:
            return p.distance(self.start)
        t = max(0.0, min(1.0, ((y0 - y1) * dy + (x0 - x1) * dx) / seg_len_sq))
        proj = Point(y1 + t * dy, x1 + t * dx)
        return p.distance(proj)


@dataclasses.dataclass(frozen=True)
class Rect:
    top: float
    left: float
    bottom: float
    right: float

    @classmethod
    def from_tlhw(cls, top, left, height, width) -> "Rect":
        return cls(top, left, top + height, left + width)

    @property
    def height(self) -> float:
        return self.bottom - self.top

    @property
    def width(self) -> float:
        return self.right - self.left

    def area(self) -> float:
        return max(0.0, self.height) * max(0.0, self.width)

    def center(self) -> Point:
        return Point((self.top + self.bottom) / 2, (self.left + self.right) / 2)

    def contains(self, p: Point) -> bool:
        return self.top <= p.y <= self.bottom and self.left <= p.x <= self.right

    def intersect(self, other: "Rect") -> "Rect":
        return Rect(
            max(self.top, other.top),
            max(self.left, other.left),
            min(self.bottom, other.bottom),
            min(self.right, other.right),
        )

    def union(self, other: "Rect") -> "Rect":
        return Rect(
            min(self.top, other.top),
            min(self.left, other.left),
            max(self.bottom, other.bottom),
            max(self.right, other.right),
        )

    def iou(self, other: "Rect") -> float:
        inter = self.intersect(other).area()
        union = self.area() + other.area() - inter
        return inter / union if union > 0 else 0.0

    def expand(self, dy: float, dx: float) -> "Rect":
        return Rect(self.top - dy, self.left - dx, self.bottom + dy, self.right + dx)

    def corners(self) -> list[Point]:
        return [
            Point(self.top, self.left),
            Point(self.top, self.right),
            Point(self.bottom, self.right),
            Point(self.bottom, self.left),
        ]


@dataclasses.dataclass(frozen=True)
class RotatedRect:
    """Oriented rectangle: center + (unit) up axis + extents
    (reference: shapes.rs RotatedRect)."""

    center: Point
    up_axis: tuple[float, float]  # (dy, dx), unit
    width: float
    height: float

    def corners(self) -> list[Point]:
        uy, ux = self.up_axis
        norm = math.hypot(uy, ux) or 1.0
        uy, ux = uy / norm, ux / norm
        # right axis = up rotated 90° clockwise
        ry, rx = ux, -uy
        hw, hh = self.width / 2, self.height / 2
        cy, cx = self.center.y, self.center.x
        return [
            Point(cy - uy * hh - ry * hw, cx - ux * hh - rx * hw),
            Point(cy - uy * hh + ry * hw, cx - ux * hh + rx * hw),
            Point(cy + uy * hh + ry * hw, cx + ux * hh + rx * hw),
            Point(cy + uy * hh - ry * hw, cx + ux * hh - rx * hw),
        ]

    def area(self) -> float:
        return self.width * self.height

    def bounding_rect(self) -> Rect:
        cs = self.corners()
        ys = [p.y for p in cs]
        xs = [p.x for p in cs]
        return Rect(min(ys), min(xs), max(ys), max(xs))


class Polygon:
    def __init__(self, points: list[Point] | np.ndarray):
        if isinstance(points, np.ndarray):
            points = [Point(float(y), float(x)) for y, x in points]
        self.points = list(points)

    def __len__(self) -> int:
        return len(self.points)

    def as_array(self) -> np.ndarray:
        return np.array([(p.y, p.x) for p in self.points], dtype=np.float32)

    def area(self) -> float:
        """Shoelace formula."""
        pts = self.as_array()
        if len(pts) < 3:
            return 0.0
        y = pts[:, 0]
        x = pts[:, 1]
        return 0.5 * abs(
            float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
        )

    def bounding_rect(self) -> Rect:
        pts = self.as_array()
        return Rect(
            float(pts[:, 0].min()), float(pts[:, 1].min()),
            float(pts[:, 0].max()), float(pts[:, 1].max()),
        )

    def contains(self, p: Point) -> bool:
        """Ray casting."""
        inside = False
        pts = self.points
        n = len(pts)
        for i in range(n):
            a, b = pts[i], pts[(i + 1) % n]
            if (a.y > p.y) != (b.y > p.y):
                x_int = a.x + (p.y - a.y) * (b.x - a.x) / (b.y - a.y)
                if p.x < x_int:
                    inside = not inside
        return inside


BoundingRect = Rect
