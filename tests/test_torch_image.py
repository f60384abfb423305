"""The port's image geometry and drawing (rten_tpu_torch.image: shapes,
contours, poly, drawing) against the JAX package's (rten_tpu.image): the
cases of tests/test_ctc_image_cli.py and seeded masks, point sets and
polygons, each run through both packages with the same inputs; the results
must be equal."""

import types

import numpy as np
import pytest

import rten_tpu.image as jimage
import rten_tpu.image.drawing as jdrawing
import rten_tpu.image.poly as jpoly
import rten_tpu_torch.image as timage
import rten_tpu_torch.image.drawing as tdrawing
import rten_tpu_torch.image.poly as tpoly


def pkg(image, poly, drawing):
    return types.SimpleNamespace(**{k: getattr(image, k) for k in image.__all__},
                                 simplify_polyline=poly.simplify_polyline, fill_polygon=drawing.fill_polygon,
                                 draw_line=drawing.draw_line)


PORT, JAX = pkg(timage, tpoly, tdrawing), pkg(jimage, jpoly, jdrawing)


def plain(v):
    """A package-neutral value: points, rects and polygons as tuples."""
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tolist())
    if hasattr(v, "points"):
        return ("polygon", plain(v.points))
    if hasattr(v, "__dataclass_fields__"):
        return (type(v).__name__, *[plain(getattr(v, f)) for f in v.__dataclass_fields__])
    return v


def pts(im, arr):
    return [im.Point(float(y), float(x)) for y, x in arr]


def rect_iou(im):
    a, b = im.Rect(0, 0, 10, 10), im.Rect(5, 5, 15, 15)
    return [a.iou(b), a.iou(im.Rect(20, 20, 30, 30)), a.intersect(b), a.union(b), a.expand(1, 2).corners(),
            a.center(), a.contains(im.Point(3, 4)), im.Rect.from_tlhw(1, 2, 3, 4)]


def polygon_area_contains(im):
    sq = im.Polygon([im.Point(0, 0), im.Point(0, 4), im.Point(4, 4), im.Point(4, 0)])
    return [sq.area(), sq.contains(im.Point(2, 2)), sq.contains(im.Point(5, 2)), sq.bounding_rect(),
            im.Line(im.Point(0, 0), im.Point(3, 4)).length(),
            im.Line(im.Point(0, 0), im.Point(0, 4)).distance_to_point(im.Point(2, 7))]


def contours_square(im):
    mask = np.zeros((10, 10), bool)
    mask[2:6, 3:8] = True
    c = im.find_contours(mask)
    return [c, [p.bounding_rect() for p in c]]


def contours_two(im):
    mask = np.zeros((10, 10), bool)
    mask[1:3, 1:3] = True
    mask[6:9, 5:9] = True
    return im.find_contours(mask)


def simplify_line(im):
    return im.simplify_polygon(im.Polygon([im.Point(0, i) for i in range(10)]), epsilon=0.5)


def hull(im):
    h = im.convex_hull([im.Point(0, 0), im.Point(0, 4), im.Point(4, 4), im.Point(4, 0), im.Point(2, 2)])
    return [h, h.area()]


def min_rect_diamond(im):
    rr = im.min_area_rect([im.Point(0, 1), im.Point(1, 2), im.Point(2, 1), im.Point(1, 0)])
    return [rr, rr.area(), rr.corners(), rr.bounding_rect()]


def drawing(im):
    img = np.zeros((10, 10), np.float32)
    im.fill_rect(img, im.Rect(2, 2, 4, 4), 1.0)
    img2 = np.zeros((10, 10), np.float32)
    im.draw_polygon(img2, im.Polygon([im.Point(0, 0), im.Point(0, 9), im.Point(9, 9), im.Point(9, 0)]))
    img3 = np.zeros((3, 12, 12), np.float32)
    im.stroke_rect(img3, im.Rect(1, 2, 8, 10), 0.5)
    im.draw_line(img3, im.Point(0, 0), im.Point(11, 7), 2.0)
    return [img, img2, img3]


def fill_triangle(im):
    img = np.zeros((12, 12), np.float32)
    im.fill_polygon(img, im.Polygon([im.Point(1, 1), im.Point(1, 10), im.Point(10, 1)]), 1.0)
    return img


def polyline_open(im):
    return im.simplify_polyline([im.Point(0, 0), im.Point(0.05, 1), im.Point(0, 2), im.Point(2, 2)], epsilon=0.2)


CASES = [rect_iou, polygon_area_contains, contours_square, contours_two, simplify_line, hull, min_rect_diamond,
         drawing, fill_triangle, polyline_open]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_cases_of_test_ctc_image_cli_match_jax(case):
    assert plain(case(PORT)) == plain(case(JAX))


def seeded_mask(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(8, 48)), int(rng.integers(8, 48))
    return rng.random((h, w)) > rng.uniform(0.3, 0.8)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_contours_and_polygons_match_jax(seed):
    """Seeded masks: every contour, its simplification, hull, min-area
    rectangle and area; seeded point clouds: hull and min-area rectangle;
    the polygons filled and stroked into images."""
    mask = seeded_mask(seed)
    rng = np.random.default_rng(seed + 50)
    cloud = rng.uniform(-20, 20, (int(rng.integers(3, 40)), 2))
    queries = rng.uniform(-25, 25, (20, 2))
    results = []
    for im in (PORT, JAX):
        out = []
        for c in im.find_contours(mask):
            out.append([c, c.area(), im.simplify_polygon(c, 1.0), c.bounding_rect()])
            if len(c) >= 3:
                out.append([im.convex_hull(c), im.min_area_rect(c)])
        p = pts(im, cloud)
        h = im.convex_hull(p)
        rr = im.min_area_rect(p)
        img = np.zeros((48, 48), np.float32)
        im.fill_polygon(img, im.Polygon(pts(im, np.abs(cloud) + 2)), 1.0)
        im.draw_polygon(img, h, 0.5)
        out.append([h, h.area(), rr, rr.corners(), im.simplify_polyline(p, 2.0), img,
                    [h.contains(q) for q in pts(im, queries)]])
        results.append(plain(out))
    assert results[0] == results[1]


def test_io_helpers_match_jax():
    rng = np.random.default_rng(2)
    img = rng.random((3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(timage.normalize_image(img), jimage.normalize_image(img))
    hwc = rng.standard_normal((5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.hwc_to_chw(hwc), jimage.hwc_to_chw(hwc))
    np.testing.assert_array_equal(timage.chw_to_hwc(img), jimage.chw_to_hwc(img))
    assert timage.__all__ == jimage.__all__
