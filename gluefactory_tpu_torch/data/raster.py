"""Filled shapes drawn into numpy images as OpenCV draws them (LINE_8), so
that the procedural training images and the shading need no cv2:

- `fill_rect`: `cv2.rectangle(..., thickness=-1)`, corners inclusive;
- `fill_circle`: `cv2.circle(..., thickness=-1)`, OpenCV's midpoint circle
  with a horizontal span per octant point;
- `fill_poly`: `cv2.fillPoly` of one contour: each edge drawn as an
  8-connected Bresenham line, then horizontal spans between the edges, the
  edge abscissas in 16.16 fixed point (slopes rounded down, the span's left
  end rounded half up and its right end half down);
- `fill_ellipse`: `cv2.ellipse(..., 0, 360, color, -1)`: OpenCV's
  `ellipse2Poly` vertices in 16.16 fixed point, filled as its
  `fillConvexPoly` fills them at that shift (the edges by its sub-pixel
  line, clipped to the image).

Against cv2 on random shapes in a 640 x 480 image, rectangles and circles
agree on every pixel and triangles on all but 1e-5 of the pixels cv2 fills
(`tests/test_torch_homographies.py::test_raster_against_cv2`); ellipses on
every pixel (`tests/test_torch_augmentations.py::test_ellipse_mask_bit_equal`).
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
HALF = 1 << (XY_SHIFT - 1)


def fill_rect(img: np.ndarray, pt1, pt2, color) -> None:
    h, w = img.shape[:2]
    x0, x1 = sorted((pt1[0], pt2[0]))
    y0, y1 = sorted((pt1[1], pt2[1]))
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def _spans(img: np.ndarray, ys, x1s, x2s, color) -> None:
    """Fill the inclusive spans [x1, x2] of rows ys, clipped to the image."""
    h, w = img.shape[:2]
    ys, x1s, x2s = (np.asarray(a, np.int64) for a in (ys, x1s, x2s))
    keep = (ys >= 0) & (ys < h) & (x1s <= x2s) & (x2s >= 0) & (x1s < w)
    ys, x1s, x2s = ys[keep], np.maximum(x1s[keep], 0), np.minimum(x2s[keep], w - 1)
    if ys.size == 0:
        return
    cols = np.arange(x1s.min(), x2s.max() + 1)
    inside = (cols[None] >= x1s[:, None]) & (cols[None] <= x2s[:, None])
    rows = np.broadcast_to(ys[:, None], inside.shape)[inside]
    img[rows, np.broadcast_to(cols[None], inside.shape)[inside]] = color


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    ys, x1s, x2s = [], [], []
    while dx >= dy:
        ys += [cy - dy, cy + dy, cy - dx, cy + dx]
        x1s += [cx - dx, cx - dx, cx - dy, cx - dy]
        x2s += [cx + dx, cx + dx, cx + dy, cx + dy]
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    _spans(img, ys, x1s, x2s, color)


def line8(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's 8-connected line from p1 to p2, ends included: Bresenham from
    the left end, the minor coordinate after k major steps being
    ceil((2 dy k - dx) / (2 dx))."""
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = -1 if y2 < y1 else 1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    k = np.arange(dx + 1)
    minor = -((dx - 2 * dy * k) // (2 * dx)) if dx else np.zeros(1, np.int64)
    xs, ys = (x1 + minor, y1 + sy * k) if steep else (x1 + k, y1 + sy * minor)
    h, w = img.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def fill_poly(img: np.ndarray, pts, color) -> None:
    n = len(pts)
    edges = []
    for i in range(n):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        line8(img, (x0, y0), (x1, y1), color)
        if y0 == y1:
            continue
        if y0 > y1:
            x0, y0, x1, y1 = x1, y1, x0, y0
        # abscissa at y0 and slope per row, 16.16 fixed point
        edges.append((y0, y1, (x0 << XY_SHIFT) + HALF, ((x1 - x0) << XY_SHIFT) // (y1 - y0)))
    if len(edges) < 2:
        return
    ys = np.arange(min(e[0] for e in edges), min(max(e[1] for e in edges), img.shape[0]))
    xs = np.full((len(edges), ys.size), np.iinfo(np.int64).max)
    for j, (y0, y1, x, dx) in enumerate(edges):
        on = (ys >= y0) & (ys < y1)
        xs[j, on] = x + (ys[on] - y0) * dx
    xs = np.sort(xs, axis=0)
    for a in range(0, len(edges) - 1, 2):
        ok = xs[a + 1] != np.iinfo(np.int64).max
        _spans(img, ys[ok], xs[a, ok] >> XY_SHIFT, (xs[a + 1, ok] - 1) >> XY_SHIFT, color)


# ---------------------------------------------------------------------------
# filled ellipses: `cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)`
# ---------------------------------------------------------------------------

XY_ONE = 1 << XY_SHIFT
# OpenCV's sine table, sin(k degrees) for k in 0..450, to 7 decimals in float32
SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32).astype(np.float64)


def _cdiv(a: int, b: int) -> int:
    """C's integer division, rounding toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1, y1, x2, y2):
    """OpenCV's `clipLine` on 16.16 fixed-point ends: (inside, x1, y1, x2, y2)."""
    right, bottom = (w << XY_SHIFT) - 1, (h << XY_SHIFT) - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line8_subpixel(w: int, h: int, p1, p2) -> list:
    """The pixels of OpenCV's `Line2` in a w x h image: the 8-connected line
    between 16.16 fixed-point ends, clipped to the image first; the far
    end's pixel, then one pixel a step along the major axis from the near
    end, the minor coordinate advanced by the fixed-point slope. (Python
    integers: a polygon's edges are a few pixels each.)"""
    inside, x1, y1, x2, y2 = _clip_line(w, h, *p1, *p2)
    if not inside:
        return []
    major_x = abs(x2 - x1) > abs(y2 - y1)
    if (x2 - x1 if major_x else y2 - y1) < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    pts = [((x2 + HALF) >> XY_SHIFT, (y2 + HALF) >> XY_SHIFT)]
    if major_x:
        step, x, y = _cdiv(dy << XY_SHIFT, abs(dx) | 1), (x1 + HALF) >> XY_SHIFT, y1 + HALF
        for _ in range(dx // XY_ONE + 1):
            pts.append((x, y >> XY_SHIFT))
            x, y = x + 1, y + step
    else:
        step, x, y = _cdiv(dx << XY_SHIFT, abs(dy) | 1), x1 + HALF, (y1 + HALF) >> XY_SHIFT
        for _ in range(dy // XY_ONE + 1):
            pts.append((x >> XY_SHIFT, y))
            x, y = x + step, y + 1
    return pts


def fill_convex_poly_subpixel(img: np.ndarray, pts, color) -> None:
    """`cv2.fillConvexPoly` of 16.16 fixed-point vertices (LINE_8, shift
    16): every edge drawn by `line8_subpixel`, then one span a row between
    the two edges walked down from the top vertex, each edge's abscissa
    starting at its upper vertex and stepping by its rounded slope."""
    h, w = img.shape[:2]
    n = len(pts)
    edge = np.array([p for i in range(n) for p in line8_subpixel(w, h, pts[i - 1], pts[i])],
                    np.int64).reshape(-1, 2)
    keep = (edge[:, 0] >= 0) & (edge[:, 0] < w) & (edge[:, 1] >= 0) & (edge[:, 1] < h)
    img[edge[keep, 1], edge[keep, 0]] = color
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    xmin, xmax = (min(xs) + HALF) >> XY_SHIFT, (max(xs) + HALF) >> XY_SHIFT
    ymin, ymax = (min(ys) + HALF) >> XY_SHIFT, (max(ys) + HALF) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    imin = ys.index(min(ys))
    # per edge walker: [vertex index, direction, x, dx, y where it ends]
    edges = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    left_to_walk = n
    rows, x1s, x2s = [], [], []
    y = ymin
    while True:
        for e in edges:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % n
            while True:
                left_to_walk -= 1
                if left_to_walk < 0:
                    break
                ty = (pts[idx][1] + HALF) >> XY_SHIFT
                if ty > y:
                    xs0, xe = pts[idx0][0], pts[idx][0]
                    e[:] = [idx, e[1], xs0, _cdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y)), ty]
                    break
                idx0, idx = idx, (idx + e[1]) % n
        if left_to_walk < 0:
            break
        if y >= 0:
            a, b = sorted((edges[0][2], edges[1][2]))
            rows.append(y)
            x1s.append((a + HALF) >> XY_SHIFT)
            x2s.append((b + HALF) >> XY_SHIFT)
        for e in edges:
            e[2] += e[3]
        y += 1
        if y > ymax:
            break
    _spans(img, rows, x1s, x2s, color)


def fill_ellipse(img: np.ndarray, center, axes, angle: float, color) -> None:
    """`cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)` with
    integer center and axes: OpenCV's `ellipse2Poly` (the angle rounded to
    a degree, one vertex every `delta` degrees, 5 for axes of 15 pixels and
    more, from its sine table) in 16.16 fixed point, the vertices rounded
    and repeats dropped, then `fill_convex_poly_subpixel`."""
    cx, cy = (int(c) << XY_SHIFT for c in center)
    ax, ay = (abs(int(a)) << XY_SHIFT for a in axes)
    delta = (max(ax, ay) + HALF) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    angle = int(np.rint(angle)) % 360
    alpha, beta = SIN_TABLE[450 - angle], SIN_TABLE[angle]
    deg = np.minimum(np.arange(0, 360 + delta, delta), 360)
    x, y = ax * SIN_TABLE[450 - deg], ay * SIN_TABLE[deg]
    px = np.rint(cx + x * alpha - y * beta).astype(np.int64)
    py = np.rint(cy + x * beta + y * alpha).astype(np.int64)
    keep = np.ones(px.size, bool)
    keep[1:] = (px[1:] != px[:-1]) | (py[1:] != py[:-1])
    pts = list(zip(px[keep].tolist(), py[keep].tolist()))
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    fill_convex_poly_subpixel(img, pts, color)
