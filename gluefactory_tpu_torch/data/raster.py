"""Filled shapes drawn into numpy images as OpenCV draws them (LINE_8, no
sub-pixel shift), so that the procedural training images need no cv2:

- `fill_rect`: `cv2.rectangle(..., thickness=-1)`, corners inclusive;
- `fill_circle`: `cv2.circle(..., thickness=-1)`, OpenCV's midpoint circle
  with a horizontal span per octant point;
- `fill_poly`: `cv2.fillPoly` of one contour: each edge drawn as an
  8-connected Bresenham line, then horizontal spans between the edges, the
  edge abscissas in 16.16 fixed point (slopes rounded down, the span's left
  end rounded half up and its right end half down).

Against cv2 on random shapes in a 640 x 480 image, rectangles and circles
agree on every pixel and triangles on all but 1e-5 of the pixels cv2 fills
(`tests/test_torch_homographies.py::test_raster_against_cv2`).
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
