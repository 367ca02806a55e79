"""The port's probabilistic Hough (`ops/hough.py`, the C++ of
`csrc/hough.cpp`) against OpenCV's `HoughLinesP`, which only this test
imports: whole outputs bit-equal, in order, on masks of every kind the
DeepLSD vectoriser meets, with the arguments it passes."""

import math

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from gluefactory_tpu_torch.models.lines.deeplsd import fields_from_lines  # noqa: E402
from gluefactory_tpu_torch.ops.hough import hough_lines_p  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs 6 workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# deeplsd.py's call: rho 1, theta pi / 180, threshold max(10, min_length // 2),
# minLineLength min_length, maxLineGap 4
ARGS = dict(rho=1.0, theta=math.pi / 180.0, threshold=10, minLineLength=15, maxLineGap=4)


def _cv2(mask, **kw):
    a = {**ARGS, **kw}
    out = cv2.HoughLinesP(mask, a["rho"], a["theta"], a["threshold"],
                          minLineLength=a["minLineLength"], maxLineGap=a["maxLineGap"])
    return np.zeros((0, 4), np.int32) if out is None else out.reshape(-1, 4)


def _port(mask, **kw):
    a = {**ARGS, **kw}
    return hough_lines_p(mask, a["rho"], a["theta"], a["threshold"], a["minLineLength"],
                         a["maxLineGap"])


def _blobs(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(3, 12))):
        cy, cx = rng.integers(0, [h, w])
        ry, rx = rng.integers(2, 12, 2)
        yy, xx = np.ogrid[:h, :w]
        m[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 255
    return m


def _drawn(rng, h, w, n):
    m = np.zeros((h, w), np.uint8)
    for _ in range(n):
        p = rng.integers(0, [w, h], (2, 2))
        cv2.line(m, tuple(map(int, p[0])), tuple(map(int, p[1])), 255, int(rng.integers(1, 4)))
    return m


def _gt_field_masks(rng, n):
    """df < 0.45 of GT fields of planted segments (the port's fields)."""
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(48, 200, 2))
        L = int(rng.integers(5, 40))
        lines = torch.from_numpy(rng.uniform(0, [w, h], (1, L, 2, 2)).astype(np.float32))
        df, _ = fields_from_lines(lines, None, h, w, 5.0)
        out.append(((df[0].numpy() < 0.45).astype(np.uint8) * 255))
    return out


def _masks():
    rng = np.random.default_rng(0)
    masks = [("empty", np.zeros((60, 80), np.uint8)), ("full", np.full((60, 80), 255, np.uint8)),
             ("full-odd", np.full((37, 53), 1, np.uint8)), ("one-row", _drawn(rng, 1, 97, 2)),
             ("one-column", np.full((83, 1), 255, np.uint8))]
    for i in range(8):
        h, w = (int(v) for v in rng.integers(20, 180, 2))
        masks.append((f"blobs{i}", _blobs(rng, h, w)))
    for i in range(6):
        h, w = (int(v) for v in rng.integers(20, 180, 2))
        m = (rng.random((h, w)) < rng.uniform(0.02, 0.4)).astype(np.uint8) * 255
        masks.append((f"noise{i}", m))
    for i, m in enumerate(_gt_field_masks(rng, 10)):
        masks.append((f"gt-field{i}", m))
    for i, (h, w) in enumerate([(33, 47), (101, 63), (127, 211), (255, 17), (19, 301)]):
        masks.append((f"odd{i}", _drawn(rng, h, w, 25)))
    return masks


MASKS = _masks()


def test_enough_masks_of_each_kind():
    assert len(MASKS) >= 30
    kinds = {name.rstrip("0123456789").split("-")[0] for name, _ in MASKS}
    assert {"empty", "full", "blobs", "noise", "gt", "odd"} <= kinds


@pytest.mark.parametrize("name,mask", MASKS, ids=[n for n, _ in MASKS])
def test_bit_equal_to_cv2(name, mask):
    want, got = _cv2(mask), _port(mask)
    assert got.dtype == np.int32 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_arguments_as_cv2_takes_them():
    """Other thresholds and gaps, and min_length / max_gap rounded half to
    even as cv2 rounds them."""
    rng = np.random.default_rng(1)
    masks = [m for name, m in MASKS if name.startswith(("gt-field", "odd"))][:6]
    for k, m in enumerate(masks):
        kw = dict(threshold=int(rng.integers(1, 30)), minLineLength=[0.5, 2.5, 7.0, 20.5, 31.0, 3.49][k],
                  maxLineGap=[0, 1.5, 2.5, 4, 9.7, 0.5][k])
        np.testing.assert_array_equal(_port(m, **kw), _cv2(m, **kw))


def test_threads_may_call_at_once():
    from concurrent.futures import ThreadPoolExecutor

    masks = [m for _, m in MASKS[-12:]]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(_port, masks))
    for m, g in zip(masks, got):
        np.testing.assert_array_equal(g, _port(m))


def test_bad_input_raises():
    with pytest.raises(ValueError, match="mask"):
        hough_lines_p(np.zeros((2, 3, 4), np.uint8), 1.0, 0.1, 10)
    with pytest.raises(RuntimeError, match="failed"):
        hough_lines_p(np.zeros((4, 4), np.uint8), 0.0, 0.1, 10)
