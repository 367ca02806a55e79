"""The eval slice's data modules against the JAX package on the CPU:
`ImagePreprocessor` over the sides and options, `resize_image(..., "area")`
against cv2's INTER_AREA through JAX's `resize_image`, `read_image` in grey,
and HPatches items on a fabricated layout.

Tolerances: downsampling by `area` bit-equal to cv2 at integer and
non-integer scales (the 2 x 2 block mean of 1 and 4 channels included);
`area` upsampling within 2 float32 ulps of 1 (the interpolation is computed
in float64 as `linear` is); grey reads bit-equal but for 16-bit colour PNGs
(1 level: libpng converts before dropping the low byte); preprocessed images
and HPatches items equal to JAX's.
"""

import cv2
import numpy as np
import pytest

from gluefactory_tpu.data import preprocess as J
from gluefactory_tpu_torch.data import preprocess as P

EPS = np.finfo(np.float32).eps


@pytest.mark.parametrize("src,dst,c", [
    ((750, 1000), (480, 640), 3),   # HPatches at 480 on the short side
    ((600, 800), (480, 640), 1),
    ((37, 53), (20, 31), 3),
    ((37, 53), (20, 53), 3),        # one axis kept
    ((91, 77), (13, 11), 3),        # integer scale 7
    ((40, 60), (20, 30), 1),        # 2 x 2, the SIMD body and its tail
    ((40, 62), (20, 31), 4),
    ((40, 60), (20, 30), 2),
    ((48, 64), (12, 16), 3),        # 4 x 4
    ((40, 60), (20, 12), 1),        # 2 x 5
])
def test_area_downsampling_bit_equal_to_cv2(src, dst, c):
    img = np.random.default_rng(src[0] * c).random(src + (c,)).astype(np.float32)
    got, gs = P.resize_image(img, dst[::-1], "area")
    want, ws = J.resize_image(img, dst[::-1], "area")
    assert got.shape == want.shape == dst + (c,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("src,dst", [((37, 53), (40, 60)), ((37, 53), (37, 60)),
                                     ((20, 30), (20, 31))])
def test_area_upsampling(src, dst):
    img = np.random.default_rng(1).random(src + (3,)).astype(np.float32)
    got, _ = P.resize_image(img, dst[::-1], "area")
    want, _ = J.resize_image(img, dst[::-1], "area")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2 * EPS


CONFS = [
    {"resize": 480, "side": "short"},
    {"resize": 480, "side": "long"},
    {"resize": 100, "side": "vert"},
    {"resize": 90, "side": "horz"},
    {"resize": 64, "side": "short", "edge_divisible_by": 8},
    {"resize": 64, "side": "long", "square_pad": True},
    {"resize": 50, "side": "short", "pad_to_multiple": 16},
    {"resize": 50, "side": "short", "antialias": False},
    {"resize": None},
    {"resize": 300, "side": "long"},
]


@pytest.mark.parametrize("conf", CONFS, ids=[str(i) for i in range(len(CONFS))])
@pytest.mark.parametrize("shape", [(150, 200, 3), (201, 99, 1)])
def test_image_preprocessor_equals_jax(conf, shape):
    """Downsampled with antialias: `area`, bit-equal; otherwise `linear`
    (upsampling, or antialias off), within 2 ulps of 1."""
    img = np.random.default_rng(shape[0]).random(shape).astype(np.float32)
    pre = P.ImagePreprocessor(conf)
    got, want = pre(img), J.ImagePreprocessor(conf)(img)
    nw, nh = pre.target_size(*shape[:2])
    linear = (nw, nh) != shape[1::-1] and not (pre.conf.antialias and (nw < shape[1] or nh < shape[0]))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if linear and k == "image":
            assert np.abs(got[k] - want[k]).max() <= 2 * EPS
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_read_image_grayscale(tmp_path):
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_torch_preprocess import WRITERS

    for kind, (name, write) in WRITERS.items():
        path = tmp_path / kind / name
        path.parent.mkdir()
        write(path)
        got, want = P.read_image(path, grayscale=True), J.read_image(path, grayscale=True)
        assert got.shape == want.shape and got.dtype == np.float32 and got.shape[-1] == 1, kind
        if kind == "png16":
            assert np.abs(got - want).max() <= 1.5 / 255, kind
        else:
            np.testing.assert_array_equal(got, want, err_msg=kind)


def _write_hpatches(root, seed=0, size=(200, 150), pairs=5, seqs=("i_fake1", "v_fake2", "i_dc")):
    """An HPatches layout with known homographies, as the JAX package's own
    test writes it; `i_dc` is one of the scenes left out."""
    rng = np.random.default_rng(seed)
    for s, seq in enumerate(seqs):
        d = root / seq
        d.mkdir(parents=True)
        img = (rng.random(size[::-1] + (3,)) * 255).astype(np.uint8)
        img = cv2.GaussianBlur(img, (0, 0), 2)
        cv2.imwrite(str(d / "1.ppm"), img[..., ::-1])
        for q in range(2, 2 + pairs):
            H = np.eye(3)
            H[:2, 2] = rng.uniform(-10, 10, 2)
            H[0, 1] = rng.uniform(-0.05, 0.05)
            cv2.imwrite(str(d / f"{q}.ppm"), cv2.warpPerspective(img, H, size)[..., ::-1])
            np.savetxt(str(d / f"H_1_{q}"), H)
    return root


@pytest.fixture()
def fake_hpatches(tmp_path, monkeypatch):
    import gluefactory_tpu.data.hpatches as jhp
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings

    root = _write_hpatches(tmp_path / "hpatches-sequences-release")
    for mod in (jsettings, jhp, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    return root


def _equal_items(a, b, path=""):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_items(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("conf", [
    {"preprocessing": {"resize": 96, "side": "short"}},
    {"preprocessing": {"resize": 96, "side": "short"}, "subset": "v", "grayscale": True},
    {"preprocessing": {"resize": 160, "side": "long"}, "ignore_large_images": False},
], ids=["short", "v_grey", "all_scenes"])
def test_hpatches_items_equal_jax(fake_hpatches, conf):
    from gluefactory_tpu.data import get_dataset as jax_get_dataset
    from gluefactory_tpu_torch.data import get_dataset

    want = jax_get_dataset("hpatches")(conf).get_dataset("test")
    got = get_dataset("hpatches")(conf).get_dataset("test")
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        _equal_items(got[i], want[i])
    assert {got[i]["scene"] for i in range(len(got))} <= {"i_fake1", "v_fake2", "i_dc"}


def test_hpatches_loader_and_refusals(fake_hpatches, tmp_path, monkeypatch):
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.data.hpatches import read_homography

    ds = get_dataset("hpatches")({"preprocessing": {"resize": 96, "side": "short"}})
    batch = next(iter(ds.get_data_loader("test")))
    assert tuple(batch["view0"]["image"].shape) == (1, 96, 128, 3)
    assert tuple(batch["H_0to1"].shape) == (1, 3, 3) and batch["name"] == ["i_fake1/2.ppm"]
    H = read_homography(fake_hpatches / "i_fake1" / "H_1_3")
    np.testing.assert_array_equal(H, np.loadtxt(fake_hpatches / "i_fake1" / "H_1_3").astype(np.float32))
    with pytest.raises(ValueError):
        ds.get_dataset("train")
    monkeypatch.setattr(tsettings, "DATA_PATH", tmp_path / "nowhere")
    with pytest.raises(FileNotFoundError):
        get_dataset("hpatches")({})
