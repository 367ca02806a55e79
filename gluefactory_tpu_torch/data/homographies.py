"""Synthetic homography-pair dataset for stage-1 training (counterpart of
`gluefactory_tpu/data/homographies.py`): per item, an image, two random
homographies, two warped patches with photometric augmentation, and the
exact patch-to-patch homography `H_0to1`. Per-index generators
`default_rng((seed, epoch, idx))` make epochs reproducible.

The images come from a folder (`image_dir`, by default
`DATA_PATH/data_dir/jpg`; every file matching `glob` below it, or the
files of `image_list`, a list or a file of paths relative to the folder),
read by `preprocess.read_image`; an unreadable file gives a zero image and
an image smaller than `source_size` is upscaled (bilinear) until it covers
it, as the JAX package does. Or they are procedural (`synthetic_images` >
0), drawn from the JAX package's numpy random stream by a numpy rasteriser
that draws as OpenCV does (`raster.py`). The warp is OpenCV's
`cv2.warpPerspective` with INTER_LINEAR on a float32 image (OpenCV 5's arithmetic, which the JAX
dataset runs), written in numpy: no OpenCV is used. It matches cv2's
pixels within an ulp but in the scalar tail of a row (`warp_patch` says
how far).

Cached features (`load_features.do`): the image's group of an HDF5 cache
(`scripts/export_local_features.py` writes one), scaled by the image's
upscaling, then in each view warped by its homography, kept where inside
the patch (every per-keypoint array filtered, where the JAX package
filters only the keypoints), thresholded on `thresh`, cut to the
`max_num_keypoints` best scores and, with `force_num_keypoints`, padded to
that count with a mask: `view["cache"]`. Divergence from the JAX package,
which looks a file up by its absolute path: the group of a file is its
path relative to the image folder, the name the export writes (a
procedural image's is its index).

Lines (`detect_lines.do`): each view's LSD segments and wireframe junctions
(`models/lines/wireframe.precompute_wireframe`, the repo's C++ LSD) after
the photometric augmentation and the grey conversion, under the seven
`WIREFRAME_KEYS`; they draw nothing from the item's generator. A one-channel
view goes to the LSD as `(img[..., 0] * 255).astype(uint8)`, as in the JAX
package. A failed detection raises in the worker.

`emit_source`: an item is the source image alone (float32 (h, w, 3) at
`source_size`, resized bilinearly as cv2.resize's INTER_LINEAR where the
read image has another size), with `idx` and `name`, for the trainer's
`device_augment`, which makes the two views on the device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core.config import merge
from ..geometry.homography import sample_homography_corners
from ..models.cache_loader import CacheLoader, pad_local_features
from ..models.lines.wireframe import precompute_wireframe
from ..settings import DATA_PATH
from .augmentations import IdentityAugmentation, augmentations
from .base_dataset import BaseDataset
from .preprocess import read_image, resize_image
from .raster import fill_circle, fill_poly, fill_rect

# ITU-R BT.601 luma, the weights of cv2's RGB2GRAY
GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def generate_synthetic_image(seed: int, size=(640, 480)) -> np.ndarray:
    """Procedural image (h, w, 3) in [0, 1]: a random gradient, 40 random
    rectangles, circles and triangles, light Gaussian noise."""
    rng = np.random.default_rng(seed)
    w, h = size
    img = np.zeros((h, w, 3), np.float32)
    gx = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    gy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    base = rng.uniform(0.1, 0.6, 3).astype(np.float32)
    img += base + 0.3 * gx * rng.uniform(-1, 1, 3) + 0.3 * gy * rng.uniform(-1, 1, 3)
    for _ in range(40):
        color = rng.uniform(0, 1, 3).astype(np.float32)
        kind = rng.integers(0, 3)
        if kind == 0:
            pt1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            pt2 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            fill_rect(img, pt1, pt2, color)
        elif kind == 1:
            center = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            fill_circle(img, center, int(rng.integers(5, 60)), color)
        else:
            pts = rng.integers(0, [w, h], size=(3, 2))
            fill_poly(img, [(int(x), int(y)) for x, y in pts], color)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def _warp_points_np(points: np.ndarray, H: np.ndarray) -> np.ndarray:
    """(N, 2) points mapped by the homography H."""
    pts = np.concatenate([points, np.ones_like(points[:, :1])], axis=1) @ H.T
    return pts[:, :2] / pts[:, 2:]


def _fma32(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (the product of two float32 is
    exact in float64)."""
    return (np.multiply(a, b, dtype=np.float64) + c).astype(np.float32)


def rgb_to_grey(img: np.ndarray) -> np.ndarray:
    """float32 (H, W, 3) RGB -> (H, W) grey, as cv2's COLOR_RGB2GRAY rounds
    it in its vector loop: g * 0.587, then + r * 0.299 and + b * 0.114 each
    by a fused multiply-add. The scalar tail of a row (the last `W % 16`
    columns or fewer on AVX2) may round some sums otherwise, by an ulp. The
    LSD reads the grey view truncated to uint8, so an ulp can move a pixel
    by one level there."""
    r, g, b = (img[..., i] for i in range(3))
    return _fma32(b, GRAY[2], _fma32(r, GRAY[0], g * GRAY[1]))


def warp_patch(img: np.ndarray, H: np.ndarray, patch_shape) -> np.ndarray:
    """img (h, w, C) float32 warped by H (source -> patch) into a (ph, pw, C)
    patch, as `cv2.warpPerspective(img, H, patch_shape, INTER_LINEAR)`
    computes it for float32 images: M = H^-1 inverted in float64 and rounded
    to float32; for patch pixel (x, y), X = fma(M0, x, M1 y + M2) and so Y
    and W, in float32, as OpenCV's vector loop rounds them on a CPU with
    fused multiply-add; the source point (X / W, Y / W) splits into its floor and fractions a,
    b; the four taps, 0 outside the image, are blended as two lerps along x
    and one along y. The source points are cv2's exactly; the lerps are
    float32 multiply-adds where cv2 fuses them, which moves a pixel by at
    most an ulp of its value. Pixel centres at integer coordinates.

    OpenCV sends the last pixels of a row (a row's length modulo its SIMD
    width, which its CPU dispatch picks at run time) through a scalar loop,
    fma(M0, x, M1 y) + M2, which rounds once more: there the port's pixel
    moves by up to an ulp of the source coordinate times the image's
    gradient. The port computes every pixel as the vector loop does, so its
    patches do not depend on the CPU."""
    pw, ph = int(patch_shape[0]), int(patch_shape[1])
    h, w, channels = img.shape
    m = np.linalg.inv(np.asarray(H, np.float64)).astype(np.float32).ravel()
    xs = np.arange(pw, dtype=np.float32)[None, :]
    ys = np.arange(ph, dtype=np.float32)[:, None]

    def row_term(i):  # M[i] x + M[i+1] y + M[i+2], as OpenCV's vector loop rounds it
        return _fma32(m[i], xs, m[i + 1] * ys + m[i + 2])

    with np.errstate(divide="ignore", invalid="ignore"):
        W = row_term(6)
        sx = row_term(0) / W
        sy = row_term(3) / W
    far = 2 * (w + h)  # a source point this far out has no tap inside
    outside = ~(np.abs(sx) <= far) | ~(np.abs(sy) <= far)  # NaN included
    sx[outside] = sy[outside] = -2.0
    x0, y0 = np.floor(sx), np.floor(sy)
    a, b = sx - x0, sy - y0
    # taps from each channel's plane in a zero border of 2: a clipped
    # corner whose taps all lie outside reads zeros, as its true taps do
    planes = np.zeros((channels, h + 4, w + 4), np.float32)
    planes[:, 2:h + 2, 2:w + 2] = img.transpose(2, 0, 1)
    planes = planes.reshape(channels, -1)
    idx = ((np.clip(y0, -2, h) + 2) * (w + 4) + np.clip(x0, -2, w) + 2).astype(np.intp)
    out = np.empty((ph, pw, channels), np.float32)
    for c, plane in enumerate(planes):
        p00, p01 = plane.take(idx), plane.take(idx + 1)
        p10, p11 = plane.take(idx + w + 4), plane.take(idx + w + 5)
        top = p00 + a * (p01 - p00)
        bottom = p10 + a * (p11 - p10)
        out[..., c] = top + b * (bottom - top)
    return out


class _HomographySplit(torch.utils.data.Dataset):
    def __init__(self, parent: "HomographyDataset", split: str):
        self.parent = parent
        self.conf = parent.conf
        self.split = split
        self.image_names = parent.images[split]

    def __len__(self):
        return len(self.image_names)

    def _read_image(self, idx: int) -> tuple:
        """(image, per-axis scale of the upscaling): a procedural image, or
        the file, zeros of `source_size` if it cannot be read, upscaled by
        the ratio that makes it cover `source_size` (the scale is the
        effective one of the rounded-up size)."""
        name = self.image_names[idx]
        if isinstance(name, int):
            return generate_synthetic_image(name, tuple(self.conf.source_size)), np.ones(2, np.float32)
        sw, sh = self.conf.source_size
        try:
            img = read_image(name)
        except IOError:
            img = np.zeros((sh, sw, 3), np.float32)
        h, w = img.shape[:2]
        scale = np.ones(2, np.float32)
        if w < sw or h < sh:
            s = max(sw / w, sh / h)
            img, scale = resize_image(img, (int(np.ceil(w * s)), int(np.ceil(h * s))))
        return img, scale

    def _transform_features(self, features: dict, H: np.ndarray, patch_shape) -> dict:
        """The cached features warped into a view: keypoints mapped by H,
        every per-keypoint array kept where the keypoint lies in the patch,
        then `thresh`, the top `max_num_keypoints` by score and
        `force_num_keypoints`."""
        lf = self.conf.load_features
        kpts = _warp_points_np(np.asarray(features["keypoints"], np.float32), np.asarray(H, np.float32))
        w, h = patch_shape
        valid = (kpts[:, 0] >= 0) & (kpts[:, 0] <= w - 1) & (kpts[:, 1] >= 0) & (kpts[:, 1] <= h - 1)
        features = dict(features, keypoints=kpts.astype(np.float32))
        features = {k: v[valid] for k, v in features.items()}
        if lf.thresh > 0:
            keep = features["keypoint_scores"] >= lf.thresh
            features = {k: v[keep] for k, v in features.items()}
        n = lf.max_num_keypoints
        if n > -1:
            inds = np.argsort(-features["keypoint_scores"])
            features = {k: v[inds[:n]] for k, v in features.items()}
            if lf.force_num_keypoints:
                features = pad_local_features(features, n)
        return features

    def cache_key(self, idx: int) -> str:
        """The cache group of image idx: its path relative to the folder
        (a procedural image's index)."""
        name = self.image_names[idx]
        if isinstance(name, int):
            return str(name)
        return Path(name).relative_to(self.parent.image_dir).as_posix()

    def _sample_view(self, img: np.ndarray, rng: np.random.Generator, aug, hconf,
                     features=None) -> dict:
        h, w = img.shape[:2]
        patch_shape = tuple(hconf.patch_shape)
        H, _, _, _ = sample_homography_corners(
            (w, h), patch_shape, difficulty=hconf.difficulty, translation=hconf.translation,
            n_angles=hconf.n_angles, max_angle=hconf.max_angle,
            min_convexity=hconf.min_convexity, rng=rng,
        )
        patch = aug(warp_patch(img, H, patch_shape), rng)
        if self.conf.grayscale:
            patch = rgb_to_grey(patch)[..., None]
        view = {
            "image": patch.astype(np.float32),
            "image_size": np.array(patch_shape, dtype=np.float32),
            "H_": H.astype(np.float32),
        }
        dl = self.conf.detect_lines
        if dl.do:
            view.update(precompute_wireframe(view["image"], dl.max_num_lines, dl.min_length,
                                             dl.nms_radius))
        if features is not None:
            view["cache"] = self._transform_features(features, H, patch_shape)
        return view

    def __getitem__(self, idx: int) -> dict:
        conf = self.conf
        if conf.reseed:
            rng = np.random.default_rng((conf.seed, self.parent.epoch, idx))
        else:
            rng = np.random.default_rng()
        name = self.image_names[idx]
        img, upscale = self._read_image(idx)
        if conf.emit_source:
            # the source only: the warps and the photometric jitter run in
            # the train step (train.device_augment, device_homography.py)
            sw, sh = conf.source_size
            if img.shape[:2] != (sh, sw):
                img, _ = resize_image(img, (sw, sh), "linear")
            return {"source_image": img.astype(np.float32), "idx": idx, "name": str(name)}
        features = None
        if self.parent.feature_loader is not None:
            features = self.parent.feature_loader({"name": self.cache_key(idx), "scales": upscale})
        # right_only: view0 is the source rescaled to the patch (difficulty
        # 0), unaugmented; only the other views are warped and augmented
        left_hconf = self.parent.left_homography if conf.right_only else conf.homography
        views = [
            self._sample_view(img, rng,
                              self.parent.left_augment if i == 0 else self.parent.photo_augment,
                              left_hconf if i == 0 else conf.homography, features)
            for i in range(3 if conf.triplet else 2)
        ]
        data = {"original_image_size": np.array(img.shape[:2][::-1], np.float32)}
        for i, v in enumerate(views):
            data[f"view{i}"] = {k: v[k] for k in v if k != "H_"}
        H0, H1 = views[0]["H_"], views[1]["H_"]
        data["H_0to1"] = (H1 @ np.linalg.inv(H0)).astype(np.float32)
        if conf.triplet:
            H2 = views[2]["H_"]
            data["H_0to2"] = (H2 @ np.linalg.inv(H0)).astype(np.float32)
            data["H_1to2"] = (H2 @ np.linalg.inv(H1)).astype(np.float32)
        data["idx"] = idx
        data["name"] = str(name)
        return data


class HomographyDataset(BaseDataset):
    default_conf = {
        "data_dir": "revisitop1m",
        "image_dir": None,  # a folder of images; default DATA_PATH/data_dir/jpg
        "image_list": None,  # paths relative to the folder: a list, or a file of one a line
        "check_file_exists": False,
        "glob": ["*.jpg", "*.png", "*.jpeg"],
        "synthetic_images": 0,  # > 0: the procedural image pool instead of a folder
        "source_size": [640, 480],
        "train_size": 100,
        "val_size": 10,
        "shuffle_seed": 0,
        "grayscale": False,
        "triplet": False,
        "right_only": False,
        "reseed": True,
        "seed": 0,
        "emit_source": False,
        "homography": {
            "difficulty": 0.8,
            "translation": 1.0,
            "max_angle": 60,
            "n_angles": 10,
            "patch_shape": [640, 480],
            "min_convexity": 0.05,
        },
        "photometric": {"name": "dark", "p": 0.75},
        # features from a cache, warped into each view
        "load_features": {"do": False, **CacheLoader.default_conf, "thresh": 0.0,
                          "max_num_keypoints": -1, "force_num_keypoints": False},
        # each view's LSD lines and wireframe junctions, computed in the
        # loader's workers (GlueStick training); mirrors the wireframe
        # extractor's conf
        "detect_lines": {"do": False, "max_num_lines": 250, "min_length": 15.0, "nms_radius": 3.0},
    }

    def _init(self, conf):
        names = list(range(conf.synthetic_images)) if conf.synthetic_images > 0 else self._list(conf)
        perm = np.random.default_rng(conf.shuffle_seed).permutation(len(names))
        names = [names[i] for i in perm]
        train_size = min(conf.train_size, max(len(names) - conf.val_size, 1))
        val_size = min(conf.val_size, len(names))
        val_names = names[-val_size:] if val_size > 0 else []
        self.images = {"train": names[:train_size], "val": val_names, "test": val_names}
        self.photo_augment = augmentations[conf.photometric.name](conf.photometric)
        self.left_augment = IdentityAugmentation() if conf.right_only else self.photo_augment
        self.left_homography = merge(conf.homography, {"difficulty": 0.0})
        self.image_dir = self.image_folder(conf)
        self.feature_loader = None
        if conf.load_features.do:
            self.feature_loader = CacheLoader(
                {k: v for k, v in conf.load_features.to_dict().items()
                 if k not in ("do", "thresh", "max_num_keypoints", "force_num_keypoints")})
        self.epoch = 0

    @staticmethod
    def image_folder(conf) -> Path:
        return Path(conf.image_dir) if conf.image_dir else DATA_PATH / conf.data_dir / "jpg"

    @staticmethod
    def _list(conf) -> list:
        """The image paths of the folder: those of `image_list` (a list, or
        a file under the folder when `image_dir` is set, else under
        `DATA_PATH/data_dir`), or every match of `glob` below the folder."""
        image_dir = HomographyDataset.image_folder(conf)
        if conf.image_list is None:
            if not image_dir.exists():
                raise FileNotFoundError(f"image dir {image_dir} not found; set data.image_dir or "
                                        "use data.synthetic_images for a procedural pool")
            return [p for pattern in conf.glob for p in sorted(image_dir.rglob(pattern))]
        if isinstance(conf.image_list, (list, tuple)):
            entries = [str(e) for e in conf.image_list]
        else:
            list_path = Path(conf.image_list)
            if not list_path.is_absolute():
                list_path = (image_dir if conf.image_dir else DATA_PATH / conf.data_dir) / list_path
            if not list_path.exists():
                raise FileNotFoundError(f"cannot find image list {list_path}")
            entries = list_path.read_text().rstrip("\n").split("\n")
        names = [image_dir / e for e in entries]
        if conf.check_file_exists:
            for p in names:
                if not p.exists():
                    raise FileNotFoundError(p)
        return names

    def get_dataset(self, split: str):
        return _HomographySplit(self, split)


def main(argv=None):
    """Write a grid of the first items' two views: synthetic images (no
    data on disk), the dataset's default augmentation."""
    import argparse

    from ..visualization.viz2d import save_image_grid

    parser = argparse.ArgumentParser()
    parser.add_argument("--num_items", type=int, default=4)
    parser.add_argument("--synthetic", type=int, default=8)
    parser.add_argument("--out", type=str, default="homographies_samples.png")
    args = parser.parse_args(argv)
    ds = HomographyDataset({"synthetic_images": args.synthetic, "train_size": args.num_items,
                            "val_size": 2})
    tds = ds.get_dataset("train")
    rows = [[tds[i]["view0"]["image"], tds[i]["view1"]["image"]]
            for i in range(min(args.num_items, len(tds)))]
    save_image_grid(args.out, rows, save_dpi=120)


if __name__ == "__main__":
    main()
