"""ETH3D multiview pairs for the match precision-recall benchmark
(counterpart of `gluefactory_tpu/data/eth3d.py`).

Layout under `DATA_PATH / data_dir` (SOLD2's `ETH3D_undistorted` export),
one folder a scene:
  `images/dslr_images_undistorted/<name>.JPG`,
  `ground_truth_depth/undistorted_depth/<name>.png` (16-bit, 1/256 units, at
  the downsized resolution),
  `dslr_calibration_undistorted/cameras.txt` and `images.txt` (COLMAP text:
  each image's pose line, then its observations `x y point3D_id ...`),
  `dslr_calibration_jpg/images.txt` (each image's camera id).
A pair is two images of a scene that see at least `min_covisibility` common
3D points. Each image is resized to `max(h, w) // downsize_factor` on its
long side, the cameras scaled by `1 / downsize_factor`, and `scales` set to
1 (the export keeps the keypoints in the downsized pixels, as the JAX
package's does). Depths are read without cv2 (`posed_images._read_png_depth`,
which repeats `cv2.imread(IMREAD_ANYDEPTH)`).
"""

from __future__ import annotations

import os

import numpy as np

from .. import settings
from .base_dataset import BaseDataset
from .geometry_io import camera_dict_from_colmap, compose_pose, invert_pose, scale_camera_dict
from .posed_images import _read_png_depth
from .preprocess import ImagePreprocessor, read_image


def qvec2rotmat(qvec) -> np.ndarray:
    """A COLMAP quaternion (w, x, y, z) as a float32 rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
        ],
        dtype=np.float32,
    )


def read_cameras(camera_file: str, scale_factor: float | None = None) -> dict:
    """A COLMAP cameras.txt as {camera id: camera dict}, each scaled by
    `scale_factor` where given."""
    with open(camera_file) as f:
        raw = f.read().rstrip().split("\n")
    cameras = {}
    for line in raw:
        if line.startswith("#"):
            continue
        fields = line.split(" ")
        cam = camera_dict_from_colmap(fields[1], int(fields[2]), int(fields[3]),
                                      [float(x) for x in fields[4:]])
        if scale_factor is not None:
            cam = scale_camera_dict(cam, [scale_factor, scale_factor])
        cameras[int(fields[0])] = cam
    return cameras


def _view(name: str, img_folder, depth_folder, camera: dict, T_w2cam: np.ndarray) -> dict:
    return {"name": name[:-4], "img_path": str(img_folder / name),
            "depth_path": str(depth_folder / name[:-4]) + ".png", "camera": camera,
            "T_w2cam": T_w2cam}


class _ETH3DItems:
    def __init__(self, parent):
        self.parent = parent
        self.conf = parent.conf

    def __len__(self):
        return len(self.parent.data)

    def _read_image(self, img_path):
        img = read_image(img_path, grayscale=self.conf.grayscale)
        h, w = img.shape[:2]
        return ImagePreprocessor({"resize": int(max(h, w) // self.conf.downsize_factor)})(img)

    def __getitem__(self, idx):
        data = dict(self.parent.data[idx])
        views = {}
        for i in "01":
            view = dict(data.pop(f"view{i}"))
            view.update(self._read_image(view.pop("img_path")))
            view["scales"] = np.array([1.0, 1.0], np.float32)
            view["depth"] = _read_png_depth(view.pop("depth_path")).astype(np.float32) / 256.0
            views[f"view{i}"] = view
        return {**data, **views, "name": f"{views['view0']['name']}_{views['view1']['name']}",
                "idx": idx}


class ETH3DDataset(BaseDataset):
    default_conf = {
        "data_dir": "ETH3D_undistorted",
        "grayscale": True,
        "downsize_factor": 8,
        "min_covisibility": 500,
        "batch_size": 1,
        "two_view": True,
        "seed": 0,
    }

    def _init(self, conf):
        self.img_dir = settings.DATA_PATH / conf.data_dir
        if not self.img_dir.exists():
            raise FileNotFoundError(f"ETH3D not found at {self.img_dir}")
        self.data = []
        for folder in sorted(self.img_dir.iterdir()):
            if folder.is_dir():
                self.data.extend(self._scene_pairs(folder, conf))

    def _scene_pairs(self, folder, conf) -> list:
        img_folder = folder / "images" / "dslr_images_undistorted"
        depth_folder = folder / "ground_truth_depth" / "undistorted_depth"
        names = sorted(img.name for img in img_folder.iterdir())
        cameras = read_cameras(str(folder / "dslr_calibration_undistorted" / "cameras.txt"),
                               1.0 / conf.downsize_factor)
        cam_idx = {}
        with open(folder / "dslr_calibration_jpg" / "images.txt") as f:
            for raw_line in f.read().rstrip().split("\n")[4::2]:
                line = raw_line.split(" ")
                cam_idx[os.path.basename(line[-1])] = int(line[-2])
        T_w2c, visible = {}, {}
        with open(folder / "dslr_calibration_undistorted" / "images.txt") as f:
            lines = f.readlines()[4:]
        for raw_pose, raw_pts in zip(lines[::2], lines[1::2]):
            pose_fields = raw_pose.strip("\n").split(" ")
            name = os.path.basename(pose_fields[-1])
            ext = list(map(float, pose_fields[1:8]))
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = qvec2rotmat(ext[:4])
            pose[:3, 3] = ext[4:]
            T_w2c[name] = pose
            visible[name] = {int(i) for i in raw_pts.strip("\n").split(" ")[2::3] if int(i) != -1}
        n = len(names)
        covis = np.zeros((n, n))
        for i in range(n - 1):
            for j in range(i + 1, n):
                covis[i, j] = len(visible[names[i]] & visible[names[j]])
        pairs = []
        for i, j in np.stack(np.where(covis >= conf.min_covisibility), axis=1):
            n0, n1 = names[i], names[j]
            pairs.append({
                "view0": _view(n0, img_folder, depth_folder, cameras[cam_idx[n0]], T_w2c[n0]),
                "view1": _view(n1, img_folder, depth_folder, cameras[cam_idx[n1]], T_w2c[n1]),
                "T_0to1": compose_pose(T_w2c[n1], invert_pose(T_w2c[n0])),
                "n_covisible_points": float(covis[i, j]),
            })
        return pairs

    def get_dataset(self, split):
        return _ETH3DItems(self)
