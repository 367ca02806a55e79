"""Procedural posed scenes for the relative-pose benchmarks: textured planes
at several depths, ray cast from each camera, so that every view's image
and depth map come from one geometry.

`synthetic_correspondences(rng, n, ...)` draws normalized correspondences
of random points under a random relative pose, with outliers, for the
essential-matrix RANSAC.

`write_posed_images(root, scene, ...)` writes a scene in MegaDepth-1500's
posed-images layout (`<root>/<scene>/images/*.jpg`, `depths/*.png` as
16-bit PNG in 1/256 units, `views.txt`, `pairs.txt`);
`write_image_pairs(root, scene, ...)` writes ScanNet-1500's
(`<root>/<scene>/*.jpg` and lines of `pairs_calibrated.txt`);
`write_megadepth_scene(root, scene, ...)` writes MegaDepth's D2-Net layout
for training (`Undistorted_SfM/<scene>/images/*.jpg`,
`depth_undistorted/<scene>/*.h5` through `utils/hdf5_write.py`,
`scene_info/<scene>.npz` with the overlap matrix of the geometry;
`write_megadepth_scenes` several at once, one pool rendering all views);
`write_eth3d_scene(root, scene, ...)` writes ETH3D's undistorted DSLR
layout (`images/dslr_images_undistorted/*.JPG` at the DSLR size,
`ground_truth_depth/undistorted_depth/*.png` at the downsized size, COLMAP
`cameras.txt` and `images.txt` with each image's observations of points
sampled on the planes); `write_zeb_scene(root, scene, ...)` writes a ZEB
scene (`<sub>-<img>.jpg` images and `<sub>-<img0>-<img1>.txt` pair files
with both overlaps, K0, K1 and the relative pose). Views are named
`<scene>_imNN` except in the ETH3D and ZEB layouts. Images are written by
Pillow (JPEG quality 95). A scene is the same for the same
seed: a back wall, a floor and two tilted panels, each with a procedural
texture (`data.homographies.generate_synthetic_image`), seen by cameras
spread around the origin, looking down +z.

    python -m gluefactory_tpu_torch.scripts_dev.posed_scenes <root> [--size 1920 1440]
    python -m gluefactory_tpu_torch.scripts_dev.posed_scenes <root> --megadepth [--size 1600 1200]
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..data.homographies import generate_synthetic_image
from ..geometry.utils import image_grid, so3exp_map
from ..geometry.wrappers import Camera
from ..utils.hdf5_write import write_datasets


def synthetic_correspondences(rng, n: int, noise: float = 0.0, outliers: float = 0.0):
    """n correspondences (normalized coordinates, float32) of points 2-6 in
    front of camera 0 under a random pose (rotation 0.1-0.5 rad about a
    random axis, unit translation), Gaussian `noise` on both views, a share
    of `outliers` of view 1's points replaced by uniform ones in
    [-0.5, 0.5]. Returns (p0, p1, R, t, unit E, outlier mask)."""
    a = rng.normal(size=3)
    a = a / np.linalg.norm(a) * rng.uniform(0.1, 0.5)
    th = np.linalg.norm(a)
    k = a / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-1, 1, (n, 3))
    X[:, 2] = rng.uniform(2, 6, n)
    X1 = X @ R.T + t
    p0 = X[:, :2] / X[:, 2:] + rng.normal(size=(n, 2)) * noise
    p1 = X1[:, :2] / X1[:, 2:] + rng.normal(size=(n, 2)) * noise
    out = np.zeros(n, bool)
    out[rng.choice(n, int(round(outliers * n)), replace=False)] = True
    p1[out] = rng.uniform(-0.5, 0.5, (out.sum(), 2))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    return p0.astype(np.float32), p1.astype(np.float32), R, t, E / np.linalg.norm(E), out


def _rot_y(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


def make_planes(seed: int, texture_size=(512, 384)) -> list:
    """(centre, axis a, axis b, half extents, texture) of each plane, in
    world coordinates: not one plane, so that the relative pose is not
    degenerate."""
    rng = np.random.default_rng(seed)
    specs = [
        ((0.0, 0.0, 9.0), np.eye(3), (12.0, 9.0)),  # back wall
        ((0.0, 2.2, 5.5), np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], float), (12.0, 5.0)),  # floor
        ((-1.3, -0.4, 4.5 + rng.uniform(-0.3, 0.3)), _rot_y(rng.uniform(20, 40)), (1.1, 1.0)),
        ((1.5, 0.3, 6.0 + rng.uniform(-0.3, 0.3)), _rot_y(-rng.uniform(20, 40)), (1.3, 1.6)),
    ]
    planes = []
    for k, (centre, rot, ext) in enumerate(specs):
        tex = generate_synthetic_image(seed * 10 + k, texture_size).astype(np.float64)
        planes.append((np.array(centre), rot[:, 0], rot[:, 1], np.array(ext), tex))
    return planes


def render(planes: list, camera: Camera, R: np.ndarray, t: np.ndarray):
    """Ray cast a (w, h) view with world-to-camera pose (R, t): the image
    (h, w, 3) in [0, 1] (each plane's texture, nearest texel) and the depth
    (h, w) along the optical axis (0 where no plane is hit)."""
    w, h = (int(v) for v in camera.size.tolist())
    rays = camera.image2cam(image_grid(h, w, dtype=torch.float64).reshape(1, -1, 2))[0]
    rays = rays.numpy() @ R  # world directions of unit-depth camera rays
    origin = -R.T @ t
    depth = np.full(h * w, np.inf)
    image = np.zeros((h * w, 3))
    for centre, a, b, ext, tex in planes:
        n = np.cross(a, b)
        denom = rays @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            s = ((centre - origin) @ n) / denom
        hit = origin + s[:, None] * rays - centre
        u, v = hit @ a, hit @ b
        inside = (s > 0) & (np.abs(u) <= ext[0]) & (np.abs(v) <= ext[1]) & (s < depth)
        th, tw = tex.shape[:2]
        tx = np.clip(((u[inside] / ext[0] + 1) / 2 * (tw - 1)).round().astype(int), 0, tw - 1)
        ty = np.clip(((v[inside] / ext[1] + 1) / 2 * (th - 1)).round().astype(int), 0, th - 1)
        image[inside] = tex[ty, tx]
        depth[inside] = s[inside]
    depth[~np.isfinite(depth)] = 0.0
    return image.reshape(h, w, 3), depth.reshape(h, w)


def make_cameras(seed: int, n_views: int, size, model: str = "PINHOLE"):
    """n_views (COLMAP camera dict, R, t) spread around the origin: centres
    within +-0.8 in x and +-0.4 in y, rotations of up to ~8 degrees."""
    rng = np.random.default_rng(seed)
    w, h = size
    f = 0.8 * w
    out = []
    for _ in range(n_views):
        if model == "PINHOLE":
            params = [f, f * rng.uniform(0.98, 1.02), w / 2, h / 2]
        elif model == "SIMPLE_RADIAL":
            params = [f, w / 2, h / 2, rng.uniform(-0.04, 0.04)]
        else:
            raise ValueError(f"procedural scenes take PINHOLE or SIMPLE_RADIAL, not {model}")
        R = so3exp_map(torch.from_numpy(rng.normal(size=3) * np.deg2rad(4))).numpy()
        centre = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.3)])
        out.append(({"model": model, "width": w, "height": h, "params": params}, R, -R @ centre))
    return out


def _save_jpeg(path: Path, image: np.ndarray, repeat: int = 1) -> None:
    """`image` in [0, 1] as a JPEG, each pixel repeated `repeat` x `repeat`."""
    from PIL import Image

    img = (image * 255).round().astype(np.uint8)
    if repeat > 1:
        img = np.repeat(np.repeat(img, repeat, 0), repeat, 1)
    Image.fromarray(img).save(path, quality=95)


def _save_depth_png(path: Path, depth: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.clip(np.round(depth * 256), 0, 65535).astype(np.uint16)).save(path)


def _render_view(args) -> tuple:
    """(image, depth) of one view of the planes of `seed`."""
    seed, cam, R, t = args
    return render(make_planes(seed), Camera.from_colmap(cam).to(torch.float64), R, t)


def _render_views(scene: str, seed: int, n_views: int, size, model: str, workers: int = 1) -> list:
    """(name, camera dict, R, t, image, depth) of each view, rendered by
    `workers` processes; names carry the scene, so that pair names are
    unique across scenes."""
    cameras = make_cameras(seed + 1, n_views, size, model)
    jobs = [(seed, cam, R, t) for cam, R, t in cameras]
    if workers > 1:
        # one torch thread a child, as write_megadepth_scene's
        fork = multiprocessing.get_context("fork")
        with ProcessPoolExecutor(min(workers, n_views), mp_context=fork,
                                 initializer=torch.set_num_threads, initargs=(1,)) as pool:
            rendered = list(pool.map(_render_view, jobs))
    else:
        rendered = [_render_view(job) for job in jobs]
    return [(f"{scene}_im{i:02d}", cam, R, t, image, depth)
            for i, ((cam, R, t), (image, depth)) in enumerate(zip(cameras, rendered))]


def _pairs(n_views: int, n_pairs: int) -> list:
    pairs = list(itertools.combinations(range(n_views), 2))
    if n_pairs > len(pairs):
        raise ValueError(f"{n_views} views make {len(pairs)} pairs, not {n_pairs}")
    return pairs[:n_pairs]


def write_posed_images(root: Path, scene: str, n_views: int = 7, n_pairs: int = 20,
                       size=(1920, 1440), model: str = "PINHOLE", seed: int = 0,
                       workers: int = 1) -> int:
    """One scene in the posed-images layout, its views rendered by `workers`
    processes; returns the number of pairs."""
    d = Path(root) / scene
    (d / "images").mkdir(parents=True, exist_ok=True)
    (d / "depths").mkdir(exist_ok=True)
    lines, names = [], []
    for name, cam, R, t, image, depth in _render_views(scene, seed, n_views, size, model, workers):
        names.append(f"{name}.jpg")
        _save_jpeg(d / "images" / f"{name}.jpg", image)
        _save_depth_png(d / "depths" / f"{name}.png", depth)
        lines.append(" ".join([f"{name}.jpg", *(repr(float(x)) for x in R.ravel()),
                               *(repr(float(x)) for x in t), cam["model"], str(cam["width"]),
                               str(cam["height"]), *(repr(float(x)) for x in cam["params"])]))
    (d / "views.txt").write_text("\n".join(lines) + "\n")
    pairs = _pairs(n_views, n_pairs)
    (d / "pairs.txt").write_text("".join(f"{names[i]} {names[j]}\n" for i, j in pairs))
    return len(pairs)


def write_image_pairs(root: Path, scene: str, n_views: int = 4, n_pairs: int = 5,
                      size=(640, 480), seed: int = 0) -> list:
    """One scene's PINHOLE views as `<root>/<scene>/<name>.jpg`; returns the
    lines of `pairs_calibrated.txt` (names relative to root, K0, K1 and the
    relative pose as 12 numbers)."""
    d = Path(root) / scene
    d.mkdir(parents=True, exist_ok=True)
    views = []
    for name, cam, R, t, image, _ in _render_views(scene, seed, n_views, size, "PINHOLE"):
        _save_jpeg(d / f"{name}.jpg", image)
        fx, fy, cx, cy = cam["params"]
        views.append((f"{scene}/{name}.jpg", np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]), R, t))
    lines = []
    for i, j in _pairs(n_views, n_pairs):
        (n0, K0, R0, t0), (n1, K1, R1, t1) = views[i], views[j]
        T = np.concatenate([R1 @ R0.T, (t1 - R1 @ R0.T @ t0)[:, None]], axis=1)
        lines.append(" ".join([n0, n1, *(repr(float(x)) for x in np.concatenate(
            [K0.ravel(), K1.ravel(), T.ravel()]))]))
    return lines


# MegaDepth views: PINHOLE cameras on an arc in front of the planes, yawed
# so that the pairs' overlaps spread over 0-1
MD_YAW_DEG, MD_BASELINE = 26.0, 1.6
OVERLAP_STRIDE = 8  # the overlap's pixel grid: every 8th pixel of each axis
OVERLAP_DEPTH_TOL = 0.05  # relative depth difference of a co-visible point


def make_arc_cameras(seed: int, n_views: int, size) -> list:
    """n_views (PINHOLE camera dict, R, t): centres spread over +-MD_BASELINE
    in x (and a little in y and z), yaws over +-MD_YAW_DEG with the centre,
    a few degrees of jitter on every axis."""
    rng = np.random.default_rng(seed)
    w, h = size
    f = 0.8 * w
    out = []
    for u in np.linspace(-1.0, 1.0, n_views) + rng.uniform(-0.1, 0.1, n_views):
        rvec = rng.normal(size=3) * np.deg2rad(2) + np.array([0.0, np.deg2rad(MD_YAW_DEG) * -u, 0.0])
        R = so3exp_map(torch.from_numpy(rvec)).numpy()
        centre = np.array([MD_BASELINE * u, rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3)])
        params = [f, f * rng.uniform(0.98, 1.02), w / 2 + rng.uniform(-8, 8), h / 2 + rng.uniform(-8, 8)]
        out.append(({"model": "PINHOLE", "width": w, "height": h, "params": params}, R, -R @ centre))
    return out


def _K(cam: dict) -> np.ndarray:
    fx, fy, cx, cy = cam["params"]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def overlap_matrix(cameras: list, depths: list) -> np.ndarray:
    """The scene's overlap matrix: entry (i, j) is the smaller of the two
    shares of co-visible pixels (`overlap_shares`)."""
    share = overlap_shares(cameras, depths)
    return np.minimum(share, share.T)


def overlap_shares(cameras: list, depths: list) -> np.ndarray:
    """Entry (i, j): the share of view i in view j, the fraction of view i's
    pixels with valid depth (> 0), on a grid of every OVERLAP_STRIDE-th
    pixel centre, whose 3D point projects inside view j in front of it onto
    a pixel whose depth agrees within OVERLAP_DEPTH_TOL (relative). The
    diagonal is 1. `cameras` are (camera dict, R, t) with world-to-camera
    poses; `depths` the full-size depth maps."""
    n = len(cameras)
    share = np.eye(n)
    points = []
    for (cam, R, t), depth in zip(cameras, depths):
        ys, xs = np.mgrid[0:depth.shape[0]:OVERLAP_STRIDE, 0:depth.shape[1]:OVERLAP_STRIDE]
        d = depth[ys, xs].ravel()
        keep = d > 0
        pix = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5, np.ones(xs.size)], 0)[:, keep]
        cam_pts = np.linalg.solve(_K(cam), pix) * d[keep]
        points.append(R.T @ (cam_pts - t[:, None]))  # world points
    for i in range(n):
        for j in range(n):
            if i == j or points[i].shape[1] == 0:
                continue
            cam, R, t = cameras[j]
            p = R @ points[i] + t[:, None]
            z = p[2]
            with np.errstate(divide="ignore", invalid="ignore"):
                uv = (_K(cam) @ p)[:2] / z
            h, w = depths[j].shape
            inside = (z > 0) & (uv[0] >= 0) & (uv[0] < w) & (uv[1] >= 0) & (uv[1] < h)
            dj = np.zeros_like(z)
            dj[inside] = depths[j][uv[1, inside].astype(int), uv[0, inside].astype(int)]
            ok = inside & (dj > 0) & (np.abs(dj - z) <= OVERLAP_DEPTH_TOL * z)
            share[i, j] = ok.mean()
    return share


def _write_md_view(args) -> tuple:
    """Render one MegaDepth view and write its JPEG and HDF5 depth; returns
    (the depth's SHA-256, the depth)."""
    planes_seed, cam, R, t, image_path, depth_path = args
    image, depth = render(make_planes(planes_seed), Camera.from_colmap(cam).to(torch.float64), R, t)
    depth = depth.astype(np.float32)
    _save_jpeg(image_path, image)
    write_datasets(depth_path, {"depth": depth})
    return hashlib.sha256(depth.tobytes()).hexdigest(), depth


def _md_scene_plan(root: Path, scene: str, n_views: int, size, seed: int):
    """A MegaDepth scene's directories, cameras, view names and render jobs."""
    img_dir = root / "Undistorted_SfM" / scene / "images"
    depth_dir = root / "depth_undistorted" / scene
    img_dir.mkdir(parents=True, exist_ok=True)
    depth_dir.mkdir(parents=True, exist_ok=True)
    (root / "scene_info").mkdir(exist_ok=True)
    cameras = make_arc_cameras(seed + 1, n_views, size)
    names = [f"{scene}_im{i:02d}" for i in range(n_views)]
    jobs = [(seed, cam, R, t, img_dir / f"{n}.jpg", depth_dir / f"{n}.h5")
            for n, (cam, R, t) in zip(names, cameras)]
    return cameras, names, jobs


def _render_md_views(jobs: list, workers: int) -> list:
    """`_write_md_view` of each job, by `workers` processes."""
    if workers <= 1:
        return [_write_md_view(job) for job in jobs]
    # one torch thread a child, as in a DataLoader's workers: a child forked
    # after torch's OpenMP pool ran hangs in its first parallel region
    # otherwise
    fork = multiprocessing.get_context("fork")
    with ProcessPoolExecutor(min(workers, len(jobs)), mp_context=fork,
                             initializer=torch.set_num_threads, initargs=(1,)) as pool:
        return list(pool.map(_write_md_view, jobs))


def _md_scene_finish(root: Path, scene: str, cameras, names, written) -> dict:
    poses = np.stack([np.concatenate([np.concatenate([R, t[:, None]], 1), [[0, 0, 0, 1]]])
                      for _, R, t in cameras])
    image_paths = [f"Undistorted_SfM/{scene}/images/{n}.jpg" for n in names]
    np.savez(root / "scene_info" / f"{scene}.npz",
             image_paths=np.array(image_paths, object),
             depth_paths=np.array([f"depth_undistorted/{scene}/{n}.h5" for n in names], object),
             poses=poses, intrinsics=np.stack([_K(cam) for cam, _, _ in cameras]),
             overlap_matrix=overlap_matrix(cameras, [d for _, d in written]))
    return {"image_paths": image_paths, "depth_sha256": [h for h, _ in written]}


def write_megadepth_scene(root: Path, scene: str, n_views: int = 12, size=(1600, 1200),
                          seed: int = 0, workers: int = 1) -> dict:
    """One scene in MegaDepth's D2-Net layout under `root`: the views'
    JPEGs, their depths as HDF5 (`/depth`, float32, 0 where no plane is
    hit) and `scene_info/<scene>.npz` (`image_paths` and `depth_paths`
    relative to `root` as object arrays, world-to-camera `poses` (n, 4, 4),
    `intrinsics` (n, 3, 3), `overlap_matrix` (`overlap_matrix`)). Views are
    rendered by `workers` processes. Returns the image paths and the
    SHA-256 of each depth array written."""
    return write_megadepth_scenes(root, {scene: seed}, n_views, size, workers)[scene]


def write_megadepth_scenes(root: Path, seeds: dict, n_views: int = 12, size=(1600, 1200),
                           workers: int = 1) -> dict:
    """`write_megadepth_scene` for each scene of `seeds` (scene -> seed),
    every scene's views rendered by one pool of `workers` processes, so that
    no worker waits for a scene's last views. Returns each scene's record."""
    root = Path(root)
    plans = {scene: _md_scene_plan(root, scene, n_views, size, seed) for scene, seed in seeds.items()}
    written = _render_md_views([job for _, _, jobs in plans.values() for job in jobs], workers)
    out = {}
    for k, (scene, (cameras, names, _)) in enumerate(plans.items()):
        out[scene] = _md_scene_finish(root, scene, cameras, names, written[k * n_views:(k + 1) * n_views])
    return out


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """A rotation matrix as COLMAP's quaternion (w, x, y, z), w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R, np.float64).ravel()
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0],
                  [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    return -qvec if qvec[0] < 0 else qvec


def _scaled(cam: dict, s: float) -> dict:
    """A PINHOLE camera dict at `s` times its size."""
    fx, fy, cx, cy = cam["params"]
    return {"model": "PINHOLE", "width": round(cam["width"] * s), "height": round(cam["height"] * s),
            "params": [fx * s, fy * s, cx * s, cy * s]}


def _render_at(planes: list, cam: dict, R, t, scale: float):
    return render(planes, Camera.from_colmap(_scaled(cam, scale)).to(torch.float64), R, t)


def _plane_points(planes: list, n: int, rng) -> np.ndarray:
    """n world points spread over the planes, each plane by its area."""
    areas = np.array([ext[0] * ext[1] for _, _, _, ext, _ in planes])
    which = rng.choice(len(planes), n, p=areas / areas.sum())
    uv = rng.uniform(-1, 1, (n, 2))
    return np.stack([planes[k][0] + u * planes[k][3][0] * planes[k][1] + v * planes[k][3][1] * planes[k][2]
                     for k, (u, v) in zip(which, uv)])


def _observations(points: np.ndarray, cam: dict, R, t, depth: np.ndarray, scale: float) -> list:
    """(x, y, point id) of the points seen by a view: in front of it, inside
    its image and not hidden (the depth map at `scale` agrees within
    OVERLAP_DEPTH_TOL)."""
    p = points @ R.T + t
    z = p[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = (p @ _K(cam).T)[:, :2] / z[:, None]
    h, w = depth.shape
    ij = np.floor(uv * scale).astype(np.int64)
    inside = (z > 0) & (ij[:, 0] >= 0) & (ij[:, 0] < w) & (ij[:, 1] >= 0) & (ij[:, 1] < h)
    seen = np.zeros(len(points), bool)
    d = depth[ij[inside, 1], ij[inside, 0]]
    seen[inside] = (d > 0) & (np.abs(d - z[inside]) <= OVERLAP_DEPTH_TOL * z[inside])
    return [(float(uv[k, 0]), float(uv[k, 1]), int(k)) for k in np.nonzero(seen)[0]]


def _eth3d_pose(R: np.ndarray):
    """(COLMAP quaternion of R, the rotation it gives back in float64)."""
    qvec = rotmat2qvec(R)
    w, x, y, z = qvec
    return qvec, np.array([[1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
                           [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
                           [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2]])


# Gaussian noise on the ETH3D and ZEB images (in [0, 1] units): it breaks
# the textures' flat regions into distinct detector scores, so that no
# top-k meets a tie between equal scores, which two implementations may
# break differently
IMAGE_NOISE = 0.05


def _noisy(image: np.ndarray, rng) -> np.ndarray:
    return np.clip(image + rng.normal(scale=IMAGE_NOISE, size=image.shape), 0, 1)


def _write_eth3d_view(args) -> list:
    """Render one ETH3D view, write its JPEG and depth PNG; returns its
    observations of the scene's points."""
    seed, k, cam, R, t, points, img_path, depth_path, downsize_factor = args
    planes = make_planes(seed)
    render_scale = max(downsize_factor // 2, 1)
    image, _ = _render_at(planes, cam, R, t, 1.0 / render_scale)
    _save_jpeg(img_path, _noisy(image, np.random.default_rng((seed, k))), render_scale)
    _, depth = _render_at(planes, cam, R, t, 1.0 / downsize_factor)
    _save_depth_png(depth_path, depth)
    return _observations(points, cam, R, t, depth, 1.0 / downsize_factor)


def write_eth3d_scene(root: Path, scene: str, n_views: int = 4, size=(6048, 4032),
                      downsize_factor: int = 8, n_points: int = 6000, seed: int = 0,
                      workers: int = 1) -> dict:
    """One scene in ETH3D's undistorted DSLR layout under `root/scene`.
    PINHOLE views of the planes as `DSC_NNNN.JPG` at `size`, rendered at
    twice the size the loader resizes them to (1 / `downsize_factor`) with
    IMAGE_NOISE and upsampled by pixel repetition; depths as 16-bit PNGs
    (1/256 units) rendered at 1 / `downsize_factor`, as the loader reads
    them; `dslr_calibration_undistorted/cameras.txt` (one camera an image)
    and `images.txt` (COLMAP quaternion poses, each followed by its
    observations of `n_points` points spread over the planes, one -1 entry
    a view), and `dslr_calibration_jpg/images.txt`. Views are rendered by
    `workers` processes. Returns the names and each pair's count of
    covisible points."""
    d = Path(root) / scene
    img_dir = d / "images" / "dslr_images_undistorted"
    depth_dir = d / "ground_truth_depth" / "undistorted_depth"
    calib = d / "dslr_calibration_undistorted"
    for p in (img_dir, depth_dir, calib, d / "dslr_calibration_jpg"):
        p.mkdir(parents=True, exist_ok=True)
    points = _plane_points(make_planes(seed), n_points, np.random.default_rng(seed + 2))
    names = [f"DSC_{k:04d}.JPG" for k in range(n_views)]
    views = [(cam, *_eth3d_pose(R), t) for cam, R, t in make_cameras(seed + 1, n_views, size, "PINHOLE")]
    jobs = [(seed, k, cam, R, t, points, img_dir / name, depth_dir / f"{name[:-4]}.png",
             downsize_factor)
            for k, (name, (cam, _, R, t)) in enumerate(zip(names, views))]
    if workers > 1:
        # one torch thread a child, as write_megadepth_scene's
        fork = multiprocessing.get_context("fork")
        with ProcessPoolExecutor(min(workers, n_views), mp_context=fork,
                                 initializer=torch.set_num_threads, initargs=(1,)) as pool:
            observations = list(pool.map(_write_eth3d_view, jobs))
    else:
        observations = [_write_eth3d_view(job) for job in jobs]
    cameras = ["# Camera list", "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]",
               f"# Number of cameras: {n_views}"]
    images = ["# Image list with two lines of data per image:",
              "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
              "#   POINTS2D[] as (X, Y, POINT3D_ID)", f"# Number of images: {n_views}"]
    for k, (name, (cam, qvec, _, t), obs) in enumerate(zip(names, views, observations)):
        cameras.append(" ".join([str(k + 1), "PINHOLE", str(cam["width"]), str(cam["height"]),
                                 *(repr(float(v)) for v in cam["params"])]))
        images.append(" ".join([str(k + 1), *(repr(float(v)) for v in qvec),
                                *(repr(float(v)) for v in t), str(k + 1),
                                f"dslr_images_undistorted/{name}"]))
        images.append(" ".join(f"{u!r} {v!r} {i}" for u, v, i in obs + [(0.5, 0.5, -1)]))
    (calib / "cameras.txt").write_text("\n".join(cameras) + "\n")
    (calib / "images.txt").write_text("\n".join(images) + "\n")
    (d / "dslr_calibration_jpg" / "images.txt").write_text("\n".join(images) + "\n")
    seen = [{i for _, _, i in obs} for obs in observations]
    covisible = {(names[i], names[j]): len(seen[i] & seen[j])
                 for i, j in itertools.combinations(range(n_views), 2)}
    return {"names": names, "covisible": covisible}


def write_zeb_scene(root: Path, scene: str, n_views: int = 5, n_pairs: int = 10,
                    size=(1600, 1200), seed: int = 0, workers: int = 1) -> list:
    """One ZEB scene under `root/scene`: PINHOLE views with IMAGE_NOISE as
    `s0-NNNN.jpg` (one subscene, `s0`) and a pair file `s0-<i>-<j>.txt`
    for each of the first `n_pairs` pairs, its line `NNNN.jpg MMMM.jpg
    overlap0 overlap1 K0(9) K1(9) T_0to1(12)` (the overlaps are the views'
    shares of co-visible pixels, `overlap_shares`). Views are rendered by
    `workers` processes. Returns the pair files' paths."""
    d = Path(root) / scene
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed + 2)
    views, depths = [], []
    for k, (_, cam, R, t, image, depth) in enumerate(_render_views(scene, seed, n_views, size, "PINHOLE",
                                                                   workers)):
        _save_jpeg(d / f"s0-{k:04d}.jpg", _noisy(image, rng))
        views.append((cam, R, t))
        depths.append(depth)
    share = overlap_shares(views, depths)
    files = []
    for i, j in _pairs(n_views, n_pairs):
        (c0, R0, t0), (c1, R1, t1) = views[i], views[j]
        T = np.concatenate([R1 @ R0.T, (t1 - R1 @ R0.T @ t0)[:, None]], axis=1)
        line = " ".join([f"{i:04d}.jpg", f"{j:04d}.jpg", repr(float(share[i, j])),
                         repr(float(share[j, i])),
                         *(repr(float(x)) for x in np.concatenate([_K(c0).ravel(), _K(c1).ravel(),
                                                                   T.ravel()]))])
        path = d / f"s0-{i:04d}-{j:04d}.txt"
        path.write_text(line + "\n")
        files.append(path)
    return files


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("root", type=Path)
    parser.add_argument("--size", type=int, nargs=2, default=(1920, 1440))
    parser.add_argument("--scenes", type=int, default=2)
    parser.add_argument("--megadepth", action="store_true",
                        help="MegaDepth's D2-Net layout (training) instead of the posed-images one")
    args = parser.parse_args(argv)
    if args.megadepth:
        for s in range(args.scenes):
            write_megadepth_scene(args.root, f"scene{s}", size=tuple(args.size), seed=s)
        return
    for s in range(args.scenes):
        write_posed_images(args.root, f"scene{s}", size=tuple(args.size),
                           model="SIMPLE_RADIAL" if s % 2 else "PINHOLE", seed=s)


if __name__ == "__main__":
    main()
