"""COLMAP-style two-view geometry without pycolmap (counterpart of
`gluefactory_tpu/robust_estimators/relative_pose/two_view_native.py`).

Both models from the port's batched RANSACs on `conf.device` (`cuda`
unless the caller asks for the CPU): an essential matrix on normalized
points (`ops/ransac.py::ransac_essential`) and a homography on pixels
(`ransac_homography`), each on the matches padded to the homography
estimator's bucket. Both draw their minimal sets from the same seed, as the
JAX estimator hands one `jax.random.key(seed)` to both (`utils/threefry.py`
repeats JAX's draw). Then COLMAP's model selection
(two_view_geometry.cc): when the homography explains almost as many matches
as the epipolar model, the scene is planar or the motion a pure rotation,
and the pose comes from the calibrated homography's decomposition
(cheirality-resolved, on the host in float64); otherwise from the essential
matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.wrappers import Pose
from ...ops.ransac import ransac_essential, ransac_homography
from ..base_estimator import BaseEstimator
from ..homography.xla_ransac import bucket_pad
from .poselib import normalized
from .xla_ransac import mean_focal


def decompose_homography(Hn: np.ndarray, p0: np.ndarray, p1: np.ndarray):
    """Candidate (R, t) of a calibrated homography Hn = K1^-1 H K0 ~ R + t
    n^T / d, by the SVD method: four candidates, or one (R, 0) for a pure
    rotation. The caller resolves them by cheirality."""
    U, S, Vt = np.linalg.svd(Hn)
    Hs = Hn / S[1]  # the middle singular value to 1
    U, S, Vt = np.linalg.svd(Hs.T @ Hs)
    if np.linalg.det(U) < 0:
        U = -U
    s1, s3 = S[0], S[2]
    v1, v2, v3 = U.T
    if s1 - s3 < 1e-8:  # pure rotation
        return [(Hs * np.sign(np.linalg.det(Hs)), np.zeros(3))]
    a = np.sqrt(max(1 - s3, 0.0))
    b = np.sqrt(max(s1 - 1, 0.0))
    nrm = np.sqrt(max(s1 - s3, 1e-12))
    sols = []
    for u in ((a * v1 + b * v3) / nrm, (a * v1 - b * v3) / nrm):
        W = np.stack([v2, u, np.cross(v2, u)], axis=1)
        Uw = np.stack([Hs @ v2, Hs @ u, np.cross(Hs @ v2, Hs @ u)], axis=1)
        R = Uw @ W.T
        t = (Hs - R) @ np.cross(v2, u)
        for sgn in (1.0, -1.0):
            sols.append((R, sgn * t))
    return sols


def _cheirality_count(R, t, p0, p1) -> int:
    """Points that triangulate (linear DLT on the two rays) with positive
    depth in both views."""
    P0 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = np.hstack([R, t.reshape(3, 1)])
    cnt = 0
    for a, b in zip(p0, p1):
        A = np.stack([a[0] * P0[2] - P0[0], a[1] * P0[2] - P0[1],
                      b[0] * P1[2] - P1[0], b[1] * P1[2] - P1[1]])
        X = np.linalg.svd(A)[2][-1]
        if abs(X[3]) < 1e-12:
            continue
        X = X[:3] / X[3]
        if X[2] > 0 and (R @ X + t)[2] > 0:
            cnt += 1
    return cnt


def _K(camera) -> np.ndarray:
    f = camera.f.double().cpu().numpy().reshape(-1)[-2:]
    c = camera.c.double().cpu().numpy().reshape(-1)[-2:]
    return np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1]], np.float64)


class NativeTwoViewEstimator(BaseEstimator):
    default_conf = {
        "ransac_th": 4.0,  # pixels, pycolmap's default max_error
        "solver": "5pt",
        "n_iters": 512,
        "seed": 0,
        "min_num_inliers": 15,  # COLMAP's TwoViewGeometryOptions
        "max_H_inlier_ratio": 0.8,  # H / E inliers above it: planar or panoramic
        "device": "cuda",
    }

    def _forward(self, data: dict) -> dict:
        kpts0 = np.asarray(data["m_kpts0"], np.float32)
        kpts1 = np.asarray(data["m_kpts1"], np.float32)
        camera0, camera1 = data["camera0"], data["camera1"]
        fail = {"success": False, "M_0to1": Pose.identity(), "inliers": np.zeros(len(kpts0), bool)}
        if len(kpts0) < 8:
            return fail
        c = self.conf
        device = torch.device(c.device)
        norm_th = float(c.ransac_th) / mean_focal(camera0, camera1)
        n0, n1 = normalized(camera0, kpts0), normalized(camera1, kpts1)

        def on(*arrays):
            return [torch.from_numpy(a).to(device) for a in arrays]

        p0n, p1n, valid, n = bucket_pad(n0, n1)
        e_out = ransac_essential(*on(p0n, p1n, valid), norm_th, seed=int(c.seed),
                                 n_iters=int(c.n_iters), solver=str(c.solver))
        e_inl = e_out["inliers"].cpu().numpy()[:n]
        e_ninl = int(e_inl.sum())
        p0p, p1p, validp, _ = bucket_pad(kpts0, kpts1)
        h_out = ransac_homography(*on(p0p, p1p, validp), float(c.ransac_th), seed=int(c.seed),
                                  n_iters=int(c.n_iters))
        h_inl = h_out["inliers"].cpu().numpy()[:n]
        h_ninl = int(h_inl.sum())
        if max(e_ninl, h_ninl) < int(c.min_num_inliers):
            return fail

        planar = h_ninl > c.max_H_inlier_ratio * max(e_ninl, 1)
        if not planar and bool(e_out["success"]):
            R = e_out["R"].double().cpu().numpy()
            t = e_out["t"].double().cpu().numpy()
            inliers = e_inl
        else:  # the pose of the calibrated homography
            H = h_out["M_0to1"].double().cpu().numpy()
            Hn = np.linalg.inv(_K(camera1)) @ H @ _K(camera0)
            best, best_cnt = None, -1
            sample = np.flatnonzero(h_inl)[:32]
            for R, t in decompose_homography(Hn, n0, n1):
                nt = np.linalg.norm(t)
                tt = t / nt if nt > 1e-9 else t
                cnt = _cheirality_count(R, tt, n0[sample], n1[sample]) if nt > 1e-9 else 0
                if cnt > best_cnt or best is None:
                    best, best_cnt = (R, tt), cnt
            R, t = best
            inliers = h_inl
        return {"success": True,
                "M_0to1": Pose.from_Rt(torch.from_numpy(np.asarray(R, np.float32)),
                                       torch.from_numpy(np.asarray(t, np.float32))),
                "inliers": inliers}
