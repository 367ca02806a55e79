"""The in-repo LO-RANSAC relative-pose estimator under PoseLib's name
(counterpart of `gluefactory_tpu/robust_estimators/relative_pose/poselib.py`):
5-point minimal hypotheses, MSAC scoring with adaptive termination at 99.9%
confidence, weighted 8-point local optimisation and the cheirality-resolved
decomposition, in C++ on the host (`robust_estimators/native.py`). The
matches are normalized by the port's `Camera` in float32, as the JAX
estimator normalizes them, and the pixel threshold becomes `ransac_th` over
the cameras' mean focal length."""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.wrappers import Pose
from ..base_estimator import BaseEstimator
from ..native import ransac_essential_native
from .xla_ransac import mean_focal


def normalized(camera, kpts: np.ndarray) -> np.ndarray:
    """Pixel points (N, 2) normalized by `camera` on the CPU in float32."""
    pts = torch.from_numpy(np.array(kpts, np.float32))[None]
    return camera.to(torch.device("cpu")).normalize(pts)[0].numpy()


class PoseLibRelativePoseEstimator(BaseEstimator):
    default_conf = {"ransac_th": 2.0, "options": {"max_iterations": 2000}, "seed": 0}

    def _forward(self, data: dict) -> dict:
        kpts0 = np.asarray(data["m_kpts0"], np.float64)
        kpts1 = np.asarray(data["m_kpts1"], np.float64)
        camera0, camera1 = data["camera0"], data["camera1"]
        if len(kpts0) < 5:
            return {"success": False, "M_0to1": Pose.identity(), "inliers": np.zeros(len(kpts0), bool)}
        R, t, inliers, num = ransac_essential_native(
            normalized(camera0, kpts0), normalized(camera1, kpts1),
            self.conf.ransac_th / mean_focal(camera0, camera1),
            max_iters=self.conf.options.max_iterations, seed=self.conf.seed)
        return {"success": num >= 5,
                "M_0to1": Pose.from_Rt(torch.from_numpy(R.astype(np.float32)),
                                       torch.from_numpy(t.astype(np.float32))),
                "inliers": inliers}
