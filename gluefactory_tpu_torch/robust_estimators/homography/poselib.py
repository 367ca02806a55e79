"""The in-repo LO-RANSAC homography estimator under PoseLib's name
(counterpart of `gluefactory_tpu/robust_estimators/homography/poselib.py`):
4-point DLT hypotheses, MSAC scoring of the symmetric transfer error and
local optimisation by weighted DLT, in C++ on the host
(`robust_estimators/native.py`)."""

from __future__ import annotations

import numpy as np

from ..base_estimator import BaseEstimator
from ..native import ransac_homography_native


class PoseLibHomographyEstimator(BaseEstimator):
    default_conf = {"ransac_th": 2.0, "options": {"max_iterations": 2000}, "seed": 0}

    def _forward(self, data: dict) -> dict:
        pts0 = np.asarray(data["m_kpts0"], np.float64)
        pts1 = np.asarray(data["m_kpts1"], np.float64)
        if len(pts0) < 4:
            return {"success": False, "M_0to1": np.eye(3, dtype=np.float32),
                    "inliers": np.zeros(len(pts0), bool)}
        H, inliers, num = ransac_homography_native(
            pts0, pts1, self.conf.ransac_th, max_iters=self.conf.options.max_iterations,
            seed=self.conf.seed)
        return {"success": num >= 4 and bool(np.isfinite(H).all()),
                "M_0to1": H.astype(np.float32), "inliers": inliers}
