"""OpenCV's essential-matrix RANSAC and `recoverPose` (counterpart of
`gluefactory_tpu/robust_estimators/relative_pose/opencv.py`): on the host,
every candidate E that `findEssentialMat` returns decomposed, the one with
the most points in front of both cameras kept. cv2 is imported only here,
when the estimator is built, and its absence raises ImportError: no other
estimator is taken in its place."""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.wrappers import Pose
from ..base_estimator import BaseEstimator
from .xla_ransac import mean_focal


class OpenCVRelativePoseEstimator(BaseEstimator):
    default_conf = {
        "ransac_th": 0.5,  # pixels
        "options": {"confidence": 0.99999, "method": "ransac"},
    }

    def _init(self, conf):
        try:
            import cv2
        except ImportError as e:
            raise ImportError("the opencv relative-pose estimator needs OpenCV (cv2), which is "
                              "not installed; select eval.estimator=xla_ransac") from e
        self.cv2 = cv2
        self.method = {"ransac": cv2.RANSAC, "usac_magsac": cv2.USAC_MAGSAC}[conf.options.method]

    def _forward(self, data: dict) -> dict:
        cv2 = self.cv2
        kpts0 = np.asarray(data["m_kpts0"], np.float64)
        kpts1 = np.asarray(data["m_kpts1"], np.float64)
        camera0, camera1 = data["camera0"], data["camera1"]
        result = {"success": False, "M_0to1": Pose.identity(),
                  "inliers": np.zeros(len(kpts0), bool)}
        if len(kpts0) < 5:
            return result
        norm_thresh = self.conf.ransac_th / mean_focal(camera0, camera1)
        # normalized in float32, as the JAX package's cameras compute
        pts0 = camera0.normalize(torch.from_numpy(kpts0[None]).float())[0].numpy()
        pts1 = camera1.normalize(torch.from_numpy(kpts1[None]).float())[0].numpy()
        E, mask = cv2.findEssentialMat(pts0, pts1, np.eye(3), threshold=norm_thresh,
                                       prob=self.conf.options.confidence, method=self.method)
        if E is None:
            return result
        best_num_inliers = 0
        for E_ in np.split(E, len(E) / 3):
            n, R, t, mask_ = cv2.recoverPose(E_, pts0, pts1, np.eye(3), 1e9, mask=mask.copy())
            if n > best_num_inliers:
                best_num_inliers = n
                result = {"success": True,
                          "M_0to1": Pose.from_Rt(R.astype(np.float32),
                                                 t.squeeze(-1).astype(np.float32)),
                          "inliers": mask_.ravel().astype(bool)}
        return result
