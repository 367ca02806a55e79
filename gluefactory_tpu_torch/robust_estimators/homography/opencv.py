"""OpenCV's homography RANSAC (counterpart of
`gluefactory_tpu/robust_estimators/homography/opencv.py`): the same
`cv2.findHomography` call, on the host. cv2 is imported only here, when the
estimator is built, and its absence raises ImportError: no other estimator
is taken in its place."""

from __future__ import annotations

import numpy as np

from ..base_estimator import BaseEstimator


class OpenCVHomographyEstimator(BaseEstimator):
    default_conf = {
        "method": "ransac",  # ransac | lmeds | rho | usac | usac_magsac
        "ransac_th": 3.0,
        "options": {"max_iters": 3000, "confidence": 0.995},
    }

    def _init(self, conf):
        try:
            import cv2
        except ImportError as e:
            raise ImportError("the opencv homography estimator needs OpenCV (cv2), which is "
                              "not installed; select eval.estimator=xla_ransac") from e
        self.cv2 = cv2
        self.method = {
            "ransac": cv2.RANSAC,
            "lmeds": cv2.LMEDS,
            "rho": cv2.RHO,
            "usac": cv2.USAC_DEFAULT,
            "usac_fast": cv2.USAC_FAST,
            "usac_accurate": cv2.USAC_ACCURATE,
            "usac_prosac": cv2.USAC_PROSAC,
            "usac_magsac": cv2.USAC_MAGSAC,
        }[conf.method]

    def _forward(self, data: dict) -> dict:
        pts0 = np.asarray(data["m_kpts0"], np.float64)
        pts1 = np.asarray(data["m_kpts1"], np.float64)
        if len(pts0) < 4:
            return {"success": False, "M_0to1": np.eye(3, dtype=np.float32),
                    "inliers": np.zeros(len(pts0), bool)}
        M, mask = self.cv2.findHomography(
            pts0, pts1, self.method, self.conf.ransac_th,
            maxIters=self.conf.options.max_iters, confidence=self.conf.options.confidence)
        if M is None:
            return {"success": False, "M_0to1": np.eye(3, dtype=np.float32),
                    "inliers": np.zeros(len(pts0), bool)}
        return {"success": True, "M_0to1": M.astype(np.float32),
                "inliers": mask.ravel().astype(bool)}
