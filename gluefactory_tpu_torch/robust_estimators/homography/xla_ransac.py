"""The batched homography RANSAC (`ops/ransac.py`) as an estimator: the
counterpart of `gluefactory_tpu/robust_estimators/homography/xla_ransac.py`,
whose name the configs select.

The matches are padded to the JAX estimator's power-of-two bucket (at least
64) with a validity mask: the Gumbel noise's shape is (n_iters, bucket), so
the same bucket gives the same minimal sets. The RANSAC runs on
`conf.device` (`cuda` unless the caller asks for the CPU); the result comes
back to the host as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.ransac import ransac_homography
from ..base_estimator import BaseEstimator


def bucket_pad(pts0, pts1, min_size: int = 64):
    """(p0, p1, valid, n): the points zero-padded to the next power of two
    of at least `min_size`, and the mask of the real ones."""
    n = len(pts0)
    size = max(min_size, 1 << int(np.ceil(np.log2(max(n, 1)))))
    valid = np.zeros(size, bool)
    valid[:n] = True
    p0 = np.zeros((size, 2), np.float32)
    p1 = np.zeros((size, 2), np.float32)
    p0[:n] = pts0
    p1[:n] = pts1
    return p0, p1, valid, n


class XLAHomographyEstimator(BaseEstimator):
    default_conf = {
        "ransac_th": 3.0,
        "n_iters": 1024,
        "seed": 0,
        "device": "cuda",
    }

    def _forward(self, data: dict) -> dict:
        pts0 = np.asarray(data["m_kpts0"], np.float32)
        pts1 = np.asarray(data["m_kpts1"], np.float32)
        if len(pts0) < 4:
            return {"success": False, "M_0to1": np.eye(3, dtype=np.float32),
                    "inliers": np.zeros(len(pts0), bool)}
        p0, p1, valid, n = bucket_pad(pts0, pts1)
        device = torch.device(self.conf.device)
        out = ransac_homography(
            torch.from_numpy(p0).to(device), torch.from_numpy(p1).to(device),
            torch.from_numpy(valid).to(device), float(self.conf.ransac_th),
            seed=int(self.conf.seed), n_iters=int(self.conf.n_iters))
        return {"success": bool(out["success"]),
                "M_0to1": out["M_0to1"].cpu().numpy().astype(np.float32),
                "inliers": out["inliers"].cpu().numpy()[:n]}
