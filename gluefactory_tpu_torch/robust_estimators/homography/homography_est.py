"""The point and line homography RANSAC (`ops/ransac.ransac_homography_hybrid`)
as an estimator: the counterpart of
`gluefactory_tpu/robust_estimators/homography/homography_est.py`, whose name
the configs select.

Points and lines are padded to the JAX estimator's buckets (points to a power
of two of at least 64, lines of at least 16) with validity masks, so a seed
draws the JAX package's minimal sets. The RANSAC runs on `conf.device`
(`cuda` unless the caller asks for the CPU); the result comes back to the
host as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.ransac import ransac_homography_hybrid
from ..base_estimator import BaseEstimator
from .xla_ransac import bucket_pad


def bucket_pad_lines(lines0, lines1, min_size: int = 16):
    """(l0, l1, valid, n): the segments zero-padded to the next power of two
    of at least `min_size`, and the mask of the real ones."""
    n = len(lines0)
    size = max(min_size, 1 << int(np.ceil(np.log2(max(n, 1)))))
    valid = np.zeros(size, bool)
    valid[:n] = True
    l0 = np.zeros((size, 2, 2), np.float32)
    l1 = np.zeros((size, 2, 2), np.float32)
    l0[:n] = lines0
    l1[:n] = lines1
    return l0, l1, valid, n


class PointLineHomographyEstimator(BaseEstimator):
    default_conf = {"ransac_th": 2.0, "n_iters": 1024, "seed": 0, "device": "cuda"}

    def _forward(self, data: dict) -> dict:
        pts0 = np.asarray(data.get("m_kpts0", np.zeros((0, 2))), np.float32)
        pts1 = np.asarray(data.get("m_kpts1", np.zeros((0, 2))), np.float32)
        lines0 = np.asarray(data.get("m_lines0", np.zeros((0, 2, 2))), np.float32)
        lines1 = np.asarray(data.get("m_lines1", np.zeros((0, 2, 2))), np.float32)
        if len(pts0) < 4:
            return {"success": False, "M_0to1": np.eye(3, dtype=np.float32),
                    "inliers": np.zeros(len(pts0), bool)}
        p0, p1, pvalid, n = bucket_pad(pts0, pts1)
        l0, l1, lvalid, nl = bucket_pad_lines(lines0, lines1)
        dev = torch.device(self.conf.device)
        t = [torch.from_numpy(a).to(dev) for a in (p0, p1, pvalid, l0, l1, lvalid)]
        out = ransac_homography_hybrid(*t, float(self.conf.ransac_th), seed=int(self.conf.seed),
                                       n_iters=int(self.conf.n_iters))
        return {"success": bool(out["success"]),
                "M_0to1": out["M_0to1"].cpu().numpy().astype(np.float32),
                "inliers": out["inliers"].cpu().numpy()[:n],
                "line_inliers": out["line_inliers"].cpu().numpy()[:nl]}
