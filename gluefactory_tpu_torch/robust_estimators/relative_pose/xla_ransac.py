"""The batched essential-matrix RANSAC (`ops/ransac.py::ransac_essential`)
as a relative-pose estimator: the counterpart of
`gluefactory_tpu/robust_estimators/relative_pose/xla_ransac.py`, whose name
the configs select.

The matches are normalized by each camera, padded to the homography
estimator's power-of-two bucket with a validity mask (so a seed gives the
JAX package's minimal sets) and the pixel threshold becomes `ransac_th`
over the cameras' mean focal length. The RANSAC runs on `conf.device`
(`cuda` unless the caller asks for the CPU), the cameras moved there; the
pose and inliers come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.wrappers import Pose
from ...ops.ransac import ransac_essential
from ..base_estimator import BaseEstimator
from ..homography.xla_ransac import bucket_pad


def mean_focal(camera0, camera1) -> float:
    """The mean of the two cameras' mean focal lengths, in pixels."""
    return 0.5 * (float(camera0.f.float().mean()) + float(camera1.f.float().mean()))


class XLARelativePoseEstimator(BaseEstimator):
    default_conf = {
        "ransac_th": 1.0,  # pixels
        "solver": "5pt",  # 5pt | 8pt
        "n_iters": 512,
        "seed": 0,
        "device": "cuda",
    }

    def _forward(self, data: dict) -> dict:
        kpts0 = np.asarray(data["m_kpts0"], np.float32)
        kpts1 = np.asarray(data["m_kpts1"], np.float32)
        if len(kpts0) < (5 if self.conf.solver == "5pt" else 8):
            return {"success": False, "M_0to1": Pose.identity(),
                    "inliers": np.zeros(len(kpts0), bool)}
        device = torch.device(self.conf.device)
        camera0, camera1 = data["camera0"].to(device), data["camera1"].to(device)
        norm_th = float(self.conf.ransac_th) / mean_focal(data["camera0"], data["camera1"])
        p0, p1, valid, n = bucket_pad(kpts0, kpts1)
        valid = torch.from_numpy(valid).to(device)
        p0 = torch.where(valid[:, None], camera0.normalize(torch.from_numpy(p0).to(device)[None])[0], 0.0)
        p1 = torch.where(valid[:, None], camera1.normalize(torch.from_numpy(p1).to(device)[None])[0], 0.0)
        out = ransac_essential(p0, p1, valid, norm_th, seed=int(self.conf.seed),
                               n_iters=int(self.conf.n_iters), solver=str(self.conf.solver))
        return {"success": bool(out["success"]),
                "M_0to1": Pose.from_Rt(out["R"].cpu(), out["t"].cpu()),
                "inliers": out["inliers"].cpu().numpy()[:n]}
