"""GT matcher from a known homography, the pipeline's `ground_truth`
component (counterpart of
`gluefactory_tpu/models/matchers/homography_matcher.py`): no parameters,
outputs `gt_matches0/1` and `gt_assignment`. Points only: line GT waits for
GlueStick's port."""

from __future__ import annotations

from ...geometry.gt_generation import gt_matches_from_homography
from ..base_model import BaseModel


class HomographyMatcher(BaseModel):
    default_conf = {
        "use_points": True,
        "use_lines": False,
        "th_positive": 3.0,
        "th_negative": 6.0,
        "n_line_sampled_pts": 50,
        "line_perp_dist_th": 5.0,
        "overlap_th": 0.2,
        "min_visibility_th": 0.5,
    }
    required_data_keys = ["H_0to1"]

    def _init(self, conf):
        if conf.use_lines:
            raise NotImplementedError("homography_matcher: use_lines needs GlueStick, not ported yet")

    def _forward(self, data: dict, train: bool = False) -> dict:
        result = {}
        if self.conf.use_points:
            out = gt_matches_from_homography(
                data["keypoints0"], data["keypoints1"], data["H_0to1"],
                pos_th=self.conf.th_positive, neg_th=self.conf.th_negative,
                mask0=data.get("keypoint_mask0"), mask1=data.get("keypoint_mask1"),
            )
            result["gt_matches0"] = out["matches0"]
            result["gt_matches1"] = out["matches1"]
            result["gt_assignment"] = out["assignment"]
        return result
