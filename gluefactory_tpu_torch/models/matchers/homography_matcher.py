"""GT matcher from a known homography, the pipeline's `ground_truth`
component (counterpart of
`gluefactory_tpu/models/matchers/homography_matcher.py`): no parameters,
outputs `gt_matches0/1` and `gt_assignment`; with `use_lines`, also
`gt_line_matches0/1` and `gt_line_assignment`
(`geometry/gt_lines.gt_line_matches_from_homography`, on the images' (h, w))."""

from __future__ import annotations

from ...geometry.gt_generation import gt_matches_from_homography
from ...geometry.gt_lines import gt_line_matches_from_homography
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
        pass

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
        if self.conf.use_lines:
            c = self.conf
            out = gt_line_matches_from_homography(
                data["lines0"], data["lines1"], data["line_mask0"], data["line_mask1"],
                tuple(data["view0"]["image"].shape[1:3]), tuple(data["view1"]["image"].shape[1:3]),
                data["H_0to1"], n_samples=c.n_line_sampled_pts, perp_dist_th=c.line_perp_dist_th,
                overlap_th=c.overlap_th, min_visibility_th=c.min_visibility_th)
            result["gt_line_matches0"] = out["matches0"]
            result["gt_line_matches1"] = out["matches1"]
            result["gt_line_assignment"] = out["assignment"]
        return result
