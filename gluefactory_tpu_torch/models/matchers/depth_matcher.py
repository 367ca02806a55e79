"""GT matcher from a relative pose and depth maps, the pipeline's
`ground_truth` component for MegaDepth (counterpart of
`gluefactory_tpu/models/matchers/depth_matcher.py`): no parameters, wraps
`gt_matches_from_pose_depth` (`th_positive`, `th_negative`, `th_epi`,
`ccth`, the keypoint masks) and outputs `gt_matches0/1`, `gt_assignment`
and `gt_visible0/1`. Always in float32: the cameras, poses and depths are
stored so, and bf16 training never reaches them. With `use_lines`, also
the line GT (`geometry/gt_lines.gt_line_matches_from_pose_depth`):
`gt_line_matches0/1` and `gt_line_assignment`."""

from __future__ import annotations

from ...geometry.gt_generation import gt_matches_from_pose_depth
from ...geometry.gt_lines import gt_line_matches_from_pose_depth
from ..base_model import BaseModel


class DepthMatcher(BaseModel):
    default_conf = {
        "use_points": True,
        "use_lines": False,
        "th_positive": 3.0,
        "th_negative": 5.0,
        "th_epi": None,  # epipolar threshold (px) for extra negatives
        "ccth": None,  # cycle-consistency relative depth threshold
        "n_line_sampled_pts": 50,
        "line_perp_dist_th": 5.0,
        "overlap_th": 0.2,
        "min_visibility_th": 0.5,
    }
    required_data_keys = ["view0", "view1", "T_0to1"]

    def _init(self, conf):
        pass

    def _forward(self, data: dict, train: bool = False) -> dict:
        result = {}
        if self.conf.use_points:
            out = gt_matches_from_pose_depth(
                data["keypoints0"], data["keypoints1"], data["view0"]["camera"],
                data["view1"]["camera"], data["T_0to1"], data["view0"]["depth"],
                data["view1"]["depth"], pos_th=self.conf.th_positive, neg_th=self.conf.th_negative,
                epi_th=self.conf.th_epi, ccth=self.conf.ccth, mask0=data.get("keypoint_mask0"),
                mask1=data.get("keypoint_mask1"))
            result["gt_matches0"] = out["matches0"]
            result["gt_matches1"] = out["matches1"]
            result["gt_assignment"] = out["assignment"]
            result["gt_visible0"] = out["visible0"]
            result["gt_visible1"] = out["visible1"]
        if self.conf.use_lines:
            c = self.conf
            out = gt_line_matches_from_pose_depth(
                data["lines0"], data["lines1"], data["line_mask0"], data["line_mask1"],
                data["view0"]["camera"], data["view1"]["camera"], data["T_0to1"],
                data["view0"]["depth"], data["view1"]["depth"], n_samples=c.n_line_sampled_pts,
                perp_dist_th=c.line_perp_dist_th, overlap_th=c.overlap_th,
                min_visibility_th=c.min_visibility_th)
            result["gt_line_matches0"] = out["matches0"]
            result["gt_line_matches1"] = out["matches1"]
            result["gt_line_assignment"] = out["assignment"]
        return result
