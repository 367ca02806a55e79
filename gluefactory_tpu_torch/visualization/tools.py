"""The viewer's plot modes (counterpart of
`gluefactory_tpu/visualization/tools.py`): keypoints, their rank and score,
heatmaps, matches, their scores, GT matches, homography and depth
reprojection errors, epipolar lines, and the three line modes.

A mode is a callable `tool(fig, axes, data, pred)` that draws one
experiment's prediction onto one row of axes; `required_keys` lists the
pred / data keys it needs (the viewer keeps the modes that every
experiment can draw). `__plot_dict__` holds the point modes,
`__plot_lines_dict__` the line modes. The errors are the port's geometry
on the CPU in float32: `geometry.homography.sym_homography_error`,
`geometry.depth.symmetric_reprojection_error`, `eval.utils.pose_to_E`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import to_numpy
from .viz2d import (cm_ranking, cm_RdGn, plot_color_line_matches, plot_epipolar_lines,
                    plot_heatmaps, plot_keypoints, plot_lines, plot_matches)


def _tool(*required_keys):
    """Attach `required_keys` to a plot mode."""

    def wrap(fn):
        fn.required_keys = list(required_keys)
        return fn

    return wrap


class RadioHideTool:
    """Switches the rows between plot modes: `draw(name)` clears what the
    last mode drew (the background images stay) and draws `name` on each
    experiment's row."""

    def __init__(self, fig, axes, data, preds, plot_dict, default="keypoints"):
        self.fig = fig
        self.axes = axes  # one row of axes per experiment
        self.data = data
        self.preds = preds  # {name: pred}
        self.plot_dict = plot_dict
        # the images on each axis before any mode drew (colour, depth overlay)
        self._n_base_images = {id(ax): len(ax.images) for row in self.axes for ax in row}
        self.current = default if default in plot_dict else next(iter(plot_dict))
        self.draw(self.current)

    def clear(self):
        for row in self.axes:
            for ax in row:
                for artist in list(ax.lines) + list(ax.collections):
                    artist.remove()
                for im in list(ax.images)[self._n_base_images.get(id(ax), 1):]:
                    im.remove()
        self.fig.artists.clear()

    def draw(self, name):
        self.clear()
        tool = self.plot_dict[name]
        for row, pred in zip(self.axes, self.preds.values()):
            tool(self.fig, row, self.data, pred)
        self.current = name
        self.fig.canvas.draw_idle()


def _matched(pred):
    m0 = to_numpy(pred["matches0"])
    valid = m0 > -1
    return to_numpy(pred["keypoints0"])[valid], to_numpy(pred["keypoints1"])[m0[valid]], valid


def _f32(x) -> torch.Tensor:
    """A float32 CPU tensor with a leading batch axis of 1."""
    return torch.as_tensor(to_numpy(x), dtype=torch.float32)[None]


def _camera(camera):
    """A `Camera` (or its dict of size, f, c, dist) as a float32 CPU camera
    with a batch axis."""
    from ..geometry.wrappers import Camera

    if isinstance(camera, dict):
        camera = Camera(to_numpy(camera["size"]), to_numpy(camera["f"]), to_numpy(camera["c"]),
                        None if camera.get("dist") is None else to_numpy(camera["dist"]))
    return camera.map_tensors(_f32)


def _pose(T):
    """A `Pose` (or a 4 x 4 matrix) as a float32 CPU pose with a batch axis."""
    from ..geometry.wrappers import Pose

    if not isinstance(T, Pose):
        T = Pose.from_4x4mat(torch.as_tensor(to_numpy(T)))
    return T.map_tensors(_f32)


@_tool("view0", "view1")
def plot_images_tool(fig, axes, data, pred):
    """The bare images."""


@_tool("keypoints0", "keypoints1")
def plot_keypoints_tool(fig, axes, data, pred):
    plot_keypoints([pred["keypoints0"], pred["keypoints1"]], axes=axes, colors="royalblue")


@_tool("keypoints0", "keypoints1", "keypoint_scores0", "keypoint_scores1")
def plot_keypoint_ranking_tool(fig, axes, data, pred):
    """Keypoints coloured by score rank."""
    plot_keypoints([pred["keypoints0"], pred["keypoints1"]], axes=axes,
                   colors=[cm_ranking(pred["keypoint_scores0"]),
                           cm_ranking(pred["keypoint_scores1"])])


@_tool("keypoints0", "keypoints1", "keypoint_scores0", "keypoint_scores1")
def plot_keypoint_scores_tool(fig, axes, data, pred):
    """Keypoints coloured red -> green by score."""
    plot_keypoints([pred["keypoints0"], pred["keypoints1"]], axes=axes,
                   colors=[cm_RdGn(pred["keypoint_scores0"]), cm_RdGn(pred["keypoint_scores1"])])


@_tool("dense_score_map0", "dense_score_map1")
def plot_heatmaps_tool(fig, axes, data, pred):
    """The detectors' dense score maps (`dense_outputs: true`), through a
    sigmoid where they hold logits."""

    def prep(h):
        h = np.asarray(to_numpy(h), np.float32)
        h = h[0] if h.ndim == 3 and h.shape[0] == 1 else h
        return 1.0 / (1.0 + np.exp(-h)) if h.min() < 0.0 else h

    plot_heatmaps([prep(pred["dense_score_map0"]), prep(pred["dense_score_map1"])], axes=axes,
                  cmap="rainbow")


@_tool("keypoints0", "keypoints1", "matches0")
def plot_matches_tool(fig, axes, data, pred):
    k0, k1, _ = _matched(pred)
    plot_matches(k0, k1, color="lime", axes=axes, a=0.5)


@_tool("keypoints0", "keypoints1", "matches0", "matching_scores0")
def plot_matching_scores_tool(fig, axes, data, pred):
    """Matches coloured by confidence (viridis)."""
    import matplotlib.pyplot as plt

    k0, k1, valid = _matched(pred)
    colors = plt.cm.viridis(to_numpy(pred["matching_scores0"])[valid]).tolist()
    plot_matches(k0, k1, color=colors, axes=axes, a=0.5)


@_tool("keypoints0", "keypoints1", "matches0", "gt_matches0")
def plot_gt_matches_tool(fig, axes, data, pred):
    gt = to_numpy(pred["gt_matches0"] if "gt_matches0" in pred else data.get("gt_matches0"))
    k0, k1, valid = _matched(pred)
    correct = (to_numpy(pred["matches0"]) == gt)[valid]
    plot_matches(k0, k1, color=cm_RdGn(correct).tolist(), axes=axes, a=0.5)


@_tool("keypoints0", "keypoints1", "matches0", "H_0to1")
def plot_homography_error_tool(fig, axes, data, pred):
    """Matches green within 3 px of the homography (symmetric error)."""
    from ..geometry.homography import sym_homography_error

    k0, k1, _ = _matched(pred)
    if len(k0) == 0:
        return
    err = sym_homography_error(_f32(k0), _f32(k1), _f32(data["H_0to1"]))[0].numpy()
    plot_matches(k0, k1, color=cm_RdGn(err < 3.0).tolist(), axes=axes, a=0.5)


@_tool("keypoints0", "keypoints1", "matches0", "T_0to1")
def plot_reprojection_error_tool(fig, axes, data, pred):
    """Matches green within 3 px of their depth reprojection, where both
    depths are valid."""
    from ..geometry.depth import symmetric_reprojection_error

    if "depth" not in data.get("view0", {}):
        return
    k0, k1, _ = _matched(pred)
    if len(k0) == 0:
        return
    err, valid = symmetric_reprojection_error(
        _f32(k0), _f32(k1), _camera(data["view0"]["camera"]), _camera(data["view1"]["camera"]),
        _pose(data["T_0to1"]), _f32(data["view0"]["depth"]), _f32(data["view1"]["depth"]))
    correct = (err[0] < 3.0).numpy() & valid[0].numpy()
    plot_matches(k0, k1, color=cm_RdGn(correct).tolist(), axes=axes, a=0.5)


@_tool("keypoints0", "keypoints1", "matches0", "T_0to1")
def plot_epipolar_tool(fig, axes, data, pred):
    """The epipolar lines of the first 30 matches."""
    from ..eval.utils import pose_to_E

    E = pose_to_E(_pose(data["T_0to1"])[0])
    K0 = to_numpy(_camera(data["view0"]["camera"])[0].calibration_matrix())
    K1 = to_numpy(_camera(data["view1"]["camera"])[0].calibration_matrix())
    F = np.linalg.inv(K1).T @ E @ np.linalg.inv(K0)
    k0, k1, _ = _matched(pred)
    plot_epipolar_lines(k0[:30], k1[:30], F, axes=axes)


@_tool("lines0", "lines1")
def plot_lines_tool(fig, axes, data, pred):
    plot_lines([pred["lines0"], pred["lines1"]], axes=list(axes))


def _matched_lines(pred):
    m0 = to_numpy(pred["line_matches0"])
    valid = m0 > -1
    return to_numpy(pred["lines0"])[valid], to_numpy(pred["lines1"])[m0[valid]], m0, valid


@_tool("lines0", "lines1", "line_matches0")
def plot_line_matches_tool(fig, axes, data, pred):
    l0, l1, _, _ = _matched_lines(pred)
    plot_color_line_matches([l0, l1], axes=list(axes))


@_tool("lines0", "lines1", "line_matches0", "line_gt_matches0")
def plot_gt_line_matches_tool(fig, axes, data, pred):
    """Line matches coloured by GT correctness."""
    gt = to_numpy(pred["line_gt_matches0"] if "line_gt_matches0" in pred
                  else data.get("line_gt_matches0"))
    l0, l1, m0, valid = _matched_lines(pred)
    plot_color_line_matches([l0, l1], correct_matches=(m0 == gt)[valid], axes=list(axes))


__plot_dict__ = {
    "images": plot_images_tool,
    "keypoints": plot_keypoints_tool,
    "keypoint_ranking": plot_keypoint_ranking_tool,
    "keypoint_scores": plot_keypoint_scores_tool,
    "heatmaps": plot_heatmaps_tool,
    "matches": plot_matches_tool,
    "matching_scores": plot_matching_scores_tool,
    "gt_matches": plot_gt_matches_tool,
    "homography_error": plot_homography_error_tool,
    "depth_matches": plot_reprojection_error_tool,
    "epipolar_lines": plot_epipolar_tool,
}

__plot_lines_dict__ = {
    "lines": plot_lines_tool,
    "line_matches": plot_line_matches_tool,
    "gt_line_matches": plot_gt_line_matches_tool,
}
