"""Per-pair evaluation metrics (counterpart of `gluefactory_tpu/eval/utils.py`,
its homography and generic parts).

They run in the eval pipeline's second loop, one item at a time on the
host, in numpy over the cached predictions; the robust estimators come from
the registry (`xla_ransac` runs on the device its conf names). The
epipolar, depth and relative-pose metrics wait for the camera geometry
(`geometry/wrappers.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.homography import compute_homography_dlt
from ..robust_estimators import load_estimator
from ..utils.tools import AUCMetric


def warp_points_np(points: np.ndarray, H: np.ndarray, inverse: bool = False) -> np.ndarray:
    H = np.linalg.inv(H) if inverse else H
    pts_h = np.concatenate([points, np.ones_like(points[..., :1])], axis=-1)
    warped = pts_h @ H.T
    return warped[..., :2] / (warped[..., 2:] + 1e-12)


def sym_homography_error_np(kpts0, kpts1, H) -> np.ndarray:
    d01 = np.linalg.norm(warp_points_np(kpts0, H) - kpts1, axis=-1)
    d10 = np.linalg.norm(warp_points_np(kpts1, H, inverse=True) - kpts0, axis=-1)
    return 0.5 * (d01 + d10)


def get_matches_scores(kpts0, kpts1, matches0, mscores0):
    """The matched keypoint pairs and their scores (unbatched arrays)."""
    matches0 = np.asarray(matches0)
    valid = matches0 > -1
    m_kpts0 = np.asarray(kpts0)[valid]
    m_kpts1 = np.asarray(kpts1)[matches0[valid]]
    scores = np.asarray(mscores0)[valid]
    return m_kpts0, m_kpts1, scores


def _matches(pred: dict):
    return get_matches_scores(pred["keypoints0"], pred["keypoints1"], pred["matches0"],
                              pred["matching_scores0"])


def _precision(err: np.ndarray, th: float) -> float:
    """Share of errors below `th`; 0 without matches."""
    return float(np.nan_to_num((err < th).mean() if err.size else np.nan))


def eval_matches_homography(data: dict, pred: dict) -> dict:
    H_gt = np.asarray(data["H_0to1"])
    pts0, pts1, _ = _matches(pred)
    err = sym_homography_error_np(pts0, pts1, H_gt)
    n0 = np.asarray(pred.get("keypoint_mask0", np.ones(len(pred["keypoints0"]), bool))).sum()
    n1 = np.asarray(pred.get("keypoint_mask1", np.ones(len(pred["keypoints1"]), bool))).sum()
    return {
        "prec@1px": _precision(err, 1),
        "prec@3px": _precision(err, 3),
        "num_matches": int(pts0.shape[0]),
        "num_keypoints": float(n0 + n1) / 2.0,
    }


def homography_corner_error_np(H, H_gt, image_size) -> float:
    w, h = float(image_size[0]), float(image_size[1])
    corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    d = np.linalg.norm(warp_points_np(corners, np.asarray(H, np.float64))
                       - warp_points_np(corners, np.asarray(H_gt, np.float64)), axis=-1)
    return float(d.mean())


def eval_homography_robust(data: dict, pred: dict, conf) -> dict:
    """The estimator `conf["estimator"]` on the matches, and its corner
    error; `conf` also goes to the estimator (`ransac_th`, `device`)."""
    H_gt = np.asarray(data["H_0to1"])
    pts0, pts1, _ = _matches(pred)
    est_data = {"m_kpts0": pts0, "m_kpts1": pts1}
    if "line_matches0" in pred:
        lm0 = np.asarray(pred["line_matches0"])
        lvalid = lm0 > -1
        est_data["m_lines0"] = np.asarray(pred["lines0"])[lvalid]
        est_data["m_lines1"] = np.asarray(pred["lines1"])[lm0[lvalid]]
    est = load_estimator("homography", conf["estimator"])(conf)(est_data)
    if not est["success"]:
        return {"H_error_ransac": np.inf, "ransac_inl": 0, "ransac_inl%": 0.0}
    inl = np.asarray(est["inliers"])
    err = homography_corner_error_np(np.asarray(est["M_0to1"]), H_gt,
                                     np.asarray(data["view0"]["image_size"]))
    return {
        "H_error_ransac": float(err),
        "ransac_inl": int(inl.sum()),
        "ransac_inl%": float(inl.mean()) if inl.size else 0.0,
    }


def eval_homography_dlt(data: dict, pred: dict) -> dict:
    """Weighted DLT homography from all matches, weighted by their scores,
    on the CPU as the JAX package pins it; NaN with fewer than 4 matches or
    no positive score."""
    pts0, pts1, scores = _matches(pred)
    error = np.nan
    if pts0.shape[0] >= 4 and scores.sum() > 0:
        H = compute_homography_dlt(torch.from_numpy(np.asarray(pts0, np.float32)[None]),
                                   torch.from_numpy(np.asarray(pts1, np.float32)[None]),
                                   torch.from_numpy(np.asarray(scores, np.float32)[None]))
        H = H[0].numpy()
        if np.isfinite(H).all():
            error = homography_corner_error_np(H, np.asarray(data["H_0to1"]),
                                               np.asarray(data["view0"]["image_size"]))
    return {"H_error_dlt": float(error)}


IGNORE_FEATURE = -2


def get_tp_fp_pts(pred_matches, gt_matches, pred_scores):
    """TP / FP flags and scores of the predicted matches, and the number of
    positives, leaving out the ignored features."""
    pred_matches = np.asarray(pred_matches)
    gt_matches = np.asarray(gt_matches)
    pred_scores = np.asarray(pred_scores)
    keep = gt_matches != IGNORE_FEATURE
    pred_matches, gt_matches, pred_scores = pred_matches[keep], gt_matches[keep], pred_scores[keep]
    num_pos = int(np.sum(gt_matches != -1))
    positive = pred_matches != -1
    tp = pred_matches[positive] == gt_matches[positive]
    fp = pred_matches[positive] != gt_matches[positive]
    return tp, fp, pred_scores[positive], num_pos


def AP(tp, fp):
    """Average precision of a PR curve, precision made monotone."""
    recall = tp
    precision = tp / np.maximum(tp + fp, 1e-9)
    recall = np.concatenate(([0.0], recall, [1.0]))
    precision = np.concatenate(([0.0], precision, [0.0]))
    for i in range(precision.size - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    i = np.where(recall[1:] != recall[:-1])[0]
    return float(np.sum((recall[i + 1] - recall[i]) * precision[i + 1]))


def aggregate_pr_results(results: dict, suffix: str = "") -> dict:
    """Per-pair TP / FP lists into a PR curve and its AP (in %)."""
    tp_list = np.concatenate(results["tp" + suffix], axis=0)
    fp_list = np.concatenate(results["fp" + suffix], axis=0)
    scores_list = np.concatenate(results["scores" + suffix], axis=0)
    n_gt = max(results["num_pos" + suffix], 1)
    idx = np.argsort(scores_list)[::-1]
    tp_vals = np.cumsum(tp_list[idx]) / n_gt
    fp_vals = np.cumsum(fp_list[idx]) / n_gt
    return {
        "curve_recall" + suffix: tp_vals,
        "curve_precision" + suffix: tp_vals / np.maximum(tp_vals + fp_vals, 1e-9),
        "AP" + suffix: AP(tp_vals, fp_vals) * 100,
    }


def eval_poses(pose_results: dict, auc_ths: list, key: str, unit: str = "°"):
    """The RANSAC threshold with the best mAA, and its AUCs and medians.
    `pose_results` is {threshold: {key: [per-pair errors], ...}}; returns
    (summaries, best threshold)."""
    pose_aucs = {th: AUCMetric(auc_ths, r[key]).compute() for th, r in pose_results.items()}
    mAAs = {k: np.mean(v) for k, v in pose_aucs.items()}
    best_th = max(mAAs, key=mAAs.get)
    if len(pose_results) > 1:
        print("Tested ransac setup with following results:")
        for k, v in mAAs.items():
            print(f"AUC {k}: {v}")
        print(f"Best threshold: {best_th}")
    summaries = {f"{key}@{ath}{unit}": pose_aucs[best_th][i] for i, ath in enumerate(auc_ths)}
    summaries[f"{key}_mAA"] = mAAs[best_th]
    for k, v in pose_results[best_th].items():
        arr = np.asarray(v, dtype=np.float64)
        if arr.ndim == 1:
            summaries[f"m{k}"] = float(round(np.median(arr), 3))
    return summaries, best_th
