"""Per-pair evaluation metrics (counterpart of `gluefactory_tpu/eval/utils.py`).

They run in the eval pipeline's second loop, one item at a time on the
host, in numpy over the cached predictions, and the depth metrics in torch
on the CPU, where the JAX package pins them; the robust estimators come
from the registry (`xla_ransac` runs on the device its conf names).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.depth import symmetric_reprojection_error
from ..geometry.gt_generation import gt_matches_from_pose_depth
from ..geometry.homography import compute_homography_dlt
from ..geometry.wrappers import Camera, Pose
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


def sym_epipolar_distance_np(p0, p1, E, squared=True) -> np.ndarray:
    """Symmetric epipolar distance; its non-squared form is the mean of the
    two point-to-line distances."""
    p0h = np.concatenate([p0, np.ones_like(p0[..., :1])], -1)
    p1h = np.concatenate([p1, np.ones_like(p1[..., :1])], -1)
    Ep0 = p0h @ E.T
    Etp1 = p1h @ E
    p1Ep0 = np.sum(p1h * Ep0, -1)
    d0 = np.maximum(Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2, 1e-6)
    d1 = np.maximum(Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2, 1e-6)
    if squared:
        return p1Ep0**2 * (1.0 / d0 + 1.0 / d1)
    return np.abs(p1Ep0) * (1.0 / np.sqrt(d0) + 1.0 / np.sqrt(d1)) / 2.0


def pose_to_E(T: Pose) -> np.ndarray:
    R, t = np.asarray(T.R), np.asarray(T.t)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], dtype=np.float64)
    return tx @ R


def angle_error_mat_np(R1, R2):
    cos = np.clip((np.trace(R1.T @ R2) - 1) / 2, -1.0, 1.0)
    return np.rad2deg(np.abs(np.arccos(cos)))


def angle_error_vec_np(v1, v2):
    """The angle between two directions, up to sign (at most 90 degrees)."""
    n = np.linalg.norm(v1) * np.linalg.norm(v2)
    err = np.rad2deg(np.arccos(np.clip(np.dot(v1, v2) / (n + 1e-15), -1.0, 1.0)))
    return min(err, 180.0 - err)


def relative_pose_error_np(T_0to1: Pose, R, t):
    """(rotation error, translation direction error) in degrees."""
    R_gt, t_gt = np.asarray(T_0to1.R), np.asarray(T_0to1.t)
    return angle_error_mat_np(np.asarray(R), R_gt), angle_error_vec_np(np.asarray(t), t_gt)


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


def eval_matches_epipolar(data: dict, pred: dict) -> dict:
    """The matches' epipolar precisions (mean line distance in normalized
    coordinates below 1e-4, 5e-4, 1e-3; 0 without matches)."""
    camera0: Camera = data["view0"]["camera"]
    camera1: Camera = data["view1"]["camera"]
    pts0, pts1, _ = _matches(pred)
    p0 = camera0.normalize(torch.from_numpy(np.asarray(pts0, np.float32)[None]))[0].numpy()
    p1 = camera1.normalize(torch.from_numpy(np.asarray(pts1, np.float32)[None]))[0].numpy()
    epi_err = sym_epipolar_distance_np(p0, p1, pose_to_E(data["T_0to1"]), squared=False)
    return {
        "epi_prec@1e-4": _precision(epi_err, 1e-4),
        "epi_prec@5e-4": _precision(epi_err, 5e-4),
        "epi_prec@1e-3": _precision(epi_err, 1e-3),
        "num_matches": int(pts0.shape[0]),
        "num_keypoints": (len(pred["keypoints0"]) + len(pred["keypoints1"])) / 2.0,
    }


def _batched(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)[None])


def eval_matches_depth(data: dict, pred: dict) -> dict:
    """Reprojection precisions through the GT depths (over the matches with
    valid depth in both views; 0 without any), the covisible count and
    share, and the recall and precision of the matches against GT matches
    from pose and depth at 3 / 5 px. On the CPU, in float32."""
    camera0: Camera = data["view0"]["camera"]
    camera1: Camera = data["view1"]["camera"]
    T_0to1: Pose = data["T_0to1"]
    depth0, depth1 = _batched(data["view0"]["depth"]), _batched(data["view1"]["depth"])
    pts0, pts1, _ = _matches(pred)
    results: dict = {"num_matches": int(pts0.shape[0])}
    if pts0.shape[0] == 0:
        results.update({"reproj_prec@1px": 0.0, "reproj_prec@3px": 0.0, "reproj_prec@5px": 0.0,
                        "covisible": 0.0, "covisible_percent": 0.0})
    else:
        err, valid = symmetric_reprojection_error(_batched(pts0), _batched(pts1), camera0, camera1,
                                                  T_0to1, depth0, depth1)
        err, valid = err[0].numpy(), valid[0].numpy()
        sel = np.nan_to_num(err[valid], nan=np.inf)
        results.update({
            "reproj_prec@1px": _precision(sel, 1),
            "reproj_prec@3px": _precision(sel, 3),
            "reproj_prec@5px": _precision(sel, 5),
            "covisible": float(valid.sum()),
            "covisible_percent": float(valid.mean()) * 100.0,
        })
    gt = gt_matches_from_pose_depth(_batched(pred["keypoints0"]), _batched(pred["keypoints1"]),
                                    camera0, camera1, T_0to1, depth0, depth1, pos_th=3.0, neg_th=5.0)
    gt_m = gt["matches0"][0].numpy()
    m = np.asarray(pred["matches0"])
    pos = (gt_m > -1).astype(np.float64)
    results["gt_match_recall@3px"] = float(((m == gt_m) * pos).sum() / (1e-8 + pos.sum()))
    pmask = ((m > -1) & (gt_m >= -1)).astype(np.float64)
    results["gt_match_precision@3px"] = float(((m == gt_m) * pmask).sum() / (1e-8 + pmask.sum()))
    return results


def eval_relative_pose_robust(data: dict, pred: dict, conf) -> dict:
    """The estimator `conf["estimator"]` on the matches and its pose error,
    the larger of the rotation and translation angles (inf where it
    fails); `conf` also goes to the estimator (`ransac_th`, `device`)."""
    pts0, pts1, _ = _matches(pred)
    est = load_estimator("relative_pose", conf["estimator"])(conf)(
        {"m_kpts0": pts0, "m_kpts1": pts1, "camera0": data["view0"]["camera"],
         "camera1": data["view1"]["camera"]})
    if not est["success"]:
        return {"rel_pose_error": np.inf, "ransac_inl": 0, "ransac_inl%": 0.0}
    inl = np.asarray(est["inliers"])
    r_err, t_err = relative_pose_error_np(data["T_0to1"], est["M_0to1"].R, est["M_0to1"].t)
    return {
        "rel_pose_error": float(max(r_err, t_err)),
        "ransac_inl": int(inl.sum()),
        "ransac_inl%": float(inl.mean()) if inl.size else 0.0,
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
