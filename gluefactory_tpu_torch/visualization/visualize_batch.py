"""The trainer's figure hook (counterpart of
`gluefactory_tpu/visualization/visualize_batch.py`), named by the configs'
`train.plot: [every, "gluefactory_tpu_torch.visualization.visualize_batch.make_match_figures"]`.

`match_data` is the numpy part, which needs no matplotlib (it runs on the
card's host); `make_match_figures` draws it.
"""

from __future__ import annotations

from ..utils.tensor import to_numpy


def match_data(pred: dict, data: dict, n_pairs: int = 2) -> list[dict]:
    """For each of the first `n_pairs` pairs of a batch: its two images,
    its two keypoint sets, the matched keypoints (kpm0, kpm1) of
    `matches0`, and `correct`, each match's flag against `gt_matches0`
    (None without it). Tensors on any device; numpy out."""
    view0, view1 = data["view0"], data["view1"]
    n_pairs = min(n_pairs, view0["image"].shape[0])
    keys = [k for k in ("keypoints0", "keypoints1", "matches0", "gt_matches0") if k in pred]
    p = to_numpy({k: pred[k][:n_pairs] for k in keys})
    images0, images1 = to_numpy(view0["image"][:n_pairs]), to_numpy(view1["image"][:n_pairs])
    pairs = []
    for i in range(n_pairs):
        m0 = p["matches0"][i]
        valid = m0 > -1
        pairs.append({
            "images": [images0[i], images1[i]],
            "keypoints": [p["keypoints0"][i], p["keypoints1"][i]],
            "matches": (p["keypoints0"][i][valid], p["keypoints1"][i][m0[valid]]),
            "correct": p["gt_matches0"][i][valid] == m0[valid] if "gt_matches0" in p else None,
        })
    return pairs


def make_match_figures(pred_: dict, data_: dict, n_pairs: int = 2) -> dict:
    """{"match_{i}": figure} of the first `n_pairs` pairs: the images, every
    keypoint in blue, the matches green where `gt_matches0` agrees and red
    where not (lime without it)."""
    import matplotlib.pyplot as plt

    from .viz2d import cm_RdGn, plot_images, plot_keypoints, plot_matches

    figs = {}
    for i, pair in enumerate(match_data(pred_, data_, n_pairs)):
        plot_images(pair["images"])
        plot_keypoints(pair["keypoints"], colors="royalblue")
        color = "lime" if pair["correct"] is None else cm_RdGn(pair["correct"]).tolist()
        plot_matches(*pair["matches"], color=color, a=0.5, lw=1.0, ps=0)
        figs[f"match_{i}"] = plt.gcf()
    return figs
