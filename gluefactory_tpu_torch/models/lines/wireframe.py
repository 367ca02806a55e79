"""Wireframe extractor: a point extractor and the LSD in GlueStick's input
format (counterpart of `gluefactory_tpu/models/lines/wireframe.py`).

1. The point extractor (SuperPoint) runs with its dense descriptors, on the
   device of the images.
2. Unless the data holds a precomputed wireframe (`precompute_wireframe`),
   the images come to the host once a forward, LSD runs on each view in a
   thread pool (`lsd.detect_lsd_host`), and line endpoints are clustered
   into junctions (`cluster_endpoints_host`, numpy); the seven arrays go
   back to the device.
3. On the device (`_assemble`): keypoints within `nms_radius` of a junction
   are masked, junction descriptors are sampled from the dense map, line
   endpoints are snapped to their junctions, and the node list is the
   `2 * max_num_lines` junction slots first, then the keypoints.

A host step that fails raises; nothing degrades to "no lines".
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.grid_sample import sample_descriptors
from .. import get_model
from ..base_model import BaseModel
from .lsd import detect_lsd_host

WIREFRAME_KEYS = ("lines", "line_scores", "line_mask", "junctions", "junc_scores", "junc_mask",
                  "lines_junc_idx")


def cluster_endpoints_host(lines: np.ndarray, valid: np.ndarray, radius: float,
                           line_scores: np.ndarray | None = None):
    """DBSCAN(eps=radius, min_samples=1) of the valid line endpoints: the
    connected components of the graph of pairs within `radius` (<=), by
    union-find, labelled in order of first occurrence; a junction is the mean
    of its endpoints, its score the mean of their lines' scores.

    lines (L, 2, 2), valid (L,). Returns junctions (2L, 2), junction scores
    (2L,), junction mask (2L,) and lines_junc_idx (L, 2)."""
    L = lines.shape[0]
    J_max = 2 * L
    endpoints = lines.reshape(-1, 2)
    ep_valid = np.repeat(valid, 2)
    if line_scores is None:
        line_scores = np.ones(L, np.float32)
    ep_scores = np.repeat(line_scores.astype(np.float32), 2)

    junctions = np.zeros((J_max, 2), np.float32)
    junc_scores = np.zeros(J_max, np.float32)
    junc_valid = np.zeros(J_max, bool)
    assign = np.zeros(2 * L, np.int64)

    idx = np.flatnonzero(ep_valid)
    if idx.size:
        pts = endpoints[idx]
        parent = np.arange(idx.size)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        ii, jj = np.nonzero(np.triu(d2 <= radius * radius, k=1))
        for a, b in zip(ii, jj):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        roots = np.array([find(a) for a in range(idx.size)])
        uniq_roots, first = np.unique(roots, return_index=True)
        label_of_root = {int(uniq_roots[o]): lbl for lbl, o in enumerate(np.argsort(first))}
        labels = np.array([label_of_root[int(r)] for r in roots])
        for j in range(int(labels.max()) + 1):
            m = labels == j
            junctions[j] = pts[m].mean(axis=0)
            junc_scores[j] = ep_scores[idx[m]].mean()
            junc_valid[j] = True
        assign[idx] = labels
    return junctions, junc_scores, junc_valid, assign.reshape(L, 2)


def wireframe_host(images: np.ndarray, max_lines: int, min_length: float, radius: float):
    """LSD and the endpoint clustering on (B, H, W, C) float images: the
    seven wireframe arrays, batched (see `WIREFRAME_KEYS`)."""
    lines, scores, valid = detect_lsd_host(images, max_lines, min_length)
    B, L = valid.shape
    junctions = np.zeros((B, 2 * L, 2), np.float32)
    junc_scores = np.zeros((B, 2 * L), np.float32)
    junc_valid = np.zeros((B, 2 * L), bool)
    junc_idx = np.zeros((B, L, 2), np.int32)
    for b in range(B):
        junctions[b], junc_scores[b], junc_valid[b], junc_idx[b] = cluster_endpoints_host(
            lines[b], valid[b], radius, scores[b])
    return lines, scores, valid, junctions, junc_scores, junc_valid, junc_idx


def precompute_wireframe(image: np.ndarray, max_lines: int, min_length: float,
                         radius: float) -> dict:
    """The wireframe of ONE (H, W, C) float image, as the data pipeline
    stores it per view: the keys `WireframeExtractor` reads instead of
    detecting."""
    arrays = wireframe_host(np.asarray(image)[None], int(max_lines), float(min_length),
                            float(radius))
    return {k: a[0] for k, a in zip(WIREFRAME_KEYS, arrays)}


class WireframeExtractor(BaseModel):
    default_conf = {
        "point_extractor": {
            "name": "superpoint",
            "dense_outputs": True,
            "max_num_keypoints": 1000,
            "force_num_keypoints": False,
            "trainable": False,
        },
        "max_num_lines": 250,
        "min_length": 15.0,
        "nms_radius": 3.0,  # junction merge radius and keypoint removal radius
        "trainable": False,
    }
    required_data_keys = ["image"]
    strict_conf = False

    def _init(self, conf):
        pconf = conf.point_extractor
        cls = get_model(pconf.name)
        sub = {k: v for k, v in pconf.to_dict().items() if k != "name"}
        sub["dense_outputs"] = True
        self.point_extractor = cls(cls.resolve_conf(sub))

    def _forward(self, data: dict, generator: torch.Generator | None = None,
                 train: bool = False) -> dict:
        c = self.conf
        ppred = self.point_extractor(data, generator=generator, train=train)
        dev = ppred["keypoints"].device
        if "lines" in data and "junctions" in data:
            arrays = [data[k] for k in WIREFRAME_KEYS]
        else:
            host = wireframe_host(data["image"].detach().float().cpu().numpy(),
                                  int(c.max_num_lines), float(c.min_length), float(c.nms_radius))
            arrays = [torch.from_numpy(a).to(dev) for a in host]
        lines, line_scores, line_mask, junctions, junc_scores, junc_mask, junc_idx = arrays
        return self._assemble(ppred, lines.float(), line_scores.float(), line_mask.bool(),
                              junctions.float(), junc_scores.float(), junc_mask.bool(),
                              junc_idx.long())

    def _assemble(self, ppred, lines, line_scores, line_mask, junctions, junc_scores, junc_mask,
                  junc_idx) -> dict:
        kpts = ppred["keypoints"]
        # keypoints near a junction are masked
        d2 = ((kpts[:, :, None, :] - junctions[:, None, :, :]) ** 2).sum(-1)  # (B, K, J)
        d2 = d2.masked_fill(~junc_mask[:, None, :], float("inf"))
        near = d2.min(-1).values < self.conf.nms_radius ** 2
        kpt_mask = ppred["keypoint_mask"] & ~near

        junc_desc = sample_descriptors(junctions, ppred["dense_descriptors"], stride=8)
        junc_scores = junc_scores * junc_mask

        # endpoints snapped to their junctions
        B, L = junc_idx.shape[:2]
        snapped = torch.gather(junctions, 1, junc_idx.reshape(B, 2 * L, 1).expand(-1, -1, 2))
        snapped = snapped.reshape(B, L, 2, 2)
        orig_lines = lines
        lines = torch.where(line_mask[..., None, None], snapped, lines)

        return {
            "keypoints": torch.cat([junctions, kpts], dim=1),
            "keypoint_scores": torch.cat([junc_scores, ppred["keypoint_scores"]], dim=1),
            "descriptors": torch.cat([junc_desc, ppred["descriptors"]], dim=1),
            "keypoint_mask": torch.cat([junc_mask, kpt_mask], dim=1),
            "lines": lines,
            "line_scores": line_scores,
            "line_mask": line_mask,
            "lines_junc_idx": junc_idx,
            "orig_lines": orig_lines,
        }

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError
