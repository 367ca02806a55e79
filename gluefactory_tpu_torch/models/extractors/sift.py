"""SIFT extractor (counterpart of `gluefactory_tpu/models/extractors/sift.py`).

Two backends, named as in the JAX package so that every config and CLI
override carries over:

- `"opencv"` (the shipped configs' default): OpenCV's SIFT on the host,
  with duplicate / NMS filtering of the DoG points and RootSIFT. cv2 is
  imported only when this backend runs, and its absence raises: no other
  backend is taken in its place (the card's machine has no cv2; run there
  with `extractor.backend=jax`).
- `"jax"`: the DoG pipeline of `ops/sift.py`, torch ops on the images'
  device (the card's, or the CPU's for CPU tensors).

Both give `scales` and `oris` beside the keypoints, descriptors and scores,
which LightGlue's `add_scale_ori` reads. `force_num_keypoints` fills the
invalid slots with uniform keypoints drawn from the caller's generator.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.sift import sift_detect
from ..base_model import BaseModel


def run_opencv_sift(sift, image_u8: np.ndarray):
    """Detect and describe on one uint8 grey image."""
    detections, descriptors = sift.detectAndCompute(image_u8, None)
    points = np.array([k.pt for k in detections], np.float32).reshape(-1, 2)
    scores = np.array([k.response for k in detections], np.float32)
    scales = np.array([k.size for k in detections], np.float32)
    angles = np.deg2rad(np.array([k.angle for k in detections], np.float32))
    if descriptors is None:
        descriptors = np.zeros((0, 128), np.float32)
    return points, scores, scales, angles, descriptors


def filter_dog_points(points, image_shape, nms_radius, scores):
    """Keep one of each set of DoG detections at identical coordinates (cv2
    emits one a dominant orientation), then the strongest an NMS cell."""
    h, w = image_shape
    ij = np.round(points - 0.5).astype(int).T[::-1]
    flat = np.ravel_multi_index(np.clip(ij, 0, [[h - 1], [w - 1]]), (h, w))
    _, unique_idx = np.unique(flat, return_index=True)
    keep = np.zeros(len(points), bool)
    keep[unique_idx] = True
    if nms_radius > 0:
        cell = np.ravel_multi_index(
            np.clip(ij // max(int(nms_radius), 1), 0, None),
            (h // max(int(nms_radius), 1) + 1, w // max(int(nms_radius), 1) + 1),
        )
        order = np.argsort(-scores)
        seen = set()
        nms_keep = np.zeros(len(points), bool)
        for i in order:
            c = cell[i]
            if c not in seen:
                seen.add(c)
                nms_keep[i] = True
        keep &= nms_keep
    return keep


def extract_sift_host(images: np.ndarray, max_kpts: int, detection_threshold: float,
                      nms_radius: int, rootsift: bool):
    """OpenCV SIFT on (B, H, W, C) images in [0, 1]: K slots per image,
    strongest first, with a validity mask."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the opencv SIFT backend needs OpenCV (cv2), which is not installed; "
                          "select extractor.backend=jax") from e
    B, H, W, C = images.shape
    K = max_kpts
    out_kpts = np.zeros((B, K, 2), np.float32)
    out_scores = np.zeros((B, K), np.float32)
    out_scales = np.zeros((B, K), np.float32)
    out_oris = np.zeros((B, K), np.float32)
    out_desc = np.zeros((B, K, 128), np.float32)
    out_valid = np.zeros((B, K), bool)
    sift = cv2.SIFT_create(contrastThreshold=detection_threshold)
    for b in range(B):
        img = images[b]
        if C == 3:
            gray = cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
        else:
            gray = (img[..., 0] * 255).astype(np.uint8)
        pts, scores, scales, angles, desc = run_opencv_sift(sift, gray)
        if len(pts) == 0:
            continue
        keep = filter_dog_points(pts, (H, W), nms_radius, scores)
        pts, scores, scales, angles, desc = pts[keep], scores[keep], scales[keep], angles[keep], desc[keep]
        order = np.argsort(-scores)[:K]
        n = len(order)
        d = desc[order]
        if rootsift:
            d = d / np.maximum(np.abs(d).sum(-1, keepdims=True), 1e-8)
            d = np.sqrt(d)
        else:
            d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
        out_kpts[b, :n] = pts[order]
        out_scores[b, :n] = scores[order]
        out_scales[b, :n] = scales[order]
        out_oris[b, :n] = angles[order]
        out_desc[b, :n] = d
        out_valid[b, :n] = True
    return out_kpts, out_scores, out_scales, out_oris, out_desc, out_valid


class SIFT(BaseModel):
    default_conf = {
        "backend": "opencv",  # "opencv": cv2 on the host; "jax": ops/sift.py on the device
        "max_num_keypoints": 4096,
        "detection_threshold": 0.0066,
        "nms_radius": 0,
        "rootsift": True,
        "force_num_keypoints": False,
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        if conf.backend not in ("opencv", "jax"):
            raise ValueError(f"SIFT backend {conf.backend!r}: expected 'opencv' or 'jax'")

    def _forward(self, data: dict, generator: torch.Generator | None = None,
                 train: bool = False) -> dict:
        """`generator` draws the random keypoints that fill invalid slots
        under `force_num_keypoints` (a fresh one seeded with 0 if None)."""
        c = self.conf
        image = data["image"]
        K = int(c.max_num_keypoints)
        if c.backend == "jax":
            pred = self._detect_device(image, K)
        else:
            out = extract_sift_host(image.detach().float().cpu().numpy(), K, float(c.detection_threshold),
                                    int(c.nms_radius), bool(c.rootsift))
            keys = ("keypoints", "keypoint_scores", "scales", "oris", "descriptors", "keypoint_mask")
            pred = {k: torch.from_numpy(v).to(image.device) for k, v in zip(keys, out)}
        if c.force_num_keypoints:
            B, H, W = image.shape[:3]
            kpts, valid = pred["keypoints"], pred["keypoint_mask"]
            if generator is None:
                generator = torch.Generator(device=image.device).manual_seed(0)
            size = data.get("image_size")
            if size is None:
                size = torch.tensor([[W, H]], dtype=torch.float32, device=image.device).expand(B, 2)
            u = torch.rand((B, K, 2), generator=generator, device=image.device, dtype=kpts.dtype)
            pred["keypoints"] = torch.where(valid[..., None], kpts, u * size[:, None, :].to(kpts.dtype))
            pred["keypoint_mask"] = torch.ones_like(valid)
        return pred

    def _detect_device(self, image: torch.Tensor, K: int) -> dict:
        """`ops/sift.py` on the image's device, with the JAX package's grey
        weights, threshold floor and signed RootSIFT."""
        gray = image
        if gray.shape[-1] == 3:
            w = torch.tensor([0.299, 0.587, 0.114], dtype=gray.dtype, device=gray.device)
            gray = (gray * w).sum(-1, keepdim=True)
        # the threshold as cv2.SIFT_create(contrastThreshold=...) takes it
        out = sift_detect(gray[..., 0].to(torch.float32), K,
                          contrast_thresh=max(float(self.conf.detection_threshold), 1e-4))
        desc = out["descriptors"]
        if self.conf.rootsift:
            l1 = desc.abs().sum(-1, keepdim=True).clamp(min=1e-8)
            desc = torch.sqrt(desc.abs() / l1) * torch.sign(desc)
        valid = out["keypoint_mask"]
        zero = torch.zeros((), device=image.device)
        return {
            "keypoints": out["keypoints"],
            "keypoint_scores": torch.where(valid, out["keypoint_scores"], zero),
            "scales": out["scales"],
            "oris": out["oris"],
            "descriptors": desc,
            "keypoint_mask": valid,
        }

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError
