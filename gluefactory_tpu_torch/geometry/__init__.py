"""Geometry for ground truth: homography sampling, warps, errors, GT matches."""
