"""Spherical range projection with occlusion removal, in numpy (the port of
``mopa_tpu/data/utils/augmentation_3d.py::occlusion_detector`` and
``range_projection``, which host-side VGI uses)."""

from __future__ import annotations

import numpy as np


def occlusion_detector(proj_yx: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """(N,) bool, True for a point that a nearer point projecting to the same
    range-image pixel occludes (a lexsort dedup keeping the closest)."""
    order = np.lexsort((depth, proj_yx[:, 1], proj_yx[:, 0]))
    sorted_yx = proj_yx[order]
    first = np.concatenate(
        [[True], np.any(np.diff(sorted_yx, axis=0) != 0, axis=1)])
    out = np.zeros(proj_yx.shape[0], dtype=bool)
    out[order] = ~first
    return out


def range_projection(points: np.ndarray, fov_up: float, fov_down: float,
                     proj_W: int, proj_H: int,
                     obj_mask: np.ndarray | None = None) -> dict:
    """Per-point range-image pixels (``proj_x``, ``proj_y``) and ``depth``.

    With ``obj_mask`` (the inserted object's points) also ``pres_idx``: True
    for the points that survive when every pixel an object point wins (the
    nearest object point per pixel) keeps only its nearest point, scan or
    object."""
    pts = points[:, :3]
    depth = np.linalg.norm(pts, 2, axis=1)
    yaw = -np.arctan2(pts[:, 1], pts[:, 0])
    pitch = np.arcsin(np.clip(pts[:, 2] / np.maximum(depth, 1e-12), -1, 1))
    fov = abs(fov_down) + abs(fov_up)

    proj_x = 0.5 * (yaw / np.pi + 1.0) * proj_W
    proj_y = (1.0 - (pitch + abs(fov_down)) / fov) * proj_H
    proj_x = np.clip(np.floor(proj_x), 0, proj_W - 1).astype(np.int32)
    proj_y = np.clip(np.floor(proj_y), 0, proj_H - 1).astype(np.int32)

    out = {"proj_x": proj_x, "proj_y": proj_y, "depth": depth}
    if obj_mask is None:
        return out

    pix = proj_y.astype(np.int64) * proj_W + proj_x
    # the object's own occlusion: its nearest point per pixel claims it
    obj_yx = np.stack([proj_y[obj_mask], proj_x[obj_mask]], axis=1)
    obj_occluded = occlusion_detector(obj_yx, depth[obj_mask])
    claimed = np.zeros(proj_H * proj_W, dtype=bool)
    claimed[pix[obj_mask][~obj_occluded]] = True
    contested = claimed[pix]
    # among the points on claimed pixels the closest per pixel stays
    occluded = occlusion_detector(
        np.stack([proj_y[contested], proj_x[contested]], axis=1),
        depth[contested])
    dropped = contested.copy()
    dropped[contested] = occluded
    out["pres_idx"] = ~dropped
    return out
