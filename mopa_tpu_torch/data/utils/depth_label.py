"""Dense depth labels for the depth head (``TRAIN.DEPTH_PRED``), the port of
``mopa_tpu/data/utils/depth_label.py``: each LiDAR point's euclidean range
written at its image pixel, zero where no point projects, the nearer point
winning a pixel that several points share."""

from __future__ import annotations

import numpy as np


def dense_depth_label(image_hw, img_indices, points) -> np.ndarray:
    """(H, W, 1) float32 range image of ``points`` (N, 3+; the first three
    columns are sensor-frame xyz) at their pixels ``img_indices`` (N, 2)
    int (row, col), inside the (H, W) image ``image_hw``."""
    h, w = int(image_hw[0]), int(image_hw[1])
    depth = np.zeros((h, w, 1), np.float32)
    if len(points) == 0:
        return depth
    rng = np.linalg.norm(np.asarray(points[:, :3], np.float32), axis=1)
    rows = np.asarray(img_indices[:, 0], np.int64)
    cols = np.asarray(img_indices[:, 1], np.int64)
    # farthest first, so the nearest point of a pixel is written last
    order = np.argsort(-rng, kind="stable")
    depth[rows[order], cols[order], 0] = rng[order]
    return depth
