"""The 3D inputs a dataset sample carries for each backbone (the JAX
package's dataset branches, ``mopa_tpu/data/*/``):

* SCN: an all-ones (N, 1) feature column beside the voxel coordinates;
* SPVCNN and PTv3 (any type whose name starts with either): (N, 4)
  features, the augmented xyz and the point's intensity / remission /
  reflectance (Pointcept's "coord" and "strength");
* SalsaNext: the (H, W, 5) range image ``proj_in`` and each point's pixel
  ``proj_xy`` (``augmentation_3d.build_range_input``).

``use_sparse_quantize`` is a constructor argument of the real-format
datasets that, as in the JAX package, has no effect.
"""

from __future__ import annotations

import numpy as np

from mopa_tpu_torch.data.utils.augmentation_3d import build_range_input


def takes_xyzi(backbone: str) -> bool:
    """The backbone takes (N, 4) xyz-and-intensity point features."""
    return str(backbone).upper().startswith(("SPVCNN", "PTV3"))


def spvcnn_feats(aug_points: np.ndarray,
                 intensity: np.ndarray) -> np.ndarray:
    """(N, 4) float32 SPVCNN features: augmented xyz, then intensity."""
    return np.concatenate([aug_points.astype(np.float32),
                           np.asarray(intensity).reshape(-1, 1)
                           .astype(np.float32)], axis=1)


def range_inputs(points: np.ndarray, intensity: np.ndarray, fov_up: float,
                 fov_down: float, proj_W: int, proj_H: int) -> dict:
    """SalsaNext's ``proj_in`` (H, W, 5) and ``proj_xy`` (N, 2) of sensor-
    frame ``points`` (N, 3) with their ``intensity`` (N,)."""
    pts4 = np.concatenate([points, np.asarray(intensity).reshape(-1, 1)],
                          axis=1).astype(np.float32)
    proj_in, proj_xy, _ = build_range_input(pts4, fov_up, fov_down, proj_W,
                                            proj_H)
    return {"proj_in": proj_in, "proj_xy": proj_xy}
