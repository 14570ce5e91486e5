"""Host-side 3D augmentation and spherical range projection with occlusion
removal, in numpy (the port of ``mopa_tpu/data/utils/augmentation_3d.py``:
``make_rotation`` and ``augment_and_scale_3d``, which the datasets call, and
``occlusion_detector`` and ``range_projection``, which host-side VGI uses,
and ``build_range_input``, SalsaNext's range image).

Randomness comes from the caller's ``np.random.Generator``; the same
generator state gives the JAX package's values.
"""

from __future__ import annotations

import numpy as np


def make_rotation(rng: np.random.Generator, noisy_rot=0.0, flip_x=0.0,
                  flip_y=0.0, rot_z=0.0):
    """The reference's noisy rotation, axis flips and z rotation as one 3x3
    float32 matrix, or None when every option is off."""
    if not (noisy_rot > 0 or flip_x > 0 or flip_y > 0 or rot_z > 0):
        return None
    rot = np.eye(3, dtype=np.float32)
    if noisy_rot > 0:
        rot += rng.standard_normal((3, 3)).astype(np.float32) * noisy_rot
    if flip_x > 0:
        rot[0][0] *= int(rng.integers(0, 2)) * 2 - 1
    if flip_y > 0:
        rot[1][1] *= int(rng.integers(0, 2)) * 2 - 1
    if rot_z > 0:
        theta = float(rng.random()) * rot_z
        z_rot = np.array([
            [np.cos(theta), -np.sin(theta), 0],
            [np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ], dtype=np.float32)
        rot = rot.dot(z_rot)
    return rot


def augment_and_scale_3d(points, scale, full_scale, rng=None, noisy_rot=0.0,
                         flip_x=0.0, flip_y=0.0, rot_z=0.0, transl=False):
    """Augment points (meters) and scale them to voxel coordinates.

    Rotates and flips (:func:`make_rotation`), multiplies by ``scale`` (20:
    5 cm voxels), shifts to the positive octant and, with ``transl``, by a
    random offset that keeps the scan inside ``full_scale``. ``points`` is
    one (N, 3) array (the JAX function's list form, one draw shared by
    several arrays, has no caller in the port: host VGI draws its own).
    Returns (coords float, rotated points); the caller casts and drops
    coordinates outside the field."""
    rng = rng or np.random.default_rng()
    rot = make_rotation(rng, noisy_rot, flip_x, flip_y, rot_z)
    pts = points.dot(rot) if rot is not None else points
    coords = np.round(pts * scale)
    coords -= coords.min(0)
    if transl:
        offset = np.clip(full_scale - coords.max(0) - 0.001, a_min=0,
                         a_max=None) * rng.random(3)
        coords += offset
    return coords, pts


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


def build_range_input(points: np.ndarray, fov_up: float, fov_down: float,
                      proj_W: int, proj_H: int) -> tuple:
    """SalsaNext's input: a scan (N, 3 or 4: xyz [+ intensity]) rasterised
    into a (proj_H, proj_W, 5) range image (range, x, y, z, intensity; -1
    where no point lands; the nearest point wins a pixel), each point's
    (row, col) pixel (N, 2) int32 and its range (N,) float32.

    Points are written farthest first by the same non-stable
    ``np.argsort(-depth)`` as the JAX package's, so ties resolve alike and
    the image is byte-equal."""
    pr = range_projection(points, fov_up, fov_down, proj_W, proj_H)
    px, py, depth = pr["proj_x"], pr["proj_y"], pr["depth"]
    pix = py.astype(np.int64) * proj_W + px
    intensity = (points[:, 3] if points.shape[1] > 3
                 else np.zeros(len(points), np.float32))
    vals = np.concatenate([depth[:, None], points[:, :3],
                           intensity[:, None]], axis=1).astype(np.float32)
    img = np.full((proj_H * proj_W, 5), -1.0, np.float32)
    order = np.argsort(-depth)
    img[pix[order]] = vals[order]
    proj_xy = np.stack([py, px], axis=1).astype(np.int32)
    return img.reshape(proj_H, proj_W, 5), proj_xy, depth.astype(np.float32)
