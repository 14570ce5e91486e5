"""LiDAR -> front-camera projection for nuScenes (PyTorch port's copy of
``mopa_tpu/data/nuscenes/projection.py``; reference
``mopa/data/nuscenes/projection.py:9-90``).

The 4-step extrinsic chain (lidar -> ego(t_lidar) -> global -> ego(t_cam)
-> cam) is composed into one Tr matrix plus the camera intrinsic, in numpy
on the host; quaternions need no pyquaternion.
"""

import numpy as np


def quat_to_rot(q):
    """(w, x, y, z) unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def _se3(rotation_q, translation):
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(rotation_q)
    m[:3, 3] = np.asarray(translation)
    return m


def map_pointcloud_to_image(pc, im_shape, info):
    """
    Args:
        pc: (3, N) lidar points.
        im_shape: (H, W, C) image shape for bounds checking.
        info: calibration dict (see preprocess.py).

    Returns:
        (mask (N,), pts_cam (N, 3), pts_img (N_valid, 2) as (u, v),
         proj_mtx (4, 4) lidar->pixel homogeneous matrix)
    """
    lidar2ego = _se3(info["lidar2ego_rotation"], info["lidar2ego_translation"])
    ego2global = _se3(info["ego2global_rotation_lidar"],
                      info["ego2global_translation_lidar"])
    global2ego = np.linalg.inv(
        _se3(info["ego2global_rotation_cam"], info["ego2global_translation_cam"]))
    ego2cam = np.linalg.inv(
        _se3(info["cam2ego_rotation"], info["cam2ego_translation"]))

    tr_mtx = ego2cam @ global2ego @ ego2global @ lidar2ego
    cam_itr = np.eye(4)
    cam_itr[:3, :3] = np.asarray(info["cam_intrinsic"])
    proj_mtx = cam_itr @ tr_mtx

    n = pc.shape[1]
    hom = np.concatenate([pc, np.ones((1, n))], axis=0)
    pts_cam = (tr_mtx @ hom)[:3]
    depths = pts_cam[2, :]

    uvw = np.asarray(info["cam_intrinsic"]) @ pts_cam
    pts_img = (uvw[:2] / np.maximum(np.abs(uvw[2:3]), 1e-9)
               * np.sign(uvw[2:3])).astype(np.float32)

    mask = (depths > 0)
    mask &= pts_img[0, :] > 0
    mask &= pts_img[0, :] < im_shape[1]
    mask &= pts_img[1, :] > 0
    mask &= pts_img[1, :] < im_shape[0]
    return mask, pts_cam.T, pts_img.T[mask, :2], proj_mtx
