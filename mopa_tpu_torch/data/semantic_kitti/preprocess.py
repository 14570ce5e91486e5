"""Offline SemanticKITTI preprocessing (PyTorch port of
``mopa_tpu/data/semantic_kitti/preprocess.py``; reference
``mopa/data/semantic_kitti/preprocess.py``).

* :func:`preprocess`: per split, every frame's camera, LiDAR and label
  paths, its ``P2 @ Tr`` projection, scene and frame id, pickled to
  ``<out_dir>/<split>.pkl`` (the loader reads the scans one by one), and
  the capacity audit of every ``audit_stride``-th scan
  (``capacity_audit_<split>.json``, :mod:`data.capacity_audit`).
* :func:`get_kitti_ground`: each scan's ground indices
  (:func:`ops.ground.estimate_ground_np`, on the card unless
  ``device="cpu"``) to ``<root_dir>/g_indices/<scene>/<frame>.bin``
  (int32), the files ``DATASET_TARGET.SemanticKITTISCN.g_indices_dir``
  names.

Usage: python -m mopa_tpu_torch.data.semantic_kitti.preprocess
         --root_dir <dir> [--out_dir <dir>] [--splits train val test]
         [--ground] [--audit-stride N]
"""

import argparse
import glob
import os
import os.path as osp
import pickle

import numpy as np

from mopa_tpu_torch.data.semantic_kitti import splits as split_defs
from mopa_tpu_torch.data.semantic_kitti.semantic_kitti_dataloader import (
    SemanticKITTIBase, select_points_in_frustum)


def _frames(root_dir, scenes):
    seq_dir = osp.join(root_dir, "dataset", "sequences")
    for scene in scenes:
        cam_paths = sorted(glob.glob(osp.join(seq_dir, scene, "image_2",
                                              "*.png")))
        calib = SemanticKITTIBase.read_calib(osp.join(seq_dir, scene,
                                                      "calib.txt"))
        proj_matrix = (calib["P2"] @ calib["Tr"]).astype(np.float32)
        for cam_path in cam_paths:
            frame_id = osp.splitext(osp.basename(cam_path))[0]
            yield {
                "camera_path": cam_path,
                "lidar_path": osp.join(seq_dir, scene, "velodyne",
                                       frame_id + ".bin"),
                "label_path": osp.join(seq_dir, scene, "labels",
                                       frame_id + ".label"),
                "proj_matrix": proj_matrix,
                "scene": scene,
                "frame_id": frame_id,
            }


def preprocess(split_name, root_dir, out_dir, audit_stride=25):
    """Write ``<out_dir>/<split_name>.pkl`` and, unless ``audit_stride`` is
    0, the split's capacity audit."""
    pkl_data = list(_frames(root_dir, getattr(split_defs, split_name)))
    os.makedirs(out_dir, exist_ok=True)
    save_path = osp.join(out_dir, "{}.pkl".format(split_name))
    with open(save_path, "wb") as f:
        pickle.dump(pkl_data, f)
    print("Wrote preprocessed data to " + save_path)
    if audit_stride:
        audit_split(split_name, pkl_data, out_dir, audit_stride)


def audit_split(split_name, pkl_data, out_dir, stride):
    """The voxel-capacity audit of every ``stride``-th frame (front of the
    car, inside the camera's frustum, as the loader keeps them) to
    ``<out_dir>/capacity_audit_<split_name>.json``."""
    from mopa_tpu_torch.data.capacity_audit import SplitAuditor

    auditor = SplitAuditor(split_name, scale=20, full_scale=4096)
    for data_dict in pkl_data[::max(int(stride), 1)]:
        points = np.fromfile(data_dict["lidar_path"],
                             dtype=np.float32).reshape(-1, 4)[:, :3]
        keep_idx = points[:, 0] > 0
        pts_h = np.concatenate(
            [points[keep_idx], np.ones([int(keep_idx.sum()), 1], np.float32)],
            axis=1)
        img_points = (data_dict["proj_matrix"] @ pts_h.T).T
        img_points = img_points[:, :2] / img_points[:, 2:3]
        keep_img = select_points_in_frustum(img_points, 0, 0, 1226, 370)
        auditor.add(points[keep_idx][keep_img])
    auditor.save(osp.join(out_dir,
                          "capacity_audit_{}.json".format(split_name)))


def get_kitti_ground(split_name, root_dir, g_dir_name="g_indices",
                     device="cuda"):
    """Each scan's int32 ground indices to
    ``<root_dir>/<g_dir_name>/<scene>/<frame>.bin``."""
    from mopa_tpu_torch.ops.ground import estimate_ground_np

    for scene in getattr(split_defs, split_name):
        out_dir = osp.join(root_dir, g_dir_name, scene)
        os.makedirs(out_dir, exist_ok=True)
        lidar_paths = sorted(glob.glob(osp.join(
            root_dir, "dataset", "sequences", scene, "velodyne", "*.bin")))
        for lidar_path in lidar_paths:
            scan = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 4)
            g_indices = estimate_ground_np(scan, device=device)
            frame_id = osp.splitext(osp.basename(lidar_path))[0]
            g_indices.tofile(osp.join(out_dir, frame_id + ".bin"))
        print("Ground indices for sequence {} -> {}".format(scene, out_dir))


def main(argv=None, device="cuda"):
    parser = argparse.ArgumentParser(description="SemanticKITTI preprocessing")
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--splits", nargs="+",
                        default=["train", "val", "test"])
    parser.add_argument("--ground", action="store_true",
                        help="also extract Patchwork-style ground indices")
    parser.add_argument("--audit-stride", type=int, default=25,
                        help="capacity-audit every Nth scan (0 disables)")
    args = parser.parse_args(argv)
    out_dir = args.out_dir or osp.join(args.root_dir, "preprocess")
    for split_name in args.splits:
        print("Preprocessing split " + split_name)
        preprocess(split_name, args.root_dir, out_dir,
                   audit_stride=args.audit_stride)
        if args.ground:
            get_kitti_ground(split_name, args.root_dir, device=device)


if __name__ == "__main__":
    main()
