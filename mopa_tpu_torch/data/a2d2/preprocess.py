"""Offline A2D2 preprocessing (PyTorch port of
``mopa_tpu/data/a2d2/preprocess.py``; reference
``mopa/data/a2d2/preprocess.py``).

Per split: undistorts each front-center camera image and label image
(cv2: Fisheye or Telecam lens), reads each point's label from the colour of
its label pixel, writes the undistorted PNGs under
``<out_dir>/undistorted/``, ``<out_dir>/preprocess/<split>.pkl`` and its
capacity audit (``capacity_audit_<split>.json``, scale 20). Frames whose
LiDAR file carries no ``row`` are skipped. All of it runs on the host;
PIL and cv2 are imported by the functions that need them.

Usage: python -m mopa_tpu_torch.data.a2d2.preprocess --root_dir <dir>
         [--out_dir <dir>] [--splits train1 train2 train3 test]
"""

import argparse
import glob
import json
import os
import os.path as osp
import pickle

import numpy as np

from mopa_tpu_torch.data.a2d2 import splits


def undistort_image(config, image, cam_name):
    """The A2D2 tutorial's undistortion of ``cam_name``'s image
    (Fisheye / Telecam lens; any other lens is returned as it is)."""
    import cv2

    cam = config["cameras"].get(cam_name)
    if cam is None:
        return image
    intr_undist = np.asarray(cam["CamMatrix"])
    intr_dist = np.asarray(cam["CamMatrixOriginal"])
    dist = np.asarray(cam["Distortion"])
    lens = cam["Lens"]
    if lens == "Fisheye":
        return cv2.fisheye.undistortImage(image, intr_dist, D=dist,
                                          Knew=intr_undist)
    if lens == "Telecam":
        return cv2.undistort(image, intr_dist, distCoeffs=dist,
                             newCameraMatrix=intr_undist)
    return image


def _frames(root_dir, scenes):
    for scene in scenes:
        cam_paths = sorted(glob.glob(
            osp.join(root_dir, scene, "camera", "cam_front_center", "*.png")))
        for cam_path in cam_paths:
            basename = osp.basename(cam_path)
            datetime, frame_id = basename[:14], basename[-13:-4]
            yield {
                "camera_path": cam_path,
                "lidar_path": osp.join(root_dir, scene, "lidar", "cam_front_center",
                                       datetime + "_lidar_frontcenter_"
                                       + frame_id + ".npz"),
                "label_path": osp.join(root_dir, scene, "label", "cam_front_center",
                                       datetime + "_label_frontcenter_"
                                       + frame_id + ".png"),
            }


def extract_sample(config, rgb_to_cls_idx, data_dict):
    """One frame's record with its undistorted image under ``img``, or
    None when its LiDAR file has no ``row``."""
    from PIL import Image

    lidar = np.load(data_dict["lidar_path"])
    points = lidar["points"]
    feats = (lidar["reflectance"] / 255 if "reflectance" in lidar
             else np.ones((points.shape[0], 1)))
    if "row" not in lidar:
        return None
    rows = lidar["row"].astype(np.int32)
    cols = lidar["col"].astype(np.int32)

    label_img = np.array(Image.open(data_dict["label_path"]))
    label_img = undistort_image(config, label_img, "front_center")
    label_pc = label_img[rows, cols, :]
    seg_label = np.full(label_pc.shape[0], len(rgb_to_cls_idx), np.int64)
    for rgb_values, cls_idx in rgb_to_cls_idx.items():
        idx = (np.asarray(rgb_values) == label_pc).all(1)
        if idx.any():
            seg_label[idx] = cls_idx

    image = np.array(Image.open(data_dict["camera_path"]))
    image = undistort_image(config, image, "front_center")
    points_img = np.stack([lidar["row"], lidar["col"]], 1).astype(np.float32)

    return {
        "seg_labels": seg_label.astype(np.uint8),
        "points": points.astype(np.float32),
        "feats": np.asarray(feats, np.float32),
        "points_img": points_img,
        "img": image,
        "camera_path": data_dict["camera_path"],
        "lidar_path": data_dict["lidar_path"],
    }


def preprocess(split_name, root_dir, out_dir):
    from PIL import Image

    from mopa_tpu_torch.data.capacity_audit import SplitAuditor

    with open(osp.join(root_dir, "cams_lidars.json"), "r") as f:
        config = json.load(f)
    with open(osp.join(root_dir, "class_list.json"), "r") as f:
        class_list = json.load(f)
    rgb_to_cls_idx = {}
    for count, k in enumerate(class_list.keys()):
        rgb = tuple(int(k.lstrip("#")[i:i + 2], 16) for i in (0, 2, 4))
        rgb_to_cls_idx[rgb] = count

    pkl_data = []
    for data_dict in _frames(root_dir, getattr(splits, split_name)):
        out = extract_sample(config, rgb_to_cls_idx, data_dict)
        if out is None:
            continue
        # the undistorted image; the pkl stores its relative path
        rel = osp.relpath(out["camera_path"], root_dir)
        und_path = osp.join(out_dir, "undistorted", rel)
        os.makedirs(osp.dirname(und_path), exist_ok=True)
        Image.fromarray(out.pop("img")).save(und_path)
        out["camera_path"] = osp.join("undistorted", rel)
        out["lidar_path"] = osp.relpath(out["lidar_path"], root_dir)
        pkl_data.append(out)

    save_dir = osp.join(out_dir, "preprocess")
    os.makedirs(save_dir, exist_ok=True)
    save_path = osp.join(save_dir, split_name + ".pkl")
    with open(save_path, "wb") as f:
        pickle.dump(pkl_data, f)
    print("Wrote preprocessed data to " + save_path)
    # the loader voxelizes A2D2 at scale 20
    auditor = SplitAuditor(split_name, scale=20, full_scale=4096)
    for rec in pkl_data[::25]:
        auditor.add(np.asarray(rec["points"], np.float32)[:, :3])
    auditor.save(osp.join(save_dir,
                          "capacity_audit_{}.json".format(split_name)))


def main(argv=None):
    parser = argparse.ArgumentParser(description="A2D2 preprocessing")
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--splits", nargs="+",
                        default=["train1", "train2", "train3", "test"])
    args = parser.parse_args(argv)
    out_dir = args.out_dir or args.root_dir
    for split_name in args.splits:
        preprocess(split_name, args.root_dir, out_dir)
    # the train split is processed in 3 chunks, then merged
    if all(s in args.splits for s in ("train1", "train2", "train3")):
        merged = []
        for s in ("train1", "train2", "train3"):
            with open(osp.join(out_dir, "preprocess", s + ".pkl"), "rb") as f:
                merged.extend(pickle.load(f))
        with open(osp.join(out_dir, "preprocess", "train.pkl"), "wb") as f:
            pickle.dump(merged, f)
        print("Merged train chunks -> train.pkl")


if __name__ == "__main__":
    main()
