"""Offline nuScenes preprocessing (PyTorch port of
``mopa_tpu/data/nuscenes/preprocess.py``; reference
``mopa/data/nuscenes/preprocess.py``).

* :func:`preprocess`: iterates the nuScenes devkit, filters samples by
  location (boston / singapore) or a day / night keyword, maps the LiDAR
  points into CAM_FRONT (:mod:`data.nuscenes.projection`), labels them
  from the 3D boxes (10 detection classes, background last), and writes
  ``<out_dir>/preprocess/<split>_<subset>.pkl`` with the capacity audit
  ``capacity_audit_<split>_<subset>.json`` (scale 20, as the loader
  voxelizes).
* :func:`get_nuscenes_ground`: each scan's int32 ground indices
  (:func:`ops.ground.estimate_ground_np`, on the card unless
  ``device="cpu"``) to ``<root_dir>/<save_dir>/<seq>/<file>``.

Needs the ``nuscenes-devkit`` (imported by the functions that use it).

Usage: python -m mopa_tpu_torch.data.nuscenes.preprocess --root_dir <dir>
         [--out_dir <dir>] [--version v1.0-trainval]
"""

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from mopa_tpu_torch.data.nuscenes import splits
from mopa_tpu_torch.data.nuscenes.projection import map_pointcloud_to_image

# detection class -> label id (object label mode; background = last)
CLASS_NAMES_TO_ID = {
    "car": 0, "truck": 1, "bus": 2, "trailer": 3, "construction_vehicle": 4,
    "pedestrian": 5, "motorcycle": 6, "bicycle": 7, "traffic_cone": 8,
    "barrier": 9,
}


def preprocess(nusc, split_names, root_dir, out_dir, keyword=None,
               keyword_action=None, subset_name=None, location=None):
    from nuscenes.eval.detection.utils import category_to_detection_name
    from nuscenes.utils.geometry_utils import points_in_box

    assert not (bool(keyword) and bool(location))
    if keyword:
        assert keyword_action in ("filter", "exclude")

    pkl_dict = {split_name: [] for split_name in split_names}

    for sample in nusc.sample:
        curr_scene_name = nusc.get("scene", sample["scene_token"])["name"]
        curr_split = None
        for split_name in split_names:
            if curr_scene_name in getattr(splits, split_name):
                curr_split = split_name
                break
        if curr_split is None:
            continue
        if subset_name == "night" and curr_split == "train" \
                and curr_scene_name in splits.val_night:
            curr_split = "val"
        if subset_name == "singapore" and curr_split == "train" \
                and curr_scene_name in splits.val_singapore:
            curr_split = "val"

        if keyword:
            desc = nusc.get("scene", sample["scene_token"])["description"].lower()
            if (keyword.lower() in desc) == (keyword_action == "exclude"):
                continue
        if location:
            scene = nusc.get("scene", sample["scene_token"])
            if location not in nusc.get("log", scene["log_token"])["location"]:
                continue

        lidar_token = sample["data"]["LIDAR_TOP"]
        cam_token = sample["data"]["CAM_FRONT"]
        lidar_path, boxes_lidar, _ = nusc.get_sample_data(lidar_token)
        cam_path, boxes_cam, cam_intrinsic = nusc.get_sample_data(cam_token)

        sd_lidar = nusc.get("sample_data", lidar_token)
        cs_lidar = nusc.get("calibrated_sensor", sd_lidar["calibrated_sensor_token"])
        pose_lidar = nusc.get("ego_pose", sd_lidar["ego_pose_token"])
        sd_cam = nusc.get("sample_data", cam_token)
        cs_cam = nusc.get("calibrated_sensor", sd_cam["calibrated_sensor_token"])
        pose_cam = nusc.get("ego_pose", sd_cam["ego_pose_token"])

        calib_infos = {
            "lidar2ego_translation": cs_lidar["translation"],
            "lidar2ego_rotation": cs_lidar["rotation"],
            "ego2global_translation_lidar": pose_lidar["translation"],
            "ego2global_rotation_lidar": pose_lidar["rotation"],
            "ego2global_translation_cam": pose_cam["translation"],
            "ego2global_rotation_cam": pose_cam["rotation"],
            "cam2ego_translation": cs_cam["translation"],
            "cam2ego_rotation": cs_cam["rotation"],
            "cam_intrinsic": cam_intrinsic,
        }

        pts = np.fromfile(lidar_path, dtype=np.float32,
                          count=-1).reshape([-1, 5])[:, :3].T
        mask, _, pts_img, proj_mtx = map_pointcloud_to_image(
            pts, (900, 1600, 3), calib_infos)
        pts_img = np.ascontiguousarray(np.fliplr(pts_img))  # (row, col)
        pts = pts[:, mask]

        seg_labels = np.full(pts.shape[1], len(CLASS_NAMES_TO_ID),
                             dtype=np.uint8)
        valid_tokens = {box.token for box in boxes_cam}
        for box in boxes_lidar:
            if box.token not in valid_tokens:
                continue
            fg_mask = points_in_box(box, pts)
            det_class = category_to_detection_name(box.name)
            if det_class is not None:
                seg_labels[fg_mask] = CLASS_NAMES_TO_ID[det_class]

        pkl_dict[curr_split].append({
            "points": pts.T,
            "seg_labels": seg_labels,
            "points_img": pts_img,
            "lidar_path": lidar_path.replace(root_dir + "/", ""),
            "camera_path": cam_path.replace(root_dir + "/", ""),
            "sample_token": sample["token"],
            "scene_name": curr_scene_name,
            "calib": calib_infos,
            "valid_mask": mask,
            "proj_matrix": proj_mtx,
        })

    from mopa_tpu_torch.data.capacity_audit import SplitAuditor

    save_dir = osp.join(out_dir, "preprocess")
    os.makedirs(save_dir, exist_ok=True)
    for split_name in split_names:
        full_name = "{}{}".format(
            split_name, "_" + subset_name if subset_name else "")
        save_path = osp.join(save_dir, full_name + ".pkl")
        with open(save_path, "wb") as f:
            pickle.dump(pkl_dict[split_name], f)
        print("Wrote preprocessed data to " + save_path)
        # the loader voxelizes the CAM_FRONT points at scale 20
        auditor = SplitAuditor(full_name, scale=20, full_scale=4096)
        for rec in pkl_dict[split_name][::25]:
            auditor.add(np.asarray(rec["points"], np.float32)[:, :3])
        auditor.save(osp.join(save_dir,
                              "capacity_audit_{}.json".format(full_name)))


def get_nuscenes_ground(root_dir, pickle_file, save_dir, device="cuda"):
    """Each scan of ``pickle_file``: its int32 ground indices to
    ``<root_dir>/<save_dir>/<seq>/<lidar file>``."""
    from mopa_tpu_torch.ops.ground import estimate_ground_np

    with open(pickle_file, "rb") as f:
        data_list = pickle.load(f)
    for data in data_list:
        points = np.fromfile(osp.join(root_dir, data["lidar_path"]),
                             dtype=np.float32).reshape(-1, 5)[:, :3]
        seq_dir, lidar_file = data["lidar_path"].split("/")[-2:]
        os.makedirs(osp.join(root_dir, save_dir, seq_dir), exist_ok=True)
        g_indices = estimate_ground_np(points, device=device)
        g_indices.tofile(osp.join(root_dir, save_dir, seq_dir, lidar_file))
    print("Completed ground extraction of {}".format(pickle_file))


def main(argv=None, device="cuda"):
    parser = argparse.ArgumentParser(description="nuScenes preprocessing")
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--version", default="v1.0-trainval")
    args = parser.parse_args(argv)
    out_dir = args.out_dir or args.root_dir

    from nuscenes import NuScenes

    nusc = NuScenes(version=args.version, dataroot=args.root_dir, verbose=True)
    preprocess(nusc, ["train", "test"], args.root_dir, out_dir,
               location="boston", subset_name="usa")
    preprocess(nusc, ["train", "val", "test"], args.root_dir, out_dir,
               location="singapore", subset_name="singapore")
    preprocess(nusc, ["train", "test"], args.root_dir, out_dir,
               keyword="night", keyword_action="exclude", subset_name="day")
    preprocess(nusc, ["train", "val", "test"], args.root_dir, out_dir,
               keyword="night", keyword_action="filter", subset_name="night")
    for pkl in ("train_night.pkl", "train_singapore.pkl"):
        get_nuscenes_ground(args.root_dir,
                            osp.join(out_dir, "preprocess", pkl), "g_indices",
                            device=device)


if __name__ == "__main__":
    main()
