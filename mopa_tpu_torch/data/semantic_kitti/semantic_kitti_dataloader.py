"""SemanticKITTI, the shipped MoPA run's target domain (port of
``mopa_tpu/data/semantic_kitti/semantic_kitti_dataloader.py``).

Scan by scan: velodyne ``.bin`` and ``.label`` files (the lower 16 label
bits), a z > -3 filter, the front-of-car view through the camera's
``P2 @ Tr``, the 10 classes shared with A2D2, per-scan pseudo-label ``.npy``
files (refined on the host, with the stored ``ori_keep_idx`` and
``ori_img_points``), SAM mask refinement, ground masks, the joint 2D/3D
``bottom_crop`` (480, 302), colour jitter and flip, the 3D augmentation,
VGI object sampling and the EMA teacher's unaugmented view. Only the SCN
backbone's inputs are ported (``data.utils.inputs``).
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np
from PIL import Image

from mopa_tpu_torch.data import native_loader
from mopa_tpu_torch.data.semantic_kitti import splits
from mopa_tpu_torch.data.utils.augmentation_3d import augment_and_scale_3d
from mopa_tpu_torch.data.utils.image_aug import \
    color_jitter as apply_color_jitter
from mopa_tpu_torch.data.utils import inputs
from mopa_tpu_torch.data.utils.depth_label import dense_depth_label
from mopa_tpu_torch.data.utils.refine_pseudo_labels import (
    refine_pseudo_labels_np, refine_sam_2Dlabels, refine_sam_mask)


def select_points_in_frustum(points_2d, x1, y1, x2, y2):
    """Points strictly inside the image box (x1, y1) .. (x2, y2)."""
    return ((points_2d[:, 0] > x1) & (points_2d[:, 1] > y1)
            & (points_2d[:, 0] < x2) & (points_2d[:, 1] < y2))


class SemanticKITTIBase:
    """Frame globbing and the label mapping."""

    # semantic-kitti.yaml label ids
    id_to_class_name = {
        0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
        15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
        30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
        44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
        51: "fence", 52: "other-structure", 60: "lane-marking", 70: "vegetation",
        71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
        99: "other-object", 252: "moving-car", 253: "moving-bicyclist",
        254: "moving-person", 255: "moving-motorcyclist", 256: "moving-on-rails",
        257: "moving-bus", 258: "moving-truck", 259: "moving-other-vehicle",
    }
    class_name_to_id = {v: k for k, v in id_to_class_name.items()}

    # 10 classes shared with A2D2
    categories = {
        "car": ["car", "moving-car"],
        "truck": ["truck", "moving-truck"],
        "bike": ["bicycle", "motorcycle", "bicyclist", "motorcyclist",
                 "moving-bicyclist", "moving-motorcyclist"],
        "person": ["person", "moving-person"],
        "road": ["road", "lane-marking"],
        "parking": ["parking"],
        "sidewalk": ["sidewalk"],
        "building": ["building"],
        "nature": ["vegetation", "trunk", "terrain"],
        "other-objects": ["fence", "traffic-sign", "other-object", "pole"],
    }

    def __init__(self, split, root_dir, merge_classes=False, ps_label_dir=None,
                 use_pc_mm=False, obj_name_ls=(), obj_root_dir=None,
                 g_indices_dir=None, sam_mask_dir=None):
        self.split = split
        self.root_dir = root_dir
        self.ps_label_dir = ps_label_dir
        self.use_pc_mm = use_pc_mm
        self.obj_name_ls = list(obj_name_ls)
        self.obj_root_dir = obj_root_dir
        self.g_indices_dir = g_indices_dir
        self.sam_mask_dir = sam_mask_dir

        assert isinstance(split, tuple)
        scenes = []
        for single_split in self.split:
            scenes.extend(getattr(splits, single_split))
        self.data = []
        self.glob_frames(scenes)

        if merge_classes:
            highest_id = max(self.id_to_class_name.keys())
            self.label_mapping = -100 * np.ones(highest_id + 2, dtype=int)
            for cat_idx, cat_list in enumerate(self.categories.values()):
                for class_name in cat_list:
                    self.label_mapping[self.class_name_to_id[class_name]] = cat_idx
            self.class_names = list(self.categories.keys())
        else:
            self.label_mapping = None

        self.obj_pc_dict = {}
        if self.use_pc_mm:
            for obj_class in self.obj_name_ls:
                glob_path = osp.join(self.obj_root_dir, obj_class, "*.bin")
                self.obj_pc_dict[obj_class] = sorted(glob.glob(glob_path))

    @staticmethod
    def read_calib(calib_path):
        """Parse a KITTI calib.txt into P2 (3x4) and Tr (4x4)."""
        calib_all = {}
        with open(calib_path, "r") as f:
            for line in f.readlines():
                if line == "\n":
                    break
                key, value = line.split(":", 1)
                calib_all[key] = np.array([float(x) for x in value.split()])
        calib_out = {"P2": calib_all["P2"].reshape(3, 4), "Tr": np.identity(4)}
        calib_out["Tr"][:3, :4] = calib_all["Tr"].reshape(3, 4)
        return calib_out

    def glob_frames(self, scenes):
        for scene in scenes:
            glob_path = osp.join(self.root_dir, "dataset", "sequences", scene,
                                 "image_2", "*.png")
            cam_paths = sorted(glob.glob(glob_path))
            if not cam_paths:
                continue
            calib = self.read_calib(
                osp.join(self.root_dir, "dataset", "sequences", scene, "calib.txt"))
            proj_matrix = (calib["P2"] @ calib["Tr"]).astype(np.float32)

            ps_prefix = (osp.join(self.root_dir, "ps_label", self.ps_label_dir, scene)
                         if self.ps_label_dir else None)
            g_prefix = (osp.join(self.root_dir, self.g_indices_dir, scene)
                        if self.g_indices_dir else None)
            sam_prefix = (osp.join(self.root_dir, self.sam_mask_dir, scene)
                          if self.sam_mask_dir else None)

            for cam_path in cam_paths:
                frame_id = osp.splitext(osp.basename(cam_path))[0]
                assert frame_id.isdigit()
                data = {
                    "camera_path": cam_path,
                    "lidar_path": osp.join(self.root_dir, "dataset", "sequences",
                                           scene, "velodyne", frame_id + ".bin"),
                    "label_path": osp.join(self.root_dir, "dataset", "sequences",
                                           scene, "labels", frame_id + ".label"),
                    "proj_matrix": proj_matrix,
                    "scene": scene,
                    "frame_id": int(frame_id),
                }
                if ps_prefix:
                    data["pslabel_path"] = osp.join(ps_prefix, frame_id + ".npy")
                if g_prefix:
                    data["g_indices_pth"] = osp.join(g_prefix, frame_id + ".bin")
                if sam_prefix:
                    data["sam_mask_path"] = osp.join(sam_prefix, frame_id + ".bin")
                self.data.append(data)

    def __len__(self):
        return len(self.data)


class SemanticKITTISCN(SemanticKITTIBase):
    def __init__(self, split, root_dir, merge_classes=False, scale=20,
                 full_scale=4096, use_feats=False, use_sparse_quantize=False,
                 image_normalizer=None, noisy_rot=0.0, flip_y=0.0, rot_z=0.0,
                 transl=False, bottom_crop=(480, 302), fliplr=0.0,
                 color_jitter=None, output_orig=False, ps_label_dir=None,
                 use_pc_mm=False, multi_objs=False, obj_name_ls=(),
                 obj_root_dir=None, z_disc=None, sc_rotation=None,
                 g_indices_dir=None, sam_mask_dir=None, ema_input=False,
                 backbone="SCN", proj_W=1024, proj_H=64, fov_up=0.05235,
                 fov_down=-0.43633, rng=None, preprocess_dir="",
                 semantic_kitti_dir="", cat_type="", with_depth_label=False):
        super().__init__(split, root_dir, merge_classes=merge_classes,
                         ps_label_dir=ps_label_dir, use_pc_mm=use_pc_mm,
                         obj_name_ls=obj_name_ls, obj_root_dir=obj_root_dir,
                         g_indices_dir=g_indices_dir, sam_mask_dir=sam_mask_dir)
        self.output_orig = output_orig
        self.scale = scale
        self.full_scale = full_scale
        self.noisy_rot = noisy_rot
        self.flip_y = flip_y
        self.rot_z = rot_z
        self.transl = transl
        self.image_normalizer = image_normalizer
        self.bottom_crop = tuple(bottom_crop) if bottom_crop else None
        self.fliplr = fliplr
        self.color_jitter = tuple(color_jitter) if color_jitter else None
        self.multi_objs = multi_objs
        self.backbone = backbone
        self.proj_W, self.proj_H = proj_W, proj_H
        self.fov_up, self.fov_down = fov_up, fov_down
        self.ema_input = ema_input
        self.with_depth_label = with_depth_label
        self.rng = rng or np.random.default_rng()

    # ----- loading -----
    def data_extraction(self, index):
        """Read one frame's scan, labels and side files."""
        data_dict = dict(self.data[index])
        scan = native_loader.read_scan(data_dict["lidar_path"])
        points = scan[:, :3]
        feats = scan[:, 3]
        label = native_loader.read_labels(data_dict["label_path"])

        z_idx = points[:, 2] > -3
        points, feats, label = points[z_idx], feats[z_idx], label[z_idx]

        if "pslabel_path" in data_dict:
            ps_data = np.load(data_dict["pslabel_path"], allow_pickle=True).tolist()
            data_dict.update({
                "pseudo_label_2d": ps_data["pseudo_label_2d"],
                "pseudo_label_3d": ps_data["pseudo_label_3d"],
                "probs_2d": ps_data["probs_2d"],
                "probs_3d": ps_data["probs_3d"],
                "ori_keep_idx": ps_data["ori_keep_idx"],
                "ori_img_points": ps_data["ori_img_points"],
            })
        if "g_indices_pth" in data_dict:
            g_indices = np.fromfile(data_dict["g_indices_pth"], dtype=np.int32)
            g_mask = np.zeros(scan.shape[0])
            g_mask[g_indices] = 1
            data_dict["g_indices"] = g_mask[z_idx].astype(bool)

        image = Image.open(data_dict["camera_path"])
        if "sam_mask_path" in data_dict:
            sam_mask = np.fromfile(data_dict["sam_mask_path"], dtype=np.uint8)
            data_dict["sam_mask"] = sam_mask.reshape(image.height, -1)

        data_dict.update({
            "image": image, "feats": feats, "points": points,
            "seg_labels": label.astype(np.int16), "scan_pth": data_dict["lidar_path"],
        })
        return data_dict

    def obj_sampling(self, obj_class):
        paths = self.obj_pc_dict[obj_class]
        pick = int(self.rng.integers(0, len(paths)))
        obj_pc = np.fromfile(paths[pick], dtype=np.float32).reshape((-1, 4))
        assert not np.any(np.isnan(obj_pc)), "NaN object points: " + paths[pick]
        obj_label = np.full(obj_pc.shape[0],
                            self.label_mapping[self.class_name_to_id[obj_class]])
        return obj_pc, obj_label

    # ----- preprocessing -----
    def preprocess(self, data_dict):
        """The camera's view of the scan, and the refined pseudo labels and
        SAM masks."""
        points = data_dict["points"]
        image_size = data_dict["image"].size
        keep_idx = points[:, 0] > 0

        if "pseudo_label_3d" in data_dict:
            raw_ps_2d = data_dict["pseudo_label_2d"].astype(np.int32)
            ps_label_2d = refine_pseudo_labels_np(data_dict["probs_2d"], raw_ps_2d)
            ps_label_3d = refine_pseudo_labels_np(
                data_dict["probs_3d"], data_dict["pseudo_label_3d"].astype(np.int32))
            data_dict.update({"pseudo_label_2d": ps_label_2d,
                              "pseudo_label_3d": ps_label_3d})
            keep_idx = data_dict["ori_keep_idx"]
            img_points = data_dict["ori_img_points"]

            if "sam_mask" in data_dict:
                n_cls = len(self.categories)
                probs_2d = np.zeros((data_dict["probs_2d"].shape[0], n_cls))
                probs_2d += np.expand_dims((1 - data_dict["probs_2d"]) / (n_cls - 1),
                                           axis=1)
                probs_2d[np.arange(len(raw_ps_2d)), raw_ps_2d] = data_dict["probs_2d"]
                full_2d_pslabels = refine_sam_2Dlabels(
                    probs_2d, img_points, data_dict["sam_mask"])
                sam_mask = refine_sam_mask(
                    data_dict["sam_mask"],
                    max_h=image_size[1] - int(np.min(img_points, axis=0)[0]))
                data_dict.update({"full_2d_pslabels": full_2d_pslabels,
                                  "sam_mask": sam_mask})
        else:
            points_h = np.concatenate(
                [points[keep_idx], np.ones([int(keep_idx.sum()), 1], np.float32)],
                axis=1)
            img_points = (data_dict["proj_matrix"].astype(np.float32)
                          @ points_h.T).T
            img_points = img_points[:, :2] / np.expand_dims(img_points[:, 2], axis=1)
            img_points = np.around(img_points, decimals=2)
            keep_img = select_points_in_frustum(img_points, 0, 0, *image_size)
            keep_idx[keep_idx] = keep_img
            img_points = np.fliplr(img_points[keep_img])  # (row, col)

            if "sam_mask" in data_dict:
                data_dict["sam_mask"] = refine_sam_mask(
                    data_dict["sam_mask"],
                    max_h=image_size[1] - int(np.min(img_points, axis=0)[0]))

        data_dict.update({
            "points": points[keep_idx],
            "feats": data_dict["feats"][keep_idx].reshape(-1, 1),
            "seg_labels": data_dict["seg_labels"][keep_idx],
            "points_img": img_points,
            "ori_img_size": image_size,
            "ori_keep_idx": keep_idx,
            "ori_img_points": img_points,
        })
        if "g_indices" in data_dict:
            data_dict["g_indices"] = data_dict["g_indices"][keep_idx]
        return data_dict

    def __getitem__(self, index):
        rng = self.rng
        data_dict = self.data_extraction(index)
        out_dict = {}

        if self.use_pc_mm:
            obj_pc_ls, obj_label_ls = [], []
            classes = (self.obj_name_ls if self.multi_objs
                       else [self.obj_name_ls[int(rng.integers(0, len(self.obj_name_ls)))]])
            for obj_class in classes:
                obj_pc, obj_label = self.obj_sampling(obj_class)
                obj_pc_ls.append(obj_pc)
                obj_label_ls.append(obj_label)
            out_dict["ori_obj_pc"] = obj_pc_ls
            out_dict["ori_obj_label"] = obj_label_ls

        data_dict = self.preprocess(data_dict)
        seg_label = data_dict["seg_labels"]
        if self.label_mapping is not None:
            seg_label = self.label_mapping[seg_label]

        points = data_dict["points"]
        feats = data_dict["feats"]
        points_img = data_dict["points_img"]
        image = data_dict["image"].copy()
        keep_idx = np.ones(len(points_img), dtype=bool)

        ori_points = points.copy()
        ori_feats = feats.copy()
        if self.ema_input:
            ori_image = np.array(image, dtype=np.float32, copy=True) / 255.0
            ori_points_img = points_img.copy()

        if self.bottom_crop:
            # joint 2D/3D bottom crop
            left = int(rng.random() * (image.size[0] + 1 - self.bottom_crop[0]))
            right = left + self.bottom_crop[0]
            top = image.size[1] - self.bottom_crop[1]
            bottom = image.size[1]
            keep_idx = ((points_img[:, 0] >= top) & (points_img[:, 0] < bottom)
                        & (points_img[:, 1] >= left) & (points_img[:, 1] < right))
            image = image.crop((left, top, right, bottom))
            points_img = points_img[keep_idx].copy()
            points_img[:, 0] -= top
            points_img[:, 1] -= left
            points = points[keep_idx]
            feats = feats[keep_idx]
            seg_label = seg_label[keep_idx]
            if "full_2d_pslabels" in data_dict:
                data_dict["full_2d_pslabels"] = \
                    data_dict["full_2d_pslabels"][top:bottom, left:right]
            if "sam_mask" in data_dict:
                data_dict["sam_mask"] = data_dict["sam_mask"][top:bottom, left:right]

        img_indices = points_img.astype(np.int64)
        image = np.asarray(image, dtype=np.float32) / 255.0
        if self.color_jitter is not None:
            image = apply_color_jitter(image, self.color_jitter, rng)
        if rng.random() < self.fliplr:
            image = np.ascontiguousarray(np.fliplr(image))
            img_indices[:, 1] = image.shape[1] - 1 - img_indices[:, 1]
            if "full_2d_pslabels" in data_dict:
                data_dict["full_2d_pslabels"] = np.ascontiguousarray(
                    np.fliplr(data_dict["full_2d_pslabels"]))
            if "sam_mask" in data_dict:
                data_dict["sam_mask"] = np.ascontiguousarray(
                    np.fliplr(data_dict["sam_mask"]))
        if self.image_normalizer:
            mean, std = self.image_normalizer
            image = (image - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)

        out_dict["img"] = image
        out_dict["img_indices"] = img_indices
        if "full_2d_pslabels" in data_dict:
            out_dict["full_2d_pslabels"] = data_dict["full_2d_pslabels"]
        if "sam_mask" in data_dict:
            out_dict["sam_mask"] = data_dict["sam_mask"]

        # KITTI lidar coords: x (front), y (left), z (up)
        coords, aug_points = augment_and_scale_3d(
            points, self.scale, self.full_scale, rng=rng, noisy_rot=self.noisy_rot,
            flip_y=self.flip_y, rot_z=self.rot_z, transl=self.transl)
        coords = coords.astype(np.int64)
        idxs = (coords.min(1) >= 0) * (coords.max(1) < self.full_scale)

        ori_coords, _ = augment_and_scale_3d(ori_points, self.scale,
                                             self.full_scale, rng=rng)
        ori_idxs = (ori_coords.min(1) >= 0) * (ori_coords.max(1) < self.full_scale)

        out_dict["coords"] = coords[idxs]
        out_dict["aug_points"] = aug_points[idxs]
        out_dict["feats"] = np.ones([int(idxs.sum()), 1], np.float32)
        if inputs.takes_xyzi(self.backbone):
            out_dict["feats"] = inputs.spvcnn_feats(aug_points[idxs],
                                                    feats[idxs])
        elif self.backbone == "SalsaNext":
            out_dict.update(inputs.range_inputs(
                points[idxs], feats[idxs], self.fov_up, self.fov_down,
                self.proj_W, self.proj_H))
        out_dict["seg_label"] = seg_label[idxs]
        out_dict["img_indices"] = out_dict["img_indices"][idxs]
        if self.with_depth_label:
            out_dict["depth_label"] = dense_depth_label(
                image.shape[:2], out_dict["img_indices"], points[idxs])
        out_dict["lidar_path"] = data_dict["lidar_path"]
        out_dict["scan_pth"] = data_dict["scan_pth"]

        if self.ema_input:
            out_dict["ori_img_indices"] = ori_points_img.astype(np.int64)[ori_idxs]
            out_dict["ori_img"] = ori_image
            out_dict["ori_coords"] = ori_coords[ori_idxs].astype(np.int64)
            out_dict["ori_feats"] = np.ones([int(ori_idxs.sum()), 1], np.float32)
            # student (post-crop, post-rf) -> teacher-output index map
            ori_pos = np.cumsum(ori_idxs) - 1
            emap_full = np.where(ori_idxs, ori_pos, -1)
            out_dict["ema_map"] = emap_full[keep_idx][idxs].astype(np.int32)

        if self.output_orig:
            out_dict.update({
                # metric sensor-frame points aligned with predictions
                # (eval-time KNN range projection, VAL.use_knn)
                "points_xyz": points[idxs].astype(np.float32),
                "orig_seg_label": seg_label,
                "orig_points_idx": idxs,
                "ori_keep_idx": data_dict["ori_keep_idx"],
                "ori_img_points": data_dict["ori_img_points"],
            })

        if "pseudo_label_2d" in data_dict:
            out_dict["pseudo_label_2d"] = data_dict["pseudo_label_2d"][keep_idx][idxs]
            out_dict["pseudo_label_3d"] = data_dict["pseudo_label_3d"][keep_idx][idxs]
            # FOV-aligned (pre-crop) labels for the VGI scan points
            out_dict["ori_pseudo_label_3d"] = data_dict["pseudo_label_3d"]

        if self.use_pc_mm:
            out_dict["ori_points"] = np.concatenate(
                [ori_points, ori_feats.reshape(-1, 1)], axis=1)
            out_dict["ori_img_size"] = np.asarray(data_dict["ori_img_size"], np.int32)
            out_dict["proj_matrix"] = np.asarray(data_dict["proj_matrix"], np.float32)
            if "g_indices" in data_dict:
                out_dict["g_indices"] = data_dict["g_indices"]

        return out_dict
