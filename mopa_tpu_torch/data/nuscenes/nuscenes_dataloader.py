"""nuScenes (port of ``mopa_tpu/data/nuscenes/nuscenes_dataloader.py``).

Samples come from the offline preprocess step's pickles: ``object`` (5
classes from the 3D boxes) or ``segmentation`` (lidarseg) labels with their
merge tables, the image resized to (400, 225) with its point pixels
rescaled, flip and colour jitter, the 3D augmentation (noisy rotation, x
flip, z rotation, translation), pseudo labels refined per scan on the host,
ground masks, SAM masks, VGI object sampling and the EMA teacher's
unaugmented view (one gather map ``ema_map`` from student to teacher
points). Images stay HWC float32; randomness comes from one numpy
``Generator``. Only the SCN backbone's inputs are ported
(``data.utils.inputs``).
"""

from __future__ import annotations

import glob
import os.path as osp
import pickle

import numpy as np
from PIL import Image

from mopa_tpu_torch.data.utils.augmentation_3d import augment_and_scale_3d
from mopa_tpu_torch.data.utils.image_aug import \
    color_jitter as apply_color_jitter
from mopa_tpu_torch.data.utils.depth_label import dense_depth_label
from mopa_tpu_torch.data.utils.refine_pseudo_labels import (
    refine_pseudo_labels_np, refine_sam_mask)


class NuScenesBase:
    """Split loading and the label mapping."""

    class_names_seg = [
        "ignore", "barrier", "bicycle", "bus", "car", "construction_vehicle",
        "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
        "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
        "vegetation",
    ]
    categories_seg = {
        "vehicle": ["bicycle", "bus", "car", "construction_vehicle",
                    "motorcycle", "trailer", "truck"],
        "driveable_surface": ["driveable_surface"],
        "sidewalk": ["sidewalk"],
        "terrain": ["terrain"],
        "manmade": ["manmade"],
        "vegetation": ["vegetation"],
    }

    class_names_obj = [
        "car", "truck", "bus", "trailer", "construction_vehicle", "pedestrian",
        "motorcycle", "bicycle", "traffic_cone", "barrier", "background",
    ]
    categories_obj = {
        "vehicle": ["car", "truck", "bus", "trailer", "construction_vehicle"],
        "pedestrian": ["pedestrian"],
        "bike": ["motorcycle", "bicycle"],
        "traffic_boundary": ["traffic_cone", "barrier"],
        "background": ["background"],
    }

    def __init__(self, split, preprocess_dir, label_mode, merge_classes=False,
                 pselab_paths=None):
        self.split = split
        self.preprocess_dir = preprocess_dir
        assert isinstance(split, tuple)
        self.data = []
        for curr_split in split:
            with open(osp.join(self.preprocess_dir, curr_split + ".pkl"), "rb") as f:
                self.data.extend(pickle.load(f))

        self.pselab_data = None
        if merge_classes:
            if label_mode == "object":
                names, cats = self.class_names_obj, self.categories_obj
            else:
                names, cats = self.class_names_seg, self.categories_seg
            self.ori_class_names = names
            self.label_mapping = -100 * np.ones(len(names), dtype=int)
            for cat_idx, cat_list in enumerate(cats.values()):
                for class_name in cat_list:
                    self.label_mapping[names.index(class_name)] = cat_idx
            self.class_names = list(cats.keys())
        else:
            names = (self.class_names_obj if label_mode == "object"
                     else self.class_names_seg)
            self.ori_class_names = names[1:] if "ignore" in names else names
            self.label_mapping = np.arange(-1, len(self.ori_class_names))
            self.label_mapping[0] = -100
            self.class_names = self.ori_class_names

    def __len__(self):
        return len(self.data)


class NuScenesSCN(NuScenesBase):
    def __init__(self, split, preprocess_dir, label_mode="object",
                 nuscenes_dir="", pselab_paths=None, merge_classes=False,
                 scale=20, full_scale=4096, use_sparse_quantize=False,
                 resize=(400, 225), image_normalizer=None,
                 noisy_rot=0.0, flip_x=0.0, rot_z=0.0, transl=False,
                 fliplr=0.0, color_jitter=None, output_orig=False,
                 ps_label_dir=None, use_pc_mm=False, multi_objs=False,
                 g_indices_dir=None, obj_name_ls=(), obj_root_dir=None,
                 z_disc=None, sc_rotation=None, sam_mask_dir=None,
                 ema_input=False, with_depth_label=False, backbone="SCN",
                 rng=None):
        # ``backbone`` comes from build_dataloader, as for the other
        # datasets; the samples carry the SCN inputs whatever it names, as
        # the JAX package's do
        super().__init__(split, preprocess_dir, label_mode,
                         merge_classes=merge_classes, pselab_paths=pselab_paths)
        self.nuscenes_dir = nuscenes_dir
        self.output_orig = output_orig
        self.ps_label_dir = ps_label_dir
        self.scale = scale
        self.full_scale = full_scale
        self.noisy_rot = noisy_rot
        self.flip_x = flip_x
        self.rot_z = rot_z
        self.transl = transl
        self.resize = tuple(resize) if resize else None
        self.image_normalizer = image_normalizer
        self.fliplr = fliplr
        self.color_jitter = tuple(color_jitter) if color_jitter else None
        self.use_pc_mm = use_pc_mm
        self.multi_objs = multi_objs
        self.obj_name_ls = list(obj_name_ls)
        self.obj_root_dir = obj_root_dir
        self.g_indices_dir = g_indices_dir
        self.sam_mask_dir = sam_mask_dir
        self.ema_input = ema_input
        self.with_depth_label = with_depth_label
        self.rng = rng or np.random.default_rng()

        if self.use_pc_mm:
            self.obj_pc_dict = {}
            for obj_class in self.obj_name_ls:
                glob_path = osp.join(self.obj_root_dir, obj_class, "*.bin")
                self.obj_pc_dict[obj_class] = sorted(glob.glob(glob_path))

    def obj_sampling(self, obj_class):
        """A random instance of ``obj_class`` from the object bank, with
        its merged label."""
        paths = self.obj_pc_dict[obj_class]
        pick = int(self.rng.integers(0, len(paths)))
        obj_pc = np.fromfile(paths[pick], dtype=np.float32).reshape((-1, 4))
        assert not np.any(np.isnan(obj_pc)), "NaN object points: " + paths[pick]
        name = "pedestrian" if obj_class == "person" else obj_class
        obj_label = np.full(obj_pc.shape[0],
                            self.label_mapping[self.ori_class_names.index(name)])
        return obj_pc, obj_label

    def __getitem__(self, index):
        rng = self.rng
        data_dict = dict(self.data[index])
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

        points = data_dict["points"].copy()
        seg_label = data_dict["seg_labels"].astype(np.int64)
        lidar_path = data_dict["lidar_path"]
        lidar_prefix, lidar_file = lidar_path.split("/")[-2], lidar_path.split("/")[-1]
        cam_prefix, cam_file = (data_dict["camera_path"].split("/")[-2],
                                data_dict["camera_path"].split("/")[-1])

        g_mask = None
        if self.g_indices_dir is not None:
            g_path = osp.join(self.nuscenes_dir, self.g_indices_dir,
                              lidar_prefix, lidar_file)
            g_indices = np.fromfile(g_path, dtype=np.int32)
            full_mask = np.zeros(data_dict["valid_mask"].shape[0])
            full_mask[g_indices] = 1
            g_mask = full_mask[data_dict["valid_mask"]].astype(bool)

        sam_mask = None
        if self.sam_mask_dir is not None:
            assert len(self.split) == 1
            sam_path = osp.join(self.nuscenes_dir, self.sam_mask_dir,
                                self.split[0], cam_prefix,
                                cam_file.replace(".jpg", ".bin"))
            sam_mask = np.fromfile(sam_path, dtype=np.uint8)

        ps_data = None
        if self.ps_label_dir is not None:
            ps_path = osp.join(self.nuscenes_dir, self.ps_label_dir,
                               lidar_prefix, lidar_file.replace(".bin", ".npy"))
            ps_data = np.load(ps_path, allow_pickle=True).tolist()

        if self.label_mapping is not None:
            seg_label = self.label_mapping[seg_label]

        # ----- image branch -----
        points_img = data_dict["points_img"].copy()
        img_path = osp.join(self.nuscenes_dir, data_dict["camera_path"])
        image = Image.open(img_path)
        ori_img_size = image.size
        ori_image_h = image.height

        if self.resize and image.size != self.resize:
            assert image.size[0] > self.resize[0]
            points_img[:, 0] = (float(self.resize[1]) / image.size[1]
                                * np.floor(points_img[:, 0]))
            points_img[:, 1] = (float(self.resize[0]) / image.size[0]
                                * np.floor(points_img[:, 1]))
            image = image.resize(self.resize, Image.BILINEAR)
            if sam_mask is not None:
                from scipy.ndimage import zoom

                sam_mask = sam_mask.reshape(ori_image_h, -1)
                sam_mask = zoom(sam_mask,
                                (self.resize[0] / ori_img_size[0],
                                 self.resize[1] / ori_img_size[1]), order=0)
                sam_mask = refine_sam_mask(
                    sam_mask,
                    max_h=image.size[1] - int(np.min(points_img, axis=0)[0]))

        if self.ema_input:
            ori_image = np.array(image, dtype=np.float32, copy=True) / 255.0
            ori_points_img = points_img.copy()

        img_indices = points_img.astype(np.int64)
        assert np.all(img_indices >= 0)
        assert np.all(img_indices[:, 0] < image.size[1])
        assert np.all(img_indices[:, 1] < image.size[0])

        image = np.asarray(image, dtype=np.float32) / 255.0
        if self.color_jitter is not None:
            image = apply_color_jitter(image, self.color_jitter, rng)
        if rng.random() < self.fliplr:
            image = np.ascontiguousarray(np.fliplr(image))
            img_indices[:, 1] = image.shape[1] - 1 - img_indices[:, 1]
            if sam_mask is not None:
                sam_mask = np.ascontiguousarray(np.fliplr(sam_mask))
        if self.image_normalizer:
            mean, std = self.image_normalizer
            image = (image - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)

        out_dict["img"] = image  # HWC
        out_dict["img_indices"] = img_indices

        # ----- 3D branch -----
        # nuscenes lidar coords: x (right), y (front), z (up)
        ori_points = points.copy()
        coords, aug_points = augment_and_scale_3d(
            points, self.scale, self.full_scale, rng=rng, noisy_rot=self.noisy_rot,
            flip_x=self.flip_x, rot_z=self.rot_z, transl=self.transl)
        coords = coords.astype(np.int64)
        idxs = (coords.min(1) >= 0) * (coords.max(1) < self.full_scale)

        out_dict["coords"] = coords[idxs]
        out_dict["aug_points"] = aug_points[idxs]
        out_dict["feats"] = np.ones([int(idxs.sum()), 1], np.float32)
        out_dict["seg_label"] = seg_label[idxs]
        out_dict["lidar_path"] = lidar_path
        out_dict["scan_pth"] = lidar_path
        out_dict["img_indices"] = out_dict["img_indices"][idxs]
        if self.with_depth_label:
            out_dict["depth_label"] = dense_depth_label(
                out_dict["img"].shape[:2], out_dict["img_indices"],
                points[idxs])

        if ps_data is not None:
            ps_label_2d = refine_pseudo_labels_np(
                ps_data["probs_2d"], ps_data["pseudo_label_2d"].astype(np.int32))
            ps_label_3d = refine_pseudo_labels_np(
                ps_data["probs_3d"], ps_data["pseudo_label_3d"].astype(np.int32))
            out_dict["pseudo_label_2d"] = ps_label_2d[idxs]
            out_dict["pseudo_label_3d"] = ps_label_3d[idxs]
            out_dict["ori_pseudo_label_3d"] = ps_label_3d

        if self.output_orig:
            # metric sensor-frame points aligned with predictions
            # (eval-time KNN range projection, VAL.use_knn)
            out_dict["points_xyz"] = points[idxs].astype(np.float32)
            out_dict["orig_seg_label"] = seg_label
            out_dict["orig_points_idx"] = idxs

        if g_mask is not None:
            out_dict["g_indices"] = g_mask

        if self.ema_input:
            ori_coords, _ = augment_and_scale_3d(ori_points, self.scale,
                                                 self.full_scale, rng=rng)
            ori_idxs = (ori_coords.min(1) >= 0) * (ori_coords.max(1) < self.full_scale)
            out_dict["ori_img_indices"] = ori_points_img.astype(np.int64)[ori_idxs]
            out_dict["ori_img"] = ori_image
            out_dict["ori_coords"] = ori_coords[ori_idxs].astype(np.int64)
            out_dict["ori_feats"] = np.ones([int(ori_idxs.sum()), 1], np.float32)
            # student point i (after idxs) = ori point position among ori_idxs
            ori_pos = np.cumsum(ori_idxs) - 1  # index into teacher outputs
            emap = np.where(ori_idxs, ori_pos, -1)[idxs]
            out_dict["ema_map"] = emap.astype(np.int32)

        if self.use_pc_mm:
            out_dict["ori_points"] = np.concatenate(
                [ori_points, np.ones((ori_points.shape[0], 1), np.float32)], axis=1)
            out_dict["ori_img_size"] = np.asarray(ori_img_size, np.int32)
            out_dict["proj_matrix"] = np.asarray(data_dict["proj_matrix"],
                                                 np.float32)

        if sam_mask is not None:
            out_dict["sam_mask"] = sam_mask

        return out_dict
