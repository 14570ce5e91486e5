"""A2D2 (Audi), the shipped MoPA run's source domain (port of
``mopa_tpu/data/a2d2/a2d2_dataloader.py``).

Samples come from the offline preprocess step's pickles: the 38 paint
classes merged into the 10 shared with SemanticKITTI (``categories_s``,
Poles among other-objects), the image resized to (480, 302) with its point
pixels rescaled, flip and colour jitter, and the 3D augmentation. Only the
SCN backbone's inputs are ported (``data.utils.inputs``).
"""

from __future__ import annotations

import json
import os.path as osp
import pickle

import numpy as np
from PIL import Image

from mopa_tpu_torch.data.utils.augmentation_3d import augment_and_scale_3d
from mopa_tpu_torch.data.utils.image_aug import \
    color_jitter as apply_color_jitter
from mopa_tpu_torch.data.utils import inputs
from mopa_tpu_torch.data.utils.depth_label import dense_depth_label


class A2D2Base:
    """The preprocessed samples and the 38 paint classes -> 10 merged
    categories."""

    # merged categories shared with SemanticKITTI
    categories_s = {
        "car": ["Car 1", "Car 2", "Car 3", "Car 4", "Ego car"],
        "truck": ["Truck 1", "Truck 2", "Truck 3"],
        "bike": ["Bicycle 1", "Bicycle 2", "Bicycle 3", "Bicycle 4",
                 "Small vehicles 1", "Small vehicles 2", "Small vehicles 3"],
        "person": ["Pedestrian 1", "Pedestrian 2", "Pedestrian 3"],
        "road": ["RD normal street", "Zebra crossing", "Solid line",
                 "RD restricted area", "Slow drive area", "Drivable cobblestone",
                 "Dashed line", "Painted driv. instr."],
        "parking": ["Parking area"],
        "sidewalk": ["Sidewalk", "Curbstone"],
        "building": ["Buildings"],
        "nature": ["Nature object"],
        "other-objects": ["Traffic signal 1", "Traffic signal 2", "Traffic signal 3",
                          "Traffic sign 1", "Traffic sign 2", "Traffic sign 3",
                          "Sidebars", "Speed bumper", "Irrelevant signs",
                          "Road blocks", "Obstacles / trash", "Animals",
                          "Signal corpus", "Electronic traffic",
                          "Traffic guide obj.", "Grid structure", "Poles"],
    }

    def __init__(self, split, preprocess_dir, merge_classes=False):
        self.split = split
        self.preprocess_dir = preprocess_dir
        assert isinstance(split, tuple)
        with open(osp.join(self.preprocess_dir, "cams_lidars.json"), "r") as f:
            self.config = json.load(f)
        self.data = []
        for curr_split in split:
            with open(osp.join(self.preprocess_dir, "preprocess",
                               curr_split + ".pkl"), "rb") as f:
                self.data.extend(pickle.load(f))

        with open(osp.join(self.preprocess_dir, "class_list.json"), "r") as f:
            class_list = json.load(f)
        self.rgb_to_class = {}
        self.rgb_to_cls_idx = {}
        for count, (k, v) in enumerate(class_list.items()):
            rgb_value = tuple(int(k.lstrip("#")[i:i + 2], 16) for i in (0, 2, 4))
            self.rgb_to_class[rgb_value] = v
            self.rgb_to_cls_idx[rgb_value] = count
        self.class_names = list(self.rgb_to_class.values())

        if merge_classes:
            self.label_mapping = -100 * np.ones(len(self.rgb_to_class) + 1, dtype=int)
            for cat_idx, cat_list in enumerate(self.categories_s.values()):
                for class_name in cat_list:
                    self.label_mapping[self.class_names.index(class_name)] = cat_idx
            self.class_names = list(self.categories_s.keys())
        else:
            self.label_mapping = None

    def __len__(self):
        return len(self.data)


class A2D2SCN(A2D2Base):
    def __init__(self, split, preprocess_dir, merge_classes=False, scale=20,
                 full_scale=4096, use_image=True, resize=(480, 302),
                 image_normalizer=None, noisy_rot=0.0, flip_y=0.0, rot_z=0.0,
                 transl=False, fliplr=0.0, color_jitter=None, use_feats=False,
                 use_sparse_quantize=False, backbone="SCN",
                 with_depth_label=False, rng=None):
        super().__init__(split, preprocess_dir, merge_classes=merge_classes)
        self.backbone = backbone
        self.with_depth_label = with_depth_label
        self.scale = scale
        self.full_scale = full_scale
        self.noisy_rot = noisy_rot
        self.flip_y = flip_y
        self.rot_z = rot_z
        self.transl = transl
        self.use_image = use_image
        self.resize = tuple(resize) if resize else None
        self.image_normalizer = image_normalizer
        self.fliplr = fliplr
        self.color_jitter = tuple(color_jitter) if color_jitter else None
        self.rng = rng or np.random.default_rng()

    def __getitem__(self, index):
        rng = self.rng
        data_dict = self.data[index]
        points = data_dict["points"].copy()
        seg_label = data_dict["seg_labels"].astype(np.int64)
        if self.label_mapping is not None:
            seg_label = self.label_mapping[seg_label]

        out_dict = {}
        if self.use_image:
            points_img = data_dict["points_img"].copy()
            img_path = osp.join(self.preprocess_dir, data_dict["camera_path"])
            image = Image.open(img_path)
            if self.resize and image.size != self.resize:
                assert image.size[0] > self.resize[0]
                points_img[:, 0] = (float(self.resize[1]) / image.size[1]
                                    * np.floor(points_img[:, 0]))
                points_img[:, 1] = (float(self.resize[0]) / image.size[0]
                                    * np.floor(points_img[:, 1]))
                image = image.resize(self.resize, Image.BILINEAR)

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
            if self.image_normalizer:
                mean, std = self.image_normalizer
                image = ((image - np.asarray(mean, np.float32))
                         / np.asarray(std, np.float32))
            out_dict["img"] = image
            out_dict["img_indices"] = img_indices

        # A2D2 lidar coords (same as KITTI): x (front), y (left), z (up)
        coords, aug_points = augment_and_scale_3d(
            points, self.scale, self.full_scale, rng=rng, noisy_rot=self.noisy_rot,
            flip_y=self.flip_y, rot_z=self.rot_z, transl=self.transl)
        coords = coords.astype(np.int64)
        idxs = (coords.min(1) >= 0) * (coords.max(1) < self.full_scale)

        out_dict["coords"] = coords[idxs]
        out_dict["aug_points"] = aug_points[idxs]
        out_dict["feats"] = np.ones([int(idxs.sum()), 1], np.float32)
        if inputs.takes_xyzi(self.backbone):
            refl = np.asarray(data_dict.get(
                "reflectance", np.ones(len(points))), np.float32)
            out_dict["feats"] = inputs.spvcnn_feats(aug_points[idxs],
                                                    refl[idxs])
        out_dict["seg_label"] = seg_label[idxs]
        out_dict["lidar_path"] = data_dict.get("lidar_path", "")
        out_dict["scan_pth"] = data_dict.get("lidar_path", "")
        if self.use_image:
            out_dict["img_indices"] = out_dict["img_indices"][idxs]
            if self.with_depth_label:
                out_dict["depth_label"] = dense_depth_label(
                    out_dict["img"].shape[:2], out_dict["img_indices"],
                    points[idxs])
        return out_dict
