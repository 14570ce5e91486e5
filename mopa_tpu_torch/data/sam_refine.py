#!/usr/bin/env python
"""Offline SAM mask generation (port of ``mopa_tpu/data/sam_refine.py``;
reference ``mopa/data/sam_refine.py:42-248``).

Writes one mask-id map per camera image for the SAM-consistency loss: the
masks of an automatic mask generator, sorted by area (largest first), are
rasterised into one uint8 id map (255 unassigned; later, smaller masks
overwrite inside larger ones) and written as ``.bin`` where the datasets'
``sam_mask_dir`` reads them.

The generator is any callable ``image -> list[{'segmentation': HxW bool,
'area': int}]``. :func:`make_sam_generator` builds segment-anything's
``SamAutomaticMaskGenerator`` from a checkpoint, as the reference does; it
needs the ``segment_anything`` package and raises ``ImportError`` without
it. Unlike the JAX package's it puts the model on ``cuda`` by default.

Usage: python -m mopa_tpu_torch.data.sam_refine --dataset kitti
         --root_dir <dir> --checkpoint <sam .pth> [--model_type vit_h]
         [--scenes 00 01 ...]
       python -m mopa_tpu_torch.data.sam_refine --dataset nuscenes
         --root_dir <dir> --checkpoint <sam .pth> --pkl <file> --split <name>
"""

import argparse
import glob
import os
import os.path as osp
import pickle

import numpy as np


def rasterize_masks(masks, image_hw):
    """Masks sorted by area, largest first, into one uint8 id map (at most
    255 ids; 255 = unassigned)."""
    h, w = image_hw
    id_map = np.full((h, w), 255, np.uint8)
    masks = sorted(masks, key=lambda m: int(m["area"]), reverse=True)
    for new_id, m in enumerate(masks[:255]):
        id_map[np.asarray(m["segmentation"], bool)] = new_id
    return id_map


def single_mask_generator(generator, image_path, out_path):
    from PIL import Image

    image = np.array(Image.open(image_path).convert("RGB"))
    id_map = rasterize_masks(generator(image), image.shape[:2])
    os.makedirs(osp.dirname(out_path), exist_ok=True)
    id_map.tofile(out_path)
    return id_map


def make_sam_generator(checkpoint, model_type="vit_h", device="cuda"):
    """segment-anything's automatic mask generator on ``device``."""
    try:
        from segment_anything import (SamAutomaticMaskGenerator,
                                      sam_model_registry)
    except ImportError as e:
        raise ImportError("make_sam_generator needs the segment_anything "
                          "package (segment-anything)") from e

    sam = sam_model_registry[model_type](checkpoint=checkpoint)
    sam.to(device)
    gen = SamAutomaticMaskGenerator(sam)

    def run(image):
        return gen.generate(image)

    return run


def kitti_mask_generator(generator, root_dir, scenes, mask_dir="img_mask"):
    """Every ``image_2/*.png`` of each scene -> ``<root_dir>/<mask_dir>/
    <scene>/<frame>.bin``."""
    for scene in scenes:
        cam_paths = sorted(glob.glob(osp.join(
            root_dir, "dataset", "sequences", scene, "image_2", "*.png")))
        out_dir = osp.join(root_dir, mask_dir, scene)
        for cam_path in cam_paths:
            frame_id = osp.splitext(osp.basename(cam_path))[0]
            single_mask_generator(generator, cam_path,
                                  osp.join(out_dir, frame_id + ".bin"))
        print("SAM masks for sequence {} -> {}".format(scene, out_dir))


def nuscenes_mask_generator(generator, nuscenes_dir, pkl_file, split_name,
                            mask_dir="img_mask"):
    """Every ``camera_path`` of a preprocess ``.pkl`` -> ``<nuscenes_dir>/
    <mask_dir>/<split_name>/<camera dir>/<image>.bin``."""
    with open(pkl_file, "rb") as f:
        data_list = pickle.load(f)
    for data in data_list:
        cam_path = osp.join(nuscenes_dir, data["camera_path"])
        prefix, fname = data["camera_path"].split("/")[-2:]
        out_path = osp.join(nuscenes_dir, mask_dir, split_name, prefix,
                            fname.replace(".jpg", ".bin"))
        single_mask_generator(generator, cam_path, out_path)
    print("SAM masks for {} -> {}".format(pkl_file, mask_dir))


def main(argv=None):
    parser = argparse.ArgumentParser(description="SAM mask generation")
    parser.add_argument("--dataset", choices=["kitti", "nuscenes"],
                        required=True)
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="segment-anything .pth checkpoint")
    parser.add_argument("--model_type", default="vit_h")
    parser.add_argument("--scenes", nargs="+", default=None)
    parser.add_argument("--pkl", default=None)
    parser.add_argument("--split", default=None)
    args = parser.parse_args(argv)
    generator = make_sam_generator(args.checkpoint, args.model_type)
    if args.dataset == "kitti":
        from mopa_tpu_torch.data.semantic_kitti import splits

        kitti_mask_generator(generator, args.root_dir,
                             args.scenes or splits.train)
    else:
        if not (args.pkl and args.split):
            parser.error("--dataset nuscenes needs --pkl and --split")
        nuscenes_mask_generator(generator, args.root_dir, args.pkl,
                                args.split)


if __name__ == "__main__":
    main()
