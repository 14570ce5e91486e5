"""Rare-object instance extraction from Waymo scans (PyTorch port of
``mopa_tpu/data/waymo/obj_point_extract.py``; reference
``mopa/data/waymo/obj_point_extract.py:44-193``).

Per target class (Waymo semantic ids: pedestrian 7, bicycle 12,
motorcycle 13), DBSCAN (eps 4, min_samples 5; scikit-learn, imported by
:func:`object_point_extraction`) clusters the class's points of each scan
that ``data_extractor`` wrote; instances whose mean range lies within
``max_distance`` (15 m) are kept, up to ``max_num`` (1000) per class, as
``<out_dir>/<class>/<n>.bin`` (N, 4) float32 files: the object bank that
VGI samples (``obj_root_dir``).

Usage: python -m mopa_tpu_torch.data.waymo.obj_point_extract
         --src_dir <extracted scans> --out_dir <dir>
         [--max_num 1000] [--max_distance 15]
"""

import argparse
import os

import numpy as np

# Waymo semantic ids of the rare classes
DEFAULT_CLASS_IDS = [7, 12, 13]
DEFAULT_CLASS_NAMES = ["person", "bicycle", "motorcycle"]


def object_point_extraction(src_data_dir, obj_class_id, obj_class_name,
                            save_dir, max_num=1000, max_distance=15.0):
    from sklearn.cluster import DBSCAN

    inst_count = [0] * len(obj_class_id)
    for sequence in sorted(os.listdir(src_data_dir)):
        seq_dir = os.path.join(src_data_dir, sequence)
        pc_dir = os.path.join(seq_dir, "bin")
        label_dir = os.path.join(seq_dir, "label")
        if not os.path.isdir(pc_dir):
            continue
        for pc_file in sorted(os.listdir(pc_dir)):
            if not pc_file.endswith(".bin"):
                continue
            pc = np.fromfile(os.path.join(pc_dir, pc_file),
                             dtype=np.float32).reshape(-1, 4)
            label = np.load(os.path.join(
                label_dir, pc_file.replace(".bin", ".npy"))).astype(np.int64)

            for i, (class_id, class_name) in enumerate(
                    zip(obj_class_id, obj_class_name)):
                if inst_count[i] >= max_num:
                    continue
                object_dir = os.path.join(save_dir, class_name)
                os.makedirs(object_dir, exist_ok=True)
                class_pc = pc[label == class_id]
                if class_pc.shape[0] == 0:
                    continue
                inst_label = DBSCAN(eps=4, min_samples=5).fit_predict(
                    class_pc[:, :3])
                for inst_id in np.unique(inst_label):
                    if inst_id < 0:
                        continue
                    inst_pc = class_pc[inst_label == inst_id]
                    mean_range = float(np.linalg.norm(
                        inst_pc[:, :3].mean(0)[:2]))
                    if mean_range > max_distance or np.any(np.isnan(inst_pc)):
                        continue
                    inst_pc.astype(np.float32).tofile(os.path.join(
                        object_dir, "{:05d}.bin".format(inst_count[i])))
                    inst_count[i] += 1
                    if inst_count[i] >= max_num:
                        break
        if all(c >= max_num for c in inst_count):
            break
    print("Extracted instances per class:",
          dict(zip(obj_class_name, inst_count)))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Rare-object extraction")
    parser.add_argument("--src_dir", required=True,
                        help="extracted Waymo scans (data_extractor output)")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--max_num", type=int, default=1000)
    parser.add_argument("--max_distance", type=float, default=15.0)
    args = parser.parse_args(argv)
    object_point_extraction(args.src_dir, DEFAULT_CLASS_IDS,
                            DEFAULT_CLASS_NAMES, args.out_dir,
                            args.max_num, args.max_distance)


if __name__ == "__main__":
    main()
