"""Map a lidar scan path to its pseudo-label output path (port of
``mopa_tpu/data/pspath_sort.py``; reference ``mopa/data/pspath_sort.py``)."""

import os.path as osp


def pspath_sort(cfg, lidar_path, pselab_dir):
    """SemanticKITTI: ``<root>/ps_label/<pselab_dir>/<scene>/<frame>.npy``;
    nuScenes: ``<nuscenes_dir>/<pselab_dir>/<prefix>/<file>.npy``; any
    other dataset: ``<pselab_dir>/<file>.npy``."""
    dataset_type = cfg.DATASET_TARGET.TYPE
    parts = lidar_path.split("/")
    if "KITTI" in dataset_type.upper():
        # .../sequences/<scene>/velodyne/<frame>.bin -> <scene>/<frame>.npy
        scene, frame = parts[-3], parts[-1]
        root = cfg.DATASET_TARGET.SemanticKITTISCN.root_dir
        return osp.join(root, "ps_label", pselab_dir, scene,
                        frame.replace(".bin", ".npy"))
    if "NUSCENES" in dataset_type.upper():
        prefix, fname = parts[-2], parts[-1]
        root = cfg.DATASET_TARGET.NuScenesSCN.nuscenes_dir
        return osp.join(root, pselab_dir, prefix,
                        fname.replace(".bin", ".npy"))
    return osp.join(pselab_dir, parts[-1].replace(".bin", ".npy"))
