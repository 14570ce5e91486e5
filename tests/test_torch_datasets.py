"""The port's real-format datasets against ``mopa_tpu``'s, on miniature
on-disk replicas of the file formats: SemanticKITTI (``make_fake_kitti`` of
``tests/test_datasets_real_format.py``: velodyne ``.bin``, ``.label``,
``calib.txt``, images, ground indices, SAM masks, an object bank; plus
per-scan pseudo-label ``.npy`` files written here), nuScenes and A2D2
(preprocess pickles, images, class lists, written here as that file's
tests write them).

Each dataset is built twice with the same options and a generator of the
same seed; every sample dict must be equal key by key, dtype and bytes,
and so must ``collate_padded`` of the samples (key-sorted, with host-built
plans and, where the sample has VGI inputs, host VGI).
"""

import json
import os
import os.path as osp
import pickle

import numpy as np
import pytest
from PIL import Image

from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.data import collate as jax_collate
from mopa_tpu.data.a2d2 import a2d2_dataloader as jax_a2d2
from mopa_tpu.data.nuscenes import nuscenes_dataloader as jax_nuscenes
from mopa_tpu.data.semantic_kitti import \
    semantic_kitti_dataloader as jax_kitti
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.data import collate
from mopa_tpu_torch.data.a2d2 import a2d2_dataloader
from mopa_tpu_torch.data.nuscenes import nuscenes_dataloader
from mopa_tpu_torch.data.semantic_kitti import semantic_kitti_dataloader
from mopa_tpu_torch.models.scn_unet import capacity_schedule
from test_datasets_real_format import make_fake_kitti
from test_torch_data_path import assert_same

LEVELS = 3
OBJ_NAMES = ["person", "bicycle", "motorcycle"]


def _write_kitti_pseudo_labels(root, ps_dir):
    """Per-scan pseudo-label files for the train scenes: each frame's
    stored view (``ori_keep_idx``, ``ori_img_points``, as the offline
    pseudo-label pass saves them), random labels and confidences."""
    ds = jax_kitti.SemanticKITTISCN(split=("train",), root_dir=root,
                                    merge_classes=True)
    r = np.random.default_rng(9)
    for frame in ds.data:
        index = ds.data.index(frame)
        view = ds.preprocess(ds.data_extraction(index))
        n = int(view["ori_keep_idx"].sum())
        out_dir = osp.join(root, "ps_label", ps_dir, frame["scene"])
        os.makedirs(out_dir, exist_ok=True)
        np.save(osp.join(out_dir, "{:06d}.npy".format(frame["frame_id"])), {
            "pseudo_label_2d": r.integers(0, 10, n).astype(np.uint8),
            "pseudo_label_3d": r.integers(0, 10, n).astype(np.uint8),
            "probs_2d": r.random(n).astype(np.float32),
            "probs_3d": r.random(n).astype(np.float32),
            "ori_keep_idx": view["ori_keep_idx"],
            "ori_img_points": view["ori_img_points"]}, allow_pickle=True)


def _write_nuscenes(root):
    """Three preprocessed samples, 800x450 images, ground indices, SAM
    masks, pseudo labels and an object bank, as the nuScenes test of
    ``test_datasets_real_format.py`` lays them out."""
    rng = np.random.default_rng(3)
    n, ow, oh = 300, 800, 450
    for d in ("samples/CAM_FRONT", "samples/LIDAR_TOP", "preprocess",
              "g_idx/LIDAR_TOP", "ps/LIDAR_TOP", "sam/train_usa/CAM_FRONT"):
        os.makedirs(osp.join(root, d), exist_ok=True)
    samples = []
    for i in range(3):
        cam = "samples/CAM_FRONT/img{}.jpg".format(i)
        Image.fromarray(rng.integers(0, 255, (oh, ow, 3), np.uint8)).save(
            osp.join(root, cam))
        pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(3, 40, n),
                        rng.uniform(-1.8, 1.5, n)], 1).astype(np.float32)
        samples.append({
            "points": pts,
            "seg_labels": rng.integers(0, 11, n).astype(np.uint8),
            "points_img": np.stack([rng.uniform(0, oh - 1, n),
                                    rng.uniform(0, ow - 1, n)],
                                   1).astype(np.float32),
            "lidar_path": "samples/LIDAR_TOP/scan{}.bin".format(i),
            "camera_path": cam,
            "valid_mask": np.ones(n, bool),
            "proj_matrix": np.eye(4, dtype=np.float32)[:3],
        })
        np.arange(0, n, 4, dtype=np.int32).tofile(
            osp.join(root, "g_idx/LIDAR_TOP/scan{}.bin".format(i)))
        rng.integers(0, 12, oh * ow).astype(np.uint8).tofile(
            osp.join(root, "sam/train_usa/CAM_FRONT/img{}.bin".format(i)))
        np.save(osp.join(root, "ps/LIDAR_TOP/scan{}.npy".format(i)), {
            "pseudo_label_2d": rng.integers(0, 5, n).astype(np.uint8),
            "pseudo_label_3d": rng.integers(0, 5, n).astype(np.uint8),
            "probs_2d": rng.random(n).astype(np.float32),
            "probs_3d": rng.random(n).astype(np.float32)}, allow_pickle=True)
    with open(osp.join(root, "preprocess", "train_usa.pkl"), "wb") as f:
        pickle.dump(samples, f)
    for cls in ("person", "bicycle"):
        os.makedirs(osp.join(root, "objects", cls), exist_ok=True)
        obj = np.concatenate([rng.uniform(-1, 1, (40, 3)) + [0, 8, -1],
                              rng.uniform(0, 1, (40, 1))], 1)
        obj.astype(np.float32).tofile(
            osp.join(root, "objects", cls, "00000.bin"))
    return root


def _write_a2d2(root):
    """One preprocessed sample with a 960x604 image and the class list,
    as the A2D2 test of ``test_datasets_real_format.py`` writes them."""
    rng = np.random.default_rng(5)
    os.makedirs(osp.join(root, "preprocess"), exist_ok=True)
    os.makedirs(osp.join(root, "imgs"), exist_ok=True)
    names = [c for cat in jax_a2d2.A2D2Base.categories_s.values()
             for c in cat] + ["Sky", "Utility vehicle 1", "Utility vehicle 2",
                              "Tractor", "Non-drivable street",
                              "Blurred area", "Rain dirt"]
    with open(osp.join(root, "class_list.json"), "w") as f:
        json.dump({"#{:06x}".format(17 * (i + 1)): n
                   for i, n in enumerate(names)}, f)
    with open(osp.join(root, "cams_lidars.json"), "w") as f:
        json.dump({"cameras": {}}, f)
    n, ow, oh = 200, 960, 604
    samples = []
    for i in range(2):
        cam = "imgs/{}.png".format(i)
        Image.fromarray(rng.integers(0, 255, (oh, ow, 3), np.uint8)).save(
            osp.join(root, cam))
        samples.append({
            "points": np.stack([rng.uniform(2, 40, n), rng.uniform(-5, 5, n),
                                rng.uniform(-1.8, 1.0, n)],
                               1).astype(np.float32),
            "seg_labels": rng.integers(0, len(names), n).astype(np.uint8),
            "points_img": np.stack([rng.uniform(0, oh - 1, n),
                                    rng.uniform(0, ow - 1, n)],
                                   1).astype(np.float32),
            "camera_path": cam, "lidar_path": "lidar/{}.npz".format(i)})
    with open(osp.join(root, "preprocess", "train.pkl"), "wb") as f:
        pickle.dump(samples, f)
    return root


AUG3D = dict(noisy_rot=0.1, rot_z=6.2831, transl=True)
AUG2D = dict(fliplr=0.5, color_jitter=(0.4, 0.4, 0.4))


def _kitti(root, case):
    kw = dict(root_dir=root, merge_classes=True, bottom_crop=(96, 64))
    if case == "kitti_target":
        kw.update(split=("train",), flip_y=0.5, use_pc_mm=True,
                  obj_name_ls=OBJ_NAMES,
                  obj_root_dir=osp.join(root, "objects"),
                  g_indices_dir="g_indices", sam_mask_dir="img_mask",
                  ema_input=True, **AUG3D, **AUG2D)
    elif case == "kitti_pseudo_labels":
        _write_kitti_pseudo_labels(root, "ps")
        kw.update(split=("train",), flip_y=0.5, ps_label_dir="ps",
                  sam_mask_dir="img_mask", use_pc_mm=True, multi_objs=True,
                  obj_name_ls=OBJ_NAMES,
                  obj_root_dir=osp.join(root, "objects"),
                  g_indices_dir="g_indices", **AUG3D, **AUG2D)
    else:  # eval
        kw.update(split=("val",), output_orig=True)
    return (semantic_kitti_dataloader.SemanticKITTISCN,
            jax_kitti.SemanticKITTISCN, kw)


def _nuscenes(root, case):
    kw = dict(split=("train_usa",), preprocess_dir=osp.join(root,
                                                            "preprocess"),
              nuscenes_dir=root, label_mode="object", merge_classes=True,
              resize=(400, 225), flip_x=0.5, **AUG3D, **AUG2D)
    if case == "nuscenes_target":
        kw.update(ps_label_dir="ps", g_indices_dir="g_idx",
                  sam_mask_dir="sam", use_pc_mm=True,
                  obj_name_ls=["person", "bicycle"],
                  obj_root_dir=osp.join(root, "objects"), ema_input=True)
    return (nuscenes_dataloader.NuScenesSCN, jax_nuscenes.NuScenesSCN, kw)


def _a2d2(root, case):
    kw = dict(split=("train",), preprocess_dir=root, merge_classes=True,
              resize=(480, 302), flip_y=0.5, **AUG3D, **AUG2D)
    return (a2d2_dataloader.A2D2SCN, jax_a2d2.A2D2SCN, kw)


CASES = {
    "kitti_target": (lambda p: make_fake_kitti(p), _kitti),
    "kitti_pseudo_labels": (lambda p: make_fake_kitti(p), _kitti),
    "kitti_eval": (lambda p: make_fake_kitti(p, with_extras=False), _kitti),
    "nuscenes_source": (_write_nuscenes, _nuscenes),
    "nuscenes_target": (_write_nuscenes, _nuscenes),
    "a2d2_source": (_write_a2d2, _a2d2),
}


def _vgi(base_cfg):
    c = base_cfg.clone()
    c.TRAIN.PC_MM.search_range = [25.0, 25.0]
    return {"rng": np.random.default_rng(12), "pc_mm": c.TRAIN.PC_MM,
            "aug": dict(AUG3D, flip_y=0.5), "scale": 20.0,
            "full_scale": 4096, "front_axis_x": True, "num_levels": LEVELS,
            "factors": None}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_samples_and_collate_match_jax(tmp_path, case):
    write, make = CASES[case]
    root = write(str(tmp_path))
    port_cls, jax_cls, kw = make(root, case)
    got_ds = port_cls(rng=np.random.default_rng(21), **kw)
    want_ds = jax_cls(rng=np.random.default_rng(21), **kw)
    assert len(got_ds) == len(want_ds) > 0
    assert got_ds.class_names == want_ds.class_names
    n = min(len(got_ds), 2)
    got = [got_ds[i] for i in range(n)]
    want = [want_ds[i] for i in range(n)]
    for i in range(n):
        assert_same(got[i], want[i], "{}[{}]".format(case, i))
    train = "eval" not in case
    budget = 256
    caps = capacity_schedule(budget, LEVELS) if train else None
    batches = []
    for fn, base in ((collate.collate_padded, port_base_cfg),
                     (jax_collate.collate_padded, jax_base_cfg)):
        batches.append(fn(got if fn is collate.collate_padded else want,
                          budget, obj_budget=64, mask_budget=12,
                          sort_points=train, host_plan_capacities=caps,
                          vgi_host=_vgi(base) if train else None))
    assert_same(batches[0], batches[1], case + " collate")
    if train:
        assert "hp_rankn" in batches[0]


@pytest.mark.parametrize("cls,kw", [
    (semantic_kitti_dataloader.SemanticKITTISCN,
     {"use_sparse_quantize": True}),
    (semantic_kitti_dataloader.SemanticKITTISCN, {"backbone": "SalsaNext"}),
    (a2d2_dataloader.A2D2SCN, {"backbone": "SPVCNN"}),
    (nuscenes_dataloader.NuScenesSCN, {"with_depth_label": True})])
def test_unported_dataset_inputs_raise(tmp_path, cls, kw):
    """The inputs that raised here before they were ported: KITTI with
    ``use_sparse_quantize`` (no effect, as in JAX) and SalsaNext's range
    images, A2D2 with SPVCNN's xyz + reflectance features, nuScenes with
    depth labels; samples and collate byte-equal to JAX's."""
    if cls is semantic_kitti_dataloader.SemanticKITTISCN:
        case = "kitti_eval" if "use_sparse_quantize" in kw \
            else "kitti_target"
    elif cls is a2d2_dataloader.A2D2SCN:
        case = "a2d2_source"
    else:
        case = "nuscenes_source"
    write, make = CASES[case]
    root = write(str(tmp_path))
    port_cls, jax_cls, base_kw = make(root, case)
    assert port_cls is cls
    if case == "kitti_target":
        base_kw = dict(base_kw, use_pc_mm=False, ema_input=False)
    base_kw.update(kw)
    got_ds = port_cls(rng=np.random.default_rng(22), **base_kw)
    want_ds = jax_cls(rng=np.random.default_rng(22), **base_kw)
    got = [got_ds[i] for i in range(min(len(got_ds), 2))]
    want = [want_ds[i] for i in range(len(got))]
    for i in range(len(got)):
        assert_same(got[i], want[i], "{}[{}]".format(kw, i))
    if kw.get("backbone") == "SalsaNext":
        assert got[0]["proj_in"].shape == (64, 1024, 5)
    if kw.get("backbone") == "SPVCNN":
        assert got[0]["feats"].shape[1] == 4
    if kw.get("with_depth_label"):
        assert got[0]["depth_label"].shape[2] == 1
    train = case != "kitti_eval"
    assert_same(collate.collate_padded(got, 256, sort_points=train),
                jax_collate.collate_padded(want, 256, sort_points=train),
                "{} collate".format(kw))
