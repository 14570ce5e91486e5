"""The port's nuScenes and A2D2 preprocessors
(``mopa_tpu_torch.data.nuscenes.{projection,preprocess}``,
``data.a2d2.preprocess``) against ``mopa_tpu``'s.

* ``map_pointcloud_to_image`` on random calibrations: every output
  bit-equal.
* nuScenes: both packages' ``main()`` over a fake devkit installed in
  ``sys.modules`` (a ``NuScenes`` over 6 scenes named from the splits: one
  in no split, Boston and Singapore logs, night scenes in train, test and
  ``val_night``, a ``val_singapore`` scene; ``points_in_box`` and
  ``category_to_detection_name``, one box category that maps to no class
  and one box outside the camera's view). Every ``.pkl`` and capacity
  audit byte-equal; the ``g_indices`` files byte-equal with JAX's 3x3
  ``eigh`` patched into the port's ground fit, and with torch's own the
  ground masks agree on >= 0.999 of the points (the convention of
  ``tests/test_torch_preprocess.py``).
* A2D2: both packages' ``main()`` on a fake tree (``cams_lidars.json`` with
  the front camera's lens Fisheye, Telecam or neither, ``class_list.json``,
  camera and label PNGs, LiDAR ``.npz`` files with and without
  ``reflectance`` and one without ``row``, which is skipped): the ``.pkl``
  files (the merged ``train.pkl`` too), the undistorted PNGs and the audits
  byte-equal.
"""

import json
import os
import os.path as osp
import pickle
import shutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mopa_tpu.data.a2d2 import preprocess as jax_a2d2
from mopa_tpu.data.nuscenes import preprocess as jax_nusc
from mopa_tpu.data.nuscenes import projection as jax_proj
from mopa_tpu_torch.data.a2d2 import preprocess as a2d2
from mopa_tpu_torch.data.a2d2 import splits as a2d2_splits
from mopa_tpu_torch.data.nuscenes import preprocess as nusc_pre
from mopa_tpu_torch.data.nuscenes import projection

SCAN_POINTS = 3000


def _files(base):
    """{relative path: bytes} of every file under ``base``."""
    out = {}
    for dirpath, _, names in os.walk(base):
        for n in names:
            p = osp.join(dirpath, n)
            with open(p, "rb") as f:
                out[osp.relpath(p, base)] = f.read()
    return out


def _unit(q):
    q = np.asarray(q, np.float64)
    return (q / np.linalg.norm(q)).tolist()


# camera axes (x right, y down, z forward) in the ego frame (x forward)
CAM_Q = (0.5, -0.5, 0.5, -0.5)


def _calib(rng):
    jitter = lambda s: rng.normal(0, s, 4)  # noqa: E731
    return {
        "lidar2ego_translation": [0.94, 0.0, 1.84],
        "lidar2ego_rotation": _unit(np.array([1.0, 0, 0, 0]) + jitter(0.02)),
        "ego2global_translation_lidar": rng.uniform(-500, 500, 3).tolist(),
        "ego2global_rotation_lidar": _unit(rng.normal(0, 1, 4)),
        "ego2global_translation_cam": rng.uniform(-500, 500, 3).tolist(),
        "ego2global_rotation_cam": _unit(rng.normal(0, 1, 4)),
        "cam2ego_translation": [1.7, 0.01, 1.51],
        "cam2ego_rotation": _unit(np.array(CAM_Q) + jitter(0.02)),
        "cam_intrinsic": np.array([[1266.4, 0, 816.3], [0, 1266.4, 491.5],
                                   [0, 0, 1]]),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_pointcloud_to_image_bit_equal(seed):
    rng = np.random.default_rng(seed)
    info = _calib(rng)
    pc = rng.uniform(-60, 60, (3, 5000))
    got = projection.map_pointcloud_to_image(pc, (900, 1600, 3), info)
    want = jax_proj.map_pointcloud_to_image(pc, (900, 1600, 3), info)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    q = rng.normal(0, 1, 4)
    q /= np.linalg.norm(q)
    np.testing.assert_array_equal(projection.quat_to_rot(q),
                                  jax_proj.quat_to_rot(q))


# ----- nuScenes -------------------------------------------------------------

# (name, log location, description, samples); see the module docstring
NUSC_SCENES = (
    ("scene-0001", "singapore-onenorth", "Night, parked cars", 2),
    ("scene-0045", "singapore-queenstown", "Rain, pedestrians", 1),
    ("scene-0230", "boston-seaport", "Construction, day", 2),
    ("scene-0003", "boston-seaport", "Night drive downtown", 1),
    ("scene-1050", "singapore-hollandvillage", "night, turn", 1),
    ("scene-0079", "boston-seaport", "In no split", 1),
)
DETECTION_NAMES = {"vehicle.car": "car",
                   "human.pedestrian.adult": "pedestrian",
                   "movable_object.trafficcone": "traffic_cone"}


class _Box:
    def __init__(self, token, name, center, wlh):
        self.token, self.name = token, name
        self.center, self.wlh = np.asarray(center), np.asarray(wlh)


def _points_in_box(box, points):
    return np.all(np.abs(points - box.center[:, None])
                  <= box.wlh[:, None] / 2, axis=0)


def _lidar_scan(rng, n=SCAN_POINTS):
    """(n, 5) float32: a ground ring at -1.8 m and objects above it."""
    n_ground = n * 2 // 3
    r = np.sqrt(rng.uniform(2 ** 2, 40 ** 2, n))
    th = rng.uniform(-np.pi, np.pi, n)
    z = np.where(np.arange(n) < n_ground, rng.normal(-1.8, 0.03, n),
                 rng.uniform(-1.6, 1.5, n))
    return np.stack([r * np.cos(th), r * np.sin(th), z,
                     rng.uniform(0, 255, n), np.zeros(n)], 1).astype(
        np.float32)


def make_fake_nuscenes(root):
    """Write the scans of :data:`NUSC_SCENES` under ``root`` and return the
    tables a ``NuScenes`` stub serves."""
    rng = np.random.default_rng(5)
    t = {k: {} for k in ("scene", "log", "sample_data", "calibrated_sensor",
                         "ego_pose")}
    samples, sample_data = [], {}
    os.makedirs(osp.join(root, "samples", "LIDAR_TOP"), exist_ok=True)
    for si, (name, location, desc, n) in enumerate(NUSC_SCENES):
        t["log"]["log%d" % si] = {"token": "log%d" % si, "location": location}
        t["scene"]["sc%d" % si] = {"token": "sc%d" % si, "name": name,
                                  "description": desc,
                                  "log_token": "log%d" % si}
        for k in range(n):
            tok = "s%d_%d" % (si, k)
            info = _calib(rng)
            for sensor, rot, trans, pose_r, pose_t in (
                    ("lidar", "lidar2ego_rotation", "lidar2ego_translation",
                     "ego2global_rotation_lidar",
                     "ego2global_translation_lidar"),
                    ("cam", "cam2ego_rotation", "cam2ego_translation",
                     "ego2global_rotation_cam",
                     "ego2global_translation_cam")):
                sd = tok + sensor
                t["calibrated_sensor"]["cs" + sd] = {
                    "rotation": info[rot], "translation": info[trans]}
                t["ego_pose"]["ep" + sd] = {"rotation": info[pose_r],
                                           "translation": info[pose_t]}
                t["sample_data"][sd] = {
                    "calibrated_sensor_token": "cs" + sd,
                    "ego_pose_token": "ep" + sd}
            # the same ego pose for both sensors keeps points in the view
            t["ego_pose"]["ep" + tok + "cam"] = t["ego_pose"]["ep" + tok
                                                              + "lidar"]
            lidar_path = osp.join(root, "samples", "LIDAR_TOP",
                                  "n_%s.pcd.bin" % tok)
            _lidar_scan(rng).tofile(lidar_path)
            boxes = [_Box(tok + "b%d" % i, name, center, (4.0, 3.0, 3.0))
                     for i, (name, center) in enumerate((
                         ("vehicle.car", (12, 0, -1)),
                         ("human.pedestrian.adult", (20, 4, -1)),
                         ("animal", (8, -3, -1)),
                         ("movable_object.trafficcone", (25, -5, -1))))]
            sample_data[tok + "lidar"] = (lidar_path, boxes, None)
            # the last box lies outside the camera's view
            sample_data[tok + "cam"] = (
                osp.join(root, "samples", "CAM_FRONT", tok + ".jpg"),
                boxes[:-1], info["cam_intrinsic"])
            samples.append({"token": tok, "scene_token": "sc%d" % si,
                            "data": {"LIDAR_TOP": tok + "lidar",
                                     "CAM_FRONT": tok + "cam"}})
    return t, samples, sample_data


def nuscenes_stub(root, monkeypatch):
    """Install a fake ``nuscenes`` devkit over ``root``'s tables."""
    tables, samples, sample_data = make_fake_nuscenes(root)

    class NuScenes:
        def __init__(self, version, dataroot, verbose=True):
            assert dataroot == root
            self.sample = samples

        def get(self, table, token):
            return tables[table][token]

        def get_sample_data(self, token):
            return sample_data[token]

    mods = {name: types.ModuleType(name) for name in (
        "nuscenes", "nuscenes.utils", "nuscenes.utils.geometry_utils",
        "nuscenes.eval", "nuscenes.eval.detection",
        "nuscenes.eval.detection.utils")}
    mods["nuscenes"].NuScenes = NuScenes
    mods["nuscenes.utils.geometry_utils"].points_in_box = _points_in_box
    mods["nuscenes.eval.detection.utils"].category_to_detection_name = \
        DETECTION_NAMES.get
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)


def _jax_eigh(cov):
    evals, evecs = jnp.linalg.eigh(jnp.asarray(cov.numpy()))
    return torch.from_numpy(np.array(evals)), torch.from_numpy(np.array(evecs))


def test_nuscenes_preprocess_files_equal(tmp_path, monkeypatch):
    root = str(tmp_path / "nusc")
    nuscenes_stub(root, monkeypatch)
    g_dir = osp.join(root, "g_indices")
    out = {}
    monkeypatch.setattr(sys, "argv", ["preprocess", "--root_dir", root,
                                      "--out_dir", str(tmp_path / "jax")])
    jax_nusc.main()
    out["jax"] = _files(tmp_path / "jax")
    ground = {"jax": _files(g_dir)}
    for name in ("jax_eigh", "torch_eigh"):
        for d in (g_dir, str(tmp_path / name)):
            if osp.isdir(d):
                shutil.rmtree(d)
        with monkeypatch.context() as m:
            if name == "jax_eigh":
                m.setattr(torch.linalg, "eigh", _jax_eigh)
            nusc_pre.main(["--root_dir", root, "--out_dir",
                           str(tmp_path / name)], device="cpu")
        out[name] = _files(tmp_path / name)
        ground[name] = _files(g_dir)

    want = out["jax"]
    subsets = {"train_usa", "test_usa", "train_singapore", "val_singapore",
               "test_singapore", "train_day", "test_day", "train_night",
               "val_night", "test_night"}
    assert set(want) == {"preprocess/%s.pkl" % s for s in subsets} | {
        "preprocess/capacity_audit_%s.json" % s for s in subsets}
    for name in ("jax_eigh", "torch_eigh"):
        assert out[name] == want, name
    # what the fake tables exercise reached the files
    recs = {s: pickle.loads(want["preprocess/%s.pkl" % s]) for s in subsets}
    scenes = {s: sorted({r["scene_name"] for r in v})
              for s, v in recs.items()}
    assert scenes["train_usa"] == ["scene-0230"]
    assert scenes["val_singapore"] == ["scene-0045"]
    assert scenes["train_singapore"] == ["scene-0001", "scene-1050"]
    assert scenes["train_night"] == ["scene-0001"]
    assert scenes["val_night"] == ["scene-1050"]
    assert scenes["test_night"] == ["scene-0003"]
    assert scenes["train_day"] == ["scene-0045", "scene-0230"]
    labels = np.concatenate([r["seg_labels"] for v in recs.values()
                             for r in v])
    assert {0, 5, 10} <= set(labels.tolist())
    assert 8 not in labels  # the traffic cone is out of the camera's view

    assert sorted(ground["jax"]) == sorted(
        "LIDAR_TOP/n_%s.pcd.bin" % t for t in ("s0_0", "s0_1", "s4_0"))
    assert ground["jax_eigh"] == ground["jax"]
    assert sorted(ground["torch_eigh"]) == sorted(ground["jax"])
    differ = 0
    for k, v in ground["jax"].items():
        a = set(np.frombuffer(v, np.int32).tolist())
        b = set(np.frombuffer(ground["torch_eigh"][k], np.int32).tolist())
        assert 0 < len(a) < SCAN_POINTS
        differ += len(a ^ b)
    assert differ <= 0.001 * SCAN_POINTS * len(ground["jax"]), differ


# ----- A2D2 ------------------------------------------------------------------

A2D2_HW = (48, 64)
A2D2_CLASSES = {"#ff0000": "Car 1", "#00ff00": "Road", "#0000ff": "Sky",
                "#ffff00": "Pedestrian 1"}
# (scene, frame id, LiDAR file keys); see the module docstring
A2D2_FRAMES = (
    (a2d2_splits.train1[0], "000000091", ("reflectance", "row")),
    (a2d2_splits.train1[0], "000000105", ("row",)),
    (a2d2_splits.train2[0], "000000012", ("reflectance", "row")),
    (a2d2_splits.test[0], "000000040", ("reflectance",)),
    (a2d2_splits.test[0], "000000077", ("reflectance", "row")),
)


def _camera(lens):
    k = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]])
    k_orig = k + np.array([[2.0, 0, 0.5], [0, 2.0, -0.5], [0, 0, 0]])
    dist = {"Fisheye": [-0.05, 0.01, -0.002, 0.0005],
            "Telecam": [-0.2, 0.05, 0.001, -0.001, 0.0]}.get(lens, [0.0] * 5)
    return {"CamMatrix": k.tolist(), "CamMatrixOriginal": k_orig.tolist(),
            "Distortion": dist, "Lens": lens}


def make_fake_a2d2(root, lens):
    rng = np.random.default_rng(11)
    h, w = A2D2_HW
    os.makedirs(root)
    with open(osp.join(root, "cams_lidars.json"), "w") as f:
        json.dump({"cameras": {"front_center": _camera(lens),
                               "side_left": _camera("Fisheye")}}, f)
    with open(osp.join(root, "class_list.json"), "w") as f:
        json.dump(A2D2_CLASSES, f)
    colours = np.array([[int(k[i:i + 2], 16) for i in (1, 3, 5)]
                        for k in A2D2_CLASSES] + [[9, 9, 9]], np.uint8)
    for scene, frame, keys in A2D2_FRAMES:
        stamp = scene.replace("_", "")
        dirs = {d: osp.join(root, scene, d, "cam_front_center")
                for d in ("camera", "lidar", "label")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            osp.join(dirs["camera"], "%s_camera_frontcenter_%s.png"
                     % (stamp, frame)))
        # label blocks of 8 x 8 pixels, one colour unknown to the class list
        blocks = rng.integers(0, len(colours), (h // 8, w // 8))
        label = colours[np.kron(blocks, np.ones((8, 8), np.int64))]
        Image.fromarray(label).save(osp.join(
            dirs["label"], "%s_label_frontcenter_%s.png" % (stamp, frame)))
        n = 300
        arrays = {"points": rng.uniform(-20, 20, (n, 3)),
                  "reflectance": rng.uniform(0, 255, n),
                  "row": rng.uniform(0, h - 1, n),
                  "col": rng.uniform(0, w - 1, n)}
        np.savez(osp.join(dirs["lidar"], "%s_lidar_frontcenter_%s.npz"
                          % (stamp, frame)),
                 **{k: v for k, v in arrays.items()
                    if k in keys + ("points", "col")})
    return root


@pytest.mark.parametrize("lens", ["Fisheye", "Telecam", "Pinhole"])
def test_a2d2_preprocess_files_equal(tmp_path, monkeypatch, lens):
    root = make_fake_a2d2(str(tmp_path / "a2d2"), lens)
    monkeypatch.setattr(sys, "argv", ["preprocess", "--root_dir", root,
                                      "--out_dir", str(tmp_path / "jax")])
    jax_a2d2.main()
    a2d2.main(["--root_dir", root, "--out_dir", str(tmp_path / "port")])
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert got == want
    splits = ("train1", "train2", "train3", "test")
    assert {"preprocess/train.pkl"} | {"preprocess/%s.pkl" % s
                                       for s in splits} | {
        "preprocess/capacity_audit_%s.json" % s for s in splits} <= set(want)
    pngs = sorted(k for k in want if k.startswith("undistorted/"))
    # the frame without "row" is skipped
    assert len(pngs) == 4
    train = pickle.loads(want["preprocess/train.pkl"])
    assert len(train) == 3
    assert train[1]["feats"].shape == (300, 1)  # no reflectance: ones
    und = np.array(Image.open(tmp_path / "port" / pngs[0]))
    raw = np.array(Image.open(osp.join(root, pngs[0][len("undistorted/"):])))
    assert und.shape == raw.shape
    assert (und == raw).all() == (lens == "Pinhole")
    labels = np.concatenate([r["seg_labels"] for r in train])
    assert {0, 1, 2, 3, 4} <= set(labels.tolist())
