"""The port's Waymo tools (``mopa_tpu_torch.data.waymo.data_extractor``,
``data.waymo.obj_point_extract``) against ``mopa_tpu``'s.

* ``extract_pc`` over a ``.tfrecord`` of three stub frames (written by
  TensorFlow), with ``waymo_open_dataset`` stubbed in ``sys.modules``: the
  frames carry a TOP and a FRONT range image (listed out of name order,
  labels on TOP only); the second frame has no segmentation labels and is
  skipped. The ``bin/`` and ``label/`` files are byte-equal to JAX's.
* ``object_point_extraction`` on fake extracted scans (person, bicycle and
  motorcycle clusters, one beyond ``max_distance``, one with a NaN
  intensity, isolated class points that DBSCAN calls noise, a sequence
  without ``bin/``): the bank is byte-equal, at a ``max_num`` that the
  person class reaches inside a scan and at the default.
* The port's ``SemanticKITTISCN`` with ``obj_root_dir`` at that bank
  samples one of its objects.
"""

import json
import os
import os.path as osp
import sys
import types

import numpy as np
import pytest

from mopa_tpu.data.waymo import data_extractor as jax_extractor
from mopa_tpu.data.waymo import obj_point_extract as jax_obj
from mopa_tpu_torch.data.semantic_kitti import semantic_kitti_dataloader
from mopa_tpu_torch.data.waymo import data_extractor, obj_point_extract
from test_datasets_real_format import make_fake_kitti
from test_torch_offline_preprocess import _files

TOP, FRONT = 1, 2
RANGE_HW = {TOP: (16, 32), FRONT: (8, 16)}


def _matrix(arr):
    """A ``MatrixFloat`` / ``MatrixInt32`` message's fields."""
    return types.SimpleNamespace(
        data=arr.reshape(-1).tolist(),
        shape=types.SimpleNamespace(dims=list(arr.shape)))


class _Frame:
    """``dataset_pb2.Frame``: parses the JSON the test writes."""

    def ParseFromString(self, data):  # noqa: N802 (protobuf's name)
        spec = json.loads(bytes(data).decode())
        self.seed = spec["seed"]
        self.lasers = [types.SimpleNamespace(
            ri_return1=types.SimpleNamespace(
                segmentation_label_compressed=b"x" if spec["labelled"]
                else b""))]
        self.context = types.SimpleNamespace(laser_calibrations=[
            types.SimpleNamespace(name=FRONT), types.SimpleNamespace(
                name=TOP)])


def _parse(frame):
    rng = np.random.default_rng(frame.seed)
    range_images, labels = {}, {}
    for name, hw in RANGE_HW.items():
        rng_m = rng.uniform(1, 60, hw)
        rng_m[rng.random(hw) < 0.25] = -1.0  # no return
        first = np.stack([rng_m, rng.uniform(0, 3000, hw),
                          rng.uniform(0, 1, hw), np.zeros(hw)],
                         -1).astype(np.float32)
        range_images[name] = [_matrix(first), _matrix(first[::-1].copy())]
    labels[TOP] = [_matrix(np.stack([
        rng.integers(0, 50, RANGE_HW[TOP]),
        rng.integers(0, 23, RANGE_HW[TOP])], -1).astype(np.int32))]
    return range_images, {}, labels, None


def _to_points(frame, range_images, camera_projections, top_pose,
               keep_polar_features=False):
    assert keep_polar_features
    points = []
    for name in sorted(range_images):
        ri = np.asarray(range_images[name][0].data, np.float32).reshape(
            range_images[name][0].shape.dims)
        mask = ri[..., 0] > 0
        rows, cols = np.nonzero(mask)
        az = cols / ri.shape[1] * 2 * np.pi
        inc = 0.3 - rows / ri.shape[0] * 0.5
        r = ri[mask, 0]
        xyz = np.stack([r * np.cos(inc) * np.cos(az),
                        r * np.cos(inc) * np.sin(az), r * np.sin(inc)], 1)
        points.append(np.concatenate([ri[mask, :3], xyz], 1).astype(
            np.float32))
    return points, []


@pytest.fixture
def waymo_stub(monkeypatch):
    mods = {name: types.ModuleType(name) for name in (
        "waymo_open_dataset", "waymo_open_dataset.dataset_pb2",
        "waymo_open_dataset.utils", "waymo_open_dataset.utils.frame_utils")}
    mods["waymo_open_dataset.dataset_pb2"].Frame = _Frame
    fu = mods["waymo_open_dataset.utils.frame_utils"]
    fu.parse_range_image_and_camera_projection = _parse
    fu.convert_range_image_to_point_cloud = _to_points
    mods["waymo_open_dataset"].dataset_pb2 = mods[
        "waymo_open_dataset.dataset_pb2"]
    mods["waymo_open_dataset"].utils = mods["waymo_open_dataset.utils"]
    mods["waymo_open_dataset.utils"].frame_utils = fu
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)


def test_extract_pc_files_equal(tmp_path, waymo_stub):
    import tensorflow as tf

    seq = str(tmp_path / "segment-1.tfrecord")
    with tf.io.TFRecordWriter(seq) as w:
        for seed, labelled in ((3, True), (4, False), (5, True)):
            w.write(json.dumps({"seed": seed,
                                "labelled": labelled}).encode())
    n_jax = jax_extractor.extract_pc(seq, str(tmp_path / "jax"))
    n_port = data_extractor.extract_pc(seq, str(tmp_path / "port"))
    assert n_jax == n_port == 2
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(want) == ["bin/00000.bin", "bin/00001.bin",
                            "label/00000.npy", "label/00001.npy"]
    assert got == want
    # the second labelled frame is seed 5's: the unlabelled one was skipped
    frame = _Frame()
    frame.ParseFromString(json.dumps({"seed": 5, "labelled": True}).encode())
    ri, _, seg, _ = _parse(frame)
    labels = data_extractor.range_labels(frame, ri, seg)
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "label" / "00001.npy"), labels[0][:, 1])
    pts = np.fromfile(tmp_path / "port" / "bin" / "00001.bin",
                      np.float32).reshape(-1, 4)
    assert pts.shape[0] == labels[0].shape[0]
    # FRONT has no labels: zeros for each of its valid pixels
    assert labels[1].shape == (int((np.asarray(ri[FRONT][0].data).reshape(
        8, 16, 4)[..., 0] > 0).sum()), 2) and not labels[1].any()


def _cluster(rng, centre, cls, n=30):
    pts = np.asarray(centre, np.float32) + rng.uniform(
        -0.5, 0.5, (n, 3)).astype(np.float32)
    return np.concatenate([pts, rng.uniform(0, 1, (n, 1))], 1), \
        np.full(n, cls)


def make_fake_waymo_scans(root):
    """Two sequences of extracted scans and one directory without
    ``bin/`` under ``root``; returns ``root``."""
    rng = np.random.default_rng(2)
    scans = {
        ("seq_a", "00000"): [((5, 0, -1), 7), ((5, 9, -1), 7),
                             ((30, 0, -1), 7), ((6, -6, -1), 12),
                             ((-7, 5, -1), 13)],
        ("seq_a", "00001"): [((-6, 0, -1), 7), ((0, -10, -1), 7),
                             ((10, 10, -1), 7), ((-8, -8, -1), 12)],
        ("seq_b", "00000"): [((4, 4, -1), 7), ((-5, -5, -1), 13)],
    }
    for (seq, name), clusters in scans.items():
        parts = [_cluster(rng, c, cls) for c, cls in clusters]
        # ground of class 0, and isolated bicycle points (DBSCAN noise)
        ground = rng.uniform(-40, 40, (400, 4)).astype(np.float32)
        parts.append((ground, np.zeros(400)))
        noise = np.array([[20, 20, 0, 0.5], [-20, 20, 0, 0.5],
                          [20, -20, 0, 0.5]], np.float32)
        parts.append((noise, np.full(3, 12)))
        pc = np.concatenate([p for p, _ in parts]).astype(np.float32)
        label = np.concatenate([lab for _, lab in parts]).astype(np.int32)
        if (seq, name) == ("seq_a", "00000"):
            # the motorcycle's NaN intensity drops it
            pc[label == 13, 3] = np.nan
        for d in ("bin", "label"):
            os.makedirs(osp.join(root, seq, d), exist_ok=True)
        pc.tofile(osp.join(root, seq, "bin", name + ".bin"))
        np.save(osp.join(root, seq, "label", name + ".npy"), label)
    os.makedirs(osp.join(root, "seq_c_no_bin"), exist_ok=True)
    return root


@pytest.mark.parametrize("max_num", [3, 1000])
def test_object_bank_files_equal(tmp_path, max_num):
    src = make_fake_waymo_scans(str(tmp_path / "scans"))
    args = (jax_obj.DEFAULT_CLASS_IDS, jax_obj.DEFAULT_CLASS_NAMES)
    assert args == (obj_point_extract.DEFAULT_CLASS_IDS,
                    obj_point_extract.DEFAULT_CLASS_NAMES)
    jax_obj.object_point_extraction(src, *args, str(tmp_path / "jax"),
                                    max_num=max_num, max_distance=15.0)
    obj_point_extract.object_point_extraction(
        src, *args, str(tmp_path / "port"), max_num=max_num,
        max_distance=15.0)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert got == want
    # 6 person clusters within 15 m (one at 30 m is cut), 2 bicycles, and
    # one motorcycle (the other has a NaN intensity)
    counts = [len(os.listdir(tmp_path / "port" / name)) for name in args[1]]
    assert counts == ([3, 2, 1] if max_num == 3 else [6, 2, 1])
    for name, data in got.items():
        obj = np.frombuffer(data, np.float32).reshape(-1, 4)
        assert obj.shape[0] >= 5 and not np.isnan(obj).any()
        assert np.linalg.norm(obj[:, :3].mean(0)[:2]) <= 15.0, name


def test_kitti_dataset_samples_the_bank(tmp_path):
    src = make_fake_waymo_scans(str(tmp_path / "scans"))
    bank = str(tmp_path / "objects")
    obj_point_extract.object_point_extraction(
        src, obj_point_extract.DEFAULT_CLASS_IDS,
        obj_point_extract.DEFAULT_CLASS_NAMES, bank)
    root = make_fake_kitti(str(tmp_path / "kitti"), with_extras=False)
    ds = semantic_kitti_dataloader.SemanticKITTISCN(
        split=("train",), root_dir=root, merge_classes=True, use_pc_mm=True,
        obj_name_ls=("person",), obj_root_dir=bank)
    sample = ds[0]
    (obj,) = sample["ori_obj_pc"]
    files = sorted(os.listdir(osp.join(bank, "person")))
    assert len(files) == 6
    bank_objs = [np.fromfile(osp.join(bank, "person", f),
                             np.float32).reshape(-1, 4) for f in files]
    assert any(o.shape == obj.shape and np.array_equal(o, obj)
               for o in bank_objs)
    person = ds.label_mapping[ds.class_name_to_id["person"]]
    assert (sample["ori_obj_label"][0] == person).all()
