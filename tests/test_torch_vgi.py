"""The port's host-side VGI and its host-plan collation against
``mopa_tpu``'s, byte for byte per seed.

* ``vgi_insert_sample_np`` in "ground" mode (with its candidate cells,
  quantised centres, anchor and road heights) and in "fv" mode, on the
  scene of ``tests/test_vgi_host.py``.
* ``occlusion_detector`` and ``range_projection``, with and without an
  object mask.
* ``vgi_host_batch`` (placement, occlusion, the shared augmentation draw,
  quantisation) at two seeds.
* ``collate._host_vgi_batch`` and ``_host_plan_batch`` on the port's seeded
  synthetic target batch (KITTI geometry, one object per scan): every key
  equal to the JAX collate functions' on the same dict, the raw VGI inputs
  removed, the cat capacity audit within its capacities; the synthetic batch
  with ``host_plans`` carries the same keys.
"""

import numpy as np
import pytest

from mopa_tpu.common.config import CfgNode as JaxCfgNode
from mopa_tpu.data import collate as jax_collate
from mopa_tpu.data import vgi_host as jax_vgi
from mopa_tpu.data.utils import augmentation_3d as jax_aug
from mopa_tpu_torch.common.config import CfgNode
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.data import collate, synthetic, vgi_host
from mopa_tpu_torch.data.utils import augmentation_3d
from test_vgi_host import PARAMS, _scene

PC_MM = {"search_voxel_size": 0.5, "search_range": (20.0, 20.0),
         "search_z_min": -2.0, "insert_mode": "ground", "use_proj": True,
         "fov_up": 0.05235, "fov_down": -0.43633, "proj_W": 256,
         "proj_H": 32}
AUG = {"noisy_rot": 0.1, "rot_z": 6.2831, "flip_y": 0.5, "transl": True}


def _assert_same(got, want, tag=""):
    """Two (nested) results equal: same keys, dtypes and bytes."""
    if isinstance(want, dict):
        assert set(got) == set(want), tag
        for k in want:
            _assert_same(got[k], want[k], "{}.{}".format(tag, k))
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (tag, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=tag)


def _points4():
    pts, pvalid, g_mask, objs, ovalid, obj_labels, proj, img_size = _scene()
    points4 = np.concatenate([pts, np.ones((pts.shape[0], 1), np.float32)], 1)
    return points4, pvalid, g_mask, objs, ovalid, obj_labels, proj, img_size


@pytest.mark.parametrize("mode", ["ground", "fv"])
def test_vgi_insert_sample_matches_jax(mode):
    args = _points4()
    kw = dict(PARAMS, insert_mode=mode, debug=mode == "ground")
    got = vgi_host.vgi_insert_sample_np(*args, np.random.default_rng(3), **kw)
    want = jax_vgi.vgi_insert_sample_np(*args, np.random.default_rng(3),
                                        **kw)
    _assert_same(got, want)
    assert got["inserted"].any()


def test_range_projection_matches_jax():
    points4, *_ = _points4()
    rng = np.random.default_rng(0)
    obj_mask = rng.random(points4.shape[0]) < 0.2
    for mask in (None, obj_mask):
        _assert_same(
            augmentation_3d.range_projection(points4, 0.05235, -0.43633, 256,
                                             32, obj_mask=mask),
            jax_aug.range_projection(points4, 0.05235, -0.43633, 256, 32,
                                     obj_mask=mask))
    yx = rng.integers(0, 4, (500, 2))
    depth = rng.random(500)
    _assert_same(augmentation_3d.occlusion_detector(yx, depth),
                 jax_aug.occlusion_detector(yx, depth))


@pytest.mark.parametrize("seed", [0, 5])
def test_vgi_host_batch_matches_jax(seed):
    points4, pvalid, g_mask, objs, ovalid, obj_labels, proj, img_size = \
        _points4()
    b = 2
    rng = np.random.default_rng(seed)
    scan_label = rng.integers(-1, 5, (b, points4.shape[0]))
    inputs = [np.stack([x] * b) for x in (points4, pvalid)] + [scan_label] \
        + [np.stack([x] * b) for x in (g_mask, objs, ovalid, obj_labels,
                                       proj, img_size)]
    kw = dict(aug=AUG, scale=20, full_scale=4096, front_axis_x=True)
    got = vgi_host.vgi_host_batch(*inputs, np.random.default_rng(seed),
                                  pc_mm=CfgNode(PC_MM), **kw)
    want = jax_vgi.vgi_host_batch(*inputs, np.random.default_rng(seed),
                                  pc_mm=JaxCfgNode(PC_MM), **kw)
    _assert_same(got, want)
    assert got["inserted"].any() and got["obj_mask"].any()


def _vgi_settings(pc_mm, seed, levels):
    return {"rng": np.random.default_rng(seed), "pc_mm": pc_mm,
            "aug": dict(synthetic.KITTI_TARGET_AUG), "scale": 20.0,
            "full_scale": 4096, "front_axis_x": True, "num_levels": levels,
            "factors": None}


def test_collate_host_vgi_and_plans_match_jax():
    b, p, levels = 2, 1024, 4
    raw = synthetic.train_batch(b, p, image_size=(128, 96), domain="target",
                                with_vgi=True)
    raw["point_valid"] = np.arange(p)[None, :] < raw["num_points"][:, None]
    caps = synthetic.host_plan_settings(
        _levels_cfg(levels), p)["capacities"]
    port_cfg = _levels_cfg(levels)
    jax_pc_mm = JaxCfgNode(dict(port_cfg.TRAIN.PC_MM))
    outs = []
    for mod, pc_mm in ((collate, port_cfg.TRAIN.PC_MM),
                       (jax_collate, jax_pc_mm)):
        out = {k: v.copy() for k, v in raw.items()}
        mod._host_vgi_batch(out, out["ori_points"], b, p,
                            synthetic.OBJ_BUDGET,
                            _vgi_settings(pc_mm, 11, levels))
        mod._host_plan_batch(out, b, p, caps, "hp_", "coords", "point_valid")
        outs.append(out)
    got, want = outs
    _assert_same(got, want)
    for k in collate.VGI_RAW_KEYS:
        assert k not in got, k
    for k in ("cat_valid", "cat_label", "cat_obj_mask", "vgi_inserted",
              "hp_cat_rankn", "hp_rankn", "_hp_cat_true_nums", "_hp_cat_caps"):
        assert k in got, k
    assert got["vgi_inserted"].all()
    assert (got["_hp_cat_true_nums"] <= got["_hp_cat_caps"][None]).all()
    # train_batch's host_plans path gives the same keys
    settings = synthetic.host_plan_settings(port_cfg, p, seed=11)
    batch = synthetic.train_batch(b, p, image_size=(128, 96),
                                  domain="target", with_vgi=True,
                                  host_plans=settings)
    _assert_same(batch, got)


def _levels_cfg(levels):
    c = port_base_cfg.clone()
    c.MODEL_3D.SCN.num_planes = levels
    c.TRAIN.PC_MM.lambda_pc_mm = 0.1
    c.TRAIN.PC_MM.search_range = [25.0, 25.0]
    return c
