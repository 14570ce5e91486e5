"""The port's range projection, occlusion removal and ground fit
(``mopa_tpu_torch.ops.projection`` / ``ops.ground``) against ``mopa_tpu``'s
on the same numpy scans.

* ``project_pixels`` / ``occlusion_removal``: pixel ids and masks equal,
  ranges to 1e-5; a batch of scans at once equals each scan alone.
* ``estimate_ground``: masks equal on the scenes of
  ``tests/test_ground_fixtures.py`` and ``tests/test_ops_extra.py`` (flat
  road with cars, ramp, curb and wall, reflected noise, elevated deck, the
  plane scene), rebuilt here from the same seeds; agreement of at least
  0.999 on seeded random LiDAR-like scans, batched and alone;
  ``estimate_ground_np``'s int32 indices equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.ops import ground as jax_ground
from mopa_tpu.ops import projection as jax_projection
from mopa_tpu_torch.ops import ground, projection
from test_ground_fixtures import GROUND_Z, _disk

torch.set_num_threads(1)

FOV = (0.05235, -0.43633)


def _cloud(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                    rng.uniform(-2.5, 1.5, n)], 1).astype(np.float32)
    pts[:5] = 0.0  # ranges of 0 take the clamped pitch
    return pts


@pytest.mark.parametrize("size", [(256, 32), (1024, 64)])
def test_project_pixels_matches_jax(size):
    pts = _cloud(0)
    want_pix, want_d = jax_projection.project_pixels(jnp.asarray(pts),
                                                     *FOV, *size)
    got_pix, got_d = projection.project_pixels(torch.from_numpy(pts),
                                               *FOV, *size)
    np.testing.assert_array_equal(got_pix.numpy(), np.asarray(want_pix))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-5)


def _occlusion_inputs(seed, b=3, n=1500):
    rng = np.random.default_rng(seed)
    pts = np.stack([np.stack([rng.uniform(3, 40, n), rng.uniform(-8, 8, n),
                              rng.uniform(-1.5, 1.5, n)], 1)
                    for _ in range(b)]).astype(np.float32)
    # exact depth ties: the lowest index must survive
    pts[:, 100:110] = pts[:, 90:91]
    obj = np.zeros((b, n), bool)
    obj[:, :80] = True
    obj[:, 95] = True
    valid = rng.random((b, n)) < 0.9
    valid[:, 90:110] = True
    return pts, valid, obj


@pytest.mark.parametrize("size", [(256, 32), (1024, 64)])
def test_occlusion_removal_matches_jax(size):
    pts, valid, obj = _occlusion_inputs(1)
    want = np.stack([np.asarray(jax_projection.occlusion_removal(
        jnp.asarray(pts[i]), jnp.asarray(valid[i]), jnp.asarray(obj[i]),
        *FOV, *size)) for i in range(len(pts))])
    t = [torch.from_numpy(a) for a in (pts, valid, obj)]
    got = projection.occlusion_removal(*t, *FOV, *size).numpy()
    np.testing.assert_array_equal(got, want)
    alone = projection.occlusion_removal(t[0][1], t[1][1], t[2][1], *FOV,
                                         *size).numpy()
    np.testing.assert_array_equal(alone, want[1])
    assert (got <= valid).all() and (got != valid).any()


def _flat_road_with_objects():
    rng = np.random.default_rng(0)
    road = _disk(rng, 8000, 2.0, 40.0, GROUND_Z)
    objs = []
    for cx, cy in ((8.0, 3.0), (-12.0, -5.0), (20.0, 10.0)):
        o = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
        o[:, 0] = cx + o[:, 0] * 1.8
        o[:, 1] = cy + o[:, 1] * 0.8
        o[:, 2] = GROUND_Z + 0.3 + (o[:, 2] + 1) * 0.6
        objs.append(o)
    return np.concatenate([road] + objs)


def _ramp():
    rng = np.random.default_rng(1)
    flat = _disk(rng, 5000, 2.0, 10.0, GROUND_Z)
    ramp = _disk(rng, 5000, 10.0, 35.0, 0.0)
    r = np.sqrt(ramp[:, 0] ** 2 + ramp[:, 1] ** 2)
    ramp[:, 2] = GROUND_Z + np.tan(np.deg2rad(8.0)) * (r - 10.0) \
        + rng.normal(0, 0.03, len(ramp)).astype(np.float32)
    return np.concatenate([flat, ramp])


def _curb_and_wall():
    rng = np.random.default_rng(2)
    road = _disk(rng, 6000, 2.0, 30.0, GROUND_Z, th0=-np.pi / 2,
                 th1=np.pi / 2)
    road = road[road[:, 1] < 5.0]
    side = _disk(rng, 6000, 2.0, 30.0, GROUND_Z + 0.15, th0=-np.pi / 2,
                 th1=np.pi / 2)
    side = side[side[:, 1] > 5.3]
    wall = np.stack([np.full(800, 18.0) + rng.normal(0, 0.02, 800),
                     rng.uniform(-8, 4, 800),
                     rng.uniform(GROUND_Z, GROUND_Z + 2.5, 800)],
                    1).astype(np.float32)
    return np.concatenate([road, side, wall])


def _reflected_noise():
    rng = np.random.default_rng(3)
    road = _disk(rng, 8000, 2.0, 30.0, GROUND_Z)
    noise = _disk(rng, 1200, 4.0, 12.0, GROUND_Z - 3.0, z_sigma=0.5)
    return np.concatenate([road, noise])


def _elevated_deck():
    rng = np.random.default_rng(4)
    road = _disk(rng, 8000, 2.0, 30.0, GROUND_Z)
    keep = ~((road[:, 0] > 3) & (road[:, 0] < 7)
             & (road[:, 1] > 0) & (road[:, 1] < 4))
    road = road[keep]
    deck = np.stack([rng.uniform(3, 7, 900), rng.uniform(0, 4, 900),
                     np.full(900, GROUND_Z + 1.2)
                     + rng.normal(0, 0.02, 900)], 1).astype(np.float32)
    return np.concatenate([road, deck])


def _plane_scene():
    rng = np.random.default_rng(0)
    n_g, n_o = 3000, 800
    gx = rng.uniform(2, 60, n_g)
    gtheta = rng.uniform(-np.pi, np.pi, n_g)
    gpts = np.stack([gx * np.cos(gtheta), gx * np.sin(gtheta),
                     rng.normal(-1.73, 0.02, n_g)], 1)
    opts = np.stack([rng.uniform(5, 30, n_o), rng.uniform(-10, 10, n_o),
                     rng.uniform(-1.0, 2.0, n_o)], 1)
    return np.concatenate([gpts, opts]).astype(np.float32)


SCENES = {"flat_road_with_objects": _flat_road_with_objects, "ramp": _ramp,
          "curb_and_wall": _curb_and_wall,
          "reflected_noise": _reflected_noise,
          "elevated_deck": _elevated_deck, "plane_scene": _plane_scene}


def _jax_mask(pts, valid=None):
    valid = np.ones(len(pts), bool) if valid is None else valid
    return np.asarray(jax_ground.estimate_ground(jnp.asarray(pts),
                                                 jnp.asarray(valid)))


@pytest.mark.parametrize("scene", list(SCENES))
def test_estimate_ground_fixture_masks_equal(scene):
    pts = SCENES[scene]().astype(np.float32)
    want = _jax_mask(pts)
    got = ground.estimate_ground(torch.from_numpy(pts),
                                 torch.ones(len(pts), dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < want.mean() < 1.0


def _lidar_scan(seed, n=12000):
    """A LiDAR-like scan: ground rings with a little slope and noise,
    boxes, a wall, reflections below the road, a few invalid points."""
    rng = np.random.default_rng(seed)
    n_g = int(0.6 * n)
    r = np.sqrt(rng.uniform(1.5 ** 2, 60 ** 2, n_g))
    th = rng.uniform(-np.pi, np.pi, n_g)
    ground_pts = np.stack([r * np.cos(th), r * np.sin(th),
                           GROUND_Z + 0.01 * r * np.cos(th)
                           + rng.normal(0, 0.04, n_g)], 1)
    n_o = n - n_g - 600
    other = np.stack([rng.uniform(-40, 40, n_o), rng.uniform(-40, 40, n_o),
                      rng.uniform(-1.6, 2.5, n_o)], 1)
    wall = np.stack([np.full(400, 15.0), rng.uniform(-10, 10, 400),
                     rng.uniform(-1.7, 1.0, 400)], 1)
    refl = np.stack([rng.uniform(3, 10, 200), rng.uniform(-3, 3, 200),
                     rng.uniform(-6, -3, 200)], 1)
    pts = np.concatenate([ground_pts, other, wall, refl]).astype(np.float32)
    valid = rng.random(n) < 0.98
    return pts, valid


def test_estimate_ground_random_scans_agree():
    scans = [_lidar_scan(s) for s in range(3)]
    want = np.stack([_jax_mask(p, v) for p, v in scans])
    pts = torch.from_numpy(np.stack([p for p, _ in scans]))
    valid = torch.from_numpy(np.stack([v for _, v in scans]))
    got = ground.estimate_ground(pts, valid).numpy()
    assert (got == want).mean() >= 0.999
    alone = ground.estimate_ground(pts[2], valid[2]).numpy()
    assert (alone == want[2]).mean() >= 0.999
    assert 0.3 < want.mean() < 0.8
    assert not (got & ~valid.numpy()).any()


def test_estimate_ground_np_indices_equal():
    pts = np.concatenate([_lidar_scan(5, 6000)[0],
                          np.ones((6000, 1), np.float32)], 1)
    want = jax_ground.estimate_ground_np(pts)
    got = ground.estimate_ground_np(pts, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(got) > 1000
