"""The port's voxel plan against the JAX reference, bit for bit.

``mopa_tpu_torch.models.scn_unet.build_unet_plan_batched`` must give exactly
the integers of ``mopa_tpu.models.scn_unet.build_unet_plan_batched`` on the
same key-sorted scans, with room to spare and with a level-0 capacity below
the true voxel count (overflow drops the same voxels on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu_torch.models import scn_unet as port_unet

torch.set_num_threads(1)

S, P, LEVELS = 2, 300, 3
LEVEL_KEYS = ("ranks", "sel", "valid", "down_nbr", "f2c", "up_off")
PLAN_KEYS = ("point_inverse", "point_counts", "point_end", "num_voxels")


def _lexkey(c):
    c = np.asarray(c, np.int64)
    return (c[:, 0] * 4096 + c[:, 1]) * 4096 + c[:, 2]


def sorted_scans(seed, s=S, p=P, extent=12):
    """Random scans with duplicate voxels, key-sorted per scan, padding last."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, extent, size=(s, p, 3)).astype(np.int32)
    valid = np.zeros((s, p), bool)
    for i in range(s):
        n = int(p * (0.8 + 0.1 * i))
        coords[i, :n] = coords[i, :n][np.argsort(_lexkey(coords[i, :n]),
                                                 kind="stable")]
        valid[i, :n] = True
    return coords, valid


def _plans(coords, valid, caps):
    ref = jax_unet.build_unet_plan_batched(
        jnp.asarray(coords), jnp.asarray(valid), LEVELS, capacities=caps)
    port = port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), LEVELS,
        capacities=caps)
    return ref, port


@pytest.mark.parametrize("caps", [None, (150, 120, 80)],
                         ids=["overflow_free", "overflow"])
def test_plan_integers_bit_identical(caps):
    coords, valid = sorted_scans(0)
    if caps is None:
        caps = port_unet.capacity_schedule(P, LEVELS,
                                           factors=(1.0,) * LEVELS)
    ref, port = _plans(coords, valid, list(caps))
    true_voxels = len(np.unique(_lexkey(coords[0][valid[0]])))
    if caps[0] < true_voxels:
        assert int(ref.num_voxels[0]) == S * caps[0]
    for l in range(LEVELS):
        for key in LEVEL_KEYS:
            r = getattr(ref.levels[l], key)
            t = getattr(port.levels[l], key)
            if r is None:
                assert t is None, (l, key)
                continue
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(r), err_msg="level {} {}".format(l, key))
    for key in PLAN_KEYS:
        np.testing.assert_array_equal(
            getattr(port, key).numpy(), np.asarray(getattr(ref, key)),
            err_msg=key)


def test_plan_ignores_point_order():
    """The port sorts for itself: a shuffled scan gives the same voxel
    tables and maps as the sorted one, and every point keeps its voxel."""
    coords, valid = sorted_scans(1)
    caps = port_unet.capacity_schedule(P, LEVELS)
    rng = np.random.default_rng(5)
    perm = np.stack([rng.permutation(P) for _ in range(S)])
    sh_coords = np.take_along_axis(coords, perm[..., None], axis=1)
    sh_valid = np.take_along_axis(valid, perm, axis=1)
    args = dict(num_levels=LEVELS, capacities=caps)
    a = port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), **args)
    b = port_unet.build_unet_plan_batched(
        torch.from_numpy(sh_coords), torch.from_numpy(sh_valid), **args)
    for l in range(LEVELS):
        for key in LEVEL_KEYS:
            x, y = getattr(a.levels[l], key), getattr(b.levels[l], key)
            if x is not None:
                assert torch.equal(x, y), (l, key)
    assert torch.equal(a.point_counts, b.point_counts)
    flat_perm = torch.from_numpy(perm + np.arange(S)[:, None] * P).reshape(-1)
    assert torch.equal(b.point_inverse, a.point_inverse[flat_perm])
