"""The port's host-built voxel plans against ``mopa_tpu``'s and against its
own device build.

* ``native_loader.build_plan_arrays`` (the port's copy of the C++ builder,
  built at first use) gives the JAX package's builder's arrays byte for byte:
  on key-sorted and on unsorted samples, with fixups forced by far-apart
  voxels, and None for both when the fixups overflow their budget.
* ``plan_from_host_arrays`` and ``concat_plans`` give JAX's arrays on every
  field (S = 3, P = 512, 4 levels, as ``tests/test_host_plan_wire.py``), and
  the port's ``build_unet_plan_batched`` on every field with its dtypes
  (ranks where a column has a neighbour: an all-miss column's rank is read
  by nothing).
* Unsorted points: the decode's run order pools all-ones features to
  exactly 1 on every active voxel, and random features as the device build
  does (JAX's decode assumes sorted points: ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.data import native_loader as jax_nl
from mopa_tpu.models import scn_unet as jax_su
from mopa_tpu_torch.data import native_loader as port_nl
from mopa_tpu_torch.models import scn_unet as port_su
from mopa_tpu_torch.ops import voxel

S, P, L = 3, 512, 4
CAPS = [512, 384, 256, 128]
DOMS = [0, 1, 1]
FIELDS = ("valid", "down_nbr", "f2c", "up_off", "ranks", "sel", "dom")


def _lexkey(c):
    c = np.asarray(c, np.int64)
    return (c[:, 0] * 4096 + c[:, 1]) * 4096 + c[:, 2]


def _samples(seed, s=S, p=P, sort=True):
    """S samples of 60-100 % of P points on a 40 x 40 x 12 grid (z-dense
    columns like LiDAR's), key-sorted or not, padded at the end."""
    rng = np.random.default_rng(seed)
    coords, valid = [], []
    for _ in range(s):
        n = int(rng.integers(3 * p // 5, p))
        c = rng.integers(0, 40, size=(n, 3)).astype(np.int32)
        c[:, 2] = rng.integers(0, 12, n)
        if sort:
            c = c[np.argsort(_lexkey(c), kind="stable")]
        coords.append(np.concatenate([c, np.zeros((p - n, 3), np.int32)]))
        valid.append(np.arange(p) < n)
    return np.stack(coords), np.stack(valid)


def _fixup_sample(p=768, n=700, seed=7):
    """Far-apart x: per-column rank jumps overflow a nibble (fixups)."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.integers(0, 3000, n), rng.integers(0, 50, n),
                  rng.integers(0, 8, n)], 1).astype(np.int32)
    c = c[np.argsort(_lexkey(c), kind="stable")]
    return (np.concatenate([c, np.zeros((p - n, 3), np.int32)]),
            np.arange(p) < n)


def _host(coords, valid, caps=CAPS):
    per = [port_nl.build_plan_arrays(c, v, caps)
           for c, v in zip(coords, valid)]
    return {k: np.stack([h[k] for h in per]) for k in per[0]}


@pytest.mark.parametrize("case", ["sorted", "unsorted", "fixups"])
def test_build_plan_arrays_bytes_match_jax(case):
    if case == "fixups":
        coords, valid = _fixup_sample()
        coords, valid, caps = coords[None], valid[None], [768, 512, 256]
    else:
        coords, valid = _samples(1, sort=case == "sorted")
        caps = CAPS
    for c, v in zip(coords, valid):
        got = port_nl.build_plan_arrays(c, v, caps)
        want = jax_nl.build_plan_arrays(c, v, caps)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if case == "fixups":
            assert (got["fix"] >= 0).sum() > 0


def test_fixup_overflow_returns_none(monkeypatch):
    """Past the fixup budget (rc -2) both builders return None; arguments
    the builder rejects raise in the port."""
    coords, valid = _fixup_sample()
    caps = [768, 512, 256]
    used = int((port_nl.build_plan_arrays(coords, valid, caps)["fix"]
                >= 0).sum())
    monkeypatch.setattr(port_nl, "FIXUP_BUDGET", used - 1)
    monkeypatch.setattr(jax_nl, "FIXUP_BUDGET", used - 1)
    assert port_nl.build_plan_arrays(coords, valid, caps) is None
    assert jax_nl.build_plan_arrays(coords, valid, caps) is None
    with pytest.raises(ValueError, match="rc -1"):
        port_nl.build_plan_arrays(coords, valid, [40000, 512, 256])


def _np(x):
    return None if x is None else np.asarray(x)


def _jax_decode(host, caps, doms=None):
    """JAX's decode, jitted (dispatched op by op it takes seconds)."""
    doms = None if doms is None else np.asarray(doms)
    return jax.jit(lambda arrs: jax_su.plan_from_host_arrays(
        arrs, caps, len(caps), sample_domains=doms))(
        {k: jnp.asarray(v) for k, v in host.items()})


def _port_decode(host, caps, doms=None):
    return port_su.plan_from_host_arrays(
        {k: torch.from_numpy(v) for k, v in host.items()}, caps, len(caps),
        sample_domains=doms)


def _assert_plans_equal(got, want, live_ranks=False, perm=True):
    """Every level field and point map of two plans equal (values; dtypes
    too where ``want`` is a port plan)."""
    for l, (g, w) in enumerate(zip(got.levels, want.levels)):
        for f in FIELDS:
            a, b = getattr(g, f), _np(getattr(w, f))
            if b is None:
                assert a is None, (l, f)
                continue
            a = a.numpy()
            if f == "ranks" and live_ranks:
                live = _np(w.sel) != 63
                a, b = a[live], b[live]
            if isinstance(getattr(w, f), torch.Tensor):
                assert a.dtype == b.dtype, (l, f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg="{} L{}".format(f, l))
    names = ["point_inverse", "point_counts", "num_voxels", "point_end"]
    for name in names + (["point_perm"] if perm else []):
        a, b = getattr(got, name).numpy(), _np(getattr(want, name))
        if isinstance(getattr(want, name), torch.Tensor):
            assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", ["sorted", "fixups"])
def test_decode_matches_jax(case):
    if case == "fixups":
        coords, valid = _fixup_sample()
        coords, valid, caps, doms = coords[None], valid[None], [768, 512,
                                                                256], [1]
    else:
        coords, valid = _samples(2)
        caps, doms = CAPS, DOMS
    host = _host(coords, valid, caps)
    got = _port_decode(host, caps, doms)
    _assert_plans_equal(got, _jax_decode(host, caps, doms), perm=False)
    # key-sorted points: the run order is the identity
    p = coords.shape[1]
    np.testing.assert_array_equal(got.point_perm.numpy(),
                                  np.arange(coords.shape[0] * p))


def test_decode_matches_device_build():
    coords, valid = _samples(3)
    got = _port_decode(_host(coords, valid), CAPS, DOMS)
    want = port_su.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), L,
        capacities=CAPS, sample_domains=DOMS)
    _assert_plans_equal(got, want, live_ranks=True)


def test_concat_plans_matches_jax():
    """[two samples at CAPS; two of a larger group] fused, as the train
    step fuses [source; target] and the VGI cat scans."""
    c1, v1 = _samples(4, s=2)
    c2, v2 = _samples(5, s=2, p=640)
    caps2 = port_su.capacity_schedule(640, L)
    h1, h2 = _host(c1, v1), _host(c2, v2, caps2)
    got = port_su.concat_plans([_port_decode(h1, CAPS, [0, 1]),
                                _port_decode(h2, caps2, [2, 2])])
    want = jax.jit(jax_su.concat_plans)([_jax_decode(h1, CAPS, [0, 1]),
                                         _jax_decode(h2, caps2, [2, 2])])
    _assert_plans_equal(got, want, perm=False)
    np.testing.assert_array_equal(got.point_perm.numpy(),
                                  np.arange(2 * P + 2 * 640))
    # device-built groups: the first group's last all-miss sentinel rank
    # lands on the second group's first row, with the dz code 63 that
    # keeps every reader off it
    fused = port_su.concat_plans([
        port_su.build_unet_plan_batched(
            torch.from_numpy(c1), torch.from_numpy(v1), L, capacities=CAPS),
        port_su.build_unet_plan_batched(
            torch.from_numpy(c2), torch.from_numpy(v2), L,
            capacities=caps2)])
    for l, lv in enumerate(fused.levels):
        n1 = 2 * CAPS[l]
        ranks = lv.ranks.reshape(-1, 9)[:n1]
        seam = ranks >= n1
        assert bool(seam.any()) and bool((ranks[seam] == n1).all()), l
        assert bool((lv.sel.reshape(-1, 9)[:n1][seam] == 63).all()), l


def test_unsorted_points_pool_like_the_device_build():
    coords, valid = _samples(6, sort=False)
    host = _host(coords, valid)
    plan = _port_decode(host, CAPS, DOMS)
    ref = port_su.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), L,
        capacities=CAPS)
    active = plan.point_counts > 0
    ones = voxel.pool_features_sorted(torch.ones((S * P, 1)),
                                      plan.point_counts, plan.point_end,
                                      plan.point_perm)
    assert int(active.sum()) == int(plan.num_voxels[0])
    assert torch.equal(ones[active], torch.ones_like(ones[active]))
    assert torch.equal(ones[~active], torch.zeros_like(ones[~active]))
    feats = torch.from_numpy(np.random.default_rng(0).normal(
        size=(S * P, 5)).astype(np.float32))
    got = voxel.pool_features_sorted(feats, plan.point_counts,
                                     plan.point_end, plan.point_perm)
    want = voxel.pool_features_sorted(feats, ref.point_counts, ref.point_end,
                                      ref.point_perm)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the JAX decode's pooling of the same arrays (no run order) is wrong
    jplan = _jax_decode(host, CAPS)
    jones = np.asarray(jax.jit(
        lambda pl: jax_su.voxel_ops.pool_features_sorted(
            jnp.ones((S * P, 1)), pl.point_inverse, pl.point_counts,
            pl.point_end, pl.point_perm, S * CAPS[0]))(jplan))
    assert not np.all(jones[active.numpy()] == 1.0)
