"""The port's sparse-conv ops against the JAX reference, in float32.

The plain twin of the K1 kernel (``submanifold_conv_wide_ref``) is held to
the XLA oracle ``sparse_conv.submanifold_conv_wide`` and to the Pallas K1 in
interpret mode; the other eval-path ops (strided conv, deconv, eval batch
norm, pooling, unpooling) are held to their JAX functions. Inputs come from
one numpy seed; plans from both packages' builders on the same scans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu.ops import sparse_conv as jsc
from mopa_tpu.ops import sparse_conv_pallas as scp
from mopa_tpu.ops import voxel as jvoxel
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.ops import sparse_conv as psc
from mopa_tpu_torch.ops import voxel as pvoxel

torch.set_num_threads(1)

S, P, LEVELS = 2, 400, 2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def plans():
    """Both packages' plans for the same two scans. Points arrive unsorted,
    so pooling runs through a non-trivial run-order permutation."""
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 14, size=(S, P, 3)).astype(np.int32)
    valid = np.ones((S, P), bool)
    valid[1, int(P * 0.85):] = False
    caps = jax_unet.capacity_schedule(P, LEVELS)
    ref = jax_unet.build_unet_plan_batched(
        jnp.asarray(coords), jnp.asarray(valid), LEVELS, capacities=caps)
    port = port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), LEVELS,
        capacities=caps)
    return ref, port, caps


def _feats(rng, rows, c, valid=None):
    f = rng.normal(size=(rows, c)).astype(np.float32)
    if valid is not None:
        f = f * np.asarray(valid)[:, None]
    return f


@pytest.mark.parametrize("cin,cout", [(1, 8), (16, 16), (32, 16)])
def test_submanifold_ref_matches_xla(plans, cin, cout):
    ref, port, _ = plans
    lv_r, lv_p = ref.levels[0], port.levels[0]
    rng = np.random.default_rng(cin)
    feats = _feats(rng, lv_p.valid.shape[0], cin, lv_p.valid.numpy())
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    want = jsc.submanifold_conv_wide(
        jnp.asarray(feats), jsc.WidePlan(lv_r.ranks, lv_r.sel), jnp.asarray(w))
    got = psc.submanifold_conv_wide_ref(torch.from_numpy(feats), lv_p.ranks,
                                        lv_p.sel, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the CPU dispatch of the public entry point is the plain twin
    got2 = psc.submanifold_conv_wide(
        torch.from_numpy(feats), psc.WidePlan(lv_p.ranks, lv_p.sel),
        torch.from_numpy(w))
    assert torch.equal(got, got2)


@pytest.mark.parametrize("cin,cout", [(16, 16), (32, 16)])
def test_submanifold_ref_matches_pallas_k1(plans, cin, cout):
    ref, port, caps = plans
    old = scp._INTERPRET
    scp._INTERPRET = True
    try:
        lv_r, lv_p = ref.levels[1], port.levels[1]
        rng = np.random.default_rng(100 + cin)
        feats = _feats(rng, lv_p.valid.shape[0], cin, lv_p.valid.numpy())
        w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
        lr, ls = scp.localize_plan(lv_r.ranks, lv_r.sel, caps[1], S)
        want = scp.submanifold_conv_wide_pallas(
            jnp.asarray(feats), lr, ls, jnp.asarray(w), caps[1], S)
    finally:
        scp._INTERPRET = old
    got = psc.submanifold_conv_wide_ref(torch.from_numpy(feats), lv_p.ranks,
                                        lv_p.sel, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrapper_takes_only_cuda_tensors(plans):
    """The K1 wrapper never falls back to the twin: a CPU tensor raises
    before any build or launch, and the launch count stays put."""
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc

    lv = plans[1].levels[0]
    feats = torch.zeros(lv.valid.shape[0], 16)
    before = dict(scc.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scc.submanifold_conv_wide_cuda(feats, lv.ranks, lv.sel,
                                       torch.zeros(27, 16, 16))
    assert scc.launches == before


def test_strided_conv_and_deconv(plans):
    ref, port, _ = plans
    fine_r, nxt_r = ref.levels[0], ref.levels[1]
    fine_p, nxt_p = port.levels[0], port.levels[1]
    rng = np.random.default_rng(7)
    cin, cout = 8, 12
    fine = _feats(rng, fine_p.valid.shape[0], cin, fine_p.valid.numpy())
    w_down = (rng.normal(size=(8, cin, cout)) * 0.3).astype(np.float32)
    want = jsc.strided_conv(jnp.asarray(fine), nxt_r.down_nbr,
                            jnp.asarray(w_down), f2c=nxt_r.f2c,
                            up_off=nxt_r.up_off, fine_valid=fine_r.valid)
    got = psc.strided_conv(torch.from_numpy(fine), nxt_p.down_nbr,
                           torch.from_numpy(w_down))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    coarse = _feats(rng, nxt_p.valid.shape[0], cout)
    w_up = (rng.normal(size=(8, cout, cin)) * 0.3).astype(np.float32)
    want = jsc.deconv(jnp.asarray(coarse), nxt_r.f2c, nxt_r.up_off,
                      jnp.asarray(w_up), fine_r.valid,
                      down_nbr=nxt_r.down_nbr)
    got = psc.deconv(torch.from_numpy(coarse), nxt_p.f2c, nxt_p.up_off,
                     torch.from_numpy(w_up), fine_p.valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("leakiness,act", [(0.0, True), (0.333, True),
                                           (0.0, False)])
def test_batch_norm_eval(leakiness, act):
    rng = np.random.default_rng(3)
    c = 24
    x = (rng.normal(size=(300, c)) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.normal(size=(2, c)).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.2, 3.0, c).astype(np.float32)
    want, _ = jsc.batch_norm_act(
        jnp.asarray(x), jnp.ones(300, bool), jnp.asarray(scale),
        jnp.asarray(bias), jsc.BNState(jnp.asarray(mean), jnp.asarray(var)),
        training=False, leakiness=leakiness, act=act)
    got = psc.batch_norm_act(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(mean), torch.from_numpy(var), leakiness=leakiness,
        act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pool_and_unpool(plans):
    ref, port, caps = plans
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(S * P, 5)).astype(np.float32)
    cap0 = S * caps[0]
    got = pvoxel.pool_features_sorted(
        torch.from_numpy(feats), port.point_counts, port.point_end,
        port.point_perm)
    want_sorted = jvoxel.pool_features_sorted(
        jnp.asarray(feats), ref.point_inverse, ref.point_counts,
        ref.point_end, ref.point_perm, cap0)
    want_scatter = jvoxel.pool_features(
        jnp.asarray(feats), ref.point_inverse, ref.point_counts, cap0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_sorted), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_scatter), **TOL)

    vox = rng.normal(size=(cap0, 5)).astype(np.float32)
    want = jvoxel.unpool_features(jnp.asarray(vox), ref.point_inverse)
    got = pvoxel.unpool_features(torch.from_numpy(vox), port.point_inverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
