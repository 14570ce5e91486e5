"""The JAX package's other voxel-plan and conv forms in the port, against
``mopa_tpu``.

Besides the batched wide-column plan the shipped paths build, the JAX
package has a monolithic plan (``build_unet_plan``: one flat table per level
with the batch index in the key, exact (V, 27) neighbour maps, scatter
pooling), the z-dense plan (``ZPlan``: windows read from a z-padded slot
table), their lookups (sort-merge, presorted, hash) and the two convs over
them. On seeded clouds with duplicate points, padding rows, several scans,
coordinates at both ends of [0, 4096) and capacities that overflow:

* every integer of the flat tables and of each lookup, of the padded z
  tables, of the hash index, of ``build_submanifold_plan`` by each method,
  of ``build_wide_plan``, ``build_zplan`` / ``zplan_from_nbr``, of
  ``build_unet_plan`` (with batch domains) and of ``concat_plans`` over
  those forms equals JAX's;
* ``submanifold_conv`` (with a bias) and ``submanifold_conv_zdense``,
  forward and both gradients, within 1e-5 of ``jax.vjp``; scatter pooling
  within 1e-6;
* ``SparseUNet`` over monolithic (``nbr``) and z-dense levels, in eval and
  in per-domain training mode, against JAX's at the bar of
  ``test_parity_golden.py`` (logits within 5e-3, argmax >= 0.995);
* ``trainer.build_plan_from_batch(sample_size=None)`` equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.ops import sparse_conv as jsc
from mopa_tpu.ops import voxel as jvox
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.ops import sparse_conv as psc
from mopa_tpu_torch.ops import voxel as pvox
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_models import nest, perturbed_stats

torch.set_num_threads(1)

LEVELS = 3
# (low, extent, points, batches): a dense cube, a thin slab at z = 0, a
# cloud at the top of the coordinate range
CLOUDS = {"dense": (0, 10, 700, 3), "z0": (0, 24, 500, 2),
          "top": (4086, 10, 400, 2)}


def cloud(name, seed=0):
    """(coords (N, 3), batch (N,), valid (N,)) numpy int64 / bool: points
    with repeats, 15 % padding rows, the slab's z pinned to 0..1."""
    lo, extent, n, batches = CLOUDS[name]
    rng = np.random.default_rng(seed)
    coords = lo + rng.integers(0, extent, size=(n, 3))
    if name == "z0":
        coords[:, 2] = rng.integers(0, 2, n)
    coords[n // 2:n // 2 + 40] = coords[:40]        # duplicate voxels
    batch = rng.integers(0, batches, n)
    valid = rng.random(n) > 0.15
    return coords.astype(np.int64), batch.astype(np.int64), valid


def _eq(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def tables(name, capacity=None):
    """(JAX table, inverse, counts), (port ones) of a flat table."""
    coords, batch, valid = cloud(name)
    cap = capacity or coords.shape[0]
    j = jax.jit(lambda c, b, v: jvox.voxelize(c, b, v, cap))(
        jnp.asarray(coords, jnp.int32), jnp.asarray(batch, jnp.int32),
        jnp.asarray(valid))
    t, inv, cnt, _ = pvox.voxelize(torch.from_numpy(coords)[None],
                                   torch.from_numpy(valid)[None], cap,
                                   batch=torch.from_numpy(batch)[None])
    return j, (t, inv[0], cnt[0])


@pytest.mark.parametrize("name", list(CLOUDS))
@pytest.mark.parametrize("overflow", [False, True], ids=["room", "overflow"])
def test_flat_table_and_lookups(name, overflow):
    n_vox = None
    if overflow:
        coords, batch, valid = cloud(name)
        keys = {tuple(r) for r in np.c_[batch, coords][valid]}
        n_vox = len(keys) - 25
    (jt, jinv, jcnt), (pt, pinv, pcnt) = tables(name, n_vox)
    _eq(pinv, jinv, "inverse")
    _eq(pcnt, jcnt, "counts")
    _eq(pt.coords[0], jt.coords, "coords")
    _eq(pt.batch[0], jt.batch, "batch")
    _eq(pt.key_hi[0], jt.key_hi, "key_hi")
    _eq(pt.key_lo[0], jt.key_lo, "key_lo")
    _eq(pt.num[0], jt.num, "num")

    # queries: the table's own voxels shifted by +1 in z (hits and misses),
    # some out of range, some invalid
    jvalid = np.asarray(jt.valid_mask())
    qc = np.asarray(jt.coords) + np.asarray([0, 0, 1])
    qc[::7] += 4096
    qb = np.array(jt.batch)
    qv = jvalid.copy()
    qv[::5] = False
    want = jax.jit(lambda t: (
        jvox.lookup(t, jnp.asarray(qc), jnp.asarray(qb), jnp.asarray(qv)),
        jvox.merge_lookup_presorted(t, t.key_hi, t.key_lo + 1,
                                    t.valid_mask()),
        jvox.rank_lookup(t, *jvox.pack_keys(jnp.asarray(qc) % 4096,
                                            jnp.asarray(qb),
                                            jnp.asarray(qv)),
                         jnp.asarray(qv))))(jt)
    qct, qbt, qvt = map(torch.from_numpy, (qc, qb, qv))
    _eq(pvox.lookup(pt, qct, qbt, qvt), want[0], "lookup")
    pv = pt.valid_mask()[0]
    _eq(pvox.merge_lookup_presorted(pt, pt.key_hi[0], pt.key_lo[0] + 1, pv),
        want[1], "merge_lookup_presorted")
    hi, lo = pvox.pack_keys_hilo(qct % 4096, qbt, qvt)
    _eq(pvox.rank_lookup(pt, hi, lo, qvt), want[2], "rank_lookup")
    # the coarser level
    jc, jf2c = jax.jit(lambda t: jvox.downsample_coords(t, 180))(jt)
    pc, pf2c = pvox.downsample_coords(pt, 180)
    _eq(pf2c[0], jf2c, "f2c")
    _eq(pc.key_hi[0], jc.key_hi, "coarse key_hi")
    _eq(pc.key_lo[0], jc.key_lo, "coarse key_lo")


@pytest.mark.parametrize("name", list(CLOUDS))
def test_padded_ztables(name):
    (jt, _, _), (pt, _, _) = tables(name)
    v = pt.capacity
    for vp in (5 * v, v):  # overflow-free, then overflowing
        want = jax.jit(lambda t: (jvox.build_padded_ztable(t, vp),
                                  jvox.build_padded_ztable_keys(t, vp)))(jt)
        got = pvox.build_padded_ztable(pt, vp)
        for f in ("p2a", "a2p", "num"):
            _eq(getattr(got, f), getattr(want[0], f), "{} {}".format(vp, f))
        got = pvox.build_padded_ztable_keys(pt, vp)
        for f in ("p2a", "num", "key_hi", "key_lo"):
            _eq(getattr(got, f), getattr(want[1], f), "{} {}".format(vp, f))


def test_hash_index():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 2 ** 31 - 1, 4000)
    lo = rng.integers(0, 2 ** 31 - 1, 4000)
    want = jvox._hash32(jnp.asarray(hi, jnp.int32), jnp.asarray(lo, jnp.int32))
    _eq(pvox._hash32(torch.from_numpy(hi), torch.from_numpy(lo)), want,
        "_hash32")
    for name in CLOUDS:
        (jt, _, _), (pt, _, _) = tables(name)
        jht = jax.jit(jvox.build_hash)(jt)
        pht = pvox.build_hash(pt)
        for f in ("slot_hi", "slot_lo", "slot_src", "n_unplaced"):
            _eq(getattr(pht, f), getattr(jht, f), "{} {}".format(name, f))
        q_hi, q_lo = pt.key_hi[0], pt.key_lo[0] + 1
        _eq(pvox.hash_lookup(pt, pht, q_hi, q_lo, pt.valid_mask()[0]),
            pvox.merge_lookup(pt, q_hi, q_lo, pt.valid_mask()[0]), name)


@pytest.mark.parametrize("method", ["merge", "presorted", "hash"])
def test_submanifold_plan_methods(method):
    for name in CLOUDS:
        (jt, _, _), (pt, _, _) = tables(name)
        if method == "hash":
            want = jax.jit(lambda t: jsc.build_submanifold_plan(
                t, ht=jvox.build_hash(t)))(jt)
            got = psc.build_submanifold_plan(pt, ht=pvox.build_hash(pt))
        else:
            want = jax.jit(lambda t: jsc.build_submanifold_plan(
                t, method=method))(jt)
            got = psc.build_submanifold_plan(pt, method=method)
        _eq(got[0], want, "{} {}".format(method, name))


@pytest.mark.parametrize("name", list(CLOUDS))
def test_wide_and_z_plans(name):
    (jt, _, _), (pt, _, _) = tables(name)
    v = pt.capacity
    want = jax.jit(lambda t: (
        jsc.build_wide_plan(t), jsc.build_zplan(t),
        jsc.build_zplan(t, 2 * v),
        jsc.zplan_from_nbr(jsc.build_submanifold_plan(t),
                           jvox.build_padded_ztable(t, 5 * v))))(jt)
    wide = psc.build_wide_plan(pt)
    _eq(wide.ranks, want[0].ranks, "wide ranks")
    _eq(wide.sel, want[0].sel, "wide sel")
    for got, ref, tag in (
            (psc.build_zplan(pt), want[1], "zplan"),
            (psc.build_zplan(pt, 2 * v), want[2], "zplan 2V"),
            (psc.zplan_from_nbr(psc.build_submanifold_plan(pt)[0],
                                pvox.build_padded_ztable(pt, 5 * v)),
             want[3], "zplan_from_nbr")):
        _eq(got.ranks, ref.ranks, tag + " ranks")
        _eq(got.p2a, ref.p2a, tag + " p2a")


LEVEL_KEYS = ("nbr", "valid", "down_nbr", "f2c", "up_off", "dom", "ranks",
              "sel", "p2a")


def _plans_equal(got, want):
    assert len(got.levels) == len(want.levels)
    for l, (g, w) in enumerate(zip(got.levels, want.levels)):
        for key in LEVEL_KEYS:
            r, t = getattr(w, key), getattr(g, key)
            if r is None:
                assert t is None, (l, key)
            else:
                _eq(t, r, "level {} {}".format(l, key))
    for key in ("point_inverse", "point_counts", "num_voxels", "point_end",
                "point_perm"):
        r, t = getattr(want, key), getattr(got, key)
        if r is None:
            assert t is None, key
        else:
            _eq(t, r, key)


def unet_plans(name, caps=None, domains=None):
    coords, batch, valid = cloud(name)
    want = jax.jit(lambda c, b, v: jax_unet.build_unet_plan(
        c, b, v, LEVELS, capacities=caps, batch_domains=domains))(
        jnp.asarray(coords, jnp.int32), jnp.asarray(batch, jnp.int32),
        jnp.asarray(valid))
    got = port_unet.build_unet_plan(
        torch.from_numpy(coords), torch.from_numpy(batch),
        torch.from_numpy(valid), LEVELS, capacities=caps,
        batch_domains=domains)
    return want, got


@pytest.mark.parametrize("name", list(CLOUDS))
@pytest.mark.parametrize("caps", [None, (300, 150, 40)],
                         ids=["schedule", "overflow"])
def test_build_unet_plan(name, caps):
    want, got = unet_plans(name, caps, np.asarray([1, 0, 1], np.int32))
    _plans_equal(got, want)


def zdense_levels(plan, name):
    """A plan's levels with z-dense plans, built from the level tables as
    the JAX package's tests build them (``build_zplan`` at level 0,
    ``zplan_from_nbr`` over a 5 V padded table above): (JAX plan, port
    plan)."""
    coords, batch, valid = cloud(name)
    caps = [lv.valid.shape[0] for lv in plan[1].levels]

    def jax_levels(c, b, v):
        t, _, _ = jvox.voxelize(c, b, v, caps[0])
        out = []
        for l in range(LEVELS):
            if l == 0:
                z = jsc.build_zplan(t)
            else:
                z = jsc.zplan_from_nbr(jsc.build_submanifold_plan(t),
                                       jvox.build_padded_ztable(
                                           t, 5 * caps[l]))
            out.append(z)
            if l + 1 < LEVELS:
                t, _ = jvox.downsample_coords(t, caps[l + 1])
        return out

    jz = jax.jit(jax_levels)(jnp.asarray(coords, jnp.int32),
                             jnp.asarray(batch, jnp.int32),
                             jnp.asarray(valid))
    t, _, _, _ = pvox.voxelize(torch.from_numpy(coords)[None],
                               torch.from_numpy(valid)[None], caps[0],
                               batch=torch.from_numpy(batch)[None])
    pz = []
    for l in range(LEVELS):
        if l == 0:
            pz.append(psc.build_zplan(t))
        else:
            pz.append(psc.zplan_from_nbr(
                psc.build_submanifold_plan(t)[0],
                pvox.build_padded_ztable(t, 5 * caps[l])))
        if l + 1 < LEVELS:
            t, _ = pvox.downsample_coords(t, caps[l + 1])
    jplan = plan[0]._replace(levels=tuple(
        lv._replace(nbr=None, ranks=z.ranks, p2a=z.p2a)
        for lv, z in zip(plan[0].levels, jz)))
    pplan = plan[1]._replace(levels=tuple(
        lv._replace(nbr=None, ranks=z.ranks, p2a=z.p2a)
        for lv, z in zip(plan[1].levels, pz)))
    return jplan, pplan


def test_concat_plans_of_other_forms():
    a = unet_plans("dense", domains=np.asarray([0, 1, 0], np.int32))
    b = unet_plans("z0", domains=np.asarray([2, 2], np.int32))
    _plans_equal(port_unet.concat_plans([a[1], b[1]]),
                 jax_unet.concat_plans([a[0], b[0]]))
    za, zb = zdense_levels(a, "dense"), zdense_levels(b, "z0")
    _plans_equal(port_unet.concat_plans([za[1], zb[1]]),
                 jax_unet.concat_plans([za[0], zb[0]]))


def _conv_case(form, cin=5, cout=7):
    (jt, _, _), (pt, _, _) = tables("dense")
    v = pt.capacity
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(v, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    g = rng.normal(size=(v, cout)).astype(np.float32)
    if form == "nbr":
        jplan = jax.jit(jsc.build_submanifold_plan)(jt)
        pplan = psc.build_submanifold_plan(pt)[0]

        def jfn(f, ww, bb):
            return jsc.submanifold_conv(f, jplan, ww, bb)

        def pfn(f, ww, bb):
            return psc.submanifold_conv(f, pplan, ww, bb)
    else:
        jplan = jax.jit(jsc.build_zplan)(jt)
        pplan = psc.build_zplan(pt)

        def jfn(f, ww, bb):
            return jsc.submanifold_conv_zdense(f, jplan, ww) + bb

        def pfn(f, ww, bb):
            return psc.submanifold_conv_zdense(f, pplan, ww) + bb
    return feats, w, bias, g, jfn, pfn


@pytest.mark.parametrize("form", ["nbr", "zdense"])
def test_conv_forms_and_gradients(form):
    feats, w, bias, g, jfn, pfn = _conv_case(form)
    out, vjp = jax.vjp(jfn, jnp.asarray(feats), jnp.asarray(w),
                       jnp.asarray(bias))
    grads = vjp(jnp.asarray(g))
    tf, tw, tb = (torch.tensor(x, requires_grad=True)
                  for x in (feats, w, bias))
    got = pfn(tf, tw, tb)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    for t, want, tag in ((tf, grads[0], "d_feats"), (tw, grads[1], "d_w"),
                         (tb, grads[2], "d_bias")):
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5 * max(scale, 1.0),
                                   err_msg=tag)


def test_scatter_pooling():
    coords, batch, valid = cloud("dense")
    (jt, jinv, jcnt), (pt, pinv, pcnt) = tables("dense", 400)
    feats = np.random.default_rng(4).normal(
        size=(coords.shape[0], 3)).astype(np.float32)
    for mode in ("mean", "sum"):
        want = jvox.pool_features(jnp.asarray(feats), jinv, jcnt, 400, mode)
        got = pvox.pool_features(torch.from_numpy(feats), pinv, pcnt, 400,
                                 mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6, err_msg=mode)


@pytest.mark.parametrize("form", ["nbr", "zdense"])
def test_sparse_unet_over_forms(form):
    """The 3D UNet (m=4, 3 levels) over monolithic or z-dense levels: eval
    with perturbed running statistics, then a training forward with
    per-domain batch norm (3 domains) and its updated statistics."""
    domains = np.asarray([0, 1, 2], np.int32)
    plans = unet_plans("dense", domains=domains)
    if form == "zdense":
        plans = zdense_levels(plans, "dense")
    jplan, pplan = plans
    n = jplan.point_inverse.shape[0]
    feats = np.random.default_rng(6).normal(size=(n, 1)).astype(np.float32)
    model = jax_unet.SparseUNet(in_channels=1, m=4, num_planes=LEVELS)
    variables = jax.jit(lambda f: model.init(jax.random.PRNGKey(1), f,
                                             jplan))(jnp.asarray(feats))
    stats = perturbed_stats(variables["batch_stats"], 3)
    jvars = {"params": variables["params"], "batch_stats": nest(stats)}
    want = jax.jit(lambda f: model.apply(jvars, f, jplan))(jnp.asarray(feats))
    want_t, jmut = jax.jit(lambda f: model.apply(
        jvars, f, jplan, train=True, n_domains=3,
        mutable=["batch_stats"]))(jnp.asarray(feats))
    port = port_unet.SparseUNet(in_channels=1, m=4, num_planes=LEVELS)
    weights.load_flax_state(port, flatten_pytree(variables["params"]), stats)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(feats), pplan)
        got_t = port.train()(torch.from_numpy(feats), pplan, n_domains=3)
    valid = np.asarray(jplan.point_inverse) >= 0
    for g, w in ((got, want), (got_t, want_t)):
        g, w = g.numpy()[valid], np.asarray(w)[valid]
        assert float(np.abs(g - w).max()) < 5e-3
        assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.995
    new_stats = weights.to_flax(port, dict(port.named_buffers()))
    for k, v in flatten_pytree(jmut["batch_stats"]).items():
        np.testing.assert_allclose(new_stats[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_build_plan_from_batch_monolithic():
    from mopa_tpu.config.xmuda import cfg as jax_base_cfg
    from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg

    coords, batch, valid = cloud("dense")
    cfgs = []
    for base in (jax_base_cfg, port_base_cfg):
        c = base.clone()
        c.MODEL_3D.TYPE = "SCN"
        c.MODEL_3D.SCN.num_planes = LEVELS
        cfgs.append(c)
    want = jax.jit(lambda c, b, v: jax_trainer.build_plan_from_batch(
        cfgs[0], c, b, v, batch_domains=np.asarray([0, 1, 1], np.int32)))(
        jnp.asarray(coords, jnp.int32), jnp.asarray(batch, jnp.int32),
        jnp.asarray(valid))
    got = port_trainer.build_plan_from_batch(
        cfgs[1], torch.from_numpy(coords), torch.from_numpy(valid), None,
        sample_domains=[0, 1, 1], batch_idx=torch.from_numpy(batch))
    _plans_equal(got, want)
    with pytest.raises(ValueError, match="batch_idx"):
        port_trainer.build_plan_from_batch(
            cfgs[1], torch.from_numpy(coords), torch.from_numpy(valid), None)
