"""Device VGI (``mopa_tpu_torch.ops.mixmatch``) against ``mopa_tpu``'s, on
the same numpy scans and the same random draws.

``jax.random`` and ``torch.Generator`` never give the same numbers, so the
port's arithmetic is fed the draws that JAX's keys give, derived as
``vgi_insert_batch`` derives them: ``split(rng, B + 1)``; per scan
``split`` into ``gkey, zkey``, then ``gumbel`` / ``uniform``; the last key
split into the augmentation's ``k_rot, k_noise, k_flip, k_transl``.

Integer and mask outputs (``coords``, ``valid``, ``label``, ``obj_mask``,
``inserted``, the candidate cells, the anchor) must be equal; float outputs
agree to 1e-5. Scenes: flat ground with three objects of distinct sizes (no
overlap), a corridor of walls, a window filled with points (no free cell,
nothing inserted) and a scan whose third object is empty padding; each case
runs the batch at once: ground and ``fv`` insert modes, ``use_proj`` and
``transl`` on and off, the online ground fit (no ``g_mask``), with and
without the scans' pseudo labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.ops import mixmatch as jax_mixmatch
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.ops import mixmatch

torch.set_num_threads(1)

B, P, K, O = 4, 2400, 3, 64
SEARCH = (10.0, 10.0)
GRID = (40, 40)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _proj():
    proj = np.array([[300, 0, 240, 0], [0, 300, 150, 0], [0, 0, 1, 0]],
                    np.float32)
    basis = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                      [0, 0, 0, 1]], np.float32)
    return proj @ basis


def _ground(rng, n):
    gx = rng.uniform(1.0, 19.0, n)
    return np.stack([gx, rng.uniform(-9.0, 9.0, n),
                     rng.normal(-1.7, 0.01, n)], 1)


def _scenes(seed=0):
    """B scans of P points (x forward, meters) with their ground masks, and
    K objects each (a third of them empty in scan 3)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, P, 4), np.float32)
    valid = np.ones((B, P), bool)
    g_mask = np.zeros((B, P), bool)
    # 0: flat ground, a few boxes
    n_g = 2000
    boxes = [np.stack([c + rng.uniform(-0.6, 0.6, 100),
                       d + rng.uniform(-0.6, 0.6, 100),
                       rng.uniform(-1.7, 0.0, 100)], 1)
             for c, d in ((8.0, 3.0), (14.0, -5.0), (5.0, -2.0), (16.0, 6.0))]
    pts[0, :, :3] = np.concatenate([_ground(rng, n_g)] + boxes)
    g_mask[0, :n_g] = True
    # 1: a corridor between two walls
    walls = [np.stack([rng.uniform(1.0, 19.0, 200),
                       wy + rng.uniform(-0.3, 0.3, 200),
                       rng.uniform(-1.7, 1.0, 200)], 1) for wy in (-3.0, 3.0)]
    pts[1, :, :3] = np.concatenate([_ground(rng, n_g)] + walls)
    g_mask[1, :n_g] = True
    valid[1, -30:] = False
    # 2: every 0.5 m cell of the window holds a point 0.5-1 m above its
    # floor, inside the z range of every object's box
    xs = np.arange(0.25, 20.0, 0.5)
    ys = np.arange(-9.75, 10.0, 0.5)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    fill = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, -1.25)], 1)
    pts[2, :, :3] = np.concatenate([fill, fill])[:P]
    g_mask[2] = True
    # 3: flat ground, padding at the end
    pts[3, :, :3] = _ground(rng, P)
    g_mask[3] = True
    valid[3, -400:] = False
    pts[..., 3] = rng.uniform(0, 1, (B, P))

    objs = np.zeros((B, K, O, 4), np.float32)
    ovalid = np.ones((B, K, O), bool)
    for i in range(B):
        for k in range(K):
            size = 0.3 + 0.35 * k
            objs[i, k, :, 0] = 4.0 + rng.uniform(0, size, O)
            objs[i, k, :, 1] = rng.uniform(-size, size, O)
            objs[i, k, :, 2] = rng.uniform(-1.7, -0.8, O)
    objs[..., 3] = 1.0
    ovalid[3, 2] = False
    ovalid[0, 1, 40:] = False
    label = rng.integers(-1, 6, (B, P))
    return {"ori_points": pts, "ori_points_valid": valid, "g_mask": g_mask,
            "ori_pseudo_label_3d": np.where(label < 0, -100, label),
            "obj_pc": objs, "obj_valid": ovalid,
            "obj_label": np.tile(np.asarray([[2, 3, 4]], np.int32), (B, 1)),
            "proj_matrix": np.tile(_proj()[:3], (B, 1, 1)),
            "img_size": np.tile(np.asarray([480, 302], np.int32), (B, 1))}


def jax_draws(key, b, k, grid):
    """The draws ``mopa_tpu.ops.mixmatch.vgi_insert_batch`` makes from
    ``key``, as numpy arrays under :func:`mixmatch.vgi_draws`' names."""
    keys = jax.random.split(key, b + 1)
    gumbel, zjit = [], []
    for i in range(b):
        gkey, zkey = jax.random.split(keys[i])
        gumbel.append(jax.random.gumbel(gkey, (k,) + tuple(grid)))
        zjit.append(jax.random.uniform(zkey, (k,)))
    k_rot, k_noise, k_flip, k_transl = jax.random.split(keys[b], 4)
    return {"gumbel": np.stack(gumbel), "zjit": np.stack(zjit),
            "noise": np.asarray(jax.random.normal(k_noise, (3, 3))),
            "flip": np.asarray(jax.random.randint(k_flip, (2,), 0, 2)),
            "rot": np.asarray(jax.random.uniform(k_rot)),
            "transl": np.asarray(jax.random.uniform(k_transl, (b, 1, 3)))}


def _cfgs(**kw):
    out = []
    for base in (jax_base_cfg, port_base_cfg):
        c = base.clone()
        c.DATASET_TARGET.TYPE = "SemanticKITTISCN"
        aug = c.DATASET_TARGET.SemanticKITTISCN.augmentation
        aug.noisy_rot, aug.flip_y, aug.rot_z = 0.1, 0.5, 6.2831
        aug.transl = kw.get("transl", True)
        c.TRAIN.PC_MM.search_range = list(SEARCH)
        c.TRAIN.PC_MM.use_proj = kw.get("use_proj", True)
        c.TRAIN.PC_MM.insert_mode = kw.get("insert_mode", "ground")
        out.append(c)
    return out


CASES = {
    "ground": {},
    "no_proj_no_transl": {"use_proj": False, "transl": False},
    "online_ground": {"drop_g_mask": True},
    "fv": {"insert_mode": "fv"},
    "no_scan_labels": {"scan_labels": False},
}


@pytest.fixture(scope="module")
def batch_runs():
    data = _scenes()
    out = {}
    for name, kw in CASES.items():
        jcfg, pcfg = _cfgs(**kw)
        batch = {k: v for k, v in data.items()
                 if not (kw.get("drop_g_mask") and k == "g_mask")}
        key = jax.random.PRNGKey(7)
        scan_labels = kw.get("scan_labels", True)
        pl_3d = jnp.zeros((B * P,), jnp.int32) if scan_labels else None
        want = jax.jit(lambda bt, kk, c=jcfg, pl=pl_3d: jax_mixmatch
                       .vgi_insert_batch(c, bt, pl, kk))(
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        draws = {k: torch.from_numpy(np.array(v))
                 for k, v in jax_draws(key, B, K, GRID).items()}
        got = mixmatch.vgi_insert_batch(
            pcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
            scan_labels, draws)
        out[name] = ({k: np.asarray(v) for k, v in want.items()},
                     {k: v.numpy() for k, v in got.items()})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_vgi_insert_batch_matches_jax(batch_runs, case):
    want, got = batch_runs[case]
    assert set(got) == set(want)
    for k in ("coords", "batch_idx", "valid", "label", "obj_mask",
              "inserted"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["feats"], want["feats"])
    ins = got["inserted"]
    if case == "fv":
        assert ins.sum() == B * K - 1
    else:
        # the full window takes no object; the other scans take some, and
        # the empty padding object never counts
        assert not ins[2].any() and ins[[0, 1, 3]].any(1).all()
        assert not ins[3, 2]
    assert got["valid"].reshape(B, -1)[2].sum() == 0 or case == "fv"


def test_vgi_insert_batch_uses_the_scan_labels(batch_runs):
    on, off = batch_runs["ground"][1], batch_runs["no_scan_labels"][1]
    scan = np.zeros((B, P + K * O), bool)
    scan[:, :P] = True
    scan = scan.reshape(-1) & on["valid"]
    assert (on["label"][scan] >= 0).any()
    assert (off["label"][scan] == -100).all()


def _sample_inputs():
    d = _scenes(1)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, B, K, GRID)
    return d, key, draws


@pytest.mark.parametrize("mode", ["ground", "fv"])
def test_vgi_insert_sample_matches_jax(mode):
    d, key, draws = _sample_inputs()
    kw = dict(voxel_size=0.5, search_range=SEARCH, z_min=-2.0,
              front_axis_x=True, insert_mode=mode)
    keys = jax.random.split(key, B + 1)[:B]
    want = jax.jit(jax.vmap(lambda p, v, g, o, ov, pm, isz, k:
                            jax_mixmatch.vgi_insert_sample(
                                p, v, jnp.zeros(P, jnp.int32), g, o, ov,
                                jnp.zeros(K, jnp.int32), pm, isz, k,
                                debug=mode == "ground", **kw)))(
        *(jnp.asarray(d[k]) for k in ("ori_points", "ori_points_valid",
                                      "g_mask", "obj_pc", "obj_valid",
                                      "proj_matrix", "img_size")), keys)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    got = mixmatch.vgi_insert_sample(
        t["ori_points"], t["ori_points_valid"], t["g_mask"], t["obj_pc"],
        t["obj_valid"], t["proj_matrix"], t["img_size"],
        torch.from_numpy(draws["gumbel"]), torch.from_numpy(draws["zjit"]),
        debug=mode == "ground", **kw)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["inserted"].numpy(),
                                  np.asarray(want["inserted"]))
    if mode == "ground":
        np.testing.assert_array_equal(got["anchor"].numpy(),
                                      np.asarray(want["anchor"]))
        # the candidate cells of every non-empty object
        nonempty = d["obj_valid"].any(-1)
        np.testing.assert_array_equal(
            got["valid_cells"].numpy()[nonempty],
            np.asarray(want["valid_cells"])[nonempty])
        for k in ("qx", "qy", "road_z"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **FLOAT_TOL)
        assert got["inserted"].sum() >= 4
    ins = got["inserted"].numpy()
    np.testing.assert_allclose(got["new_obj"].numpy()[ins],
                               np.asarray(want["new_obj"])[ins],
                               **FLOAT_TOL)


def test_sat_box_sums_match_jax():
    rng = np.random.default_rng(5)
    occ = (rng.random((2, 6, 5, 4)) < 0.3).astype(np.int32)
    s = rng.integers(0, 4, (2, 7, 3))
    ext = rng.integers(1, 3, (2, 7, 3))
    want = np.stack([np.asarray(jax_mixmatch._box_sum(
        jax_mixmatch._sat3(jnp.asarray(occ[i])), jnp.asarray(s[i]),
        jnp.asarray(ext[i]))) for i in range(2)])
    got = mixmatch._box_sum(mixmatch._sat3(torch.from_numpy(occ)),
                            torch.from_numpy(s), torch.from_numpy(ext))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        mixmatch._sat3(torch.from_numpy(occ)).numpy()[0],
        np.asarray(jax_mixmatch._sat3(jnp.asarray(occ[0]))))


def test_draws_have_the_shapes_the_arithmetic_reads():
    gen = torch.Generator().manual_seed(0)
    d = mixmatch.vgi_draws(B, K, GRID, gen, "cpu")
    ref = jax_draws(jax.random.PRNGKey(0), B, K, GRID)
    assert {k: tuple(v.shape) for k, v in d.items()} == \
        {k: np.shape(v) for k, v in ref.items()}
    assert set(d["flip"].tolist()) <= {0, 1}
    assert (d["zjit"] >= 0).all() and (d["zjit"] < 1).all()


def test_noisy_rotation_coords_agree_to_a_voxel():
    """XLA's CPU dot and torch's matmul round the noisy rotation's (P, 3) x
    (3, 3) product differently in the last bit, so a point on a rounding
    boundary can land one voxel over: on the VGI step test's scene over
    several keys, every other output is equal and at most 1 % of the points
    move, by one voxel."""
    from test_torch_vgi_step import _vgi_inputs

    data = _vgi_inputs(2)
    b, k_objs = data["obj_valid"].shape[:2]
    jcfg, pcfg = _cfgs()
    for c in (jcfg, pcfg):
        c.TRAIN.PC_MM.search_range = [25.0, 25.0]
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    moved = total = 0
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jax.jit(lambda bt, kk: jax_mixmatch.vgi_insert_batch(
            jcfg, bt, jnp.zeros(1), kk))(jbatch, key)
        draws = {k: torch.from_numpy(np.array(v))
                 for k, v in jax_draws(key, b, k_objs, (100, 100)).items()}
        got = mixmatch.vgi_insert_batch(
            pcfg, {k: torch.from_numpy(np.array(v))
                   for k, v in data.items()}, True, draws)
        for k in ("valid", "label", "obj_mask", "inserted"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        diff = np.abs(got["coords"].numpy() - np.asarray(want["coords"]))
        valid = np.asarray(want["valid"])
        assert diff[valid].max() <= 1
        moved += int((diff[valid] > 0).any(1).sum())
        total += int(valid.sum())
    assert moved <= 0.01 * total, (moved, total)
