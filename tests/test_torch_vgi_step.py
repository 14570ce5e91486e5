"""The shipped MoPA step, VGI on with host-built plans, against
``mopa_tpu``'s: the pre-EMA step and the EMA step at ``ema_xm_prob`` 0 and 1.

Fixtures and tolerances are ``test_torch_train_step.py``'s (flax init with
batch-norm biases at 2 through the weight bridge, dropout off, SGD at lr
1000, ``LOSS_TOL``, parameter changes to 1e-4 of their tensor's largest),
with ``lambda_pc_mm`` 0.1, ``ema_start_iter`` 0 (one student program serves
both phases, as in the reference) and EMA alpha 0.99. Every scan group ships
its host-built plan (``hp_*`` for [source; target], ``hp_ori_*`` for the
teacher's view); the target batch carries host VGI's cat domain, computed
by the port's ``collate._host_vgi_batch`` on a small ground + wall scene
with one object per scan, and its ``hp_cat_*`` plan. The cat points are
key-sorted on the host before that plan is built, so that JAX's decode
(which assumes sorted points: ROADMAP Queue 3) pools them right too.

* Losses and metrics (``pc_mm_loss``, ``pc_mm_acc``, ``vgi_inserted`` among
  them) to ``LOSS_TOL``, confusion matrices exact, the batch-norm running
  statistics (three domains in the 3D net) to ``LOSS_TOL``, each
  parameter's change to 1e-4 of its largest, the EMA parameters 0.99 old +
  0.01 new.
* The port's step on host-built plans equals its step on device-built
  plans: the same batches without ``hp_*`` / ``hp_ori_*``.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.data import collate
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.models.scn_unet import capacity_schedule
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_ema_step import _ema_batch
from test_torch_train_step import (B, LOSS_TOL, P, _batch, _cfg,
                                   _identity_dropout, _lift_bn_biases,
                                   _np_tree)

torch.set_num_threads(1)

ALPHA = 0.99
K_OBJ, O_OBJ = 1, 64
N_CAT = P + K_OBJ * O_OBJ
RUNS = ["pre_ema", "ema_xm0", "ema_xm1"]


def _step_cfg(base, xm_prob=0.7):
    return _cfg(base, **{"TRAIN.PC_MM.lambda_pc_mm": 0.1,
                         "TRAIN.PC_MM.ema_start_iter": 0,
                         "TRAIN.PC_MM.ema_alpha_teacher": ALPHA,
                         "TRAIN.PC_MM.ema_xm_prob": xm_prob})


def _lexkey(c):
    c = np.asarray(c, np.int64)
    return (c[..., 0] * 4096 + c[..., 1]) * 4096 + c[..., 2]


def _vgi_inputs(seed):
    """B scans of P points (meters): ground ahead of the car, a wall, and
    one object of O_OBJ points to insert; a camera looking down +x."""
    rng = np.random.default_rng(seed)
    n_ground = 2 * P // 3
    pts = np.zeros((B, P, 4), np.float32)
    for i in range(B):
        ground = np.stack([rng.uniform(3.0, 14.0, n_ground),
                           rng.uniform(-4.0, 4.0, n_ground),
                           rng.normal(-1.7, 0.01, n_ground)], 1)
        wall = np.stack([rng.uniform(12.0, 12.5, P - n_ground),
                         rng.uniform(-2.0, 2.0, P - n_ground),
                         rng.uniform(-1.7, 1.0, P - n_ground)], 1)
        pts[i, :, :3] = np.concatenate([ground, wall])
        pts[i, :, 3] = 1.0
    valid = np.ones((B, P), bool)
    valid[1, -20:] = False
    objs = np.zeros((B, K_OBJ, O_OBJ, 4), np.float32)
    objs[..., :3] = np.asarray([5.0, 0.5, -1.4]) + rng.uniform(
        -0.3, 0.3, (B, K_OBJ, O_OBJ, 3))
    objs[..., 3] = 1.0
    proj = np.asarray([[32.0, -60.0, 0.0, 0.0], [24.0, 0.0, -60.0, 0.0],
                       [1.0, 0.0, 0.0, 0.0]], np.float32)
    label = rng.integers(-1, 5, (B, P))
    return {"ori_points": pts, "ori_points_valid": valid,
            "g_mask": np.arange(P)[None].repeat(B, 0) < n_ground,
            "ori_pseudo_label_3d": np.where(label < 0, -100, label),
            "obj_pc": objs, "obj_valid": np.ones((B, K_OBJ, O_OBJ), bool),
            "obj_label": np.full((B, K_OBJ), 3, np.int32),
            "proj_matrix": np.stack([proj] * B),
            "img_size": np.tile(np.asarray([64, 48], np.int32), (B, 1))}


def _with_host_plans(batch, caps, ema=False):
    out = dict(batch)
    for pre in ("", "ori_") if ema else ("",):
        out[pre + "point_valid"] = (np.arange(P)[None, :]
                                    < out[pre + "num_points"][:, None])
        collate._host_plan_batch(out, B, P, caps, "hp_" + pre,
                                 pre + "coords", pre + "point_valid")
    return out


def _target(seed, caps, ema):
    """A target batch with host VGI's cat domain (cat points key-sorted,
    then their plan) and host-built plans. Its pseudo labels are int16, the
    wire dtype the EMA teacher's labels also have, so that JAX compiles one
    student step for both phases."""
    out = _ema_batch(seed) if ema else _batch(seed, True)
    for k in ("pseudo_label_2d", "pseudo_label_3d"):
        out[k] = out[k].astype(np.int16)
    out.update(_vgi_inputs(seed))
    settings = {"rng": np.random.default_rng(seed), "pc_mm": _step_cfg(
        port_base_cfg).TRAIN.PC_MM, "aug": {"noisy_rot": 0.1, "flip_y": 0.5,
                                           "transl": True},
                "scale": 20.0, "full_scale": 4096, "front_axis_x": True,
                "num_levels": len(caps), "factors": None}
    collate._host_vgi_batch(out, out["ori_points"], B, P, O_OBJ, settings)
    assert out["vgi_inserted"].all()
    coords = out["_cat_coords"].reshape(B, N_CAT, 3)
    for i in range(B):
        key = np.where(out["cat_valid"][i], _lexkey(coords[i]),
                       np.iinfo(np.int64).max)
        perm = np.argsort(key, kind="stable")
        coords[i] = coords[i][perm]
        for k in ("cat_valid", "cat_label", "cat_obj_mask"):
            out[k][i] = out[k][i][perm]
    out["_cat_coords"] = coords.reshape(-1, 3)
    collate._host_plan_batch(out, B, N_CAT, out["_hp_cat_caps"], "hp_cat_",
                             "_cat_coords", "cat_valid")
    return _with_host_plans(out, caps, ema)


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if not k.startswith("_")}


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's step on the same batches, per run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _identity_dropout)
    try:
        jcfg = _step_cfg(jax_base_cfg, 0.0)
        jmodels, _ = jax_trainer.build_models(jcfg)
        jstate0 = jax.jit(lambda b: jax_trainer.create_train_state(
            jcfg, jmodels, b, seed=3))(_jax_batch(_batch(0, False)))
        jstate0 = jstate0._replace(
            params_2d=_lift_bn_biases(jstate0.params_2d),
            params_3d=_lift_bn_biases(jstate0.params_3d))
        jstate0 = jstate0._replace(
            ema_params_2d=jax.tree_util.tree_map(jnp.copy,
                                                 jstate0.params_2d),
            ema_params_3d=jax.tree_util.tree_map(jnp.copy,
                                                 jstate0.params_3d))
        flax_vars = tuple(flatten_pytree(t) for t in (
            jstate0.params_2d, jstate0.batch_stats_2d, jstate0.params_3d,
            jstate0.batch_stats_3d))
        before = {"2d": _np_tree(jstate0.params_2d),
                  "3d": _np_tree(jstate0.params_3d)}
        jsteps = {"ema_xm0": jax_trainer.make_train_step(
            jcfg, jmodels, with_pl=True, with_ema=True, with_mopa=True)}
        jsteps["pre_ema"] = jsteps["ema_xm0"].student_jit
        jsteps["ema_xm1"] = jax_trainer.make_train_step(
            _step_cfg(jax_base_cfg, 1.0), jmodels, with_pl=True,
            with_ema=True, with_mopa=True, reuse_step=jsteps["pre_ema"])
        caps = capacity_schedule(P, 3)
        src = _with_host_plans(_batch(1, False), caps)
        out = {}
        for run in RUNS:
            ema = run != "pre_ema"
            trg = _target(2, caps, ema)
            jnew, jm = jsteps[run](
                jax.tree_util.tree_map(jnp.copy, jstate0), _jax_batch(src),
                _jax_batch(trg))
            pcfg = _step_cfg(port_base_cfg, float(run[-1]) if ema else 0.7)
            pmodels = port_trainer.build_models(pcfg, device="cpu")
            pmodels.model_2d.net_2d.dropout_rate = 0.0
            pstate = port_trainer.create_train_state(
                pcfg, pmodels, flax_variables=flax_vars)
            pstep = port_trainer.make_train_step(pcfg, pmodels, with_pl=True,
                                                 with_ema=ema)
            pstate, pm = pstep(pstate, src, trg)
            out[run] = dict(jnew=jnew, jm=jm, pstate=pstate, pm=pm,
                            pmodels=pmodels)
    finally:
        mp.undo()
    return before, out


@pytest.mark.parametrize("run", RUNS)
def test_vgi_step_losses_and_metrics(runs, run):
    jm, pm = runs[1][run]["jm"], runs[1][run]["pm"]
    assert set(pm) == set(jm)
    assert {"pc_mm_loss", "pc_mm_acc", "vgi_inserted"} <= set(pm)
    assert int(pm["vgi_inserted"]) > 0
    for k in jm:
        want, got = np.asarray(jm[k]), pm[k].numpy()
        if k.startswith("cm_") or k == "vgi_inserted":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **LOSS_TOL)


@pytest.mark.parametrize("run", RUNS)
def test_vgi_step_batch_stats(runs, run):
    r = runs[1][run]
    for model, jstats, pstats in (
            (r["pmodels"].model_2d, r["jnew"].batch_stats_2d,
             r["pstate"].batch_stats_2d),
            (r["pmodels"].model_3d, r["jnew"].batch_stats_3d,
             r["pstate"].batch_stats_3d)):
        want = _np_tree(jstats)
        got = weights.to_flax(model, pstats)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **LOSS_TOL)


@pytest.mark.parametrize("net", ["2d", "3d"])
@pytest.mark.parametrize("run", RUNS)
def test_vgi_step_parameters_and_ema(runs, run, net):
    before, r = runs[0][net], runs[1][run]
    model = r["pmodels"][0 if net == "2d" else 1]
    pstate = r["pstate"]
    got = weights.to_flax(model, getattr(pstate, "params_" + net))
    got_ema = weights.to_flax(model, getattr(pstate, "ema_params_" + net))
    jnew = _np_tree(getattr(r["jnew"], "params_" + net))
    assert set(got) == set(jnew) == set(got_ema)
    top = max(float(np.abs(jnew[k] - before[k]).max()) for k in jnew)
    moved = 0
    for k in jnew:
        d_want, d_got = jnew[k] - before[k], got[k] - before[k]
        scale = float(np.abs(d_want).max())
        if k.endswith((".conv.bias", ".tconv.bias")):  # feeds a batch norm
            assert max(scale, float(np.abs(d_got).max())) <= 1e-4 * top, k
        else:
            np.testing.assert_allclose(d_got, d_want, rtol=0,
                                       atol=1e-4 * scale + 1e-12, err_msg=k)
            moved += scale > 0
        np.testing.assert_allclose(
            got_ema[k], ALPHA * before[k] + (1 - ALPHA) * got[k], rtol=1e-6,
            atol=1e-6, err_msg=k)
    assert moved > len(jnew) // 2


@pytest.mark.parametrize("ema", [False, True])
def test_host_plan_step_matches_device_plan_step(ema):
    """The same batches on host-built and on device-built plans (the cat
    plan is host-built in both) give the same step."""
    caps = capacity_schedule(P, 3)
    src = _with_host_plans(_batch(1, False), caps)
    trg = _target(2, caps, ema)
    dropped = ({k: v for k, v in b.items()
                if not k.startswith(("hp_", "_hp_"))
                or k.startswith(("hp_cat_", "_hp_cat_"))} for b in (src, trg))
    results = []
    for s, t in ((src, trg), tuple(dropped)):
        pcfg = _step_cfg(port_base_cfg, 1.0)
        models = port_trainer.build_models(pcfg, device="cpu", seed=4)
        models.model_2d.net_2d.dropout_rate = 0.0
        state = port_trainer.create_train_state(pcfg, models)
        step = port_trainer.make_train_step(pcfg, models, with_pl=True,
                                            with_ema=ema)
        state, metrics = step(state, s, t)
        results.append((metrics, {k: v.detach().clone() for k, v in
                                  state.params_3d.items()}))
    (m_host, p_host), (m_dev, p_dev) = results
    assert set(m_host) == set(m_dev)
    for k in m_dev:
        np.testing.assert_allclose(m_host[k].numpy(), m_dev[k].numpy(),
                                   err_msg=k, **LOSS_TOL)
    for k in p_dev:
        torch.testing.assert_close(p_host[k], p_dev[k], rtol=1e-5,
                                   atol=1e-5)
