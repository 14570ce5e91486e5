"""The shipped MoPA step through the device-VGI route (a VGI target batch
without host VGI's ``hp_cat_*`` plan) against ``mopa_tpu``'s: the pre-EMA
step and the EMA step at ``ema_xm_prob`` 0 and 1.

Fixtures and bars are ``test_torch_vgi_step.py``'s (flax init with
batch-norm biases at 2 through the weight bridge, dropout off, SGD at lr
1000, ``ema_start_iter`` 0, EMA alpha 0.99; losses and metrics to
``LOSS_TOL``, confusion matrices and ``vgi_inserted`` exact, batch-norm
statistics to ``LOSS_TOL``, each parameter's change to 1e-4 of its
largest), with the target batch carrying the raw VGI inputs instead of the
cat domain, and the target dataset SemanticKITTI, so the search window lies
ahead in +x. Both steps insert on the device and build the cat plan there.
JAX draws from ``split(state.rng, 4)[3]``; the port's draw function
(``ops.mixmatch.vgi_draws``) is patched to return those draws.

The augmentation here flips y and translates but has no noisy rotation:
XLA's CPU dot and torch's matmul round the (P, 3) x (3, 3) product of a
noisy rotation differently in the last bit, so a point on a rounding
boundary can land one voxel over (on this scene 1 of 640 cat points, which
moves ``pc_mm_loss`` by 1.6e-3).
``test_torch_mixmatch.py`` holds the noisy rotation's arithmetic, and
measures that share.

A target batch whose host cat plan overflows the fixup budget
(``native_loader.FIXUP_BUDGET`` patched to 1 here) keeps its raw inputs and
now trains through the device route.
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
from mopa_tpu_torch.data import collate, native_loader
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.models.scn_unet import capacity_schedule
from mopa_tpu_torch.ops import mixmatch
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_ema_step import _ema_batch
from test_torch_mixmatch import jax_draws
from test_torch_train_step import (B, LOSS_TOL, P, _batch, _identity_dropout,
                                   _lift_bn_biases, _np_tree)
from test_torch_vgi_step import (ALPHA, K_OBJ, O_OBJ, _jax_batch,
                                 _step_cfg, _vgi_inputs, _with_host_plans)

torch.set_num_threads(1)

RUNS = ["pre_ema", "ema_xm0", "ema_xm1"]


def _device_vgi_cfg(base, xm_prob=0.7):
    c = _step_cfg(base, xm_prob)
    c.DATASET_TARGET.TYPE = "SemanticKITTISCN"
    aug = c.DATASET_TARGET.SemanticKITTISCN.augmentation
    aug.noisy_rot, aug.flip_y, aug.rot_z, aug.transl = 0.0, 0.5, 0.0, True
    return c


def _target(seed, caps, ema):
    """A target batch with the raw VGI inputs (no cat domain) and the
    host-built plans of its scans (and of the teacher's view)."""
    out = _ema_batch(seed) if ema else _batch(seed, True)
    for k in ("pseudo_label_2d", "pseudo_label_3d"):
        out[k] = out[k].astype(np.int16)
    out.update(_vgi_inputs(seed))
    return _with_host_plans(out, caps, ema)


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's step on the same batches, per run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _identity_dropout)
    try:
        jcfg = _device_vgi_cfg(jax_base_cfg, 0.0)
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
            _device_vgi_cfg(jax_base_cfg, 1.0), jmodels, with_pl=True,
            with_ema=True, with_mopa=True, reuse_step=jsteps["pre_ema"])
        # the student step's VGI key: split(state.rng, 4)[3]
        vgi_key = jax.random.split(jstate0.rng, 4)[3]
        draws = {k: torch.from_numpy(np.array(v)) for k, v in jax_draws(
            vgi_key, B, K_OBJ, mixmatch.search_grid(jcfg.TRAIN.PC_MM))
            .items()}
        mp.setattr(mixmatch, "vgi_draws", lambda *a, **kw: dict(draws))
        caps = capacity_schedule(P, 3)
        src = _with_host_plans(_batch(1, False), caps)
        out = {}
        for run in RUNS:
            ema = run != "pre_ema"
            trg = _target(2, caps, ema)
            assert "hp_cat_rankn" not in trg and "ori_points" in trg
            jnew, jm = jsteps[run](
                jax.tree_util.tree_map(jnp.copy, jstate0), _jax_batch(src),
                _jax_batch(trg))
            pcfg = _device_vgi_cfg(port_base_cfg,
                                   float(run[-1]) if ema else 0.7)
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
def test_device_vgi_step_losses_and_metrics(runs, run):
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
def test_device_vgi_step_batch_stats(runs, run):
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
def test_device_vgi_step_parameters_and_ema(runs, run, net):
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
def test_overflowing_cat_plan_trains_through_device_vgi(monkeypatch, ema):
    """Host VGI whose cat plan overflows the fixup budget leaves the raw
    inputs and no cat key; the step inserts on the device instead of
    raising, with draws from the state's generator."""
    caps = capacity_schedule(P, 3)
    cfg = _device_vgi_cfg(port_base_cfg, 1.0)
    trg = _ema_batch(2) if ema else _batch(2, True)
    trg.update(_vgi_inputs(2))
    settings = {"rng": np.random.default_rng(2), "pc_mm": cfg.TRAIN.PC_MM,
                "aug": {"noisy_rot": 0.1, "flip_y": 0.5, "transl": True},
                "scale": 20.0, "full_scale": 4096, "front_axis_x": True,
                "num_levels": len(caps), "factors": None}
    monkeypatch.setattr(native_loader, "FIXUP_BUDGET", 1)
    collate._host_vgi_batch(trg, trg["ori_points"], B, P, O_OBJ, settings)
    monkeypatch.undo()
    assert not any(k.startswith(("hp_cat_", "cat_")) for k in trg)
    assert all(k in trg for k in _vgi_inputs(2))
    trg = _with_host_plans(trg, caps, ema)
    src = _with_host_plans(_batch(1, False), caps)
    models = port_trainer.build_models(cfg, device="cpu", seed=4)
    state = port_trainer.create_train_state(cfg, models)
    step = port_trainer.make_train_step(cfg, models, with_pl=True,
                                        with_ema=ema)
    state, metrics = step(state, src, trg)
    assert state.step == 1
    assert int(metrics["vgi_inserted"]) > 0
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
