"""The slice as a whole on the CPU: loaders feed the shipped MoPA step
across the EMA switch, the port's against ``mopa_tpu``'s.

Both packages build their loaders from ``configs/synthetic/mopa_smoke.yaml``
(float32, ``NUM_WORKERS`` 0, VGI on with host plans, ``ema_start_iter`` 2)
and run 3 iterations as ``mopa_tpu/train/common.py::train`` does: before
the switch the source and target loaders without the teacher's inputs,
``strip_ema`` on both streams and the target's ``seg_label`` stripped; at
the switch both loaders rebuilt at ``start_iteration`` 2, the target's with
``want_ema``. The port's batches go through ``device_prefetch``, JAX's
through ``device_batch``.

Cut to fit a test: the SCN at m=4 with 3 levels (the loaders' plans follow)
and 64x48 images (at 128x96 the 2D head's bias sums 49k pixel terms, and
the two frameworks' float32 summation orders part at ~2e-4 of its largest
gradient);
SGD without momentum at lr 1e-3, raised to 1000 for the third update so
that each parameter's change carries its gradient above float32 rounding
(as ``test_torch_vgi_step.py`` steps at 1000); ``ema_xm_prob`` 1, so the
teacher's fusion draw is the same on both sides; dropout off and
batch-norm biases at 2 (``test_torch_train_step.py``). JAX's target batches
get their VGI cat points key-sorted and the cat plan rebuilt, because JAX's
host-plan decode pools unsorted points wrongly (ROADMAP Queue 3); the
port's go unchanged.

* Every iteration: the same metric keys; losses to 1e-3 relative;
  ``vgi_inserted`` exact and non-zero.
* The switch: the teacher's labels equal JAX's ``teacher_jit``'s except at
  near ties (under 1 % of the points), as ``test_torch_ema_step.py`` holds
  them.
* The EMA step: each parameter's change to 1e-4 of its tensor's largest
  (``test_torch_vgi_step.py``'s bar), the EMA parameters and the
  batch-norm statistics to 1e-4 of their tensor's largest (a conv bias that
  feeds a batch norm, 0 in exact arithmetic, to 1e-4 of the net's largest).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.data import build as jax_build
from mopa_tpu.data import collate as jax_collate
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.train import common as jax_common
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.data import build
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.train import common
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_data_path import smoke_cfgs
from test_torch_train_step import _identity_dropout, _lift_bn_biases, _np_tree

torch.set_num_threads(1)

EMA_START, ITERATIONS = 2, 3
LOSS_RTOL = 1e-3
NEAR = 1e-4
OPTS = {"MODEL_3D.SCN.m": 4, "MODEL_3D.SCN.num_planes": 3,
        "OPTIMIZER.MODEL_2D.TYPE": "SGD", "OPTIMIZER.MODEL_3D.TYPE": "SGD",
        "OPTIMIZER.MODEL_2D.SGD.momentum": 0.0,
        "OPTIMIZER.MODEL_3D.SGD.momentum": 0.0,
        "OPTIMIZER.MODEL_2D.BASE_LR": 1e-3,
        "OPTIMIZER.MODEL_3D.BASE_LR": 1e-3,
        "SCHEDULER.MultiStepLR.milestones": (EMA_START,),
        "SCHEDULER.MultiStepLR.gamma": 1e6,
        "TRAIN.PC_MM.ema_start_iter": EMA_START,
        "TRAIN.PC_MM.ema_xm_prob": 1.0,
        "DATASET_SOURCE.SyntheticSCN.image_size": (64, 48),
        "DATASET_TARGET.SyntheticSCN.image_size": (64, 48)}


def _lexkey(c):
    c = np.asarray(c, np.int64)
    return (c[..., 0] * 4096 + c[..., 1]) * 4096 + c[..., 2]


def _sorted_cat(batch):
    """JAX's target batch with its cat points key-sorted per sample and
    the cat plan rebuilt (JAX's decode pools only sorted points right)."""
    out = dict(batch)
    b, n_cat = out["cat_valid"].shape
    coords = out["_cat_coords"].reshape(b, n_cat, 3).copy()
    for k in ("cat_valid", "cat_label", "cat_obj_mask"):
        out[k] = out[k].copy()
    for i in range(b):
        key = np.where(out["cat_valid"][i], _lexkey(coords[i]),
                       np.iinfo(np.int64).max)
        perm = np.argsort(key, kind="stable")
        coords[i] = coords[i][perm]
        for k in ("cat_valid", "cat_label", "cat_obj_mask"):
            out[k][i] = out[k][i][perm]
    out["_cat_coords"] = coords.reshape(-1, 3)
    jax_collate._host_plan_batch(out, b, n_cat, out["_hp_cat_caps"],
                                 "hp_cat_", "_cat_coords", "cat_valid",
                                 audit=False)
    return out


def _near_ties(pcfg, pmodels, pstate, trg, num_classes):
    """(2D, 3D) masks of the student points whose fused teacher label sits
    within NEAR of a tie (``test_torch_ema_step.py::_exempt`` at
    ``ema_xm_prob`` 1)."""
    batch = common.decode_batch(trg, "cpu")
    p2, p3 = port_trainer.teacher_forward(pcfg, pmodels, pstate, batch)
    b, p = batch["ori_point_valid"].shape
    valid = batch["ori_point_valid"].reshape(-1).numpy()
    p2, p3 = p2.numpy().astype(np.float64), p3.numpy().astype(np.float64)
    e2 = -p2 * np.log2(p2 + 1e-30) / np.log2(num_classes)
    e3 = -p3 * np.log2(p3 + 1e-30) / np.log2(num_classes)
    w2 = (1 / (e2 + 1e-30)) / (1 / (e2 + 1e-30) + 1 / (e3 + 1e-30))
    probs = w2 * p2 + (1 - w2) * p3
    top = np.sort(probs, axis=1)
    conf, lab = probs.max(1), probs.argmax(1)
    near = top[:, -1] - top[:, -2] < NEAR
    for c in range(num_classes):
        sel = valid & (lab == c)
        if sel.any():
            th = min(np.median(conf[sel]), 0.9)
            near |= sel & (np.abs(conf - th) < NEAR)
    emap = batch["ema_map"].numpy()
    flat = np.where((emap >= 0) & (emap < p),
                    emap + np.arange(b)[:, None] * p, -1).reshape(-1)
    mask = np.where(flat >= 0, near[np.clip(flat, 0, None)], False)
    return mask, mask


def _loaders(cfgs, start, want_ema_trg):
    """(JAX source, JAX target, port source, port target) batch streams."""
    jcfg, pcfg = cfgs
    trg_strip = dict(strip_ema=not want_ema_trg, strip_keys=("seg_label",))

    def jax_stream(loader, **kw):
        for batch in loader:
            if "cat_valid" in batch:
                batch = _sorted_cat(batch)
            yield jax_common.device_batch(batch, **kw)

    kw = dict(start_iteration=start)
    return (jax_stream(jax_build.build_dataloader(
                jcfg, "train", "source", want_ema=False, **kw),
                strip_ema=True),
            jax_stream(jax_build.build_dataloader(
                jcfg, "train", "target", want_ema=want_ema_trg, **kw),
                **trg_strip),
            common.device_prefetch(build.build_dataloader(
                pcfg, "train", "source", want_ema=False, **kw), "cpu",
                strip_ema=True),
            common.device_prefetch(build.build_dataloader(
                pcfg, "train", "target", want_ema=want_ema_trg, **kw),
                "cpu", **trg_strip))


@pytest.fixture(scope="module")
def run():
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _identity_dropout)
    try:
        cfgs = smoke_cfgs(**OPTS)
        jcfg, pcfg = cfgs
        jmodels, _ = jax_trainer.build_models(jcfg)
        example = jax_common.device_batch(next(iter(
            jax_build.build_dataloader(jcfg, "train", "source",
                                       want_ema=False))))
        jstate = jax.jit(lambda b: jax_trainer.create_train_state(
            jcfg, jmodels, b, seed=3))(example)
        jstate = jstate._replace(
            params_2d=_lift_bn_biases(jstate.params_2d),
            params_3d=_lift_bn_biases(jstate.params_3d))
        jstate = jstate._replace(
            ema_params_2d=jax.tree_util.tree_map(jnp.copy,
                                                 jstate.params_2d),
            ema_params_3d=jax.tree_util.tree_map(jnp.copy,
                                                 jstate.params_3d))
        pmodels = port_trainer.build_models(pcfg, device="cpu")
        pmodels.model_2d.net_2d.dropout_rate = 0.0
        pstate = port_trainer.create_train_state(
            pcfg, pmodels, flax_variables=tuple(flatten_pytree(t) for t in (
                jstate.params_2d, jstate.batch_stats_2d, jstate.params_3d,
                jstate.batch_stats_3d)))
        jstep = jax_trainer.make_train_step(jcfg, jmodels, with_pl=True,
                                            with_ema=False, with_mopa=True)
        pstep = port_trainer.make_train_step(pcfg, pmodels, with_pl=True,
                                             with_ema=False)
        streams = _loaders(cfgs, 0, False)
        out = {"metrics": []}
        for it in range(ITERATIONS):
            if it == EMA_START:
                streams = _loaders(cfgs, it, True)
                jstep = jax_trainer.make_train_step(
                    jcfg, jmodels, with_pl=True, with_ema=True,
                    with_mopa=True, reuse_step=jstep)
                pstep = port_trainer.make_train_step(
                    pcfg, pmodels, with_pl=True, with_ema=True)
            jsrc, jtrg, psrc, ptrg = (next(s) for s in streams)
            if it == EMA_START:
                teacher_in = {k: v for k, v in jtrg.items()
                              if common.is_ema_key(k)}
                out["jlabels"] = [np.asarray(x) for x in
                                  jstep.teacher_jit(jstate, teacher_in)]
                out["plabels"] = [x.numpy() for x in
                                  pstep.teacher_step(pstate, ptrg)]
                out["near"] = _near_ties(pcfg, pmodels, pstate, ptrg,
                                         pcfg.MODEL_3D.NUM_CLASSES)
                out["student_valid"] = (
                    np.arange(ptrg["ema_map"].shape[1])[None]
                    < ptrg["num_points"].numpy()[:, None]).reshape(-1)
                out["before"] = {"2d": _np_tree(jstate.params_2d),
                                 "3d": _np_tree(jstate.params_3d)}
            jstate, jm = jstep(jstate, jsrc, jtrg)
            pstate, pm = pstep(pstate, psrc, ptrg)
            out["metrics"].append((jm, pm))
        for s in streams:
            s.close()
        out.update(jstate=jstate, pstate=pstate, pmodels=pmodels)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("it", range(ITERATIONS))
def test_losses_match_jax(run, it):
    jm, pm = run["metrics"][it]
    assert set(pm) == set(jm)
    assert int(pm["vgi_inserted"]) == int(jm["vgi_inserted"]) > 0
    for k in jm:
        want, got = np.asarray(jm[k]), pm[k].numpy()
        if k.startswith("cm_"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif k.endswith("loss"):
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
            assert np.isfinite(got), k


def test_teacher_labels_match_jax(run):
    valid = run["student_valid"]
    for g, w, near, tag in zip(run["plabels"], run["jlabels"], run["near"],
                               ("2d", "3d")):
        assert g.dtype == w.dtype == np.int16, tag
        assert near[valid].mean() < 0.01, tag
        np.testing.assert_array_equal(g[~near], w[~near], err_msg=tag)
        kept = (g >= 0) & valid
        assert 0.2 < kept.sum() / valid.sum() < 1.0, tag


@pytest.mark.parametrize("net", ["2d", "3d"])
def test_ema_step_gradients_match_jax(run, net):
    before = run["before"][net]
    model = run["pmodels"][0 if net == "2d" else 1]
    got = weights.to_flax(model, getattr(run["pstate"], "params_" + net))
    jnew = _np_tree(getattr(run["jstate"], "params_" + net))
    assert set(got) == set(jnew)
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
    assert moved > len(jnew) // 2


@pytest.mark.parametrize("net", ["2d", "3d"])
def test_ema_params_and_batch_stats_match_jax(run, net):
    model = run["pmodels"][0 if net == "2d" else 1]
    for kind in ("ema_params_", "batch_stats_"):
        want = _np_tree(getattr(run["jstate"], kind + net))
        got = weights.to_flax(model, getattr(run["pstate"], kind + net))
        assert set(got) == set(want), kind
        top = max(float(np.abs(w).max()) for w in want.values())
        for k in want:
            if k.endswith((".conv.bias", ".tconv.bias")):
                # a bias before a batch norm has a zero gradient: both
                # sides hold rounding noise around its initial 0
                assert max(float(np.abs(got[k]).max()),
                           float(np.abs(want[k]).max())) <= 1e-4 * top, k
                continue
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-4 * scale + 1e-7,
                                       err_msg=kind + k)
