"""The step, eval and validation of the other 3D backbones and of the depth
head, the port against ``mopa_tpu``.

Both packages read the same synthetic streams through their own
``build_dataloader`` (``SyntheticSCN``, 2 + 2 scans of up to 400 points at a
256-point budget, 48 x 32 images; the batches are checked byte-equal first):

* ``spvcnn``: ``MODEL_3D.TYPE`` SPVCNN at its published widths
  (``DEFAULT_CS``, up to 384 -> 256 channels), host plans of 5 levels,
  with pseudo labels (``with_pl``);
* ``salsanext``: SalsaNext (base 32) on 24 x 80 range images, no plan,
  ``with_pl`` off;
* ``scn_depth``: the SCN step with ``TRAIN.DEPTH_PRED`` (the depth head on
  the 2D net, ``lambda_dp_src`` 0.1) and pseudo labels.

Each starts from the reference's flax init with every batch-norm bias at 2
(ReLU inputs away from 0), carried by the weight bridge, dropout off on
both sides, and takes one SGD step at learning rate 1000, so the new
parameters carry the gradients (``test_torch_train_step.py``'s scheme):
losses and metrics to ``LOSS_TOL`` (1e-5), every parameter's change to
1e-4 of its tensor's largest change, batch statistics to ``LOSS_TOL``.

SalsaNext's 3D net runs in float64 on both sides (``jax.enable_x64`` with
float64 3D parameters and statistics; the port's 3D net in ``double()``),
because its float32 training step is ill-conditioned in both packages
alike: flax's batch norm takes the variance as E[x^2] - E[x]^2, and on
range images of metres (up to ~50) the two packages' float32 features each
lie ~1e-3 of their largest value from a float64 forward, and their 3D
gradients agree only to a cosine of 0.88 (ROADMAP Queue 3 records the
conditioning as the JAX package's; the port mirrors it). Both packages then
round the input to the float32 compute dtype and promote it with the
float64 parameters, cast the features to float32 before the heads, which
promote them again, and take float32 logits into the losses, as flax does;
the 2D net stays float32. The SalsaNext step is then held to the same limits
as the others, its 3D updates included.

Eval steps: probabilities to 1e-4;
``validate()``: the evaluators' confusion matrices equal. Then the
combinations JAX cannot run fail in the port too.
"""

import logging

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.common.metric_logger import MetricLogger as JaxMetricLogger
from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.data import build as jax_build
from mopa_tpu.data.utils import validate as jax_validate
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.common.metric_logger import MetricLogger
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.data import build
from mopa_tpu_torch.data.utils import validate as port_validate
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.train import trainer as port_trainer

from test_torch_data_path import assert_same
from test_torch_train_step import (LOSS_TOL, _identity_dropout, _jax_batch,
                                   _lift_bn_biases, _np_tree)

torch.set_num_threads(1)

CASES = {
    "spvcnn": ({"MODEL_3D.TYPE": "SPVCNN"}, True),
    "salsanext": ({"MODEL_3D.TYPE": "SalsaNext"}, False),
    "scn_depth": ({"TRAIN.DEPTH_PRED": True,
                   "TRAIN.DEPTH_PRED_COE.lambda_dp_src": 0.1}, True),
}


def _cfg(base, **kw):
    c = base.clone()
    c.MODEL_2D.TYPE = "UNetResNet34"
    c.MODEL_3D.TYPE = "SCN"
    c.MODEL_2D.NUM_CLASSES = c.MODEL_3D.NUM_CLASSES = 5
    c.MODEL_2D.DUAL_HEAD = c.MODEL_3D.DUAL_HEAD = True
    c.MODEL_2D.UNetResNet34.pretrained = False
    c.MODEL_3D.SCN.m = 4
    c.MODEL_3D.SCN.num_planes = 3
    c.DATASET_SOURCE.TYPE = c.DATASET_TARGET.TYPE = "SyntheticSCN"
    c.DATASET_SOURCE.TRAIN = c.DATASET_TARGET.TRAIN = ("train",)
    c.DATASET_TARGET.VAL = ("val",)
    for d in (c.DATASET_SOURCE.SyntheticSCN, c.DATASET_TARGET.SyntheticSCN):
        d.length = 4
        d.n_points = 400
        d.image_size = (48, 32)
        d.num_classes = 5
        d.proj_H, d.proj_W = 24, 80
    c.DATASET_TARGET.SyntheticSCN.with_pseudo_labels = True
    c.OPTIMIZER.MODEL_2D.TYPE = c.OPTIMIZER.MODEL_3D.TYPE = "SGD"
    c.OPTIMIZER.MODEL_2D.BASE_LR = c.OPTIMIZER.MODEL_3D.BASE_LR = 1000.0
    c.SCHEDULER.TYPE = "MultiStepLR"
    c.SCHEDULER.MultiStepLR.milestones = (4,)
    c.SCHEDULER.MAX_ITERATION = 2
    c.TRAIN.BATCH_SIZE = 2
    c.VAL.BATCH_SIZE = 2
    c.TRAIN.CLASS_WEIGHTS = [1.0, 2.0, 1.0, 1.5, 1.0]
    c.TRAIN.XMUDA.lambda_xm_src = 1.0
    c.TRAIN.XMUDA.lambda_xm_trg = 0.1
    c.TRAIN.XMUDA.lambda_pl = 1.0
    c.TRAIN.PC_MM.lambda_sam_cons = 0.0
    c.TRAIN.PC_MM.lambda_pc_mm = 0.0
    c.TPU.POINT_BUDGET = 256
    c.TPU.COMPUTE_DTYPE = "float32"
    c.DATALOADER.NUM_WORKERS = 0
    for k, v in kw.items():
        node = c
        *path, leaf = k.split(".")
        for q in path:
            node = node[q]
        node[leaf] = v
    return c


def _first(cfg, builder, domain, mode="train"):
    return next(iter(builder(cfg, mode, domain)))


def _wire(batch):
    return {k: v for k, v in batch.items() if not k.startswith("_")}


def _no_dropout(models):
    models.model_2d.net_2d.dropout_rate = 0.0
    for mod in models.model_3d.modules():
        for name in ("dropout", "dropout_rate"):
            if isinstance(getattr(mod, name, None), float):
                setattr(mod, name, 0.0)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _identity_dropout)
    # JAX's eval plans assume sorted points (ROADMAP Queue 3)
    mp.setattr(jax_trainer, "_presorted", lambda cfg: False)
    yield mp
    mp.undo()


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request, monkeypatch_module):
    kw, with_pl = CASES[request.param]
    jcfg, pcfg = _cfg(jax_base_cfg, **kw), _cfg(port_base_cfg, **kw)
    src = _first(pcfg, build.build_dataloader, "source")
    trg = _first(pcfg, build.build_dataloader, "target")
    assert_same(_wire(src), _wire(_first(jcfg, jax_build.build_dataloader,
                                         "source")), "source")
    assert_same(_wire(trg), _wire(_first(jcfg, jax_build.build_dataloader,
                                         "target")), "target")
    jmodels, _ = jax_trainer.build_models(jcfg)
    jstate = jax.jit(lambda b: jax_trainer.create_train_state(
        jcfg, jmodels, b, seed=3))(_jax_batch(_wire(src)))
    jstate = jstate._replace(params_2d=_lift_bn_biases(jstate.params_2d),
                             params_3d=_lift_bn_biases(jstate.params_3d))
    pmodels = port_trainer.build_models(pcfg, device="cpu")
    _no_dropout(pmodels)
    x64 = request.param == "salsanext"  # the module docstring says why
    if x64:
        pmodels.model_3d.double()
    flax_vars = (flatten_pytree(jstate.params_2d),
                 flatten_pytree(jstate.batch_stats_2d),
                 flatten_pytree(jstate.params_3d),
                 flatten_pytree(jstate.batch_stats_3d))
    pstate = port_trainer.create_train_state(pcfg, pmodels,
                                             flax_variables=flax_vars)
    before = {"2d": _np_tree(jstate.params_2d),
              "3d": _np_tree(jstate.params_3d)}
    with jax.enable_x64(x64):
        if x64:
            jstate = jstate._replace(
                params_3d=_float64(jstate.params_3d),
                batch_stats_3d=_float64(jstate.batch_stats_3d))
        jstep = jax_trainer.make_train_step(jcfg, jmodels, with_pl=with_pl,
                                            with_ema=False, with_mopa=False)
        jnew, jm = jstep(jstate, _jax_batch(_wire(src)),
                         _jax_batch(_wire(trg)))
    pstep = port_trainer.make_train_step(pcfg, pmodels, with_pl=with_pl,
                                         with_mopa=False)
    pstate, pm = pstep(pstate, src, trg)
    return dict(case=request.param, cfgs=(jcfg, pcfg), jmodels=jmodels,
                jnew=jnew, jm=jm, pstate=pstate, pm=pm, pmodels=pmodels,
                before=before)


def test_backbone_step_losses_and_metrics(run):
    jm, pm = run["jm"], run["pm"]
    assert set(pm) == set(jm)
    if run["case"] == "scn_depth":
        assert "depth_pred_loss" in pm
    for k in jm:
        want = np.asarray(jm[k])
        if k.startswith("cm_"):
            np.testing.assert_array_equal(pm[k].numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(pm[k].numpy(), want, err_msg=k,
                                       **LOSS_TOL)


@pytest.mark.parametrize("net", ["2d", "3d"])
def test_backbone_step_parameters_and_stats(run, net):
    """SGD's first update is -lr * g: each tensor's change to 1e-4 of its
    largest change (a bias that feeds a batch norm, whose exact gradient is
    0, to 1e-4 of the net's largest change); batch statistics to
    ``LOSS_TOL``."""
    model = run["pmodels"][0 if net == "2d" else 1]
    pstate = run["pstate"]
    params = getattr(pstate, "params_" + net)
    jnew = _np_tree(getattr(run["jnew"], "params_" + net))
    before = run["before"][net]
    got = weights.to_flax(model, params)
    assert set(got) == set(jnew)
    top = max(float(np.abs(jnew[k] - before[k]).max()) for k in jnew)
    moved = 0
    for k in jnew:
        d_want, d_got = jnew[k] - before[k], got[k] - before[k]
        scale = float(np.abs(d_want).max())
        if k.endswith((".conv.bias", ".tconv.bias")) or (
                "point_transform" in k and k.endswith(".bias")):
            assert max(scale, float(np.abs(d_got).max())) <= 1e-4 * top, k
            continue
        np.testing.assert_allclose(d_got, d_want, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)
        moved += scale > 0
    assert moved > len(jnew) // 2
    want_stats = _np_tree(getattr(run["jnew"], "batch_stats_" + net))
    got_stats = weights.to_flax(model, getattr(pstate, "batch_stats_" + net))
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], err_msg=k,
                                   **LOSS_TOL)


@pytest.mark.parametrize("backbone", ["SPVCNN", "SalsaNext"])
def test_backbone_validate(backbone, monkeypatch_module, tmp_path):
    """``validate()`` of both packages over the val stream (4 scans in 2
    batches), the same weights: the 2D, 3D and 2D+3D confusion matrices
    equal; each eval batch's probabilities to 1e-4."""
    jcfg = _cfg(jax_base_cfg, **{"MODEL_3D.TYPE": backbone})
    pcfg = _cfg(port_base_cfg, **{"MODEL_3D.TYPE": backbone})
    batch = _first(pcfg, build.build_dataloader, "target", "val")
    jmodels, _ = jax_trainer.build_models(jcfg)
    jstate = jax.jit(lambda b: jax_trainer.create_train_state(
        jcfg, jmodels, b, seed=5))(_jax_batch(_wire(batch)))
    pmodels = port_trainer.build_models(pcfg, device="cpu")
    weights.load_flax_params(
        pmodels.model_2d, pmodels.model_3d,
        flatten_pytree(jstate.params_2d), flatten_pytree(jstate.batch_stats_2d),
        flatten_pytree(jstate.params_3d), flatten_pytree(jstate.batch_stats_3d))
    want = jax_validate.make_eval_step(jcfg, jmodels)(jstate,
                                                      _jax_batch(_wire(batch)))
    got = port_validate.make_eval_step(pcfg, pmodels)(batch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    logger = logging.getLogger("test_torch_backbone_step")
    evals = {
        "jax": jax_validate.validate(
            jcfg, jstate, jmodels, jax_build.build_dataloader(
                jcfg, "val", "target"), JaxMetricLogger(), logger),
        "port": port_validate.validate(
            pcfg, pmodels, build.build_dataloader(pcfg, "val", "target"),
            MetricLogger(), logger)}
    for kind in ("2D", "3D", "2D+3D"):
        cm = evals["port"][kind].confusion_matrix
        np.testing.assert_array_equal(cm, evals["jax"][kind].confusion_matrix,
                                      err_msg=kind)
        assert cm.sum() > 0


@pytest.mark.parametrize("opts,with_ema", [
    ({"TRAIN.PC_MM.lambda_pc_mm": 0.1}, False), ({}, True)],
    ids=["vgi", "ema"])
def test_spvcnn_with_vgi_or_ema_fails_as_jax_does(opts, with_ema,
                                                  monkeypatch_module):
    """SPVCNN's 4 input channels against the 1-channel VGI cat scans and
    teacher view: JAX's step fails to trace (a TypeError in the fused 3D
    forward, or in the teacher's stem conv); the port refuses at
    ``make_train_step``, naming ROADMAP Queue 3."""
    kw = dict(opts, **{"MODEL_3D.TYPE": "SPVCNN"})
    jcfg, pcfg = _cfg(jax_base_cfg, **kw), _cfg(port_base_cfg, **kw)
    t = jcfg.DATASET_TARGET.SyntheticSCN
    if with_ema:
        t.with_ema = True
    else:
        t.with_vgi = True
    src = _jax_batch(_wire(_first(jcfg, jax_build.build_dataloader,
                                  "source")))
    trg = _jax_batch(_wire(_first(jcfg, jax_build.build_dataloader,
                                  "target")))
    jmodels, _ = jax_trainer.build_models(jcfg)
    # the state's shapes only: tracing the step is what fails
    state = jax.eval_shape(lambda b: jax_trainer.create_train_state(
        jcfg, jmodels, b, seed=3), src)
    jstep = jax_trainer.make_train_step(jcfg, jmodels, with_pl=True,
                                        with_ema=with_ema)
    with pytest.raises(TypeError, match="concatenate|dot_general"):
        if with_ema:
            jstep.teacher_jit.lower(state, {
                k: v for k, v in trg.items()
                if k.startswith("ori_") or k == "ema_map"})
        else:
            jstep.lower(state, src, trg)
    pmodels = port_trainer.build_models(pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 3"):
        port_trainer.make_train_step(pcfg, pmodels, with_pl=True,
                                     with_ema=with_ema)


@pytest.mark.parametrize("opts,with_ema", [
    ({"TRAIN.PC_MM.lambda_pc_mm": 0.1}, False), ({}, True)],
    ids=["vgi", "ema"])
def test_salsanext_with_vgi_or_ema_raises_as_jax_does(opts, with_ema):
    kw = dict(opts, **{"MODEL_3D.TYPE": "SalsaNext"})
    jcfg, pcfg = _cfg(jax_base_cfg, **kw), _cfg(port_base_cfg, **kw)
    with pytest.raises(AssertionError, match="SCN-backbone"):
        jax_trainer.make_train_step(jcfg, None, with_pl=True,
                                    with_ema=with_ema)
    with pytest.raises(ValueError, match="voxel backbones"):
        port_trainer.make_train_step(
            pcfg, port_trainer.Models(torch.nn.Linear(1, 1), None),
            with_pl=True, with_ema=with_ema)
