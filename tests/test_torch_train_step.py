"""The port's pre-EMA MoPA train step against ``mopa_tpu``'s.

Both packages start from the same weights (the reference's flax init with
every batch-norm bias at 2, carried over by the weight bridge) and take the
same numpy batch pair: 2 + 2 key-
sorted scans of 256 points on a dense coordinate grid (so the submanifold
convs see many neighbour pairs), 32x48 images, 5 classes, SAM masks in an
8-id budget, every loss of the step switched on except VGI. Dropout is
neutralised on both sides (flax ``nn.Dropout`` patched to the identity in
the reference; the port's rate set to 0), because the two packages draw
different random bits. The biases keep ReLU inputs away from 0: the two
frameworks' float32 forwards differ by ~1e-5, and one ReLU input that lands
on the other side of the kink moves the gradient of every encoder tensor by
~1 % at this size.

* (a) SGD: the first update is -lr * g, so the new parameters carry the
  gradients. Losses and metrics to 1e-5, confusion matrices exact, batch
  statistics to 1e-5, every parameter's change to 1e-4 x its tensor's
  largest change, EMA parameters equal to the new parameters. A conv bias
  that feeds a batch norm has an exact gradient of 0; its change is held to
  1e-4 x the net's largest change.
* (b) The shipped optimizer, Adam: two steps, losses and metrics of the
  second to 1e-4.
* (c) The port sorts points itself: the step on shuffled scans gives the
  losses of the step on sorted scans.
* A device mesh (M13), which the port does not have yet, raises
  ``NotImplementedError`` naming its ROADMAP item; the other 3D backbones
  and the depth head carry the JAX package's flax variables.
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
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.train import trainer as port_trainer

torch.set_num_threads(1)

B, P, H, W, NCLS, BUDGET = 2, 256, 32, 48, 5, 8
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(base, optimizer="SGD", **kw):
    c = base.clone()
    c.MODEL_2D.TYPE = "UNetResNet34"
    c.MODEL_3D.TYPE = "SCN"
    c.MODEL_2D.NUM_CLASSES = NCLS
    c.MODEL_3D.NUM_CLASSES = NCLS
    c.MODEL_2D.DUAL_HEAD = True
    c.MODEL_3D.DUAL_HEAD = True
    c.MODEL_2D.UNetResNet34.pretrained = False
    c.MODEL_3D.SCN.m = 4
    c.MODEL_3D.SCN.num_planes = 3
    c.OPTIMIZER.MODEL_2D.TYPE = optimizer
    c.OPTIMIZER.MODEL_3D.TYPE = optimizer
    c.OPTIMIZER.MODEL_2D.BASE_LR = 0.01
    if optimizer == "SGD":
        # -lr * g must stand well above the float32 spacing of the
        # parameters it is added to, or the rounding of the new value
        # hides the gradient
        c.OPTIMIZER.MODEL_2D.BASE_LR = 1000.0
        c.OPTIMIZER.MODEL_3D.BASE_LR = 1000.0
    c.SCHEDULER.TYPE = "MultiStepLR"
    c.SCHEDULER.MultiStepLR.milestones = (1,)
    c.TRAIN.CLASS_WEIGHTS = [1.0, 2.0, 1.0, 1.5, 1.0]
    c.TRAIN.XMUDA.lambda_xm_src = 1.0
    c.TRAIN.XMUDA.lambda_xm_trg = 0.1
    c.TRAIN.XMUDA.lambda_pl = 1.0
    c.TRAIN.XMUDA.lambda_minent = 0.05
    c.TRAIN.PC_MM.lambda_sam_cons = 0.5
    c.TRAIN.PC_MM.lambda_pc_mm = 0.0
    c.TRAIN.PC_MM.use_class_weights = True
    c.TPU.POINT_BUDGET = P
    c.TPU.SAM_MASK_BUDGET = BUDGET
    c.TPU.COMPUTE_DTYPE = "float32"
    for k, v in kw.items():
        node = c
        *path, leaf = k.split(".")
        for q in path:
            node = node[q]
        node[leaf] = v
    return c


def _batch(seed, target):
    """B key-sorted scans (the second one padded), images, labels and, for
    the target, pseudo labels and SAM mask ids (some images without any)."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((B, P, 3), np.int64)
    valid = np.zeros((B, P), bool)
    labels = np.full((B, P), -100, np.int64)
    for i, n in enumerate((P, 200)):
        c = rng.integers(0, 9, size=(n, 3))
        key = (c[:, 0] * 4096 + c[:, 1]) * 4096 + c[:, 2]
        coords[i, :n] = c[np.argsort(key, kind="stable")]
        valid[i, :n] = True
        labels[i, :n] = rng.integers(-1, NCLS, n)
    out = {
        "img": rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8),
        "img_indices": np.stack([rng.integers(0, H, (B, P)),
                                 rng.integers(0, W, (B, P))], -1),
        "coords": coords.reshape(B * P, 3),
        "seg_label": labels.reshape(B * P),
        "num_points": valid.sum(1),
        "feats_ones": np.ones((B, 1), np.float32),
    }
    if target:
        ps = labels.reshape(-1).copy()
        ps[rng.random(ps.shape[0]) < 0.3] = -100
        out["pseudo_label_2d"] = ps
        out["pseudo_label_3d"] = np.where(rng.random(ps.shape[0]) < 0.2,
                                          -100, ps)
        masks = rng.integers(-1, BUDGET, (B, H // 8, W // 8))
        masks = np.repeat(np.repeat(masks, 8, 1), 8, 2)
        masks[1] = -1  # an image with no mask
        out["sam_mask"] = masks
    return out


def _lift_bn_biases(params, value=2.0):
    """Flax params with every batch-norm bias (a module holding ``scale``)
    set to ``value``."""
    if hasattr(params, "items"):
        out = {k: _lift_bn_biases(v, value) for k, v in params.items()}
        if "scale" in out and "bias" in out:
            out["bias"] = jnp.full_like(out["bias"], value)
        return type(params)(out) if not isinstance(params, dict) else out
    return params


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _identity_dropout(*args, **kwargs):
    return lambda x, *a, **k: x


def _setup(optimizer):
    """(JAX step, JAX state, port step, port state, port models)."""
    jcfg = _cfg(jax_base_cfg, optimizer)
    pcfg = _cfg(port_base_cfg, optimizer)
    jmodels, _ = jax_trainer.build_models(jcfg)
    # jitted: flax's init dispatched op by op takes tens of seconds on the CPU
    jstate = jax.jit(lambda b: jax_trainer.create_train_state(
        jcfg, jmodels, b, seed=3))(_jax_batch(_batch(0, False)))
    jstate = jstate._replace(params_2d=_lift_bn_biases(jstate.params_2d),
                             params_3d=_lift_bn_biases(jstate.params_3d))
    jstep = jax_trainer.make_train_step(jcfg, jmodels, with_pl=True,
                                        with_ema=False, with_mopa=True)
    pmodels = port_trainer.build_models(pcfg, device="cpu")
    pmodels.model_2d.net_2d.dropout_rate = 0.0
    pstate = port_trainer.create_train_state(
        pcfg, pmodels, flax_variables=(
            flatten_pytree(jstate.params_2d),
            flatten_pytree(jstate.batch_stats_2d),
            flatten_pytree(jstate.params_3d),
            flatten_pytree(jstate.batch_stats_3d)))
    pstep = port_trainer.make_train_step(pcfg, pmodels, with_pl=True)
    return jstep, jstate, pstep, pstate, pmodels


def _np_tree(tree):
    return {k: np.array(v) for k, v in flatten_pytree(tree).items()}


@pytest.fixture(scope="module")
def sgd_run(monkeypatch_module):
    monkeypatch_module.setattr(flax.linen, "Dropout", _identity_dropout)
    jstep, jstate, pstep, pstate, pmodels = _setup("SGD")
    src, trg = _batch(1, False), _batch(2, True)
    before = {"2d": _np_tree(jstate.params_2d),
              "3d": _np_tree(jstate.params_3d)}
    jnew, jm = jstep(jstate, _jax_batch(src), _jax_batch(trg))
    pstate, pm = pstep(pstate, src, trg)
    return dict(before=before, jnew=jnew, jm=jm, pstate=pstate, pm=pm,
                pmodels=pmodels)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_sgd_step_losses_and_metrics(sgd_run):
    jm, pm = sgd_run["jm"], sgd_run["pm"]
    assert set(pm) == set(jm)
    for k in jm:
        want = np.asarray(jm[k])
        got = pm[k].numpy()
        if k.startswith("cm_"):
            np.testing.assert_array_equal(got, want, err_msg=k)
            assert got.sum() > 0
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **LOSS_TOL)


def test_sgd_step_batch_stats(sgd_run):
    jnew, pstate, pmodels = (sgd_run["jnew"], sgd_run["pstate"],
                             sgd_run["pmodels"])
    for tag, model, jstats, pstats in (
            ("2d", pmodels.model_2d, jnew.batch_stats_2d,
             pstate.batch_stats_2d),
            ("3d", pmodels.model_3d, jnew.batch_stats_3d,
             pstate.batch_stats_3d)):
        want = _np_tree(jstats)
        got = weights.to_flax(model, pstats)
        assert set(got) == set(want), tag
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **LOSS_TOL)


@pytest.mark.parametrize("net", ["2d", "3d"])
def test_sgd_step_parameter_updates(sgd_run, net):
    """SGD's first update is -lr * g: each tensor's change matches JAX's to
    1e-4 of its largest change, so every gradient of the step is held."""
    model = sgd_run["pmodels"][0 if net == "2d" else 1]
    pstate = sgd_run["pstate"]
    params = pstate.params_2d if net == "2d" else pstate.params_3d
    ema = pstate.ema_params_2d if net == "2d" else pstate.ema_params_3d
    jnew = _np_tree(getattr(sgd_run["jnew"], "params_" + net))
    before = sgd_run["before"][net]
    got = weights.to_flax(model, params)
    assert set(got) == set(jnew)
    top = max(float(np.abs(jnew[k] - before[k]).max()) for k in jnew)
    moved = 0
    for k in jnew:
        d_want = jnew[k] - before[k]
        d_got = got[k] - before[k]
        scale = float(np.abs(d_want).max())
        if k.endswith((".conv.bias", ".tconv.bias")):  # feeds a batch norm
            assert max(scale, float(np.abs(d_got).max())) <= 1e-4 * top, k
            continue
        np.testing.assert_allclose(d_got, d_want, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)
        moved += scale > 0
    assert moved > len(jnew) // 2
    for k, v in ema.items():  # before ema_start_iter the teacher = student
        assert torch.equal(v, params[k].detach()), k


def test_adam_two_steps():
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _identity_dropout)
    try:
        jstep, jstate, pstep, pstate, _ = _setup("Adam")
        batches = [(_batch(1, False), _batch(2, True)),
                   (_batch(3, False), _batch(4, True))]
        for src, trg in batches:
            jstate, jm = jstep(jstate, _jax_batch(src), _jax_batch(trg))
            pstate, pm = pstep(pstate, src, trg)
    finally:
        mp.undo()
    assert pstate.step == 2 and pstate.opt_2d.count == 2
    for k in jm:
        want = np.asarray(jm[k])
        if k.startswith("cm_"):
            np.testing.assert_array_equal(pm[k].numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(pm[k].numpy(), want, rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def test_step_on_shuffled_points():
    """Shuffling each scan's points (padding included) changes no loss."""
    rng = np.random.default_rng(5)
    src, trg = _batch(1, False), _batch(2, True)
    perm = np.concatenate([i * P + rng.permutation(P) for i in range(B)])

    def shuffled(batch):
        out = dict(batch)
        for k in ("coords", "seg_label", "pseudo_label_2d",
                  "pseudo_label_3d"):
            if k in batch:
                out[k] = batch[k][perm]
        out["img_indices"] = batch["img_indices"].reshape(B * P, 2)[
            perm].reshape(B, P, 2)
        valid = (np.arange(P)[None] < batch["num_points"][:, None])
        out["point_valid"] = valid.reshape(-1)[perm].reshape(B, P)
        del out["num_points"]
        return out

    metrics = []
    for s, t in ((src, trg), (shuffled(src), shuffled(trg))):
        pcfg = _cfg(port_base_cfg)
        models = port_trainer.build_models(pcfg, device="cpu", seed=4)
        models.model_2d.net_2d.dropout_rate = 0.0
        state = port_trainer.create_train_state(pcfg, models)
        step = port_trainer.make_train_step(pcfg, models, with_pl=True)
        metrics.append(step(state, s, t)[1])
    for k, v in metrics[0].items():
        np.testing.assert_allclose(metrics[1][k].numpy(), v.numpy(),
                                   err_msg=k, **LOSS_TOL)


@pytest.mark.parametrize("case,item", [("backbone", "M14"), ("mesh", "M13"),
                                       ("depth", "M14")])
def test_unported_paths_raise(case, item):
    """A device mesh (M13) still raises. The other 3D backbones and the
    depth head (M14, which raised here before they were ported) now build:
    the port's nets carry exactly the flax variables, names and shapes, of
    the JAX package's nets from the same config (``jax.eval_shape`` of its
    init), and their step builds. Their numbers are held by
    ``test_torch_backbone_step.py``."""
    if case == "mesh":
        pcfg = _cfg(port_base_cfg)
        models = port_trainer.build_models(pcfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP " + item):
            port_trainer.make_train_step(pcfg, models, with_pl=True,
                                         mesh=object())
        return
    variants = ([{"MODEL_3D.TYPE": "SPVCNN"}, {"MODEL_3D.TYPE": "SalsaNext"}]
                if case == "backbone" else [{"TRAIN.DEPTH_PRED": True}])
    for kw in variants:
        jcfg, pcfg = _cfg(jax_base_cfg, **kw), _cfg(port_base_cfg, **kw)
        batch = {k: jnp.asarray(v) for k, v in _batch(0, False).items()}
        batch["feats"] = jnp.ones((B * P, 4 if "SPVCNN" in str(kw) else 1))
        batch["proj_in"] = jnp.zeros((B, 16, 64, 5))
        batch["proj_xy"] = jnp.zeros((B, P, 2), jnp.int32)
        jmodels, _ = jax_trainer.build_models(jcfg)
        shapes = jax.eval_shape(lambda b: jax_trainer.create_train_state(
            jcfg, jmodels, b, seed=3), batch)
        models = port_trainer.build_models(pcfg, device="cpu")
        for net, params, stats in (
                (models.model_2d, shapes.params_2d, shapes.batch_stats_2d),
                (models.model_3d, shapes.params_3d, shapes.batch_stats_3d)):
            want = {".".join(str(q.key) for q in path): tuple(v.shape)
                    for tree in (params, stats) for path, v in
                    jax.tree_util.tree_flatten_with_path(tree)[0]}
            got = {k: tuple(v.shape) for k, v in weights.to_flax(
                net, net.state_dict()).items()}
            assert got == want, (kw, sorted(set(got) ^ set(want)))
        port_trainer.make_train_step(pcfg, models, with_pl=True)
