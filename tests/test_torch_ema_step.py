"""The port's EMA phase of the MoPA train step against ``mopa_tpu``'s.

Fixtures and tolerances are those of ``test_torch_train_step.py``: the same
flax init with batch-norm biases at 2 carried over by the weight bridge,
dropout neutralised, SGD at lr 1000. Target batches gain the teacher's
unaugmented view: their own scans, images and pixel indices, key-sorted per
scan with ``ema_map`` remapped through the sort as the reference's collate
does (JAX's teacher builds its plan with ``presorted``), and an ``ema_map``
that is not the identity (shuffled positions, -1s and entries past the
budget).

* ``refine_pseudo_labels`` equals ``refine_pseudo_labels_jax`` exactly.
* The teacher's labels equal those of JAX's ``teacher_jit`` at
  ``ema_xm_prob`` 0 (per-net labels) and 1 (fused labels). Points whose
  top-2 probability gap, or whose distance to their class threshold, is
  below 1e-5 may differ (the two frameworks' float32 forwards differ by
  ~1e-5); they must be under 1 % of the valid points.
* The whole EMA step against JAX's ``step_with_teacher``: losses and metrics
  to 1e-5, every parameter's change to 1e-4 of its tensor's largest change,
  and the EMA parameters equal to 0.99 old + 0.01 new (``ema_start_iter``
  0, alpha 0.99) to 1e-6.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.data.utils.refine_pseudo_labels import refine_pseudo_labels_jax
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu.train.common import EMA_ONLY_KEYS, EMA_ONLY_PREFIX
from mopa_tpu.train.common import decode_batch as jax_decode_batch
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.data.utils.refine_pseudo_labels import \
    refine_pseudo_labels
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.data import synthetic
from mopa_tpu_torch.train import common as port_common
from mopa_tpu_torch.train import trainer as port_trainer
from mopa_tpu_torch.train.common import decode_batch
from test_torch_train_step import (B, H, LOSS_TOL, NCLS, P, W, _batch, _cfg,
                                   _identity_dropout, _jax_batch,
                                   _lift_bn_biases, _np_tree)

torch.set_num_threads(1)

ALPHA = 0.99
NEAR = 1e-5


def _ema_cfg(base, xm_prob):
    return _cfg(base, **{"TRAIN.PC_MM.ema_xm_prob": xm_prob,
                         "TRAIN.PC_MM.ema_start_iter": 0,
                         "TRAIN.PC_MM.ema_alpha_teacher": ALPHA})


def _lexkey(c):
    return (c[:, 0] * 4096 + c[:, 1]) * 4096 + c[:, 2]


def _ema_batch(seed):
    """A target batch (``_batch(seed, True)``) with the teacher's view."""
    out = _batch(seed, True)
    rng = np.random.default_rng(100 + seed)
    n_student = out["num_points"]
    ori_coords = np.zeros((B, P, 3), np.int64)
    ori_idx = np.zeros((B, P, 2), np.int64)
    emap = np.full((B, P), -1, np.int64)
    n_ori = (P, 220)
    for i, n in enumerate(n_ori):
        c = rng.integers(0, 9, size=(n, 3))
        pix = np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], -1)
        m = rng.integers(0, n, n_student[i])
        m[rng.random(n_student[i]) < 0.1] = -1   # not seen by the teacher
        m[:3] = P + np.arange(3)                  # past the budget
        # key-sort the ori points and remap ema_map through the sort
        operm = np.argsort(_lexkey(c), kind="stable")
        inv = np.empty(n, np.int64)
        inv[operm] = np.arange(n)
        ori_coords[i, :n] = c[operm]
        ori_idx[i, :n] = pix[operm]
        ok = (m >= 0) & (m < n)
        emap[i, :n_student[i]] = np.where(ok, inv[np.clip(m, 0, n - 1)], m)
    out.update(ori_img=rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8),
               ori_img_indices=ori_idx, ori_coords=ori_coords.reshape(B * P, 3),
               ori_num_points=np.asarray(n_ori), ema_map=emap,
               ori_feats_ones=np.ones((B, 1), np.float32))
    return out


def _teacher_in(trg):
    """The target's EMA-only keys, as JAX's step hands them its teacher."""
    return {k: jnp.asarray(v) for k, v in trg.items() if k in EMA_ONLY_KEYS}


def test_ema_only_keys_match_jax():
    assert port_common.EMA_ONLY_KEYS == EMA_ONLY_KEYS
    assert port_common.EMA_ONLY_PREFIX == EMA_ONLY_PREFIX


def test_decode_teacher_keys_matches_jax():
    trg = _ema_batch(2)
    want = jax_decode_batch(_teacher_in(trg))
    got = decode_batch({k: v for k, v in trg.items()
                        if port_common.is_ema_key(k)}, "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_synthetic_ema_views():
    """The student view is the ori view mirrored in y, with a flipped image,
    10 % of its points swapped for points the teacher did not see; both are
    key-sorted, and ``ema_map`` joins them."""
    w, h, p = 96, 64, 512
    b = synthetic.train_batch(2, p, start_index=7, image_size=(w, h),
                              domain="target", with_ema=True)
    np.testing.assert_array_equal(b["img"], b["ori_img"][:, :, ::-1])
    for i in range(2):
        n = b["num_points"][i]
        emap = b["ema_map"][i, :n]
        seen = emap >= 0
        assert 0.05 < 1 - seen.mean() < 0.15
        assert (emap[seen] != np.arange(n)[seen]).any()
        assert (b["ema_map"][i, n:] == -1).all()
        sc = b["coords"].reshape(2, p, 3)[i, :n][seen]
        oc = b["ori_coords"].reshape(2, p, 3)[i][emap[seen]]
        np.testing.assert_array_equal(sc[:, [0, 2]], oc[:, [0, 2]])
        assert (sc[:, 1] + oc[:, 1] == sc[0, 1] + oc[0, 1]).all()
        si = b["img_indices"][i, :n][seen]
        oi = b["ori_img_indices"][i][emap[seen]]
        np.testing.assert_array_equal(si[:, 0], oi[:, 0])
        np.testing.assert_array_equal(si[:, 1], w - 1 - oi[:, 1])
        for key in ("coords", "ori_coords"):
            c = b[key].reshape(2, p, 3)[i, :n]
            assert (np.diff(_lexkey(c)) >= 0).all(), key
    with pytest.raises(ValueError):
        synthetic.train_batch(1, p, image_size=(w, h), with_ema=True)


def _setup(xm_prob):
    """(JAX EMA step, JAX state, port EMA step, port state, port models,
    port cfg)."""
    jcfg = _ema_cfg(jax_base_cfg, xm_prob)
    pcfg = _ema_cfg(port_base_cfg, xm_prob)
    jmodels, _ = jax_trainer.build_models(jcfg)
    jstate = jax.jit(lambda b: jax_trainer.create_train_state(
        jcfg, jmodels, b, seed=3))(_jax_batch(_batch(0, False)))
    jstate = jstate._replace(params_2d=_lift_bn_biases(jstate.params_2d),
                             params_3d=_lift_bn_biases(jstate.params_3d))
    jstate = jstate._replace(
        ema_params_2d=jax.tree_util.tree_map(jnp.copy, jstate.params_2d),
        ema_params_3d=jax.tree_util.tree_map(jnp.copy, jstate.params_3d))
    jstep = jax_trainer.make_train_step(jcfg, jmodels, with_pl=True,
                                        with_ema=True, with_mopa=True)
    pmodels = port_trainer.build_models(pcfg, device="cpu")
    pmodels.model_2d.net_2d.dropout_rate = 0.0
    pstate = port_trainer.create_train_state(
        pcfg, pmodels, flax_variables=(
            flatten_pytree(jstate.params_2d),
            flatten_pytree(jstate.batch_stats_2d),
            flatten_pytree(jstate.params_3d),
            flatten_pytree(jstate.batch_stats_3d)))
    pstep = port_trainer.make_train_step(pcfg, pmodels, with_pl=True,
                                         with_ema=True)
    return jstep, jstate, pstep, pstate, pmodels, pcfg


@pytest.fixture(scope="module")
def no_dropout():
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _identity_dropout)
    yield
    mp.undo()


# --------------------------------------------------------------- refinement

def _refine_case(case):
    rng = np.random.default_rng({"padding": 0, "absent_class": 1,
                                 "even_odd": 2, "ties": 3}[case])
    n, c = 301, 6
    probs = rng.random(n).astype(np.float32)
    labels = rng.integers(0, c, n)
    valid = np.ones(n, bool)
    if case == "padding":
        valid[rng.random(n) < 0.3] = False
        valid[-20:] = False
    if case == "absent_class":
        labels[labels == 2] = 4
        valid[labels == 5] = False    # present only at padding
    if case == "even_odd":
        labels = np.repeat(np.arange(c), [40, 41, 2, 1, 100, 117])
    if case == "ties":
        probs = np.round(probs * 8) / 8   # many equal confidences
        probs[labels == 1] = 0.95         # above 0.9: the cap applies
    return probs, labels, valid, c


@pytest.mark.parametrize("case", ["padding", "absent_class", "even_odd",
                                  "ties"])
def test_refine_pseudo_labels_matches_jax(case):
    probs, labels, valid, c = _refine_case(case)
    want = np.asarray(refine_pseudo_labels_jax(
        jnp.asarray(probs), jnp.asarray(labels, jnp.int32),
        jnp.asarray(valid), c))
    got = refine_pseudo_labels(torch.from_numpy(probs),
                               torch.from_numpy(labels),
                               torch.from_numpy(valid), c).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got[valid] == -100).any()


def test_refine_ignores_labels_out_of_range():
    """A valid point whose label is outside [0, C) gets -100 (JAX keeps it
    under the clipped class's threshold: ROADMAP Queue 3)."""
    probs = torch.tensor([0.5, 0.6, 0.7, 0.9, 0.8])
    labels = torch.tensor([0, -5, 7, 1, 1])
    got = refine_pseudo_labels(probs, labels, torch.ones(5, dtype=bool), 3)
    assert got.tolist() == [0, -100, -100, 1, -100]


# --------------------------------------------------------- teacher labels

def _exempt(pcfg, pmodels, pstate, trg, xm):
    """(2D, 3D) masks of the student points whose teacher label sits within
    NEAR of a tie: the top-2 gap of the probabilities it was refined from,
    or its confidence's distance to its class threshold."""
    batch = decode_batch(trg, "cpu")
    p2, p3 = port_trainer.teacher_forward(pcfg, pmodels, pstate, batch)
    valid = batch["ori_point_valid"].reshape(-1).numpy()
    p2, p3 = p2.numpy().astype(np.float64), p3.numpy().astype(np.float64)
    if xm:
        e2 = -p2 * np.log2(p2 + 1e-30) / np.log2(NCLS)
        e3 = -p3 * np.log2(p3 + 1e-30) / np.log2(NCLS)
        w2 = (1 / (e2 + 1e-30)) / (1 / (e2 + 1e-30) + 1 / (e3 + 1e-30))
        sources = [w2 * p2 + (1 - w2) * p3] * 2
    else:
        sources = [p2, p3]
    emap = batch["ema_map"].numpy()
    base = np.arange(B)[:, None] * P
    flat = np.where((emap >= 0) & (emap < P), emap + base, -1).reshape(-1)
    masks = []
    for probs in sources:
        top = np.sort(probs, axis=1)
        conf, lab = probs.max(1), probs.argmax(1)
        near = top[:, -1] - top[:, -2] < NEAR
        for c in range(NCLS):
            sel = valid & (lab == c)
            if sel.any():
                th = min(np.median(conf[sel]), 0.9)
                near |= sel & (np.abs(conf - th) < NEAR)
        masks.append(np.where(flat >= 0, near[np.clip(flat, 0, None)],
                              False))
    return masks


@pytest.mark.parametrize("xm", [0, 1])
def test_teacher_labels_match_jax(no_dropout, xm):
    jstep, jstate, pstep, pstate, pmodels, pcfg = _setup(float(xm))
    trg = _ema_batch(2)
    want = [np.asarray(x) for x in jstep.teacher_jit(jstate,
                                                     _teacher_in(trg))]
    got = [x.numpy() for x in pstep.teacher_step(pstate, trg)]
    exempt = _exempt(pcfg, pmodels, pstate, trg, xm)
    student_valid = (np.arange(P)[None] < trg["num_points"][:, None]
                     ).reshape(-1)
    for g, w, ex, tag in zip(got, want, exempt, ("2d", "3d")):
        assert g.dtype == w.dtype == np.int16, tag
        assert ex[student_valid].mean() < 0.01, tag
        np.testing.assert_array_equal(g[~ex], w[~ex], err_msg=tag)
        kept = (g >= 0) & student_valid
        assert 0.2 < kept.sum() / student_valid.sum() < 1.0, tag
        assert (g[trg["ema_map"].reshape(-1) < 0] == -100).all(), tag
    if xm:
        np.testing.assert_array_equal(got[0], got[1])
    else:
        assert (got[0] != got[1]).any()


# ------------------------------------------------------- the whole EMA step

@pytest.fixture(scope="module")
def ema_run(no_dropout):
    jstep, jstate, pstep, pstate, pmodels, _ = _setup(1.0)
    src, trg = _batch(1, False), _ema_batch(2)
    before = {"2d": _np_tree(jstate.params_2d),
              "3d": _np_tree(jstate.params_3d)}
    jlabels = [np.asarray(x) for x in jstep.teacher_jit(jstate,
                                                        _teacher_in(trg))]
    plabels = [x.numpy() for x in pstep.teacher_step(pstate, trg)]
    jnew, jm = jstep(jstate, _jax_batch(src), _jax_batch(trg))
    pstate, pm = pstep(pstate, src, trg)
    return dict(before=before, jnew=jnew, jm=jm, pstate=pstate, pm=pm,
                pmodels=pmodels, jlabels=jlabels, plabels=plabels)


def test_ema_step_losses_and_metrics(ema_run):
    # the comparison is of the step: both sides must splice the same labels
    for g, w in zip(ema_run["plabels"], ema_run["jlabels"]):
        np.testing.assert_array_equal(g, w)
    jm, pm = ema_run["jm"], ema_run["pm"]
    assert set(pm) == set(jm)
    assert "pl_loss_trg_2d" in pm
    for k in jm:
        want, got = np.asarray(jm[k]), pm[k].numpy()
        if k.startswith("cm_"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **LOSS_TOL)


@pytest.mark.parametrize("net", ["2d", "3d"])
def test_ema_step_parameters_and_ema(ema_run, net):
    """Each tensor's change matches JAX's to 1e-4 of its largest change; the
    EMA parameters are 0.99 old + 0.01 new."""
    model = ema_run["pmodels"][0 if net == "2d" else 1]
    pstate = ema_run["pstate"]
    params = pstate.params_2d if net == "2d" else pstate.params_3d
    ema = pstate.ema_params_2d if net == "2d" else pstate.ema_params_3d
    jnew = _np_tree(getattr(ema_run["jnew"], "params_" + net))
    before = ema_run["before"][net]
    got = weights.to_flax(model, params)
    got_ema = weights.to_flax(model, ema)
    assert set(got) == set(jnew) == set(got_ema)
    moved = 0
    for k in jnew:
        d_want = jnew[k] - before[k]
        d_got = got[k] - before[k]
        scale = float(np.abs(d_want).max())
        if not k.endswith((".conv.bias", ".tconv.bias")):
            np.testing.assert_allclose(d_got, d_want, rtol=0,
                                       atol=1e-4 * scale + 1e-12, err_msg=k)
            moved += scale > 0
        np.testing.assert_allclose(
            got_ema[k], ALPHA * before[k] + (1 - ALPHA) * got[k], rtol=1e-6,
            atol=1e-6, err_msg=k)
    assert moved > len(jnew) // 2
    assert pstate.step == 1


def test_ema_needs_pseudo_labels():
    pcfg = _ema_cfg(port_base_cfg, 0.5)
    models = port_trainer.build_models(pcfg, device="cpu")
    with pytest.raises(ValueError, match="pseudo-label"):
        port_trainer.make_train_step(pcfg, models, with_pl=False,
                                     with_ema=True)
