"""The port's ``validate()`` against ``mopa_tpu``'s on the val stream of
``configs/synthetic/mopa_smoke.yaml`` (8 batches of 2 scans, float32),
with JAX's weights bridged into the port, both with ``entropy_fuse`` and
a pseudo-label directory.

Cut to fit a test: the SCN at m=4 with 3 levels. JAX's eval plan assumes
key-sorted points (``trainer._presorted``, ROADMAP Queue 3) and the eval
loader keeps dataset order, so JAX's ``_presorted`` is patched to False
here; the port's eval plan sorts its points itself.

* Each evaluator's predictions (2D, 3D, xM, xM_ety) equal JAX's on every
  point except where the port's top two (fused) probabilities lie within
  ``NEAR`` (1e-5) of each other; so the confusion matrices are equal up to
  those points.
* The per-batch losses within 1e-5; the pseudo-label files: the same
  names and keys, labels equal except at those near ties, probabilities
  within 1e-5.
* The port alone: validation moves no batch-norm statistic or parameter,
  and the next train step trains again (``.train()``).
* KNN (``VAL.use_knn``): ``knn_postprocess_scan`` against JAX's on the
  val scans with seeded labels (exact) and probabilities (1e-5); a lone
  outlier re-voted; ``validate()`` with ``use_knn`` and ``knn_prob``
  against JAX's: the 3D predictions equal except at near ties of the
  re-voted probabilities.
* SemanticKITTI's on-disk fixture: the pseudo-label files hold
  ``ori_keep_idx`` and ``ori_img_points`` equal to JAX's.
"""

import copy
import functools
import logging
import os

import jax
import numpy as np
import pytest
import torch

from mopa_tpu.common.metric_logger import MetricLogger as JaxMetricLogger
from mopa_tpu.data import build as jax_build
from mopa_tpu.data.utils import validate as jax_validate
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.train import common as jax_common
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.common.metric_logger import MetricLogger
from mopa_tpu_torch.data import build
from mopa_tpu_torch.data.utils import validate as port_validate
from mopa_tpu_torch.train import common
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_data_path import smoke_cfgs

torch.set_num_threads(1)

NEAR = 1e-5
LOSS_TOL = 1e-5
OPTS = {"MODEL_3D.SCN.m": 4, "MODEL_3D.SCN.num_planes": 3}
KINDS = ("2D", "3D", "2D+3D", "xM_ety")


def _recording(cls, store):
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            store.append([])
            self._log = store[-1]

        def update(self, pred_label, gt_label):
            self._log.append(np.array(pred_label))
            super().update(pred_label, gt_label)
    return Recording


def _top_gap(probs):
    top = np.sort(probs, axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.fixture(scope="module")
def nets():
    """(JAX config, port config, JAX models, JAX state, port models): the
    flax init of JAX's nets, bridged into the port's."""
    jcfg, pcfg = smoke_cfgs(**OPTS)
    jmodels, _ = jax_trainer.build_models(jcfg)
    example = jax_common.device_batch(next(iter(
        jax_build.build_dataloader(jcfg, "train", "source",
                                   want_ema=False))))
    jstate = jax.jit(lambda b: jax_trainer.create_train_state(
        jcfg, jmodels, b, seed=3))(example)
    pmodels = port_trainer.build_models(pcfg, device="cpu")
    port_trainer.create_train_state(
        pcfg, pmodels, flax_variables=tuple(flatten_pytree(t) for t in (
            jstate.params_2d, jstate.batch_stats_2d, jstate.params_3d,
            jstate.batch_stats_3d)))
    return jcfg, pcfg, jmodels, jstate, pmodels


def _validate_both(nets, root, cfgs, **kw):
    """Both packages' ``validate()`` over their val loaders of ``cfgs``,
    with each evaluator's updates, the port's eval-step probabilities and
    its KNN re-votes recorded."""
    _, _, jmodels, jstate, pmodels = nets
    jcfg, pcfg = cfgs
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_trainer, "_presorted", lambda cfg: False)
        records = {"jax": [], "port": []}
        mp.setattr(jax_validate, "Evaluator",
                   _recording(jax_validate.Evaluator, records["jax"]))
        mp.setattr(port_validate, "Evaluator",
                   _recording(port_validate.Evaluator, records["port"]))
        probs, knn = [], []
        real_step, real_knn = port_validate.make_eval_step, \
            port_validate._knn_revote

        def recording_step(cfg, models):
            step = real_step(cfg, models)

            def wrapped(batch):
                out = step(batch)
                probs.append((out[0].numpy(), out[1].numpy(),
                              batch["num_points"].numpy()))
                return out
            return wrapped

        def recording_knn(*a):
            out = real_knn(*a)
            knn.append(out[0])
            return out

        mp.setattr(port_validate, "make_eval_step", recording_step)
        mp.setattr(port_validate, "_knn_revote", recording_knn)
        logger = logging.getLogger("test_torch_validate")
        loggers = {"jax": JaxMetricLogger(), "port": MetricLogger()}
        evals = {
            "jax": jax_validate.validate(
                jcfg, jstate, jmodels,
                jax_build.build_dataloader(jcfg, "val", "target"),
                loggers["jax"], logger, pselab_dir=str(root / "jax"), **kw),
            "port": port_validate.validate(
                pcfg, pmodels, build.build_dataloader(pcfg, "val", "target"),
                loggers["port"], logger, pselab_dir=str(root / "port"),
                **kw)}
    finally:
        mp.undo()
    return dict(evals=evals, records=records, probs=probs, knn=knn,
                loggers=loggers, root=root)


@pytest.fixture(scope="module")
def run(nets, tmp_path_factory):
    pmodels = nets[4]
    before = {k: v.clone() for m in pmodels[:2]
              for k, v in m.state_dict().items()}
    out = _validate_both(nets, tmp_path_factory.mktemp("validate"),
                         nets[:2], entropy_fuse=True)
    out["after"] = {k: v.clone() for m in pmodels[:2]
                    for k, v in m.state_dict().items()}
    out.update(before=before, cfgs=nets[:2], pmodels=pmodels)
    return out


@pytest.fixture(scope="module")
def knn_run(nets, tmp_path_factory):
    """Both packages validate with ``VAL.use_knn`` and ``VAL.knn_prob``."""
    cfgs = smoke_cfgs(**OPTS, **{"VAL.use_knn": True, "VAL.knn_prob": True})
    return _validate_both(nets, tmp_path_factory.mktemp("knn"), cfgs)


def _near_ties(run):
    """Per evaluator kind, per updated sample: the points whose top two
    probabilities (of the kind's fused probabilities) lie within NEAR."""
    out = {k: [] for k in KINDS}
    for p2, p3, num_points in run["probs"]:
        b = num_points.shape[0]
        p2 = p2.reshape(b, -1, p2.shape[-1]).astype(np.float64)
        p3 = p3.reshape(b, -1, p3.shape[-1]).astype(np.float64)
        e2 = np.exp(-(-p2 * np.log2(p2 + 1e-30)
                      / np.log2(p2.shape[-1])).sum(-1))[..., None]
        e3 = np.exp(-(-p3 * np.log2(p3 + 1e-30)
                      / np.log2(p3.shape[-1])).sum(-1))[..., None]
        fused = {"2D": p2, "3D": p3, "2D+3D": p2 + p3,
                 "xM_ety": e2 / (e2 + e3) * p2 + e3 / (e2 + e3) * p3}
        for kind, probs in fused.items():
            gap = _top_gap(probs)
            for bi in range(b):
                out[kind].append(gap[bi, :int(num_points[bi])] < NEAR)
    return out


def test_same_evaluators(run):
    assert list(run["evals"]["port"]) == list(run["evals"]["jax"]) == \
        list(KINDS)
    for kind in KINDS:
        assert run["evals"]["port"][kind].class_names == \
            run["evals"]["jax"][kind].class_names


@pytest.mark.parametrize("kind", KINDS)
def test_predictions_and_confusion_match_jax(run, kind):
    i = KINDS.index(kind)
    got, want = run["records"]["port"][i], run["records"]["jax"][i]
    near = _near_ties(run)[kind]
    assert len(got) == len(want) == len(near) == 16
    flips = total = 0
    for g, w, nr in zip(got, want, near):
        assert g.shape == w.shape == nr.shape
        diff = g != w
        assert not (diff & ~nr).any(), kind
        flips += int(diff.sum())
        total += g.size
    assert flips <= 0.01 * total
    cm_p = run["evals"]["port"][kind].confusion_matrix
    cm_j = run["evals"]["jax"][kind].confusion_matrix
    assert np.abs(cm_p - cm_j).sum() <= 2 * flips
    assert cm_p.sum() == cm_j.sum() > 0


def test_losses_match_jax(run):
    lp, lj = run["loggers"]["port"], run["loggers"]["jax"]
    for name in ("seg_loss_2d", "seg_loss_3d"):
        got, want = list(lp.meters[name].values), list(lj.meters[name].values)
        assert len(got) == len(want) == 8
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    for name in ("seg_iou_2d", "seg_iou_3d", "seg_iou_xM"):
        assert lp.meters[name].global_avg == pytest.approx(
            lj.meters[name].global_avg, abs=1e-3)


def test_pseudo_label_files_match_jax(run):
    root = run["root"]
    names = sorted(os.listdir(root / "jax"))
    assert names == sorted(os.listdir(root / "port"))
    assert len(names) == 16
    near = _near_ties(run)
    # the loader keeps dataset order: file i is updated sample i
    for i, name in enumerate(names):
        want = np.load(root / "jax" / name, allow_pickle=True).item()
        got = np.load(root / "port" / name, allow_pickle=True).item()
        assert set(got) == set(want) == {"probs_2d", "pseudo_label_2d",
                                         "probs_3d", "pseudo_label_3d"}
        for d, kind in (("2d", "2D"), ("3d", "3D")):
            g, w = got["pseudo_label_" + d], want["pseudo_label_" + d]
            assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
            same = g == w
            assert not (~same & ~near[kind][i]).any(), (name, d)
            np.testing.assert_allclose(got["probs_" + d][same],
                                       want["probs_" + d][same],
                                       rtol=LOSS_TOL, atol=LOSS_TOL)


def test_validation_moves_no_statistic(run):
    assert set(run["after"]) == set(run["before"])
    for k, v in run["before"].items():
        assert torch.equal(run["after"][k], v), k
    assert not run["pmodels"].model_2d.training


def test_train_step_after_validation_trains(run):
    _, pcfg = run["cfgs"]
    models = copy.deepcopy(run["pmodels"])  # left in eval mode by validate
    assert not models.model_2d.training
    state = port_trainer.create_train_state(pcfg, models)
    step = port_trainer.make_train_step(pcfg, models, with_pl=True)
    batches = [common.device_batch(next(iter(build.build_dataloader(
        pcfg, "train", dom, want_ema=False))), "cpu", strip_ema=True)
        for dom in ("source", "target")]
    means = {k: v.clone() for k, v in state.batch_stats_3d.items()}
    step(state, *batches)
    assert models.model_2d.training and models.model_3d.training
    assert any(not torch.equal(means[k], v)
               for k, v in state.batch_stats_3d.items())


def _knn_kw(cfg, prob):
    pc = cfg.TRAIN.PC_MM
    return dict(nclasses=cfg.MODEL_3D.NUM_CLASSES, fov_up=pc.fov_up,
                fov_down=pc.fov_down, proj_w=pc.proj_W, proj_h=pc.proj_H,
                k=cfg.TRAIN.XMUDA.knn_k, output_prob=prob)


@pytest.mark.parametrize("prob", [False, True])
def test_knn_scan_matches_jax(prob):
    """``knn_postprocess_scan`` on the val stream's scans, seeded random
    labels or probabilities: labels exact, summed probabilities to 1e-5."""
    from mopa_tpu.ops import knn as jax_knn
    from mopa_tpu_torch.ops import knn as port_knn

    _, pcfg = smoke_cfgs(**OPTS)
    kw = _knn_kw(pcfg, prob)
    rng = np.random.default_rng(8)
    step = jax.jit(jax.vmap(functools.partial(jax_knn.knn_postprocess_scan,
                                              **kw)))
    loader = build.build_dataloader(pcfg, "val", "target")
    for batch, _ in zip(loader, range(2)):
        pts, valid = batch["points_xyz"], batch["point_valid"]
        probs = rng.random(valid.shape + (kw["nclasses"],)).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        values = probs if prob else probs.argmax(-1).astype(np.int32)
        want = np.asarray(step(pts, valid, values))
        got = np.stack([port_knn.knn_postprocess_scan(
            torch.from_numpy(pts[i]), torch.from_numpy(valid[i]),
            torch.from_numpy(values[i]), **kw).numpy()
            for i in range(valid.shape[0])])
        assert got.shape == want.shape
        if prob:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
            assert (got[valid] != values[valid]).mean() > 0.1  # it re-votes


def test_knn_flips_an_outlier():
    """A lone mislabelled point among agreeing neighbours takes their
    label, as ``tests/test_validate_knn.py`` holds the JAX package's."""
    from mopa_tpu_torch.ops import knn as port_knn

    rng = np.random.default_rng(0)
    n = 64
    theta = rng.uniform(-0.05, 0.05, n)
    phi = rng.uniform(-0.02, 0.02, n)
    pts = np.stack([10 * np.cos(phi) * np.cos(theta),
                    10 * np.cos(phi) * np.sin(theta),
                    10 * np.sin(phi)], 1).astype(np.float32)
    labels = np.full(n, 2, np.int32)
    labels[0] = 7
    out = port_knn.knn_postprocess_scan(
        torch.from_numpy(pts), torch.ones(n, dtype=torch.bool),
        torch.from_numpy(labels), nclasses=8, fov_up=0.05235,
        fov_down=-0.43633, proj_w=64, proj_h=16)
    assert (out == 2).all()


def test_validate_with_knn_matches_jax(run, knn_run):
    """``VAL.use_knn`` + ``knn_prob``: the 2D predictions are the plain
    run's; the 3D and xM predictions equal JAX's except where the port's
    re-voted probabilities hold a near tie; the pseudo-label files carry
    the re-voted 3D labels."""
    rec, plain = knn_run["records"], run["records"]
    for g, w in zip(rec["port"][0], plain["port"][0]):
        np.testing.assert_array_equal(g, w)
    gaps = [gap for pr in knn_run["knn"] for gap in _top_gap(pr)]
    assert len(gaps) == len(rec["port"][1]) == len(rec["jax"][1]) == 16
    flips = total = changed = 0
    for g, w, gap, base in zip(rec["port"][1], rec["jax"][1], gaps,
                               plain["port"][1]):
        diff = g != w
        assert not (diff & (gap[:g.size] >= NEAR)).any()
        flips += int(diff.sum())
        total += g.size
        changed += int((g != base).sum())
    assert flips <= 0.01 * total and changed > 0
    for kind in (1, 2):
        cm_p = knn_run["evals"]["port"][KINDS[kind]].confusion_matrix
        cm_j = knn_run["evals"]["jax"][KINDS[kind]].confusion_matrix
        assert np.abs(cm_p - cm_j).sum() <= 2 * flips + 0.01 * cm_j.sum()
    name = sorted(os.listdir(knn_run["root"] / "port"))[0]
    got = np.load(knn_run["root"] / "port" / name, allow_pickle=True).item()
    np.testing.assert_array_equal(got["pseudo_label_3d"], rec["port"][1][0])


def test_kitti_pseudo_label_files_match_jax(nets, tmp_path):
    """On SemanticKITTI's on-disk fixture (the val sequence, 2 scans), the
    pseudo-label files carry the reference's KITTI keys, ``ori_keep_idx``
    and ``ori_img_points``, equal to JAX's, under ``<scene>/<frame>``."""
    from test_datasets_real_format import make_fake_kitti

    root = str(tmp_path / "kitti")
    make_fake_kitti(root, with_extras=False)
    cfgs = smoke_cfgs(**OPTS, **{
        "DATASET_TARGET.TYPE": "SemanticKITTISCN",
        "DATASET_TARGET.SemanticKITTISCN.root_dir": root,
        "DATASET_TARGET.VAL": ("val",)})
    out = _validate_both(nets, tmp_path, cfgs)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    files = sorted(str(f.relative_to(jdir)) for f in jdir.rglob("*.npy"))
    assert files == sorted(str(f.relative_to(pdir))
                           for f in pdir.rglob("*.npy"))
    assert files == ["07/000000.npy", "07/000001.npy"]
    for name in files:
        want = np.load(jdir / name, allow_pickle=True).item()
        got = np.load(pdir / name, allow_pickle=True).item()
        assert set(got) == set(want) == {
            "probs_2d", "pseudo_label_2d", "probs_3d", "pseudo_label_3d",
            "ori_keep_idx", "ori_img_points"}
        for k in ("ori_keep_idx", "ori_img_points"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for kind in KINDS[:3]:
        assert out["evals"]["port"][kind].class_names == \
            out["evals"]["jax"][kind].class_names
