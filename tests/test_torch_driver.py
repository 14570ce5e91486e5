"""The training driver on the CPU: the port's ``train()`` against
``mopa_tpu``'s, resumed from one JAX checkpoint through the EMA switch, and
the port's driver and CLIs on their own.

``configs/synthetic/mopa_smoke.yaml`` (float32, Adam, VGI on with host
plans, SAM, ``ema_start_iter`` 2), cut to fit a test as
``test_torch_loader_step.py`` cuts it: the SCN at m=4 with 3 levels,
64x48 images; dropout off on both sides (flax ``nn.Dropout`` patched to
the identity, the port's rate 0), because the two packages draw different
random bits.

JAX's ``train()`` runs the config to iteration 2 (checkpoints at 2); its
batch-norm biases (params and EMA) are then set to 2 in those files, as
``test_torch_train_step.py`` sets them, to keep ReLU inputs away from the
kink where the two frameworks' float32 forwards would part. Then each
package resumes a copy of that directory to iteration 4, in the EMA phase
from its first iteration, once with ``ema_xm_prob`` 0 and once with 1 (so
the teacher's fusion draw is the same on both sides), validating at 4.
Three of JAX's faults are patched in the test, as the earlier slices'
tests patch them: its resume reads optax's state by field name where its
writer wrote indices, and would restart Adam (``test_torch_checkpoint.py``;
its reader is patched to read by index); its host-plan decode pools the
unsorted VGI cat points wrongly (its loaders' cat points are key-sorted,
``test_torch_loader_step.py::_sorted_cat``); its eval plan assumes sorted
points (``_presorted`` patched to False). To save time, JAX's
checkpoints are pickled with protocol 4, as the port's are (the files load
the same), and its ``create_train_state`` is jitted, as the step tests
jit it (the resumed runs overwrite its values).

* Every iteration: the same metric keys, losses within ``LOSS_RTOL``
  (1e-3) relative; the source confusion matrices equal but for at most
  ``FLIPS`` (1 %) of their counts.
* The final checkpoints hold the same names; every tensor of the model,
  the EMA and the optimizer within ``PARAM_TOL`` (1e-3) x its tensor's
  largest value; counts and steps exact. Adam turns a gradient of rounding
  noise into a step of about the learning rate, so the tensors whose exact
  gradient is 0 or nearly so are held to ``NOISE_TOL``, the two resumed
  steps' worth of the learning rate on each side, and their moments are
  not compared: a conv bias that feeds a batch norm (its gradient is
  exactly 0), and the 3D stem, whose all-ones input makes its output vary
  only with the neighbour counts before a batch norm.
* The validation IoUs within 1e-3 and the ``val_class_iou.xlsx`` rows:
  the same strings, numbers within 1e-3.
* The port alone: ``train()`` from scratch on the CPU (finite losses, the
  checkpoint files, the ring, the xlsx, no loader or prefetch thread left,
  2 pool threads per loader, the loader wait as one ``loop/next_batch``
  span an iteration and the log's ``data`` meter), the baseline and xMUDA variants for 2
  iterations, ``TPU.DATA_PARALLEL`` > 1 without a process group raising,
  ``parse_args`` /
  ``load_cfg`` equal to JAX's, and each CLI's ``main`` raising before it
  builds anything when no GPU is visible.
"""

import logging
import math
import os
import pathlib
import shutil
import sys
import tempfile
import threading

import flax.linen
import numpy as np
import pytest
import torch

from mopa_tpu.common import checkpoint as jax_ckpt
from mopa_tpu.common.xlsx import read_xlsx_rows
from mopa_tpu.models import torch_compat
from mopa_tpu.train import common as jax_common
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.common import spans
from mopa_tpu_torch.common.logger import setup_logger
from mopa_tpu_torch.train import common
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_checkpoint import unflatten_by_index
from test_torch_data_path import SMOKE, smoke_cfgs
from test_torch_loader_step import _sorted_cat
from test_torch_train_step import _identity_dropout

torch.set_num_threads(1)

LOSS_RTOL = 1e-3
PARAM_TOL = 1e-3
IOU_TOL = 1e-3
FLIPS = 0.01
LR = 1e-3
NOISE_TOL = 2 * 2 * LR
NOISE = (".conv.bias", ".tconv.bias", "net_3d.stem")
OPTS = {"MODEL_3D.SCN.m": 4, "MODEL_3D.SCN.num_planes": 3,
        "DATASET_SOURCE.SyntheticSCN.image_size": (64, 48),
        "DATASET_TARGET.SyntheticSCN.image_size": (64, 48),
        "TRAIN.CHECKPOINT_PERIOD": 2}
_THREADS = ("mopa-loader", "mopa-prefetch")


class _SortedCat:
    """A JAX loader whose target batches carry key-sorted cat points."""

    def __init__(self, loader):
        self.loader = loader
        self.dataset = loader.dataset

    def __iter__(self):
        for batch in self.loader:
            yield _sorted_cat(batch) if "cat_valid" in batch else batch

    def __len__(self):
        return len(self.loader)


def _recorder(make_step, out):
    """``make_train_step`` whose steps append their host metrics to
    ``out`` (the outermost call only: JAX's EMA step calls the pre-EMA
    one)."""
    depth = [0]

    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(state, src, trg):
            depth[0] += 1
            try:
                state, metrics = step(state, src, trg)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                out.append({k: np.asarray(v.cpu() if torch.is_tensor(v)
                                          else v) for k, v in metrics.items()})
            return state, metrics
        return recorded
    return make


def _port_models(build_models):
    def build(*args, **kwargs):
        models = build_models(*args, **kwargs)
        models.model_2d.net_2d.dropout_rate = 0.0
        return models
    return build


def _logger(name):
    log = logging.getLogger("test_torch_driver." + name)
    log.setLevel(logging.WARNING)
    return log


def _copy_run(src, dst):
    """The checkpoints (hard links) and pointer files of a run directory,
    without the ring (it names the source directory's files)."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if name.endswith(".pth"):
            os.link(os.path.join(src, name), os.path.join(dst, name))
        elif name.startswith("last_checkpoint"):
            shutil.copy(os.path.join(src, name), dst)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _lift_bn_biases(run_dir):
    """Set every batch-norm bias (params and EMA; a ``.bias`` beside a
    ``.scale``) of a run directory's checkpoints to 2."""
    for name in os.listdir(run_dir):
        if not name.endswith(".pth"):
            continue
        path = os.path.join(run_dir, name)
        ckpt = _load(path)
        for part, prefix in (("model", "params."), ("ema", "")):
            for k in ckpt[part]:
                if k.startswith(prefix) and k.endswith(".bias") \
                        and k[:-len("bias")] + "scale" in ckpt[part]:
                    ckpt[part][k] = np.full_like(ckpt[part][k], 2.0)
        torch.save(ckpt, path, pickle_protocol=4)


def _jax_patches(mp):
    import jax

    real_create = jax_trainer.create_train_state
    mp.setattr(jax_trainer, "create_train_state",
               lambda cfg, models, example, seed=None: jax.jit(
                   lambda b: real_create(cfg, models, b, seed))(example))
    mp.setattr(flax.linen, "Dropout", _identity_dropout)
    mp.setattr(jax_trainer, "_presorted", lambda cfg: False)
    mp.setattr(torch_compat, "unflatten_into", unflatten_by_index)
    real_build = jax_common.build_dataloader
    mp.setattr(jax_common, "build_dataloader",
               lambda *a, **kw: _SortedCat(real_build(*a, **kw)))
    real_save = jax_ckpt.torch.save
    mp.setattr(jax_ckpt.torch, "save", lambda obj, f, **kw: real_save(
        obj, f, **{"pickle_protocol": 4, **kw}))


@pytest.fixture
def tmp_path():
    """A directory removed after the test: a run writes ~0.4 GB per 2D
    checkpoint, which pytest's kept temporary directories would pile up."""
    path = tempfile.mkdtemp(prefix="mopa-driver-test-")
    yield pathlib.Path(path)
    shutil.rmtree(path, ignore_errors=True)


def _file_diffs(got_path, want_path):
    """Two checkpoints side by side: their top-level keys, iterations and
    schedulers, and per part and name the dtypes and shapes and the
    largest difference beside the reference's largest value."""
    got, want = _load(got_path), _load(want_path)
    out = {"keys": (set(got), set(want)),
           "iteration": (got["iteration"], want["iteration"]),
           "scheduler": (got["scheduler"], want["scheduler"]), "parts": {}}
    for part in ("model", "ema", "optimizer"):
        rows = {}
        for k, w in want[part].items():
            g = got[part].get(k)
            if g is None or g.shape != w.shape:
                rows[k] = (False, 0.0, 0.0)
                continue
            diff = float(np.abs(g.astype(np.float64) - w).max()) \
                if g.size else 0.0
            rows[k] = (g.dtype == w.dtype, diff,
                       float(np.abs(w).max()) if w.size else 0.0)
        out["parts"][part] = (set(got[part]), set(want[part]), rows)
    return out


@pytest.fixture(scope="module")
def resumed():
    root = pathlib.Path(tempfile.mkdtemp(prefix="mopa-driver-test-"))
    out = {"metrics": {}, "evals": {}, "files": {}, "xlsx": {}}
    mp = pytest.MonkeyPatch()
    try:
        _jax_patches(mp)
        jcfg, _ = smoke_cfgs(**OPTS, **{"SCHEDULER.MAX_ITERATION": 2,
                                        "VAL.PERIOD": 0})
        start = str(root / "start")
        os.makedirs(start)
        jax_common.train(jcfg, _logger("jax"), start, "run", "mopa")
        _lift_bn_biases(start)
        for x in (0.0, 1.0):
            cfgs = smoke_cfgs(**OPTS, **{"TRAIN.PC_MM.ema_xm_prob": x})
            dirs = {}
            for tag, pkg, cfg in (("jax", jax_common, cfgs[0]),
                                  ("port", common, cfgs[1])):
                key = (tag, x)
                dirs[tag] = run_dir = str(root / "{}_{}".format(*key))
                _copy_run(start, run_dir)
                metrics = out["metrics"][key] = []
                trainer = jax_trainer if tag == "jax" else port_trainer
                with pytest.MonkeyPatch.context() as m2:
                    m2.setattr(trainer, "make_train_step", _recorder(
                        trainer.make_train_step, metrics))
                    kw = {}
                    if tag == "port":
                        m2.setattr(port_trainer, "build_models",
                                   _port_models(port_trainer.build_models))
                        kw["device"] = "cpu"
                    _, ev = pkg.train(cfg, _logger(tag), run_dir, "run",
                                      "mopa", **kw)
                out["evals"][key] = {k: v.overall_iou for k, v in ev.items()}
                out["xlsx"][key] = read_xlsx_rows(
                    os.path.join(run_dir, "val_class_iou.xlsx"))
            for which in ("2d", "3d"):
                name = "model_{}_000004.pth".format(which)
                out["files"][(x, which)] = _file_diffs(
                    os.path.join(dirs["port"], name),
                    os.path.join(dirs["jax"], name))
            for d in dirs.values():
                shutil.rmtree(d)
    finally:
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)
    return out


@pytest.mark.parametrize("x", [0.0, 1.0])
def test_resumed_iterations_match_jax(resumed, x):
    got, want = resumed["metrics"][("port", x)], resumed["metrics"][("jax", x)]
    assert len(got) == len(want) == 2
    for pm, jm in zip(got, want):
        assert set(pm) == set(jm)
        assert "pc_mm_loss" in pm and int(pm["vgi_inserted"]) == int(
            jm["vgi_inserted"]) > 0
        for k in jm:
            if k.startswith("cm_"):
                assert pm[k].sum() == jm[k].sum() > 0
                assert np.abs(pm[k] - jm[k]).sum() <= 2 * FLIPS * jm[k].sum()
            elif k.endswith("loss"):
                assert np.isfinite(pm[k]), k
                np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_RTOL,
                                           atol=1e-7, err_msg=k)


@pytest.mark.parametrize("x", [0.0, 1.0])
@pytest.mark.parametrize("which", ["2d", "3d"])
def test_resumed_checkpoints_match_jax(resumed, x, which):
    f = resumed["files"][(x, which)]
    assert f["keys"][0] == f["keys"][1]
    assert f["iteration"] == (4, 4)
    assert f["scheduler"] == ({"last_epoch": 4}, {"last_epoch": 4})
    counts = 0
    for part, (got_names, want_names, rows) in f["parts"].items():
        assert got_names == want_names, part
        for k, (same_dtype, diff, scale) in rows.items():
            assert same_dtype, (part, k)
            if k.endswith(NOISE):
                if part != "optimizer":
                    assert diff <= NOISE_TOL, (part, k, diff)
            elif part == "optimizer" and not k.startswith(("0.1.", "0.2.")):
                assert diff == 0, (part, k)  # the counts
                counts += 1
            else:
                assert diff <= PARAM_TOL * scale + 1e-12, (part, k, diff,
                                                           scale)
    assert counts == 2


@pytest.mark.parametrize("x", [0.0, 1.0])
def test_resumed_validation_matches_jax(resumed, x):
    got, want = resumed["evals"][("port", x)], resumed["evals"][("jax", x)]
    assert list(got) == list(want) == ["2D", "3D", "2D+3D"]
    for k in want:
        assert abs(got[k] - want[k]) <= IOU_TOL, k
    rows = [resumed["xlsx"][(tag, x)] for tag in ("port", "jax")]
    assert len(rows[0]) == len(rows[1]) == 4
    for rp, rj in zip(*rows):
        assert len(rp) == len(rj)
        for a, b in zip(rp, rj):
            if isinstance(b, str):
                assert a == b
            else:
                assert abs(a - b) <= IOU_TOL


def _alive():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(_THREADS)]


@pytest.fixture(scope="module")
def scratch_run():
    """The port's ``train()`` from scratch: 4 iterations, 2 pool threads
    per loader, checkpoints at 2 and 4, validation at 4."""
    run_dir = tempfile.mkdtemp(prefix="mopa-driver-test-")
    try:
        yield _scratch_run(run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _scratch_run(run_dir):
    """Run 1 to iteration 4 with validation, then run 2 on the same
    directory to 5 without: it resumes at 4."""
    metrics, seen, calls, loaders = [], [], [], []
    with pytest.MonkeyPatch.context() as mp:
        real_make, real_prefetch = port_trainer.make_train_step, \
            common.device_prefetch
        real_build = common.build_dataloader

        def make(*a, **kw):
            calls.append(kw.get("with_ema"))
            return real_make(*a, **kw)

        def prefetch(*a, **kw):
            for batch in real_prefetch(*a, **kw):
                seen.append(_alive())
                yield batch

        def build_dataloader(cfg, mode="train", domain="source",
                             start_iteration=0, want_ema=None):
            loaders.append((mode, domain, start_iteration, want_ema))
            return real_build(cfg, mode, domain, start_iteration, want_ema)

        mp.setattr(port_trainer, "make_train_step", _recorder(make, metrics))
        mp.setattr(common, "device_prefetch", prefetch)
        mp.setattr(common, "build_dataloader", build_dataloader)
        log_file = os.path.join(run_dir, "logs", "train.log")
        logger = setup_logger("mopa_tpu_torch.test_driver", log_file,
                              color=False)
        out = {}
        for run, opts in (("first", {}), ("second", {
                "SCHEDULER.MAX_ITERATION": 5, "VAL.PERIOD": 0})):
            _, pcfg = smoke_cfgs(workers=2, **OPTS, **opts,
                                 **{"TRAIN.MAX_TO_KEEP": 1})
            del calls[:], loaders[:]
            with spans.recording() as rec:
                state, ev = common.train(pcfg, logger, run_dir, "run",
                                         "mopa", device="cpu")
            out[run] = dict(
                spans=list(rec.spans),
                files=set(os.listdir(run_dir)), state=state, evals=ev,
                calls=list(calls), loaders=list(loaders), alive=_alive(),
                metrics=list(metrics),
                ring=open(os.path.join(run_dir,
                                       "checkpoint_ring_2d")).read().split())
            if run == "first":
                out[run]["rows"] = read_xlsx_rows(
                    os.path.join(run_dir, "val_class_iou.xlsx"))
            del metrics[:]
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
    out["first"]["seen"] = seen
    out["first"]["log"] = open(log_file).read()
    return out


def test_train_from_scratch(scratch_run):
    run = scratch_run["first"]
    assert run["state"].step == 4
    assert len(run["metrics"]) == 4
    for m in run["metrics"]:
        assert all(np.isfinite(v).all() for v in m.values())
        assert "pc_mm_loss" in m and int(m["vgi_inserted"]) > 0
    # MAX_TO_KEEP 1: the ring dropped the checkpoints of iteration 2
    assert {"model_2d_000004.pth", "model_3d_000004.pth",
            "last_checkpoint_2d", "last_checkpoint_3d", "checkpoint_ring_2d",
            "best_val_xM_2d.pth", "best_val_xM_3d.pth",
            "val_class_iou.xlsx"} <= run["files"]
    assert "model_2d_000002.pth" not in run["files"]
    rows = run["rows"]
    assert [r[0] for r in rows] == ["modality", "2D", "3D", "2D+3D"]
    assert rows[1][-1] == round(run["evals"]["2D"].overall_iou, 4)
    assert "iter:    4" in run["log"]
    assert "Iteration[4]-Val" in run["log"]
    assert "data: " in run["log"]


def test_train_spans_the_loader_wait(scratch_run):
    """Each iteration's wait for its batches is one ``loop/next_batch``
    span, outside the step's ``train/step`` span, which carries the
    state's step."""
    for run, first in (("first", 0), ("second", 4)):
        got = scratch_run[run]["spans"]
        n = scratch_run[run]["state"].step - first
        waits = [s for s in got if s.name == "loop/next_batch"]
        steps = [s for s in got if s.name == port_trainer.STEP_SPAN]
        assert len(waits) == n and [s.parent for s in waits] == [None] * n
        assert [s.step for s in steps] == list(range(first, first + n))
        assert all(w.end_ns <= s.start_ns for w, s in zip(waits, steps))


def test_train_switches_to_the_ema_step(scratch_run):
    """The pre-EMA step, then at ``ema_start_iter`` the EMA step, and
    both train loaders rebuilt there, the target's with the teacher's
    inputs."""
    run = scratch_run["first"]
    assert run["calls"] == [False, True]
    assert [ld for ld in run["loaders"] if ld[0] == "train"] == [
        ("train", "source", 0, False), ("train", "target", 0, False),
        ("train", "source", 2, False), ("train", "target", 2, True)]


def test_train_leaves_no_thread(scratch_run):
    # the loaders' pool and producer threads ran beside the prefetch ones
    assert any(any(n.startswith("mopa-loader-pool") for n in names)
               for names in scratch_run["first"]["seen"])
    assert scratch_run["first"]["alive"] == []
    assert scratch_run["second"]["alive"] == []


def test_train_resumes_in_place(scratch_run):
    """A second ``train()`` on the same directory resumes at its last
    checkpoint: its loaders start there in the EMA phase, it ends at the
    new ``MAX_ITERATION`` and the ring keeps ``MAX_TO_KEEP`` files."""
    run = scratch_run["second"]
    assert run["state"].step == 5 and len(run["metrics"]) == 1
    assert math.isfinite(float(run["metrics"][0]["total_loss"]))
    assert [ld for ld in run["loaders"] if ld[0] == "train"] == [
        ("train", "source", 4, False), ("train", "target", 4, True)]
    assert [os.path.basename(p) for p in run["ring"]] == [
        "model_2d_000005.pth"]
    assert "model_2d_000004.pth" not in run["files"]
    assert run["evals"] == {}


@pytest.mark.parametrize("variant", ["baseline", "xmuda"])
def test_other_variants_train(tmp_path, variant):
    opts = dict(OPTS, **{"SCHEDULER.MAX_ITERATION": 2, "VAL.PERIOD": 0})
    if variant == "baseline":
        opts.update({"TRAIN.XMUDA.lambda_xm_trg": 0.0,
                     "TRAIN.XMUDA.lambda_pl": 0.0})
    _, pcfg = smoke_cfgs(**opts)
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_trainer, "make_train_step", _recorder(
            port_trainer.make_train_step, metrics))
        state, ev = common.train(pcfg, _logger("port"), str(tmp_path), "run",
                                 variant, device="cpu")
    assert state.step == 2 and ev == {}
    want = {"baseline": {"loss_src_2d", "loss_src_3d", "xm_loss_src_2d",
                         "xm_loss_src_3d", "total_loss"},
            "xmuda": {"loss_src_2d", "loss_src_3d", "xm_loss_src_2d",
                      "xm_loss_src_3d", "xm_loss_trg_2d", "xm_loss_trg_3d",
                      "pl_loss_trg_2d", "pl_loss_trg_3d", "total_loss"}}
    for m in metrics:
        assert {k for k in m if "loss" in k} == want[variant]
        assert all(np.isfinite(v).all() for v in m.values())
    assert {"model_2d_000002.pth", "model_3d_000002.pth"} <= set(
        os.listdir(tmp_path))
    assert _alive() == []


def test_data_parallel_raises(tmp_path):
    """``TPU.DATA_PARALLEL`` 2 without a process group raises
    ``parallel.mesh``'s own error before anything is built (data-parallel
    training itself is held by ``test_torch_data_parallel_train.py``)."""
    _, pcfg = smoke_cfgs(**OPTS, **{"TPU.DATA_PARALLEL": 2})
    with pytest.raises(RuntimeError, match="none is initialised"):
        common.train(pcfg, _logger("port"), str(tmp_path), "run", "mopa",
                     device="cpu")
    assert os.listdir(tmp_path) == []


ARGVS = [["--cfg", SMOKE, "TRAIN.BATCH_SIZE", "4", "OUTPUT_DIR", "out"],
         ["--task", "T", "--resume_dir", "r", "--cfg", SMOKE],
         ["--cfg", SMOKE, "--model_prefix", "m", "--pselab_dir", "ps",
          "VAL.BATCH_SIZE", "3"]]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_and_load_cfg_match_jax(monkeypatch, argv):
    test_args = "--model_prefix" in argv
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    got = common.parse_args("d", "default.yaml", with_test_args=test_args)
    want = jax_common.parse_args("d", "default.yaml",
                                 with_test_args=test_args)
    assert vars(got) == vars(want)
    cp, cj = common.load_cfg(got), jax_common.load_cfg(want)
    assert cp.is_frozen()

    def flat(node, prefix=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "."))
            else:
                out[prefix + k] = v
        return out
    fp, fj = flat(cp), flat(cj)
    assert set(fp) <= set(fj)  # the port leaves out TPU-only keys
    assert {k: fj[k] for k in fp} == fp


def test_prepare_output_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", "--cfg", "configs/x/y.yaml"])
    args = common.parse_args("d", "default.yaml")
    _, pcfg = smoke_cfgs(**{"OUTPUT_DIR": str(tmp_path)})
    first = common.prepare_output_dir(pcfg, args)
    second = common.prepare_output_dir(pcfg, args)
    assert first[0] != second[0] and second[0] == first[0] + "-1"
    assert first[0].startswith(os.path.join(str(tmp_path), "models"))
    assert first[0].endswith("configs_x_y_torch")
    assert os.path.isdir(os.path.join(first[0], "logs"))
    assert first[2].startswith(os.path.join(first[0], "logs", "MoPA_train_"))


@pytest.mark.parametrize("module", ["train.train_baseline",
                                    "train.train_xmuda",
                                    "train.train_xmuda_mopa", "test.test"])
def test_cli_raises_without_a_gpu(tmp_path, monkeypatch, module):
    import importlib

    assert not torch.cuda.is_available()
    mod = importlib.import_module("mopa_tpu_torch." + module)
    monkeypatch.setattr(sys, "argv", ["prog", "--cfg", SMOKE, "OUTPUT_DIR",
                                      str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main()
    assert not os.path.exists(tmp_path / "out")
