"""The port's host utilities of the training and eval drivers against
``mopa_tpu``'s, on the same seeded inputs: the logger's format and file
layout, ``AverageMeter`` / ``MetricLogger`` (the 20-value window, tensor
inputs), ``iou_to_excel`` and the xlsx writer, ``get_md5``, ``purge_cfg``
on every shipped YAML, ``SegIoU`` and ``Evaluator`` (the ``print_table``
and ``save_table`` strings included, which the port writes without
``tabulate``) and ``pspath_sort``. All are host code: every comparison is
exact.
"""

import glob
import os
import re
import zipfile

import numpy as np
import pytest
import torch

from mopa_tpu.common import logger as jax_logger
from mopa_tpu.common import metric_logger as jax_ml
from mopa_tpu.common import xlsx as jax_xlsx
from mopa_tpu.common.config import purge_cfg as jax_purge
from mopa_tpu.common.io_utils import get_md5 as jax_md5
from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.data.pspath_sort import pspath_sort as jax_pspath
from mopa_tpu.data.utils.evaluate import Evaluator as JaxEvaluator
from mopa_tpu.models.metric import SegIoU as JaxSegIoU
from mopa_tpu_torch.common import logger as port_logger
from mopa_tpu_torch.common import metric_logger as port_ml
from mopa_tpu_torch.common import xlsx as port_xlsx
from mopa_tpu_torch.common.config import purge_cfg as port_purge
from mopa_tpu_torch.common.io_utils import get_md5 as port_md5
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.data.pspath_sort import pspath_sort as port_pspath
from mopa_tpu_torch.data.utils.evaluate import Evaluator as PortEvaluator
from mopa_tpu_torch.models.metric import SegIoU as PortSegIoU
from test_torch_config import PORT_ONLY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("car", "truck", "bike", "person", "road", "parking",
           "sidewalk", "building", "nature", "other-objects")
_STAMP = re.compile(r"^\[\d\d/\d\d \d\d:\d\d:\d\d\] ")


def _unstamped(text):
    return [_STAMP.sub("[T] ", ln) for ln in text.splitlines()]


def _log_both(tmp_path, capsys, output):
    """Each package's ``setup_logger`` (the same arguments but the name)
    logs an INFO and a WARNING line; returns {package: (console lines,
    file lines)} with the time stamps replaced."""
    out = {}
    for tag, mod in (("jax", jax_logger), ("port", port_logger)):
        name = "mopa_fmt_" + tag
        path = None if output is None else str(tmp_path / tag / output)
        log = mod.setup_logger(name, path, abbrev_name="MoPA")
        log.getChild("sub").info("hello %d", 3)
        log.warning("careful")
        for h in log.handlers:
            h.flush()
        console = _unstamped(capsys.readouterr().out.replace(name, "NAME"))
        lines = []
        if path is not None:
            f = path if path.endswith((".log", ".txt")) \
                else os.path.join(path, "log.txt")
            with open(f) as fh:
                lines = _unstamped(fh.read().replace(name, "NAME"))
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)
        out[tag] = (console, lines)
    return out


@pytest.mark.parametrize("output", [None, "run/x_train.log", "outdir"])
def test_logger_format_and_file_layout(tmp_path, capsys, output):
    got = _log_both(tmp_path, capsys, output)
    assert got["port"] == got["jax"]
    console, lines = got["port"]
    # the console abbreviates the names below the root; WARNING in colour
    assert console == ["[T] MoPA.sub INFO: hello 3",
                       "[T] NAME \x1b[33mWARNING\x1b[0m: careful"]
    if output is not None:
        # the console's formatter renamed the record before the file's
        # handler saw it, in both packages
        assert lines == ["[T] MoPA.sub INFO: hello 3",
                         "[T] NAME WARNING: careful"]


def test_get_logger_names_the_package():
    assert port_logger.get_logger().name == "mopa_tpu_torch"


def _feed(meter_logger, values, wrap):
    for v in values:
        meter_logger.update(loss=wrap(v), acc=np.float32(v / 2),
                            pair=(wrap(v * 3), 2))


@pytest.mark.parametrize("tensor", [False, True])
def test_metric_logger_matches_jax(tensor):
    """The port's meters fed 0-d tensors (or numbers) hold what JAX's hold
    fed the same float32 numbers."""
    values = np.random.default_rng(0).random(27).astype(np.float32).tolist()
    port, jax = port_ml.MetricLogger("  "), jax_ml.MetricLogger("  ")
    _feed(port, values, torch.tensor if tensor else np.float32)
    _feed(jax, values, np.float32)
    assert str(port) == str(jax)
    assert port.summary_str == jax.summary_str
    for name in ("loss", "acc", "pair"):
        p, j = port.meters[name], jax.meters[name]
        assert len(p.values) == 20  # the window
        assert list(p.values) == list(j.values)
        assert (p.avg, p.global_avg, p.count) == (j.avg, j.global_avg,
                                                  j.count)
    assert isinstance(port.meters["loss"].values[0], float)
    port.remove("acc")
    port.reset()
    assert list(port.meters) == ["loss", "pair"]
    assert np.isnan(port.loss.avg) and np.isnan(port.loss.global_avg)


def test_average_meter_window_matches_jax():
    p, j = port_ml.AverageMeter(window_size=3), jax_ml.AverageMeter(3)
    for v, c in ((1.0, 1), (2.0, 3), (4.0, 1), (8.0, 2)):
        p.update(v, c)
        j.update(v, c)
        assert (str(p), p.summary_str) == (str(j), j.summary_str)
    assert p.avg == (2.0 + 4.0 + 8.0) / 6


def _evaluators(seed, n_classes=len(CLASSES), empty=(5,)):
    """A port and a JAX ``Evaluator`` fed the same seeded predictions;
    the classes of ``empty`` have neither labels nor predictions (NaN
    IoU)."""
    rng = np.random.default_rng(seed)
    names = CLASSES[:n_classes]
    port, jax = PortEvaluator(names), JaxEvaluator(names)
    keep = [c for c in range(n_classes) if c not in empty]
    for n in (0, 50, 1000):
        gt = rng.choice(keep, n)
        gt[rng.random(n) < 0.1] = -100
        pred = np.where(rng.random(n) < 0.5, np.maximum(gt, 0),
                        rng.choice(keep, n))
        port.update(pred, gt)
        jax.update(pred, gt)
    return port, jax


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluator_matches_jax(seed, tmp_path):
    port, jax = _evaluators(seed)
    np.testing.assert_array_equal(port.confusion_matrix,
                                  jax.confusion_matrix)
    assert port.overall_acc == jax.overall_acc
    assert port.overall_iou == jax.overall_iou
    np.testing.assert_array_equal(port.class_iou, jax.class_iou)
    np.testing.assert_array_equal(port.class_seg_acc, jax.class_seg_acc)
    assert np.isnan(port.class_iou[5])
    assert port.print_table() == jax.print_table()
    port.save_table(str(tmp_path / "p.tsv"))
    jax.save_table(str(tmp_path / "j.tsv"))
    assert (tmp_path / "p.tsv").read_text() == (tmp_path / "j.tsv").read_text()


def test_evaluator_tables_on_edge_cases():
    """A fresh evaluator (every class NaN), one class, long names."""
    for names in (CLASSES, ("only",), ("a" * 30, "b")):
        port, jax = PortEvaluator(names), JaxEvaluator(names)
        assert port.print_table() == jax.print_table()
        port.update(np.zeros(7, int), np.zeros(7, int))
        jax.update(np.zeros(7, int), np.zeros(7, int))
        assert port.print_table() == jax.print_table()


def test_seg_iou_matches_jax():
    rng = np.random.default_rng(2)
    port, jax = PortSegIoU(10, name="seg_iou_2d"), JaxSegIoU(10)
    assert np.isnan(port.global_avg) and str(port) == str(jax)
    for _ in range(3):
        mat = rng.integers(0, 50, (10, 10))
        mat[3] = 0
        mat[:, 3] = 0
        port.update_mat(torch.from_numpy(mat).numpy())
        jax.update_mat(mat)
        np.testing.assert_array_equal(port.iou, jax.iou)
        assert port.global_avg == jax.global_avg
        assert (port.avg, str(port), port.summary_str) == (
            jax.avg, str(jax), jax.summary_str)
    port.reset()
    assert port.mat is None and port.name == "seg_iou_2d"


def test_iou_to_excel_rows_match_jax(tmp_path):
    port, jax = _evaluators(3)
    evals_p = {"2D": port, "3D": port, "2D+3D": port}
    evals_j = {"2D": jax, "3D": jax, "2D+3D": jax}
    mods = list(evals_p)
    for ext in ("xlsx", "csv"):
        a = port_ml.iou_to_excel(evals_p, str(tmp_path / ("p." + ext)), mods)
        b = jax_ml.iou_to_excel(evals_j, str(tmp_path / ("j." + ext)), mods)
        if ext == "csv":
            assert open(a).read() == open(b).read()
            continue
        rows = port_xlsx.read_xlsx_rows(a)
        assert rows == jax_xlsx.read_xlsx_rows(b)
        assert rows[0] == ["modality", *CLASSES, "overall_iou"]
        assert rows[1][6] == 0.0  # NaN IoU -> 0
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            assert za.namelist() == zb.namelist()
            for name in za.namelist():
                assert za.read(name) == zb.read(name), name


def test_xlsx_cells_round_trip(tmp_path):
    rows = [["s<&>", 1, 2.5, True, float("nan")], [], ["x" * 40]]
    a = port_xlsx.write_xlsx(str(tmp_path / "a.xlsx"), rows, "sheet")
    b = jax_xlsx.write_xlsx(str(tmp_path / "b.xlsx"), rows, "sheet")
    assert port_xlsx.read_xlsx_rows(a) == jax_xlsx.read_xlsx_rows(b) == [
        ["s<&>", 1.0, 2.5, True, "nan"], [], ["x" * 40]]


def test_get_md5_matches_jax(tmp_path):
    f = tmp_path / "blob"
    f.write_bytes(np.random.default_rng(4).bytes(3 << 20 | 17))
    assert port_md5(str(f)) == jax_md5(str(f))
    assert port_md5(str(f)) == __import__("hashlib").md5(
        f.read_bytes()).hexdigest()


SHIPPED = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                           recursive=True))


def _paths(node, prefix=""):
    out = set()
    for k, v in node.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _paths(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("path", SHIPPED,
                         ids=[os.path.relpath(p, ROOT) for p in SHIPPED])
def test_purge_cfg_on_shipped_configs(path):
    """Each package's purge removes the same keys from its own merged
    config (the port's defaults leave out a few TPU-only keys), and the
    purged trees agree on every key they share."""
    removed, kept = [], []
    for base, purge in ((jax_base_cfg, jax_purge), (port_base_cfg,
                                                    port_purge)):
        c = base.clone()
        c.merge_from_file(path)
        before = _paths(c)
        purge(c)
        removed.append(before - _paths(c))
        kept.append(c)
    # the port's own 3D nets' options (which JAX lacks) go with the rest
    assert {p for p in removed[1] if not (p + ".").startswith(PORT_ONLY)} \
        == removed[0]
    assert any(p.startswith("DATASET_SOURCE.") for p in removed[1])
    shared = _paths(kept[0]) & _paths(kept[1])
    for key in shared:
        a, b = kept[0], kept[1]
        for part in key.split("."):
            a, b = a[part], b[part]
        if not isinstance(a, dict):
            assert a == b, key
    ds = kept[1].DATASET_SOURCE
    assert ds.TYPE in ds and not any(
        k.endswith("SCN") and k != ds.TYPE for k in ds)


def test_pspath_sort_matches_jax():
    for kind, path in (("SemanticKITTISCN",
                        "/d/sequences/08/velodyne/000123.bin"),
                       ("NuScenesSCN", "/d/samples/LIDAR_TOP/abc.bin"),
                       ("SyntheticSCN", "synthetic/000004.bin")):
        for base in (jax_base_cfg, port_base_cfg):
            c = base.clone()
            c.DATASET_TARGET.TYPE = kind
            if base is jax_base_cfg:
                want = jax_pspath(c, path, "ps")
            else:
                got = port_pspath(c, path, "ps")
        assert got == want, kind
        assert got.endswith(".npy")
