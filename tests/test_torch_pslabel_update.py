"""The port's ``pslabel_update`` (``mopa_tpu_torch.data.utils.
pslabel_update``) against ``mopa_tpu``'s on SemanticKITTI's on-disk fixture
(``make_fake_kitti``: 3 target train scans), with one set of weights in
both packages (JAX's flax init bridged into the port through
``models.weights``; the nets of ``tests/test_torch_validate.py``, SCN at
m=4 with 3 levels), plain and with ``entropy_fuse``.

* Both write one file per scan under the same names, with the reference's
  KITTI keys; ``ori_keep_idx`` and ``ori_img_points`` equal; the labels
  equal except where the port's top two probabilities lie within ``NEAR``
  (1e-5) of each other, the probabilities within 1e-5 where the labels
  agree, as ``tests/test_torch_validate.py`` holds ``validate()``'s files.
  Each file is as long as its scan's points in the camera's view, with
  labels in [0, 10).
* The returned evaluators are JAX's (``xM_ety`` with ``entropy_fuse``).
* Both packages' ``SemanticKITTISCN`` crop even eval scans (the default
  ``bottom_crop`` (480, 302)) at a random offset from an unseeded RNG
  (ROADMAP Queue 3), so each dataset's RNG is seeded with 0 here.
* The port's ``SemanticKITTISCN`` with ``ps_label_dir`` at those files reads
  the labels back.
"""

import logging

import numpy as np
import pytest

from mopa_tpu.data.utils import pslabel_update as jax_pslabel
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.data.semantic_kitti import semantic_kitti_dataloader
from mopa_tpu_torch.data.utils import pslabel_update
from mopa_tpu_torch.data.utils import validate as port_validate
from test_datasets_real_format import make_fake_kitti
from test_torch_data_path import smoke_cfgs
from test_torch_validate import NEAR, OPTS, _top_gap, nets  # noqa: F401

FRAMES = 3
KEYS = {"probs_2d", "pseudo_label_2d", "probs_3d", "pseudo_label_3d",
        "ori_keep_idx", "ori_img_points"}


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return make_fake_kitti(str(tmp_path_factory.mktemp("kitti")),
                           scenes=("00",), frames=FRAMES, with_extras=False)


def _pslabel_both(nets, root, out, entropy_fuse):
    """Both packages' ``pslabel_update`` into ``out/jax`` and ``out/port``,
    with the port's eval-step probabilities recorded."""
    _, _, jmodels, jstate, pmodels = nets
    jcfg, pcfg = smoke_cfgs(**OPTS, **{
        "DATASET_TARGET.TYPE": "SemanticKITTISCN",
        "DATASET_TARGET.SemanticKITTISCN.root_dir": root})
    probs = []
    real_step = port_validate.make_eval_step

    def recording_step(cfg, models):
        step = real_step(cfg, models)

        def wrapped(batch):
            result = step(batch)
            probs.append((result[0].numpy(), result[1].numpy()))
            return result
        return wrapped

    def seeded_rng(seed=None, _rng=np.random.default_rng):
        return _rng(0 if seed is None else seed)

    logger = logging.getLogger("test_torch_pslabel_update")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np.random, "default_rng", seeded_rng)
        # JAX's eval plan assumes key-sorted points (ROADMAP Queue 3)
        mp.setattr(jax_trainer, "_presorted", lambda cfg: False)
        mp.setattr(port_validate, "make_eval_step", recording_step)
        evals = {
            "jax": jax_pslabel.pslabel_update(
                jcfg, jstate, jmodels, logger, str(out / "jax"),
                entropy_fuse=entropy_fuse),
            "port": pslabel_update.pslabel_update(
                pcfg, pmodels, logger, str(out / "port"),
                entropy_fuse=entropy_fuse)}
    return evals, probs


@pytest.mark.parametrize("entropy_fuse", [False, True])
def test_pslabel_files_match_jax(nets, kitti_root, tmp_path,  # noqa: F811
                                 entropy_fuse):
    evals, probs = _pslabel_both(nets, kitti_root, tmp_path, entropy_fuse)
    kinds = ["2D", "3D", "2D+3D"] + (["xM_ety"] if entropy_fuse else [])
    assert list(evals["port"]) == list(evals["jax"]) == kinds
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    files = sorted(str(f.relative_to(jdir)) for f in jdir.rglob("*.npy"))
    assert files == sorted(str(f.relative_to(pdir))
                           for f in pdir.rglob("*.npy"))
    assert files == ["00/{:06d}.npy".format(i) for i in range(FRAMES)]
    assert len(probs) == FRAMES  # VAL.BATCH_SIZE 1: one batch per scan
    for name, (p2, p3) in zip(files, probs):
        want = np.load(jdir / name, allow_pickle=True).item()
        got = np.load(pdir / name, allow_pickle=True).item()
        assert set(got) == set(want) == KEYS
        for k in ("ori_keep_idx", "ori_img_points"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        n = int(got["ori_keep_idx"].sum())
        for d, p in (("2d", p2), ("3d", p3)):
            g, w = got["pseudo_label_" + d], want["pseudo_label_" + d]
            assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape == (n,)
            assert g.max() < 10
            near = _top_gap(p.astype(np.float64))[:n] < NEAR
            same = g == w
            assert not (~same & ~near).any(), (name, d)
            np.testing.assert_allclose(got["probs_" + d][same],
                                       want["probs_" + d][same],
                                       rtol=1e-5, atol=1e-5)
    for kind in kinds:
        cm_p = evals["port"][kind].confusion_matrix
        cm_j = evals["jax"][kind].confusion_matrix
        assert cm_p.sum() == cm_j.sum() > 0
        assert np.abs(cm_p - cm_j).sum() <= 0.01 * cm_j.sum()


def test_dataset_reads_the_labels_back(nets, kitti_root,  # noqa: F811
                                       tmp_path):
    _, _, _, _, pmodels = nets
    _, pcfg = smoke_cfgs(**OPTS, **{
        "DATASET_TARGET.TYPE": "SemanticKITTISCN",
        "DATASET_TARGET.SemanticKITTISCN.root_dir": kitti_root})
    out = str(tmp_path / "ps")
    pslabel_update.pslabel_update(pcfg, pmodels,
                                  logging.getLogger("test"), out)
    ds = semantic_kitti_dataloader.SemanticKITTISCN(
        split=("train",), root_dir=kitti_root, merge_classes=True,
        ps_label_dir=out)
    assert len(ds) == FRAMES
    for i in range(FRAMES):
        written = np.load(tmp_path / "ps" / "00" / "{:06d}.npy".format(i),
                          allow_pickle=True).item()
        read = ds.data_extraction(i)
        for k in ("pseudo_label_2d", "pseudo_label_3d", "probs_2d",
                  "probs_3d", "ori_keep_idx"):
            np.testing.assert_array_equal(read[k], written[k])
        view = ds.preprocess(read)
        assert view["pseudo_label_3d"].shape == written[
            "pseudo_label_3d"].shape
