"""The port's data path against ``mopa_tpu``'s, byte for byte per seed.

* ``IterationBasedBatchSampler``: the index stream, fresh and resumed at
  ``start_iter``, shuffled or not, with and without ``drop_last``.
* ``set_random_seed`` / ``worker_rng``, ``color_jitter``,
  ``make_rotation`` / ``augment_and_scale_3d``, the host refinements
  (``refine_pseudo_labels_np``, ``refine_sam_2Dlabels``,
  ``refine_sam_mask``) and the raw scan reads (with their row capacity).
* ``SyntheticSCN.__getitem__`` per index for each flag set that
  ``configs/synthetic/mopa_smoke.yaml`` uses, train and val, and the
  learnable mode with several objects.
* ``collate_padded`` on every key, dtype and ``_meta`` entry: key-sorted or
  not, host plans, host VGI, the capacity audit on and off, samples over
  the budget (the strided pick of every point group, ``ema_map`` and the
  eval restore mask remapped), SAM id remaps into small and large budgets,
  the float32 fallback of the raw VGI points.
* ``build_dataloader`` on ``mopa_smoke.yaml`` at ``NUM_WORKERS`` 0: the same
  batches per domain and mode, with ``want_ema`` True and False and
  ``start_iteration`` 2. At ``NUM_WORKERS`` 3 only the order
  (``_meta.lidar_path``), the keys, shapes and dtypes: the datasets draw
  from one generator shared by the pool's threads, in JAX too. A threaded
  loader abandoned early returns; an exception in a sample reaches the
  consumer (in JAX it stops the producer thread and the consumer waits
  forever: ROADMAP Queue 3).
* ``device_batch``: the key set, values and dtypes of JAX's for
  ``strip_ema`` True and False and ``strip_keys=("seg_label",)``.
  ``device_prefetch``: the order, a worker's exception re-raised, a stop
  on abandon (its thread and the loader's end).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.common import rng as jax_rng
from mopa_tpu.common import sampler as jax_sampler
from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.data import build as jax_build
from mopa_tpu.data import collate as jax_collate
from mopa_tpu.data import native_loader as jax_nl
from mopa_tpu.data import synthetic as jax_synthetic
from mopa_tpu.data.utils import augmentation_3d as jax_aug
from mopa_tpu.data.utils import image_aug as jax_image_aug
from mopa_tpu.data.utils import refine_pseudo_labels as jax_refine
from mopa_tpu.train import common as jax_common
from mopa_tpu_torch.common import rng, sampler
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.data import build, collate, native_loader, synthetic
from mopa_tpu_torch.data.utils import augmentation_3d, image_aug
from mopa_tpu_torch.data.utils import refine_pseudo_labels as refine
from mopa_tpu_torch.models.scn_unet import capacity_schedule
from mopa_tpu_torch.train import common

SMOKE = "configs/synthetic/mopa_smoke.yaml"
LOADER_TIMEOUT_S = 20.0


def assert_same(got, want, tag=""):
    """Two nested results equal: the same keys, list lengths, dtypes,
    shapes and bytes."""
    if isinstance(want, dict):
        assert set(got) == set(want), (tag, sorted(set(got) ^ set(want)))
        for k in want:
            assert_same(got[k], want[k], "{}.{}".format(tag, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), tag
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, "{}[{}]".format(tag, i))
    elif isinstance(want, str) or want is None:
        assert got == want, (tag, got, want)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (tag, got.dtype, want.dtype)
        assert got.shape == want.shape, (tag, got.shape, want.shape)
        assert got.tobytes() == want.tobytes(), tag


def smoke_cfgs(workers=0, **opts):
    """``mopa_smoke.yaml`` merged into both packages' configs."""
    out = []
    for base in (jax_base_cfg, port_base_cfg):
        c = base.clone()
        c.merge_from_file(SMOKE)
        c.DATALOADER.NUM_WORKERS = workers
        for k, v in opts.items():
            node = c
            *path, leaf = k.split(".")
            for q in path:
                node = node[q]
            node[leaf] = v
        c.freeze()
        out.append(c)
    return out


def _smoke_dataset_kwargs(domain, train=True):
    """The SyntheticSCN kwargs of ``mopa_smoke.yaml``'s ``domain``."""
    cfg = smoke_cfgs()[1]
    kw = dict(cfg.get("DATASET_" + domain.upper()).SyntheticSCN)
    kw["output_orig"] = not train
    return kw


# ----- sampler, seeds, small host functions -------------------------------

@pytest.mark.parametrize("start_iter,shuffle,drop_last", [
    (0, True, True), (5, True, True), (3, False, True), (4, True, False)])
def test_sampler_stream_matches_jax(start_iter, shuffle, drop_last):
    args = (10, 3, 12)
    kw = dict(start_iter=start_iter, shuffle=shuffle, drop_last=drop_last,
              seed=7)
    got = list(sampler.IterationBasedBatchSampler(*args, **kw))
    want = list(jax_sampler.IterationBasedBatchSampler(*args, **kw))
    assert_same(got, want)
    assert len(got) == len(sampler.IterationBasedBatchSampler(*args, **kw))


def test_seeding_matches_jax():
    rng.set_random_seed(5)
    got = (np.random.random(3), torch.rand(2))
    jax_rng.set_random_seed(5)
    assert_same(got[0], np.random.random(3))
    rng.set_random_seed(5)
    assert torch.equal(torch.rand(2), got[1])
    assert_same(rng.worker_rng(3, 2).random(4),
                jax_rng.worker_rng(3, 2).random(4))


def test_color_jitter_matches_jax():
    img = np.random.default_rng(0).random((6, 9, 3)).astype(np.float32)
    for strengths in ((0.4, 0.4, 0.4), (0.0, 0.3, 0.0)):
        got = image_aug.color_jitter(img, strengths,
                                     np.random.default_rng(4))
        want = jax_image_aug.color_jitter(img, strengths,
                                          np.random.default_rng(4))
        assert_same(got, want)


@pytest.mark.parametrize("aug", [
    {}, {"noisy_rot": 0.1, "flip_y": 0.5, "rot_z": 6.2831, "transl": True},
    {"noisy_rot": 0.1, "flip_x": 0.5, "rot_z": 6.2831, "transl": True}])
def test_augment_and_scale_3d_matches_jax(aug):
    pts = np.random.default_rng(1).normal(0, 10, (500, 3)).astype(np.float32)
    got = augmentation_3d.augment_and_scale_3d(
        pts, 20, 4096, rng=np.random.default_rng(2), **aug)
    want = jax_aug.augment_and_scale_3d(pts, 20, 4096,
                                        rng=np.random.default_rng(2), **aug)
    assert_same(got, want)


def test_host_refinements_match_jax():
    r = np.random.default_rng(3)
    probs = r.random(400).astype(np.float32)
    labels = r.integers(0, 5, 400).astype(np.int32)
    assert_same(refine.refine_pseudo_labels_np(probs, labels),
                jax_refine.refine_pseudo_labels(probs, labels))
    h, w = 30, 40
    sam = np.repeat(np.repeat(r.integers(0, 30, (6, 8)), 5, 0), 5, 1)
    sam[:, :20] = 40  # a mask over half the image
    probs2 = r.random((400, 5)).astype(np.float32)
    pix = np.stack([r.integers(0, h, 400), r.integers(0, w, 400)], 1)
    assert_same(refine.refine_sam_2Dlabels(probs2, pix, sam),
                jax_refine.refine_sam_2Dlabels(probs2, pix, sam))
    for max_h in (None, 12):
        assert_same(refine.refine_sam_mask(sam.astype(np.uint8), max_h=max_h),
                    jax_refine.refine_sam_mask(sam.astype(np.uint8),
                                               max_h=max_h))


def test_raw_scan_reads_match_jax(tmp_path):
    r = np.random.default_rng(4)
    scan = r.random((300, 4)).astype(np.float32)
    labels = (r.integers(0, 260, 300) | (7 << 16)).astype(np.uint32)
    scan.tofile(tmp_path / "a.bin")
    labels.tofile(tmp_path / "a.label")
    assert_same(native_loader.read_scan(str(tmp_path / "a.bin")),
                jax_nl.read_scan(str(tmp_path / "a.bin")))
    assert_same(native_loader.read_labels(str(tmp_path / "a.label")),
                jax_nl.read_labels(str(tmp_path / "a.label")))
    # the C++ readers' capacity is a check here, not a cut
    n = native_loader.SCAN_CAPACITY + 1
    np.zeros((n, 4), np.float32).tofile(tmp_path / "big.bin")
    np.zeros(n, np.uint32).tofile(tmp_path / "big.label")
    with pytest.raises(ValueError, match="capacity"):
        native_loader.read_scan(str(tmp_path / "big.bin"))
    with pytest.raises(ValueError, match="capacity"):
        native_loader.read_labels(str(tmp_path / "big.label"))


# ----- SyntheticSCN ----------------------------------------------------------

SYNTHETIC_FLAVOURS = {
    # mopa_smoke.yaml's source and target streams, in train and in eval
    "source_train": (_smoke_dataset_kwargs("source"), {}),
    "target_train": (_smoke_dataset_kwargs("target"), {}),
    "target_train_no_ema": (_smoke_dataset_kwargs("target"),
                            {"with_ema": False}),
    "target_val": (_smoke_dataset_kwargs("target", train=False), {}),
    "learnable_multi_objs": (_smoke_dataset_kwargs("target"),
                             {"learnable": True, "multi_objs": True}),
}


@pytest.mark.parametrize("flavour", sorted(SYNTHETIC_FLAVOURS))
def test_synthetic_getitem_matches_jax(flavour):
    kw, extra = SYNTHETIC_FLAVOURS[flavour]
    kw = dict(kw, **extra)
    got_ds, want_ds = synthetic.SyntheticSCN(**kw), \
        jax_synthetic.SyntheticSCN(**kw)
    for index in (3, 0, 3):  # the second read of 3 comes from the cache
        assert_same(got_ds[index], want_ds[index], "{}[{}]".format(flavour,
                                                                   index))


@pytest.mark.parametrize("kw", [{"backbone": "SPVCNN"},
                                {"backbone": "SalsaNext"},
                                {"with_depth_label": True}],
                         ids=["spvcnn", "salsanext", "depth"])
def test_synthetic_unported_inputs_raise(kw):
    """The inputs of the other backbones and the depth labels (ported since
    they raised here): SPVCNN's xyz + intensity features, SalsaNext's range
    image and pixels (32 x 256), the dense depth label; samples and their
    key-sorted collate byte-equal to JAX's."""
    kw = dict(kw, length=4, n_points=2048, image_size=(128, 96))
    got_ds = synthetic.SyntheticSCN(**kw)
    want_ds = jax_synthetic.SyntheticSCN(**kw)
    got = [got_ds[i] for i in range(2)]
    want = [want_ds[i] for i in range(2)]
    for i in range(2):
        assert_same(got[i], want[i], "{}[{}]".format(kw, i))
    key = {"SPVCNN": "feats", "SalsaNext": "proj_in"}.get(
        kw.get("backbone"), "depth_label")
    assert np.asarray(got[0][key]).shape[-1] == {
        "feats": 4, "proj_in": 5, "depth_label": 1}[key]
    assert_same(collate.collate_padded(got, 1024, sort_points=True),
                jax_collate.collate_padded(want, 1024, sort_points=True),
                "collate")


# ----- collate_padded ---------------------------------------------------------

def _samples(n, n_points=2048, image_size=(128, 96), **flags):
    kw = dict(length=8, n_points=n_points, image_size=image_size, **flags)
    ds = jax_synthetic.SyntheticSCN(**kw)
    return [ds[i] for i in range(n)]


def _vgi_settings(pc_mm, levels, seed=11):
    return {"rng": np.random.default_rng(seed), "pc_mm": pc_mm,
            "aug": {}, "scale": 20.0, "full_scale": 4096,
            "front_axis_x": True, "num_levels": levels, "factors": None}


TARGET = dict(with_pseudo_labels=True, with_sam_mask=True, with_vgi=True,
              with_ema=True)
COLLATE_CASES = {
    "train_plans_vgi_audit": (TARGET, dict(point_budget=1024,
                                           sort_points=True, plans=True,
                                           vgi=True)),
    "train_plans_vgi_no_audit": (TARGET, dict(point_budget=1024,
                                              sort_points=True, plans=True,
                                              vgi=True, audit=False)),
    "unsorted_raw_vgi_inputs": (TARGET, dict(point_budget=1024)),
    "over_budget_every_group": (TARGET, dict(point_budget=256,
                                             sort_points=True)),
    "eval_over_budget": (dict(output_orig=True), dict(point_budget=300)),
    "sam_ids_past_a_small_budget": (dict(with_sam_mask=True,
                                         sam_mask_budget=40),
                                    dict(point_budget=1024, mask_budget=4)),
    "sam_ids_in_a_large_budget": (dict(with_sam_mask=True),
                                  dict(point_budget=1024, mask_budget=200)),
    "raw_points_past_int16": (TARGET, dict(point_budget=1024,
                                           far_points=True)),
}


@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_collate_padded_matches_jax(case):
    flags, opts = COLLATE_CASES[case]
    opts = dict(opts)
    samples = _samples(2, **flags)
    if opts.pop("far_points", False):
        for s in samples:
            s["ori_points"] = s["ori_points"] * np.asarray(
                [100.0, 100.0, 100.0, 1.0], np.float32)
    levels = 3
    jcfg, pcfg = smoke_cfgs()
    budget = opts.pop("point_budget")
    caps = capacity_schedule(budget, levels) if opts.pop("plans", False) \
        else None
    use_vgi = opts.pop("vgi", False)
    outs = []
    for fn, c in ((collate.collate_padded, pcfg),
                  (jax_collate.collate_padded, jcfg)):
        vgi = _vgi_settings(c.TRAIN.PC_MM, levels) if use_vgi else None
        outs.append(fn([dict(s) for s in samples], budget,
                       obj_budget=512, host_plan_capacities=caps,
                       vgi_host=vgi, **opts))
    got, want = outs
    assert_same(got, want, case)
    assert caps is None or "hp_rankn" in got
    if use_vgi:
        assert "hp_cat_rankn" in got and got["vgi_inserted"].any()
        assert ("_hp_cat_true_nums" in got) == opts.get("audit", True)


# ----- build_dataloader -------------------------------------------------------

LOADERS = [("source", "train", False), ("target", "train", False),
           ("target", "train", True), ("source", "val", None),
           ("target", "val", None)]


@pytest.mark.parametrize("domain,mode,want_ema", LOADERS)
def test_build_dataloader_matches_jax(domain, mode, want_ema):
    jcfg, pcfg = smoke_cfgs()
    if mode == "val":  # the shipped smoke config has no source val split
        jcfg, pcfg = smoke_cfgs(**{"DATASET_SOURCE.VAL": ("val",)})
    kw = dict(want_ema=want_ema,
              start_iteration=2 if mode == "train" else 0)
    got = build.build_dataloader(pcfg, mode, domain, **kw)
    want = jax_build.build_dataloader(jcfg, mode, domain, **kw)
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        assert_same(g, w, "batch {}".format(n))
        n += 1
    assert n == len(want) > 0
    if mode == "train":
        # a pass audits its first two batches
        assert "hp_rankn" in g and ("_hp_true_nums" in g) == (n <= 2)
        assert ("hp_ori_rankn" in g) == bool(want_ema)
        assert ("hp_cat_rankn" in g) == (domain == "target")


def test_point_budgets_and_dataset_types_match_jax():
    assert set(build.DATASET_TYPES) == set(jax_build.DATASET_TYPES)
    assert build.DEFAULT_POINT_BUDGET == jax_build.DEFAULT_POINT_BUDGET
    assert build.PREFETCH == jax_build.PREFETCH
    assert build.AUDIT_BATCHES == jax_build.DataLoader(
        None, [], 1).audit_batches
    jcfg, pcfg = smoke_cfgs()
    for t in build.DATASET_TYPES:
        assert build.point_budget_for(pcfg, t) == \
            jax_build.point_budget_for(jcfg, t)


def _threads(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix)]


def _wait_gone(prefix):
    deadline = time.perf_counter() + LOADER_TIMEOUT_S
    while _threads(prefix) and time.perf_counter() < deadline:
        time.sleep(0.05)
    return not _threads(prefix)


def test_threaded_loader_keeps_order_keys_shapes_and_dtypes():
    jcfg, pcfg = smoke_cfgs(workers=3)
    got = build.build_dataloader(pcfg, "train", "target", want_ema=True)
    want = jax_build.build_dataloader(jcfg, "train", "target", want_ema=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["_meta"]["lidar_path"] == w["_meta"]["lidar_path"]
        assert set(g) == set(w)
        for k in w:
            if k != "_meta":
                assert (g[k].shape, g[k].dtype) == (w[k].shape, w[k].dtype), k
        # the first two batches carry the capacity audit, later ones not
        assert ("_hp_true_nums" in g) == (i < 2)
    assert i == len(want) - 1 == 3
    assert _wait_gone("mopa-loader")


def test_threaded_loader_stops_when_abandoned():
    pcfg = smoke_cfgs(workers=2)[1]
    t0 = time.perf_counter()
    it = iter(build.build_dataloader(pcfg, "train", "target"))
    next(it)
    it.close()
    assert _wait_gone("mopa-loader")
    assert time.perf_counter() - t0 < LOADER_TIMEOUT_S


class _Failing:
    """A dataset whose third sample raises."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == 2:
            raise RuntimeError("bad sample 2")
        return self.ds[i]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_exception_reaches_the_consumer(workers):
    ds = _Failing(synthetic.SyntheticSCN(length=4, n_points=600,
                                         image_size=(32, 24)))
    loader = build.DataLoader(ds, [np.arange(2), np.arange(2, 4)], 256,
                              num_workers=workers)
    it = iter(loader)
    next(it)
    with pytest.raises(RuntimeError, match="bad sample 2"):
        next(it)
    assert _wait_gone("mopa-loader")


# ----- device_batch and device_prefetch ---------------------------------------

def _as_numpy(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("strip_ema,strip_keys", [
    (False, ()), (True, ()), (False, ("seg_label",)),
    (True, ("seg_label",))])
def test_device_batch_matches_jax(strip_ema, strip_keys):
    jcfg, pcfg = smoke_cfgs()
    host = next(iter(build.build_dataloader(pcfg, "train", "target",
                                            want_ema=True)))
    # a batch whose samples fill the budget ships its all-ones feats as
    # the feats_ones marker; it keeps the raw VGI inputs (no host VGI),
    # whose ori_points_valid both packages drop for their device VGI's
    # decode to rebuild from vgi_num_points
    full = collate.collate_padded(_samples(2, **TARGET), 256)
    for batch in (host, full):
        got = common.device_batch(batch, "cpu", strip_ema, strip_keys)
        want = jax_common.device_batch(batch, strip_ema, strip_keys)
        assert all(isinstance(v, torch.Tensor) for v in got.values())
        if batch is full:
            assert "ori_points_valid" not in want
            assert "ori_points_valid" not in got
            np.testing.assert_array_equal(
                common.decode_batch(got, "cpu")["ori_points_valid"],
                batch["ori_points_valid"])
        assert_same(_as_numpy(got), _as_numpy(want))
    assert "feats_ones" in got and "feats" not in got
    assert ("ema_map" in got) != strip_ema
    assert "seg_label" not in got or not strip_keys


def test_decode_widens_the_raw_vgi_wire_like_jax():
    """The raw VGI inputs of a collated target batch, through each
    package's device_batch and decode: ``ori_points`` from its int16 fixed
    point, ``ori_points_valid`` from ``vgi_num_points``, the labels
    widened; equal values."""
    batch = collate.collate_padded(_samples(2, **TARGET), 256)
    batch["proj_xy"] = np.arange(2 * 256 * 2, dtype=np.int16).reshape(
        2, 256, 2)
    assert batch["ori_points"].dtype == np.int16
    got = common.decode_batch(common.device_batch(batch, "cpu"), "cpu")
    want = jax_common.decode_batch(jax_common.device_batch(batch))
    for k in ("ori_points", "ori_points_valid", "ori_pseudo_label_3d",
              "proj_xy", "vgi_num_points", "obj_pc", "obj_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["ori_points"].dtype == torch.float32
    assert got["ori_pseudo_label_3d"].dtype == torch.int64


def test_device_batch_copies():
    batch = {"num_points": np.asarray([3, 4], np.int32),
             "img": np.zeros((2, 2, 2, 3), np.uint8)}
    got = common.device_batch(batch, "cpu")
    batch["img"][:] = 7
    assert int(got["img"].sum()) == 0


def test_device_prefetch_keeps_order():
    host = [{"num_points": np.asarray([i], np.int32),
             "seg_label": np.full(4, i, np.int16)} for i in range(6)]
    got = list(common.device_prefetch(iter(host), "cpu",
                                      strip_keys=("seg_label",)))
    assert [int(b["num_points"][0]) for b in got] == list(range(6))
    assert all(set(b) == {"num_points"} for b in got)
    assert _wait_gone("mopa-prefetch")


def test_device_prefetch_reraises_a_worker_exception():
    def gen():
        yield {"num_points": np.asarray([1], np.int32)}
        raise ValueError("loader broke")

    it = common.device_prefetch(gen(), "cpu")
    next(it)
    with pytest.raises(ValueError, match="loader broke"):
        next(it)


def test_device_prefetch_stops_when_abandoned():
    pcfg = smoke_cfgs(workers=2)[1]
    t0 = time.perf_counter()
    it = common.device_prefetch(
        build.build_dataloader(pcfg, "train", "source"), "cpu")
    next(it)
    it.close()
    assert _wait_gone("mopa-prefetch")
    assert _wait_gone("mopa-loader")
    assert time.perf_counter() - t0 < LOADER_TIMEOUT_S


def test_device_batch_decodes_like_jax():
    """The step's decode of a shipped batch equals JAX's on the keys both
    rebuild (masks, all-ones feats, batch indices, widened dtypes)."""
    jcfg, pcfg = smoke_cfgs()
    host = next(iter(build.build_dataloader(pcfg, "train", "target",
                                            want_ema=True)))
    got = common.decode_batch(common.device_batch(host, "cpu"), "cpu")
    want = jax_common.decode_batch(
        {k: jnp.asarray(v) for k, v in
         jax_common.device_batch(host).items()})
    assert "ori_batch_idx" not in want  # no ori_coords with hp_ori_* plans
    for k in ("point_valid", "ori_point_valid", "batch_idx", "feats",
              "ori_feats", "img", "ori_img", "ema_map", "sam_mask",
              "img_indices", "pseudo_label_3d"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
