"""Seeded synthetic LiDAR + camera data: the dataset ``SyntheticSCN`` (port
of ``mopa_tpu/data/synthetic.py::SyntheticSCN``, which the loaders of
``data.build`` read), and ready-collated eval and train batches built from
the same scan geometry.

A scan is a ring-structured ground plane (fixed elevation angles hit the
plane at fixed ranges, like a LiDAR) plus random upright boxes in the front
frustum, projected by a KITTI-like pinhole camera; only points that land in
the image are kept. Points are scaled to 5 cm voxel coordinates (scale 20),
subsampled to the point budget with an evenly strided pick, and sorted by
voxel key per scan, as the reference's collate does for train batches. Train
batches add the target-domain keys of the pre-EMA MoPA step: offline pseudo
labels and SAM mask ids. No augmentation is applied, except to the student
view of a target batch that also carries the EMA teacher's unaugmented view
(``train_batch(..., with_ema=True)``). Target batches can carry the inputs
of VGI (``with_vgi``: the raw scan in meters, its ground mask, one object
to insert, the camera) and any batch its host-built voxel plans
(``host_plans``: ``data.collate``), with host VGI run on the batch.
"""

from __future__ import annotations

import numpy as np

from mopa_tpu_torch.data.collate import _lexkey
from mopa_tpu_torch.data.utils.augmentation_3d import augment_and_scale_3d
from mopa_tpu_torch.data.utils import inputs
from mopa_tpu_torch.data.utils.depth_label import dense_depth_label

# Seed base of the reference's per-index raw scans (SyntheticSCN.__getitem__).
SCAN_SEED = 20260817
# The 3D augmentation of the shipped MoPA config's target scans
# (configs/a2d2_semantic_kitti/xmuda_pl_mopa.yaml: SemanticKITTISCN's
# defaults with rot_z 0), which host VGI draws once per batch.
KITTI_TARGET_AUG = {"noisy_rot": 0.1, "flip_y": 0.5, "rot_z": 0.0,
                    "transl": True}
# Point slots per VGI object (the reference collate's obj_budget).
OBJ_BUDGET = 2048


def synthetic_scan(rng: np.random.Generator, n_points: int,
                   num_classes: int = 10):
    """Ground rings + boxes; returns (points (N, 3) float32, labels (N,),
    ground mask (N,))."""
    n_rings = 48
    per = max(n_points // 2 // n_rings, 1)
    thetas = np.linspace(-0.436, -0.035, n_rings)  # -25 .. -2 deg
    rr = np.clip(1.7 / np.tan(-thetas), 0.0, 60.0)
    az = rng.uniform(-0.5, 0.5, (n_rings, per))
    gx = (rr[:, None] * np.cos(az)).ravel()
    gy = (rr[:, None] * np.sin(az)).ravel()
    n_ground = gx.shape[0]
    gz = rng.normal(-1.7, 0.01, n_ground)
    pts = [np.stack([gx, gy, gz], 1)]
    labs = [np.full(n_ground, 4)]  # road
    remaining = n_points - n_ground
    while remaining > 0:
        m = min(remaining, int(rng.integers(200, 512)))
        cx = rng.uniform(4, 45)
        cy = cx * rng.uniform(-0.4, 0.4)
        c = int(rng.integers(0, num_classes))
        sx, sy = rng.uniform(0.4, 1.5, 2)
        sz = rng.uniform(0.5, 2.5)
        pts.append(np.stack([cx + rng.uniform(-sx, sx, m),
                             cy + rng.uniform(-sy, sy, m),
                             rng.uniform(-1.7, -1.7 + 2 * sz, m)], 1))
        labs.append(np.full(m, c))
        remaining -= m
    points = np.concatenate(pts).astype(np.float32)
    return (points, np.concatenate(labs).astype(np.int64),
            np.arange(points.shape[0]) < n_ground)


def project(points: np.ndarray, image_size):
    """Pinhole projection to (row, col); returns (img_points, keep)."""
    w, h = image_size
    f = 0.6 * w
    proj = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
    # camera frame: x right (= -y lidar), y down (= -z), z forward (= x)
    cam = np.stack([-points[:, 1], -points[:, 2], points[:, 0]], 1)
    uvw = (proj @ cam.T).T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)
    cols, rows = uv[:, 0], uv[:, 1]
    keep = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w) \
        & (points[:, 0] > 0.5)
    return np.stack([rows, cols], 1), keep


def eval_sample(index: int, n_points: int = 24000, image_size=(480, 302),
                scale: int = 20, full_scale: int = 4096,
                num_classes: int = 10, stream: int = 0) -> dict:
    """One scan: uint8 image (H, W, 3), img_indices (N, 2), coords (N, 3),
    seg_label (N,), and the points in meters (N, 3) with their ground mask
    (N,) (``points``, ``g_mask``; the inputs of VGI). ``stream`` > 0 draws
    from another seed sequence (the target domain of train batches)."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [SCAN_SEED, index] + ([stream] if stream else [])))
    points, labels, g_mask = synthetic_scan(rng, n_points, num_classes)
    img_points, keep = project(points, image_size)
    w, h = image_size
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    points, labels, g_mask = points[keep], labels[keep], g_mask[keep]
    img_points = img_points[keep]
    img_indices = np.floor(img_points).astype(np.int64)
    img_indices[:, 0] = np.clip(img_indices[:, 0], 0, h - 1)
    img_indices[:, 1] = np.clip(img_indices[:, 1], 0, w - 1)
    coords = np.round(points * scale)
    coords -= coords.min(0)
    inside = (coords.min(1) >= 0) & (coords.max(1) < full_scale)
    return {"img": image, "img_indices": img_indices[inside],
            "coords": coords[inside].astype(np.int64),
            "seg_label": labels[inside], "points": points[inside],
            "g_mask": g_mask[inside]}


def collate_eval(samples, point_budget: int) -> dict:
    """Pad scans to the point budget into one batch in the wire format:
    img (B, H, W, 3) uint8, img_indices (B, P, 2), coords (B*P, 3),
    seg_label (B*P,) (-100 at padding), num_points (B,), feats_ones (B, 1)
    (the all-ones SCN input feature). Each scan is key-sorted."""
    p = int(point_budget)
    b = len(samples)
    out = {"img": np.stack([s["img"] for s in samples]),
           "img_indices": np.zeros((b, p, 2), np.int64),
           "coords": np.zeros((b, p, 3), np.int64),
           "seg_label": np.full((b, p), -100, np.int64),
           "num_points": np.zeros(b, np.int64),
           "feats_ones": np.ones((b, 1), np.float32)}
    for i, s in enumerate(samples):
        n = s["coords"].shape[0]
        pick = np.arange(n) if n <= p else \
            np.linspace(0, n - 1, p).round().astype(np.int64)
        order = pick[np.argsort(_lexkey(s["coords"][pick]), kind="stable")]
        k = order.shape[0]
        out["img_indices"][i, :k] = s["img_indices"][order]
        out["coords"][i, :k] = s["coords"][order]
        out["seg_label"][i, :k] = s["seg_label"][order]
        out["num_points"][i] = k
    out["coords"] = out["coords"].reshape(b * p, 3)
    out["seg_label"] = out["seg_label"].reshape(b * p)
    return out


def eval_batch(batch_size: int, point_budget: int = 16384,
               start_index: int = 0, **sample_kwargs) -> dict:
    """A collated batch of scans ``start_index .. start_index+batch_size-1``."""
    return collate_eval([eval_sample(start_index + i, **sample_kwargs)
                         for i in range(batch_size)], point_budget)


def sam_mask(rng: np.random.Generator, image_size, mask_budget: int,
             block: int = 24) -> np.ndarray:
    """(H, W) int64 SAM-like mask ids in [-1, mask_budget): constant over
    ``block`` x ``block`` pixel tiles (regions, not pixel noise), -1 where
    no mask covers the tile."""
    w, h = image_size
    tiles = rng.integers(-1, mask_budget, ((h + block - 1) // block,
                                           (w + block - 1) // block))
    return np.repeat(np.repeat(tiles, block, 0), block, 1)[:h, :w].astype(
        np.int64)


def ema_views(sample: dict, point_budget: int, seed) -> tuple:
    """(student, ori, ema_map) of one scan for the EMA phase.

    ``ori`` is the teacher's unaugmented view: the scan picked to the budget
    with an evenly strided pick and key-sorted. The student view is another
    point set: a random 10 % of the ori points are dropped and as many points
    of the scan outside the ori pick take their place (none when the scan
    fits the budget); its coordinates are mirrored in y and its image is
    flipped left-right with its pixel columns. It is key-sorted too, so
    ``ema_map`` (student point -> its position in the sorted ori view, -1
    for a point the teacher did not see) holds shifted positions, as the
    reference's collate leaves it after sorting both views."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    coords, p = sample["coords"], int(point_budget)
    n = coords.shape[0]
    pick = np.arange(n) if n <= p else \
        np.linspace(0, n - 1, p).round().astype(np.int64)
    ori_ids = pick[np.argsort(_lexkey(coords[pick]), kind="stable")]
    k = ori_ids.shape[0]
    others = np.setdiff1d(np.arange(n), pick)
    n_new = min(k // 10, others.shape[0])
    kept = np.sort(rng.permutation(k)[:k - n_new])
    stu_ids = np.concatenate([ori_ids[kept],
                              rng.choice(others, n_new, replace=False)])
    stu_pos = np.concatenate([kept, np.full(n_new, -1)])
    stu_coords = coords[stu_ids].copy()
    stu_coords[:, 1] = coords[:, 1].max() - stu_coords[:, 1]
    order = np.argsort(_lexkey(stu_coords), kind="stable")
    img_indices = sample["img_indices"][stu_ids[order]].copy()
    w = sample["img"].shape[1]
    img_indices[:, 1] = w - 1 - img_indices[:, 1]
    student = {"img": np.ascontiguousarray(sample["img"][:, ::-1]),
               "img_indices": img_indices, "coords": stu_coords[order],
               "seg_label": sample["seg_label"][stu_ids[order]]}
    ori = {"img": sample["img"],
           "img_indices": sample["img_indices"][ori_ids],
           "coords": coords[ori_ids], "seg_label": sample["seg_label"][ori_ids]}
    return student, ori, stu_pos[order]


def lidar_projection(image_size) -> np.ndarray:
    """(3, 4) float32 lidar -> image matrix of :func:`project`'s camera."""
    w, h = image_size
    f = 0.6 * w
    proj = np.array([[f, 0, w / 2.0, 0], [0, f, h / 2.0, 0], [0, 0, 1, 0]],
                    np.float32)
    basis = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                      [0, 0, 0, 1]], np.float32)
    return proj @ basis


def vgi_inputs(samples, point_budget: int, image_size, seed) -> dict:
    """The raw VGI inputs of the reference's collated target batch, from
    each scan's points picked to the budget (strided, in scan order): the
    points in meters with an all-ones intensity column ``ori_points`` (B, P,
    4) float32, ``ori_points_valid`` (B, P), ``vgi_num_points`` (B,),
    ``g_mask`` (B, P) (the ground rings), ``ori_pseudo_label_3d`` (B, P)
    (the labels with 30 % dropped to -100), one object per scan of 96-255
    points in a 0.8 m box 5-12 m ahead (``obj_pc`` (B, 1, OBJ_BUDGET, 4),
    ``obj_valid``, ``obj_label`` (B, 1) int32 class 3), ``proj_matrix`` (B,
    3, 4) and ``img_size`` (B, 2) int32 (W, H)."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    b, p = len(samples), int(point_budget)
    out = {"ori_points": np.zeros((b, p, 4), np.float32),
           "vgi_num_points": np.zeros(b, np.int64),
           "g_mask": np.zeros((b, p), bool),
           "ori_pseudo_label_3d": np.full((b, p), -100, np.int64),
           "obj_pc": np.zeros((b, 1, OBJ_BUDGET, 4), np.float32),
           "obj_valid": np.zeros((b, 1, OBJ_BUDGET), bool),
           "obj_label": np.zeros((b, 1), np.int32),
           "proj_matrix": np.broadcast_to(lidar_projection(image_size),
                                          (b, 3, 4)).copy(),
           "img_size": np.tile(np.asarray(image_size, np.int32), (b, 1))}
    for i, smp in enumerate(samples):
        n = smp["points"].shape[0]
        pick = np.arange(n) if n <= p else \
            np.linspace(0, n - 1, p).round().astype(np.int64)
        k = pick.shape[0]
        out["ori_points"][i, :k, :3] = smp["points"][pick]
        out["ori_points"][i, :k, 3] = 1.0
        out["vgi_num_points"][i] = k
        out["g_mask"][i, :k] = smp["g_mask"][pick]
        label = smp["seg_label"][pick].copy()
        label[rng.random(k) < 0.3] = -100
        out["ori_pseudo_label_3d"][i, :k] = label
        m = int(rng.integers(96, 256))
        centre = np.array([rng.uniform(5, 12), rng.uniform(-2, 2),
                           rng.uniform(-1.6, -1.0)])
        out["obj_pc"][i, 0, :m, :3] = centre + rng.uniform(-0.4, 0.4, (m, 3))
        out["obj_pc"][i, 0, :m, 3] = rng.uniform(0, 1, m)
        out["obj_valid"][i, 0, :m] = True
        out["obj_label"][i, 0] = 3
    out["ori_points_valid"] = (np.arange(p)[None, :]
                               < out["vgi_num_points"][:, None])
    return out


def host_plan_settings(cfg, point_budget: int, seed: int = 0) -> dict:
    """What :func:`train_batch` needs to build host plans for ``cfg``:
    ``capacities`` (``capacity_schedule(point_budget)``, ``TPU.CAP_FACTORS``
    honoured) and, when ``TRAIN.PC_MM.lambda_pc_mm`` > 0, ``vgi``: the host
    VGI settings of ``data.collate._host_vgi_batch`` with a generator seeded
    by ``seed`` (:data:`KITTI_TARGET_AUG`, scale 20, full scale 4096, x
    forward)."""
    from mopa_tpu_torch.models.build import plan_levels
    from mopa_tpu_torch.models.scn_unet import capacity_schedule

    levels = plan_levels(cfg)
    factors = tuple(cfg.TPU.get("CAP_FACTORS", ())) or None
    out = {"capacities": capacity_schedule(int(point_budget), levels,
                                           factors=factors), "vgi": None}
    if float(cfg.TRAIN.PC_MM.lambda_pc_mm) > 0:
        out["vgi"] = {"rng": np.random.default_rng(seed),
                      "pc_mm": cfg.TRAIN.PC_MM,
                      "aug": dict(KITTI_TARGET_AUG),
                      "scale": 20.0, "full_scale": 4096,
                      "front_axis_x": True, "num_levels": levels,
                      "factors": factors}
    return out


def train_batch(batch_size: int, point_budget: int = 16384,
                start_index: int = 0, image_size=(480, 302),
                domain: str = "source", mask_budget: int = 64,
                num_classes: int = 10, with_ema: bool = False,
                with_vgi: bool = False, host_plans: dict | None = None
                ) -> dict:
    """A collated train batch of scans ``start_index ..`` of one domain, in
    the wire format of :func:`collate_eval`. The target domain draws other
    scans and adds ``pseudo_label_2d``/``pseudo_label_3d`` (B*P,) (the
    labels with 30 % dropped to -100, as offline pseudo labels leave points
    out) and ``sam_mask`` (B, H, W) ids in [-1, ``mask_budget``).

    ``with_ema`` (target only) makes the batch the student view of
    :func:`ema_views` and adds the teacher's keys: ``ori_img`` (B, H, W, 3)
    uint8, ``ori_img_indices`` (B, P, 2), ``ori_coords`` (B*P, 3),
    ``ori_num_points`` (B,), ``ori_feats_ones`` (B, 1) and ``ema_map``
    (B, P) (-1 at padding and for points the teacher did not see).

    ``with_vgi`` (target only) adds the raw VGI inputs of
    :func:`vgi_inputs`. ``host_plans`` (:func:`host_plan_settings`) runs
    the loader's host work on the batch (:func:`add_host_plans`): host VGI's
    ``cat_*``, ``vgi_inserted`` and ``hp_cat_*`` keys replace the raw VGI
    inputs, and ``hp_*`` / ``hp_ori_*`` hold the scans' plans."""
    if domain not in ("source", "target"):
        raise ValueError("domain must be 'source' or 'target'")
    target = domain == "target"
    if (with_ema or with_vgi) and not target:
        raise ValueError("only target batches carry the EMA teacher's view "
                         "and the VGI inputs")
    samples = [eval_sample(start_index + i, image_size=image_size,
                           num_classes=num_classes, stream=int(target))
               for i in range(batch_size)]
    raw = samples
    if with_ema:
        views = [ema_views(smp, point_budget, [SCAN_SEED, start_index + i, 3])
                 for i, smp in enumerate(samples)]
        samples = [v[0] for v in views]
        ori = collate_eval([v[1] for v in views], point_budget)
    out = collate_eval(samples, point_budget)
    if with_ema:
        for k in ("img", "img_indices", "coords", "num_points",
                  "feats_ones"):
            out["ori_" + k] = ori[k]
        out["ema_map"] = np.full((batch_size, point_budget), -1, np.int64)
        for i, (_, _, emap) in enumerate(views):
            out["ema_map"][i, :emap.shape[0]] = emap
    if target:
        rng = np.random.default_rng(np.random.SeedSequence(
            [SCAN_SEED, start_index, batch_size, 2]))
        ps = out["seg_label"].copy()
        ps[rng.random(ps.shape[0]) < 0.3] = -100
        out["pseudo_label_2d"] = ps
        out["pseudo_label_3d"] = ps.copy()
        out["sam_mask"] = np.stack([sam_mask(rng, image_size, mask_budget)
                                    for _ in range(batch_size)])
    if with_vgi:
        out.update(vgi_inputs(raw, point_budget, image_size,
                              [SCAN_SEED, start_index, batch_size, 4]))
    if host_plans is not None:
        add_host_plans(out, host_plans)
    return out


def add_host_plans(batch: dict, host_plans: dict) -> dict:
    """Run ``data.collate`` on a collated train batch, in place, as the
    reference's loader does: host VGI first where the batch has VGI inputs
    and ``host_plans`` (:func:`host_plan_settings`) holds ``vgi``, then the
    plans of the key-sorted scans (``hp_*``, with ``point_valid``) and, where
    the batch has the teacher's view, of that view (``hp_ori_*``, with
    ``ori_point_valid``). Returns the batch."""
    from mopa_tpu_torch.data import collate

    b, p = batch["img_indices"].shape[:2]
    if "ori_points" in batch and host_plans["vgi"] is not None:
        collate._host_vgi_batch(batch, batch["ori_points"], b, p, OBJ_BUDGET,
                                host_plans["vgi"])
    for pre in ("", "ori_") if "ori_coords" in batch else ("",):
        batch[pre + "point_valid"] = (np.arange(p)[None, :]
                                      < batch[pre + "num_points"][:, None])
        collate._host_plan_batch(batch, b, p, host_plans["capacities"],
                                 "hp_" + pre, pre + "coords",
                                 pre + "point_valid")
    return batch


class SyntheticSCN:
    """A dataset of seeded synthetic scans in the per-sample schema of the
    real datasets (KITTI flavour: front-view scans), so that collate, the
    loaders and the train step run without dataset files.

    The raw scan of an index (:func:`synthetic_scan`, points in the image
    of :func:`project`, a uniform random image) is a fixed function of the
    index and cached; each ``__getitem__`` draws its augmentation afresh
    from a generator seeded by ``rng`` (or ``seed``) and the index: image
    flip, the 3D rotation, flips and translation of
    :func:`augment_and_scale_3d`. Flags add the target domain's inputs:
    offline pseudo labels (30 % dropped), SAM mask ids in
    [-1, ``sam_mask_budget``), the EMA teacher's unaugmented view
    (``ori_*``, ``ema_map``) and the raw inputs of VGI (the scan in meters,
    its ground mask, one object, or ``n_objs`` with ``multi_objs``, the
    camera). ``learnable`` paints class colours and gives each class its own
    slab thickness, so that a trained model can reach a high mIoU.
    ``output_orig`` (eval) adds the points in meters and the restore mask.
    The 3D inputs follow ``backbone`` (:mod:`~mopa_tpu_torch.data.utils.
    inputs`; a random intensity per point for SPVCNN, PTv3 and SalsaNext,
    whose range image is ``proj_H`` x ``proj_W`` over ``fov_up`` /
    ``fov_down``),
    and ``with_depth_label`` adds the dense ``depth_label`` (H, W, 1).
    """

    class_names = ["car", "truck", "bike", "person", "road",
                   "parking", "sidewalk", "building", "nature", "other-objects"]

    def __init__(self, split=("train",), length=64, n_points=8192,
                 image_size=(480, 302), num_classes=10, scale=20,
                 full_scale=4096, noisy_rot=0.1, flip_y=0.5, rot_z=6.2831,
                 transl=True, fliplr=0.5, color_jitter=None, output_orig=False,
                 with_pseudo_labels=False, with_sam_mask=False,
                 with_vgi=False, with_ema=False, sam_mask_budget=16,
                 multi_objs=False, n_objs=3, backbone="SCN", proj_W=256,
                 proj_H=32, fov_up=0.05235, fov_down=-0.43633, seed=0,
                 with_depth_label=False, learnable=False, rng=None,
                 **_unused):
        self.length = length
        self.n_points = n_points
        self.image_size = tuple(image_size)  # (W, H)
        self.num_classes = num_classes
        self.class_names = self.class_names[:num_classes]
        self.scale = scale
        self.full_scale = full_scale
        self.noisy_rot = noisy_rot
        self.flip_y = flip_y
        self.rot_z = rot_z
        self.transl = transl
        self.fliplr = fliplr
        self.output_orig = output_orig
        self.with_pseudo_labels = with_pseudo_labels
        self.with_sam_mask = with_sam_mask
        self.with_vgi = with_vgi
        self.with_ema = with_ema
        self.sam_mask_budget = sam_mask_budget
        self.learnable = learnable
        self.multi_objs = multi_objs
        self.n_objs = n_objs
        self.backbone = backbone
        self.proj_W, self.proj_H = proj_W, proj_H
        self.fov_up, self.fov_down = fov_up, fov_down
        self.with_depth_label = with_depth_label
        self.rng = rng or np.random.default_rng(seed)
        self._scan_cache = {}

    def __len__(self):
        return self.length

    def _scan(self, rng):
        """(points, labels, ground mask) of one raw scan."""
        if not self.learnable:
            return synthetic_scan(rng, self.n_points, self.num_classes)
        # learnable: each box is a slab of class-specific thickness at a
        # fixed clearance over the ground, with a road "shadow" disk under
        # its footprint
        n = self.n_points
        n_rings = 48
        per = max(n // 2 // n_rings, 1)
        thetas = np.linspace(-0.436, -0.035, n_rings)  # -25 .. -2 deg
        rr = np.clip(1.7 / np.tan(-thetas), 0.0, 60.0)
        az = rng.uniform(-0.5, 0.5, (n_rings, per))
        gx = (rr[:, None] * np.cos(az)).ravel()
        gy = (rr[:, None] * np.sin(az)).ravel()
        n_ground = gx.shape[0]
        gz = rng.normal(-1.7, 0.01, n_ground)
        pts = [np.stack([gx, gy, gz], 1)]
        labs = [np.full(n_ground, 4)]  # road
        remaining = n - n_ground
        box_classes = [c for c in range(self.num_classes) if c != 4]
        while remaining > 0:
            m = min(remaining, int(rng.integers(200, 512)))
            cx = rng.uniform(4, 45)
            cy = cx * rng.uniform(-0.4, 0.4)
            c = int(rng.choice(box_classes))
            sx, sy = rng.uniform(0.15, 0.45, 2)
            thick = 0.1 * (c + 1)
            ms = max(m // 4, 16)
            pts.append(np.stack([cx + rng.uniform(-sx, sx, ms),
                                 cy + rng.uniform(-sy, sy, ms),
                                 rng.normal(-1.7, 0.01, ms)], 1))
            labs.append(np.full(ms, 4))
            remaining -= ms
            m = max(min(m, remaining), 16)
            pts.append(np.stack([cx + rng.uniform(-sx, sx, m),
                                 cy + rng.uniform(-sy, sy, m),
                                 -1.2 + rng.uniform(0.0, thick, m)], 1))
            labs.append(np.full(m, c))
            remaining -= m
        points = np.concatenate(pts).astype(np.float32)
        return (points, np.concatenate(labs).astype(np.int64),
                np.arange(points.shape[0]) < n_ground)

    def _raw(self, index):
        """The cached raw scan of ``index``: points, labels and ground mask
        in the image, their pixels, the lidar -> image matrix, the image."""
        if index not in self._scan_cache:
            scan_rng = np.random.default_rng(
                np.random.SeedSequence([SCAN_SEED, index]))
            pts, labs, g_mask = self._scan(scan_rng)
            img_points, keep = project(pts, self.image_size)
            w, h = self.image_size
            image = scan_rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
            self._scan_cache[index] = (
                pts[keep], labs[keep], g_mask[keep], img_points[keep],
                lidar_projection(self.image_size), image)
        return self._scan_cache[index]

    def __getitem__(self, index):
        rng = np.random.default_rng(
            np.random.SeedSequence([int(self.rng.integers(1 << 30)), index]))
        pts_c, labs_c, gm_c, ipts_c, proj_matrix, img_c = self._raw(index)
        points, labels, g_mask = pts_c.copy(), labs_c.copy(), gm_c.copy()
        image = img_c.copy()
        w, h = self.image_size

        out = {}
        ori_points = points.copy()
        img_indices = np.floor(ipts_c).astype(np.int64)
        img_indices[:, 0] = np.clip(img_indices[:, 0], 0, h - 1)
        img_indices[:, 1] = np.clip(img_indices[:, 1], 0, w - 1)

        if self.learnable:
            # class colours in 3x3 patches at the points' pixels
            palette = (np.arange(1, self.num_classes + 1)[:, None]
                       * np.asarray([[0.09, 0.17, 0.05]])) % 1.0
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    rr = np.clip(img_indices[:, 0] + dr, 0, h - 1)
                    cc = np.clip(img_indices[:, 1] + dc, 0, w - 1)
                    image[rr, cc] = (0.8 * palette[labels]
                                     + 0.2 * image[rr, cc]).astype(np.float32)

        if self.with_ema:
            out["ori_img"] = image.copy()
            ori_points_img = img_indices.copy()

        if rng.random() < self.fliplr:
            image = np.ascontiguousarray(np.fliplr(image))
            img_indices = img_indices.copy()
            img_indices[:, 1] = image.shape[1] - 1 - img_indices[:, 1]

        coords, aug_points = augment_and_scale_3d(
            points, self.scale, self.full_scale, rng=rng,
            noisy_rot=self.noisy_rot, flip_y=self.flip_y, rot_z=self.rot_z,
            transl=self.transl)
        coords = coords.astype(np.int64)
        idxs = (coords.min(1) >= 0) * (coords.max(1) < self.full_scale)

        out.update({
            "img": image,
            "img_indices": img_indices[idxs],
            "coords": coords[idxs],
            "aug_points": aug_points[idxs],
            "feats": np.ones([int(idxs.sum()), 1], np.float32),
            "seg_label": labels[idxs],
            "lidar_path": "synthetic/{:06d}.bin".format(index),
            "scan_pth": "synthetic/{:06d}.bin".format(index),
        })
        if self.with_depth_label:
            out["depth_label"] = dense_depth_label(
                (h, w), img_indices[idxs], points[idxs])
        n = int(idxs.sum())
        if inputs.takes_xyzi(self.backbone):
            out["feats"] = inputs.spvcnn_feats(
                aug_points[idxs],
                rng.uniform(0, 1, (n, 1)).astype(np.float32))
        elif self.backbone == "SalsaNext":
            out.update(inputs.range_inputs(
                points[idxs], rng.uniform(0, 1, (n, 1)), self.fov_up,
                self.fov_down, self.proj_W, self.proj_H))

        if self.with_pseudo_labels:
            ps = labels.copy()
            ps[rng.random(ps.shape[0]) < 0.3] = -100
            out["pseudo_label_2d"] = ps[idxs]
            out["pseudo_label_3d"] = ps[idxs]
            out["ori_pseudo_label_3d"] = ps

        if self.with_sam_mask:
            out["sam_mask"] = rng.integers(-1, self.sam_mask_budget,
                                           (h, w)).astype(np.int32)

        if self.output_orig:
            out["points_xyz"] = points[idxs].astype(np.float32)
            out["orig_seg_label"] = labels
            out["orig_points_idx"] = idxs

        if self.with_ema:
            ori_coords, _ = augment_and_scale_3d(ori_points, self.scale,
                                                 self.full_scale, rng=rng)
            ori_idxs = ((ori_coords.min(1) >= 0)
                        * (ori_coords.max(1) < self.full_scale))
            out["ori_img_indices"] = ori_points_img[ori_idxs]
            out["ori_coords"] = ori_coords[ori_idxs].astype(np.int64)
            out["ori_feats"] = np.ones([int(ori_idxs.sum()), 1], np.float32)
            ori_pos = np.cumsum(ori_idxs) - 1
            out["ema_map"] = np.where(ori_idxs, ori_pos,
                                      -1)[idxs].astype(np.int32)

        if self.with_vgi:
            obj_ls, lab_ls = [], []
            for k in range(self.n_objs if self.multi_objs else 1):
                m = int(rng.integers(96, 256))
                lab = 3 - k % 3
                c = np.array([rng.uniform(5, 12), rng.uniform(-2, 2),
                              rng.uniform(-1.6, -1.0)])
                obj = (c + rng.uniform(-0.4, 0.4, (m, 3))).astype(np.float32)
                if self.learnable:
                    # the object obeys the slab-thickness rule too
                    obj[:, 2] = (obj[:, 2].min()
                                 + rng.uniform(0.0, 0.1 * (lab + 1), m)
                                 ).astype(np.float32)
                obj_ls.append(np.concatenate(
                    [obj, rng.uniform(0, 1, (m, 1)).astype(np.float32)], 1))
                lab_ls.append(np.full(m, lab))
            out["ori_obj_pc"] = obj_ls
            out["ori_obj_label"] = lab_ls
            out["ori_points"] = np.concatenate(
                [ori_points, np.ones((ori_points.shape[0], 1), np.float32)],
                1)
            out["ori_img_size"] = np.asarray(self.image_size, np.int32)
            out["proj_matrix"] = proj_matrix[:3, :4]
            out["g_indices"] = g_mask
        return out
