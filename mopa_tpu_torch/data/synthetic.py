"""Seeded synthetic LiDAR + camera batches, eval and train (port of the scan
geometry of ``mopa_tpu/data/synthetic.py::SyntheticSCN``).

A scan is a ring-structured ground plane (fixed elevation angles hit the
plane at fixed ranges, like a LiDAR) plus random upright boxes in the front
frustum, projected by a KITTI-like pinhole camera; only points that land in
the image are kept. Points are scaled to 5 cm voxel coordinates (scale 20),
subsampled to the point budget with an evenly strided pick, and sorted by
voxel key per scan, as the reference's collate does for train batches. Train
batches add the target-domain keys of the pre-EMA MoPA step: offline pseudo
labels and SAM mask ids. No augmentation is applied, except to the student
view of a target batch that also carries the EMA teacher's unaugmented view
(``train_batch(..., with_ema=True)``).
"""

from __future__ import annotations

import numpy as np

# Seed base of the reference's per-index raw scans (SyntheticSCN.__getitem__).
SCAN_SEED = 20260817


def synthetic_scan(rng: np.random.Generator, n_points: int,
                   num_classes: int = 10):
    """Ground rings + boxes; returns (points (N, 3) float32, labels (N,))."""
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
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(labs).astype(np.int64))


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
    seg_label (N,). ``stream`` > 0 draws from another seed sequence (the
    target domain of train batches)."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [SCAN_SEED, index] + ([stream] if stream else [])))
    points, labels = synthetic_scan(rng, n_points, num_classes)
    img_points, keep = project(points, image_size)
    w, h = image_size
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    points, labels, img_points = points[keep], labels[keep], img_points[keep]
    img_indices = np.floor(img_points).astype(np.int64)
    img_indices[:, 0] = np.clip(img_indices[:, 0], 0, h - 1)
    img_indices[:, 1] = np.clip(img_indices[:, 1], 0, w - 1)
    coords = np.round(points * scale)
    coords -= coords.min(0)
    inside = (coords.min(1) >= 0) & (coords.max(1) < full_scale)
    return {"img": image, "img_indices": img_indices[inside],
            "coords": coords[inside].astype(np.int64),
            "seg_label": labels[inside]}


def _lexkey(coords: np.ndarray) -> np.ndarray:
    c = np.asarray(coords, np.int64)
    return (c[:, 0] * 4096 + c[:, 1]) * 4096 + c[:, 2]


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


def train_batch(batch_size: int, point_budget: int = 16384,
                start_index: int = 0, image_size=(480, 302),
                domain: str = "source", mask_budget: int = 64,
                num_classes: int = 10, with_ema: bool = False) -> dict:
    """A collated train batch of scans ``start_index ..`` of one domain, in
    the wire format of :func:`collate_eval`. The target domain draws other
    scans and adds ``pseudo_label_2d``/``pseudo_label_3d`` (B*P,) (the
    labels with 30 % dropped to -100, as offline pseudo labels leave points
    out) and ``sam_mask`` (B, H, W) ids in [-1, ``mask_budget``).

    ``with_ema`` (target only) makes the batch the student view of
    :func:`ema_views` and adds the teacher's keys: ``ori_img`` (B, H, W, 3)
    uint8, ``ori_img_indices`` (B, P, 2), ``ori_coords`` (B*P, 3),
    ``ori_num_points`` (B,), ``ori_feats_ones`` (B, 1) and ``ema_map``
    (B, P) (-1 at padding and for points the teacher did not see)."""
    if domain not in ("source", "target"):
        raise ValueError("domain must be 'source' or 'target'")
    target = domain == "target"
    if with_ema and not target:
        raise ValueError("only target batches carry the EMA teacher's view")
    samples = [eval_sample(start_index + i, image_size=image_size,
                           num_classes=num_classes, stream=int(target))
               for i in range(batch_size)]
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
    return out
