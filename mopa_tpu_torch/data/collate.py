"""Padded batch assembly (port of ``mopa_tpu/data/collate.py``).

``collate_padded`` turns the per-sample dicts of a dataset into one batch
of fixed-shape numpy arrays: every per-point array is padded or cut (an
evenly strided pick) to a per-sample point budget P, and the batch's 3D
arrays are flat (B*P, ...). Arrays take compact wire dtypes, which the step's
``train.common.decode_batch`` widens on the card: uint8 images, int16 voxel
coordinates, pixel indices and labels, int8 SAM ids (remapped into a static
budget), float16 features, int16 fixed-point raw VGI points.

Train batches are key-sorted per sample, and the host work of the loader
runs here on the collated batch, in place: host VGI
(``_host_vgi_batch``) and the host-built voxel plans (``_host_plan_batch``)
write the wire keys the train step decodes: ``hp_*`` (the [source; target]
student scans), ``hp_ori_*`` (the EMA teacher's view) and ``hp_cat_*`` (the
VGI cat scans), each a stack of per-sample ``native_loader.
build_plan_arrays`` outputs, plus the cat domain's ``cat_valid``,
``cat_label``, ``cat_obj_mask`` and ``vgi_inserted``. Keys starting with
"_" stay on the host: ``_meta`` (paths, eval restore masks), the capacity
audits ``_<prefix>true_nums``, the cat capacities ``_hp_cat_caps`` and the
cat points ``_cat_coords``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# The raw VGI inputs; the step reads the cat arrays instead, so they leave
# the batch once host VGI ran.
VGI_RAW_KEYS = ("ori_points", "ori_points_valid", "vgi_num_points", "g_mask",
                "obj_pc", "obj_valid", "obj_label", "proj_matrix", "img_size",
                "ori_pseudo_label_3d")


def _int16_ok(*vals) -> bool:
    return all(-32768 <= int(v) <= 32767 for v in vals)


def _quantize_img(img: np.ndarray) -> np.ndarray:
    """A [0, 1] float image as the uint8 wire image (what the reference's
    PIL pipeline holds before its /255); an image outside [0, 1] (an
    ``image_normalizer`` is set) stays float32."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    if img.min() >= 0.0 and img.max() <= 1.0 + 1e-6:
        return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    return img.astype(np.float32)


def _pad_to(arr: np.ndarray, budget: int, fill=0):
    """(``arr`` padded with ``fill`` or cut to ``budget`` rows, the rows
    kept)."""
    n = arr.shape[0]
    if n >= budget:
        return arr[:budget], min(n, budget)
    pad = np.full((budget - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0), n


def remap_mask_ids(mask: np.ndarray, budget: int) -> np.ndarray:
    """Raw SAM mask ids to dense ids in [0, ``budget``), the largest masks
    first (a stable sort by area); negative ids and masks past the budget
    become -100."""
    mask = mask.astype(np.int32)
    ids, inv, counts = np.unique(mask, return_inverse=True,
                                 return_counts=True)
    pos = np.where(ids >= 0)[0]
    order = pos[np.argsort(-counts[pos], kind="stable")]
    newid = np.full(ids.shape[0], -100, np.int32)
    newid[order[:budget]] = np.arange(min(budget, order.shape[0]),
                                      dtype=np.int32)
    return newid[inv].reshape(mask.shape)


# The per-point groups of a sample: the augmented points, the EMA teacher's
# original points (``ema_map`` points into them) and the raw scan (VGI).
_POINT_KEYS = ("coords", "feats", "seg_label", "img_indices",
               "pseudo_label_2d", "pseudo_label_3d", "proj_xy", "points_xyz",
               "ema_map")
_ORI_KEYS = ("ori_coords", "ori_feats", "ori_img_indices")
_RAW_KEYS = ("ori_points", "ori_pseudo_label_3d", "g_indices")


def _strided_pick(n: int, budget: int) -> np.ndarray:
    """``budget`` evenly spaced increasing indices into ``n`` > budget."""
    return np.linspace(0, n - 1, budget).round().astype(np.int64)


def _fair_subsample(s: Dict, budget: int) -> Dict:
    """Cut each per-point group of a sample over ``budget`` by an evenly
    strided pick (not the first ``budget`` rows, which would drop whole
    regions of a key-sorted or ground-first scan). ``ema_map`` is remapped
    through the original group's pick; ``orig_points_idx`` (eval) is
    rebuilt so that batch rows still map to original points in order."""
    n = np.asarray(s["coords"]).shape[0] if "coords" in s else 0
    n_ori = np.asarray(s["ori_coords"]).shape[0] if "ori_coords" in s else 0
    n_raw = np.asarray(s["ori_points"]).shape[0] if "ori_points" in s else 0
    if n <= budget and n_ori <= budget and n_raw <= budget:
        return s
    s = dict(s)
    if n > budget:
        pick = _strided_pick(n, budget)
        for k in _POINT_KEYS:
            if k in s:
                s[k] = np.asarray(s[k])[pick]
        if "orig_points_idx" in s:
            mask = np.asarray(s["orig_points_idx"])
            kept = np.where(mask)[0][pick]
            new_mask = np.zeros_like(mask)
            new_mask[kept] = True
            s["orig_points_idx"] = new_mask
    if n_ori > budget:
        pick_o = _strided_pick(n_ori, budget)
        for k in _ORI_KEYS:
            if k in s:
                s[k] = np.asarray(s[k])[pick_o]
        if "ema_map" in s:
            inv = np.full(n_ori, -1, np.int64)
            inv[pick_o] = np.arange(budget)
            em = np.asarray(s["ema_map"])
            safe = np.clip(em, 0, n_ori - 1)
            s["ema_map"] = np.where((em >= 0) & (em < n_ori), inv[safe],
                                    -1).astype(em.dtype)
    if n_raw > budget:
        pick_r = _strided_pick(n_raw, budget)
        for k in _RAW_KEYS:
            if k in s:
                s[k] = np.asarray(s[k])[pick_r]
    return s


def _lexkey(coords):
    c = np.asarray(coords, np.int64)
    return (c[:, 0] * 4096 + c[:, 1]) * 4096 + c[:, 2]


def _sort_sample_points(s: Dict) -> Dict:
    """Reorder a sample's per-point arrays by packed voxel key (a stable
    sort), the EMA original group by its own, with ``ema_map`` remapped
    through that permutation. Voxel plans, losses and metrics do not depend
    on the point order."""
    s = dict(s)
    perm = np.argsort(_lexkey(s["coords"]), kind="stable")
    for k in _POINT_KEYS:
        if k in s:
            s[k] = np.asarray(s[k])[perm]
    if "ori_coords" in s:
        operm = np.argsort(_lexkey(s["ori_coords"]), kind="stable")
        inv = np.empty(len(operm), np.int64)
        inv[operm] = np.arange(len(operm))
        for k in _ORI_KEYS:
            if k in s:
                s[k] = np.asarray(s[k])[operm]
        if "ema_map" in s:
            em = np.asarray(s["ema_map"])
            safe = np.clip(em, 0, max(len(inv) - 1, 0))
            s["ema_map"] = np.where((em >= 0) & (em < len(inv)),
                                    inv[safe], -1).astype(em.dtype)
    return s


def _true_level_nums(coords_s, valid_s, num_levels: int) -> np.ndarray:
    """The true unique-voxel count of every level of one sample, free of the
    plan builder's capacity clamps (which cascade into coarser levels): the
    capacity audit. Level 0 counts key changes of key-sorted points (sorts
    otherwise); each coarser level halves every 12-bit field of the packed
    keys and dedups them."""
    c = np.asarray(coords_s, np.int64)[np.asarray(valid_s, bool)]
    c = c[np.all((c >= 0) & (c < 4096), axis=1)]
    tn = np.zeros(num_levels, np.int32)
    key = (c[:, 0] << 24) | (c[:, 1] << 12) | c[:, 2]
    for lvl in range(num_levels):
        if key.size == 0:
            break
        if lvl > 0:
            key = ((key >> 25 << 24) | ((key >> 13 & 0x7FF) << 12)
                   | ((key & 0xFFF) >> 1))
            key = np.unique(key)
        elif np.any(np.diff(key) < 0):
            key = np.unique(key)
        else:
            key = key[np.concatenate(([True], np.diff(key) != 0))]
        tn[lvl] = key.size
    return tn


def _host_plan_batch(out: Dict, b: int, p: int, capacities, prefix: str,
                     coords_key: str, valid_key: str,
                     audit: bool = True) -> None:
    """Build the B samples' UNet voxel plans on the host and stack their
    wire arrays into ``out`` under ``prefix`` (``inverse`` and ``counts``
    as int16 when the point budget and the capacities fit). When one
    sample's fixups overflow the builder's budget no key is written (the
    step then builds that group's plan on the device). With ``audit`` the
    builder-independent true level counts go to ``_<prefix>true_nums``
    (the loader audits its first batches only)."""
    from mopa_tpu_torch.data import native_loader

    coords = np.asarray(out[coords_key]).reshape(b, p, 3)
    valid = np.asarray(out[valid_key]).reshape(b, p)
    per = []
    for i in range(b):
        host = native_loader.build_plan_arrays(coords[i], valid[i],
                                               capacities)
        if host is None:
            return
        per.append(host)
    if audit:
        out["_" + prefix + "true_nums"] = np.stack(
            [_true_level_nums(coords[i], valid[i], len(capacities))
             for i in range(b)])
    compact = {}
    if _int16_ok(p, int(max(capacities))):
        compact = {"inverse": np.int16, "counts": np.int16}
    for key in ("rankn", "ebits", "cbits", "downn", "downe", "f2c",
                "upoffn", "inverse", "counts", "nums", "fix"):
        stacked = np.stack([h[key] for h in per])
        out[prefix + key] = stacked.astype(compact.get(key, stacked.dtype))


def _host_vgi_batch(out: Dict, pts: np.ndarray, b: int, p: int,
                    obj_budget: int, vgi_host: Dict,
                    audit: bool = True) -> None:
    """Run VGI on the host (``data.vgi_host.vgi_host_batch``) over the
    batch's raw VGI inputs and ship the cat domain: ``cat_valid``,
    ``cat_label`` (int16), ``cat_obj_mask``, ``vgi_inserted`` and the
    ``hp_cat_*`` plan at ``capacity_schedule(P + K * obj_budget)``; the raw
    inputs (:data:`VGI_RAW_KEYS`) are dropped. ``vgi_host`` holds ``rng``
    (an ``np.random.Generator``), ``pc_mm``, ``aug``, ``scale``,
    ``full_scale``, ``front_axis_x``, ``num_levels`` and ``factors``. When
    the cat plan's fixups overflow, the batch keeps its raw inputs and
    gains no cat key."""
    from mopa_tpu_torch.data.vgi_host import vgi_host_batch
    from mopa_tpu_torch.models.scn_unet import capacity_schedule

    scan_label = out.get(
        "ori_pseudo_label_3d",
        np.full((b, p), -100, np.int32)).reshape(b, p).astype(np.int32)
    cat = vgi_host_batch(
        pts, out["ori_points_valid"], scan_label, out["g_mask"],
        out["obj_pc"], out["obj_valid"], out["obj_label"],
        out["proj_matrix"], out["img_size"], vgi_host["rng"],
        pc_mm=vgi_host["pc_mm"], aug=vgi_host["aug"],
        scale=vgi_host["scale"], full_scale=vgi_host["full_scale"],
        front_axis_x=vgi_host["front_axis_x"])
    k_max = out["obj_valid"].shape[1]
    n_cat = p + k_max * obj_budget
    cat_caps = capacity_schedule(n_cat, int(vgi_host["num_levels"]),
                                 factors=vgi_host.get("factors") or None)
    out["cat_valid"] = cat["valid"].reshape(b, n_cat)
    out["_cat_coords"] = cat["coords"]
    _host_plan_batch(out, b, n_cat, cat_caps, "hp_cat_",
                     "_cat_coords", "cat_valid", audit=audit)
    if "hp_cat_rankn" not in out:  # fixup overflow: no cat domain
        del out["cat_valid"], out["_cat_coords"]
        return
    out["cat_label"] = cat["label"].reshape(b, n_cat).astype(np.int16)
    out["cat_obj_mask"] = cat["obj_mask"].reshape(b, n_cat)
    out["vgi_inserted"] = cat["inserted"]
    out["_hp_cat_caps"] = np.asarray(cat_caps, np.int32)
    for k in VGI_RAW_KEYS:
        out.pop(k, None)


def collate_padded(samples: List[Dict], point_budget: int,
                   obj_budget: int = 2048, mask_budget: int = 64,
                   sort_points: bool = False,
                   host_plan_capacities=None, vgi_host=None,
                   audit: bool = True) -> Dict:
    """Collate per-sample dicts (a dataset's ``__getitem__``) into one
    padded numpy batch.

    Keys: ``img`` (B, H, W, 3), ``img_indices`` (B, P, 2), ``point_valid``
    (B, P), ``num_points`` (B,), ``coords`` (B*P, 3), ``batch_idx``,
    ``feats``, ``seg_label`` and the pseudo labels (B*P, ...), ``sam_mask``
    (B, H, W), ``depth_label`` (B, H, W, 1), SalsaNext's ``proj_in`` (B, H_r,
    W_r, 5) and ``proj_xy`` (B, P, 2); the EMA teacher's ``ori_img``, ``ori_img_indices``,
    ``ori_coords``, ``ori_batch_idx``, ``ori_point_valid``,
    ``ori_num_points``, ``ori_feats`` and ``ema_map`` (B, P); the raw VGI
    inputs ``ori_points`` (B, P, 4), ``ori_points_valid``,
    ``vgi_num_points``, ``g_mask``, ``ori_pseudo_label_3d``, ``obj_pc``
    (B, K, ``obj_budget``, 4), ``obj_valid``, ``obj_label`` (B, K),
    ``proj_matrix`` (B, 3, 4) and ``img_size`` (B, 2); and ``_meta``.

    ``sort_points`` (train) key-sorts each sample. ``vgi_host`` (the
    settings of :func:`_host_vgi_batch`) runs host VGI where the batch has
    a ground mask, and ``host_plan_capacities`` (with ``sort_points``)
    builds the scans' plans (``hp_*``, and ``hp_ori_*`` for the teacher's
    view). ``audit`` adds the capacity audits."""
    samples = [_fair_subsample(s, point_budget) for s in samples]
    if sort_points:
        samples = [_sort_sample_points(s) for s in samples]
    b = len(samples)
    out: Dict[str, np.ndarray] = {}
    p = point_budget

    def stack_points(key, fill, dtype=None, budget=p):
        arrs, counts = [], []
        for s in samples:
            a = np.asarray(s[key])
            if dtype is not None:
                a = a.astype(dtype)
            a, n = _pad_to(a, budget, fill)
            arrs.append(a)
            counts.append(n)
        return np.stack(arrs), np.asarray(counts, np.int32)

    # int16 holds coordinates, indices and labels while the receptive field,
    # the point budget and the image stay below 32768 (full_scale is 4096)
    idx_t = np.int16 if _int16_ok(p, 4096) else np.int32

    coords, num_points = stack_points("coords", 0, idx_t)
    out["coords"] = coords.reshape(b * p, 3)
    out["num_points"] = num_points
    batch_idx = np.repeat(np.arange(b, dtype=np.int32)[:, None], p, axis=1)
    out["batch_idx"] = batch_idx.reshape(b * p)
    out["point_valid"] = np.arange(p)[None, :] < num_points[:, None]

    feats, _ = stack_points("feats", 0, np.float16)
    out["feats"] = feats.reshape(b * p, -1)

    if "seg_label" in samples[0]:
        lab, _ = stack_points("seg_label", -100, idx_t)
        out["seg_label"] = lab.reshape(b * p)

    if "img" in samples[0]:
        out["img"] = np.stack([_quantize_img(s["img"]) for s in samples])
        idx, _ = stack_points("img_indices", 0, idx_t)
        out["img_indices"] = idx

    for key in ("pseudo_label_2d", "pseudo_label_3d"):
        if key in samples[0]:
            lab, _ = stack_points(key, -100, idx_t)
            out[key] = lab.reshape(b * p)

    if "proj_in" in samples[0]:
        # SalsaNext's range images and each point's pixel
        out["proj_in"] = np.stack(
            [np.asarray(s["proj_in"], np.float32) for s in samples])
        pxy, _ = stack_points("proj_xy", 0, np.int32)
        out["proj_xy"] = pxy

    if "points_xyz" in samples[0]:
        # the points in meters, for the eval-time KNN
        pxyz, _ = stack_points("points_xyz", 0, np.float32)
        out["points_xyz"] = pxyz

    if "sam_mask" in samples[0]:
        mask_t = np.int8 if mask_budget <= 127 else idx_t
        out["sam_mask"] = np.stack(
            [remap_mask_ids(np.asarray(s["sam_mask"]), mask_budget)
             for s in samples]).astype(mask_t)

    if "depth_label" in samples[0]:
        out["depth_label"] = np.stack(
            [np.asarray(s["depth_label"], np.float32) for s in samples])

    if "ori_img" in samples[0]:
        out["ori_img"] = np.stack([_quantize_img(s["ori_img"])
                                   for s in samples])
        oidx, _ = stack_points("ori_img_indices", 0, idx_t)
        out["ori_img_indices"] = oidx
        ocoords, onum = stack_points("ori_coords", 0, idx_t)
        out["ori_coords"] = ocoords.reshape(b * p, 3)
        out["ori_batch_idx"] = out["batch_idx"]
        out["ori_point_valid"] = np.arange(p)[None, :] < onum[:, None]
        out["ori_num_points"] = onum
        ofeats, _ = stack_points("ori_feats", 0, np.float16)
        out["ori_feats"] = ofeats.reshape(b * p, -1)
        emap, _ = stack_points("ema_map", -1, idx_t)
        out["ema_map"] = emap

    if "ori_points" in samples[0]:
        pts, vnum = stack_points("ori_points", 0, np.float32)
        # int16 fixed point on the wire (5 mm in xyz, 2^-15 in intensity)
        # where the scan fits; float32 otherwise
        if (np.abs(pts[..., :3]).max(initial=0.0) < 163.0
                and np.abs(pts[..., 3:]).max(initial=0.0) <= 1.0):
            q = np.empty(pts.shape, np.int16)
            q[..., :3] = np.rint(pts[..., :3] * 200.0)
            q[..., 3:] = np.rint(pts[..., 3:] * 32000.0)
            out["ori_points"] = q
        else:
            out["ori_points"] = pts
        out["ori_points_valid"] = np.arange(p)[None, :] < vnum[:, None]
        out["vgi_num_points"] = vnum
        if "g_indices" in samples[0]:
            g, _ = stack_points("g_indices", 0, bool)
            out["g_mask"] = g
        if "ori_pseudo_label_3d" in samples[0]:
            opl, _ = stack_points("ori_pseudo_label_3d", -100, idx_t)
            out["ori_pseudo_label_3d"] = opl
        # K candidate objects per scan, padded to the batch's largest K
        k_max = max(len(s["ori_obj_pc"]) for s in samples)
        objs, labels, ovalid = [], [], []
        for s in samples:
            s_objs, s_valid, s_labels = [], [], []
            for ki in range(k_max):
                if ki < len(s["ori_obj_pc"]):
                    opc = np.asarray(s["ori_obj_pc"][ki], np.float32)
                    opc, n = _pad_to(opc, obj_budget, 0)
                    lab = int(np.asarray(s["ori_obj_label"][ki]).flat[0])
                else:
                    opc, n, lab = (np.zeros((obj_budget, 4), np.float32), 0,
                                   -100)
                s_objs.append(opc)
                s_valid.append(np.arange(obj_budget) < n)
                s_labels.append(lab)
            objs.append(np.stack(s_objs))
            ovalid.append(np.stack(s_valid))
            labels.append(s_labels)
        out["obj_pc"] = np.stack(objs)
        out["obj_valid"] = np.stack(ovalid)
        out["obj_label"] = np.asarray(labels, np.int32)
        out["proj_matrix"] = np.stack(
            [np.asarray(s["proj_matrix"], np.float32)[:3, :4]
             for s in samples])
        out["img_size"] = np.stack(
            [np.asarray(s["ori_img_size"], np.int32) for s in samples])
        if vgi_host is not None and "g_mask" in out:
            _host_vgi_batch(out, pts, b, p, obj_budget, vgi_host,
                            audit=audit)

    if host_plan_capacities is not None and sort_points:
        _host_plan_batch(out, b, p, host_plan_capacities, "hp_",
                         "coords", "point_valid", audit=audit)
        if "ori_coords" in out:
            _host_plan_batch(out, b, p, host_plan_capacities, "hp_ori_",
                             "ori_coords", "ori_point_valid", audit=audit)

    meta = {}
    for key in ("lidar_path", "scan_pth"):
        if key in samples[0]:
            meta[key] = [s[key] for s in samples]
    for key in ("orig_seg_label", "orig_points_idx", "ori_keep_idx",
                "ori_img_points"):
        if key in samples[0]:
            meta[key] = [np.asarray(s[key]) for s in samples]
    if meta:
        out["_meta"] = meta
    return out
