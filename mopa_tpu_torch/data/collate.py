"""Host-built voxel plans and host-side VGI on a collated batch (the port of
``mopa_tpu/data/collate.py::_host_plan_batch`` and ``_host_vgi_batch`` with
the helpers they use).

Both work in place on a collated numpy batch dict and write the wire keys
the train step decodes: ``hp_*`` (the [source; target] student scans),
``hp_ori_*`` (the EMA teacher's view) and ``hp_cat_*`` (the VGI cat scans),
each a stack of per-sample ``native_loader.build_plan_arrays`` outputs, plus
the cat domain's ``cat_valid``, ``cat_label``, ``cat_obj_mask`` and
``vgi_inserted``. Keys starting with "_" stay on the host: the capacity
audits ``_<prefix>true_nums``, the cat capacities ``_hp_cat_caps`` and the
cat points ``_cat_coords``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# The raw VGI inputs; the step reads the cat arrays instead, so they leave
# the batch once host VGI ran.
VGI_RAW_KEYS = ("ori_points", "ori_points_valid", "vgi_num_points", "g_mask",
                "obj_pc", "obj_valid", "obj_label", "proj_matrix", "img_size",
                "ori_pseudo_label_3d")


def _int16_ok(*vals) -> bool:
    return all(-32768 <= int(v) <= 32767 for v in vals)


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
                     coords_key: str, valid_key: str) -> None:
    """Build the B samples' UNet voxel plans on the host and stack their
    wire arrays into ``out`` under ``prefix`` (``inverse`` and ``counts``
    as int16 when the point budget and the capacities fit). When one
    sample's fixups overflow the builder's budget no key is written (the
    step then builds that group's plan on the device). The
    builder-independent true level counts go to ``_<prefix>true_nums``."""
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
                    obj_budget: int, vgi_host: Dict) -> None:
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
                     "_cat_coords", "cat_valid")
    if "hp_cat_rankn" not in out:  # fixup overflow: no cat domain
        del out["cat_valid"], out["_cat_coords"]
        return
    out["cat_label"] = cat["label"].reshape(b, n_cat).astype(np.int16)
    out["cat_obj_mask"] = cat["obj_mask"].reshape(b, n_cat)
    out["vgi_inserted"] = cat["inserted"]
    out["_hp_cat_caps"] = np.asarray(cat_caps, np.int32)
    for k in VGI_RAW_KEYS:
        out.pop(k, None)
