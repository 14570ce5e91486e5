"""VGI (valid ground-based insertion) on the host, in numpy: a frozen copy
of the arithmetic of the port's ``data/vgi_host.py`` and of the range
projection it uses, so that the reference rebuilds the VGI cat scans from
the raw inputs and a generator state, whatever later changes the program
makes to its own copy.

Per target scan, an object is placed on a free ground cell in front of the
car and inside the camera's view, farther out than it was scanned, turned
about the sensor and set onto the local road height; occlusion in a
spherical range image then removes the points the object hides (and its own
hidden points); one augmentation draw shared by the whole batch rotates,
flips and translates the [scan; object] point sets into voxel coordinates.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def occlusion_detector(proj_yx: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """(N,) bool, True for a point that a nearer point projecting to the same
    range-image pixel occludes (a lexsort dedup keeping the closest)."""
    order = np.lexsort((depth, proj_yx[:, 1], proj_yx[:, 0]))
    sorted_yx = proj_yx[order]
    first = np.concatenate(
        [[True], np.any(np.diff(sorted_yx, axis=0) != 0, axis=1)])
    out = np.zeros(proj_yx.shape[0], dtype=bool)
    out[order] = ~first
    return out


def range_projection(points: np.ndarray, fov_up: float, fov_down: float,
                     proj_W: int, proj_H: int,
                     obj_mask: np.ndarray | None = None) -> dict:
    """Per-point range-image pixels (``proj_x``, ``proj_y``) and ``depth``.

    With ``obj_mask`` (the inserted object's points) also ``pres_idx``: True
    for the points that survive when every pixel an object point wins (the
    nearest object point per pixel) keeps only its nearest point, scan or
    object."""
    pts = points[:, :3]
    depth = np.linalg.norm(pts, 2, axis=1)
    yaw = -np.arctan2(pts[:, 1], pts[:, 0])
    pitch = np.arcsin(np.clip(pts[:, 2] / np.maximum(depth, 1e-12), -1, 1))
    fov = abs(fov_down) + abs(fov_up)

    proj_x = 0.5 * (yaw / np.pi + 1.0) * proj_W
    proj_y = (1.0 - (pitch + abs(fov_down)) / fov) * proj_H
    proj_x = np.clip(np.floor(proj_x), 0, proj_W - 1).astype(np.int32)
    proj_y = np.clip(np.floor(proj_y), 0, proj_H - 1).astype(np.int32)

    out = {"proj_x": proj_x, "proj_y": proj_y, "depth": depth}
    if obj_mask is None:
        return out

    pix = proj_y.astype(np.int64) * proj_W + proj_x
    # the object's own occlusion: its nearest point per pixel claims it
    obj_yx = np.stack([proj_y[obj_mask], proj_x[obj_mask]], axis=1)
    obj_occluded = occlusion_detector(obj_yx, depth[obj_mask])
    claimed = np.zeros(proj_H * proj_W, dtype=bool)
    claimed[pix[obj_mask][~obj_occluded]] = True
    contested = claimed[pix]
    # among the points on claimed pixels the closest per pixel stays
    occluded = occlusion_detector(
        np.stack([proj_y[contested], proj_x[contested]], axis=1),
        depth[contested])
    dropped = contested.copy()
    dropped[contested] = occluded
    out["pres_idx"] = ~dropped
    return out


Z_BUDGET = 32  # z cells of the occupancy grid


def _zprefix(occ):
    """(gx, gy, Z) occupancy -> (gx, gy, Z+1) prefix sums along z."""
    zp = np.zeros(occ.shape[:2] + (occ.shape[2] + 1,), np.int32)
    np.cumsum(occ, axis=2, out=zp[:, :, 1:])
    return zp


def _free_grid(zp, ext_box, gx_dim, gy_dim, z_budget):
    """Cells (x, y) where the ``ext_box``-sized box anchored at (x, y, z0) is
    empty for z0 = 0 or 1: a z-prefix difference selects the z-slab, and a
    2D summed-area table over it answers every box query by slices."""
    ex, ey, ez = int(ext_box[0]), int(ext_box[1]), int(ext_box[2])
    free = np.zeros((gx_dim, gy_dim), bool)
    if ex <= 0 or ey <= 0 or ez <= 0:
        return free
    nx, ny = gx_dim - ex + 1, gy_dim - ey + 1  # anchors where the box fits
    if nx <= 0 or ny <= 0:
        return free
    for z0 in (0, 1):
        if z0 + ez > z_budget:
            continue
        slab = zp[:, :, z0 + ez] - zp[:, :, z0]          # (gx, gy)
        sat2 = np.zeros((gx_dim + 1, gy_dim + 1), np.int32)
        np.cumsum(np.cumsum(slab, 0), 1, out=sat2[1:, 1:])
        box = (sat2[ex:ex + nx, ey:ey + ny] - sat2[:nx, ey:ey + ny]
               - sat2[ex:ex + nx, :ny] + sat2[:nx, :ny])
        free[:nx, :ny] |= box == 0
    return free


def vgi_insert_sample_np(points, pvalid, g_mask, objs, ovalid, obj_labels,
                         proj_matrix, img_size, rng: np.random.Generator, *,
                         voxel_size, search_range, z_min, front_axis_x,
                         insert_mode="ground", fv_z_disc=-0.324, debug=False):
    """Place one scan's K candidate objects.

    Args:
        points (P, 4) scan points (meters; intensity last), pvalid (P,),
        g_mask (P,) ground points, objs (K, O, 4), ovalid (K, O),
        obj_labels (K,), proj_matrix (3, 4) lidar -> image, img_size (W, H).
        ``insert_mode`` "ground": anchor cells are free ground cells of a
        ``voxel_size`` grid over ``search_range`` in front of the car (x
        forward when ``front_axis_x``), inside the image, no nearer than the
        object was; objects are placed largest first, each on a random
        remaining cell (cells near an earlier pick are blocked), rotated
        about the sensor and set onto the cell's lowest ground point (plus
        up to 0.1 m). "fv": objects behind the car are mirrored to the front.

    Returns {"new_obj": (K, O, 3), "inserted": (K,)}; with ``debug`` also
    the candidate cells, their quantised centres, the anchor and the road
    heights."""
    objs = np.asarray(objs, np.float32)
    ovalid = np.asarray(ovalid, bool)
    k_objs = objs.shape[0]

    if insert_mode == "fv":
        shifted_z = objs[:, :, 2] - fv_z_disc
        om = np.where(ovalid[:, :, None], objs[:, :, :3], 0.0)
        cnt = np.maximum(ovalid.sum(1).astype(np.float32), 1.0)
        ctr = om.sum(1) / cnt[:, None]
        r = np.sqrt(ctr[:, 0] ** 2 + ctr[:, 1] ** 2)
        theta = np.arccos(np.clip(ctr[:, 1] / np.maximum(r, 1e-9), -1.0, 1.0))
        c2, s2 = np.cos(2.0 * theta), np.sin(2.0 * theta)
        x, y = objs[:, :, 0], objs[:, :, 1]
        xr = x * c2[:, None] + y * s2[:, None]
        yr = -x * s2[:, None] + y * c2[:, None]
        mirror = (ctr[:, 0] < 0)[:, None]
        new_obj = np.stack([np.where(mirror, xr, x),
                            np.where(mirror, yr, y), shifted_z], axis=-1)
        return {"new_obj": new_obj.astype(np.float32),
                "inserted": ovalid.sum(1) > 0}

    vs = voxel_size
    sx = int(search_range[0] / vs)
    sy = int(search_range[1] / vs)
    zmin_vox = int(math.floor(z_min / vs))
    gx_dim, gy_dim = 2 * sx, 2 * sy

    pts = np.asarray(points, np.float32)[:, :3]
    pvalid = np.asarray(pvalid, bool)
    vox = np.floor(pts / vs).astype(np.int32)
    off = (np.asarray([0, -sy, zmin_vox], np.int32) if front_axis_x
           else np.asarray([-sx, 0, zmin_vox], np.int32))
    gidx = vox - off
    inf = np.float32(1e30)

    inb = (pvalid
           & (gidx[:, 2] >= 0) & (gidx[:, 2] < Z_BUDGET)
           & (gidx[:, 0] >= 0) & (gidx[:, 0] < gx_dim)
           & (gidx[:, 1] >= 0) & (gidx[:, 1] < gy_dim))
    occ = np.zeros((gx_dim, gy_dim, Z_BUDGET), np.int32)
    occ[gidx[inb, 0], gidx[inb, 1], gidx[inb, 2]] = 1
    zp = _zprefix(occ)

    xs = np.arange(gx_dim, dtype=np.int32)
    ys = np.arange(gy_dim, dtype=np.int32)
    gxx, gyy = np.meshgrid(xs, ys, indexing="ij")

    g_sel = pvalid & np.asarray(g_mask, bool)
    g2d_ok = (g_sel & (gidx[:, 0] >= 0) & (gidx[:, 0] < gx_dim)
              & (gidx[:, 1] >= 0) & (gidx[:, 1] < gy_dim))
    gground = np.zeros((gx_dim, gy_dim), np.int32)
    gground[gidx[g2d_ok, 0], gidx[g2d_ok, 1]] = 1
    zmin_cell = np.full((gx_dim, gy_dim), inf, np.float32)
    np.minimum.at(zmin_cell, (gidx[g2d_ok, 0], gidx[g2d_ok, 1]),
                  pts[g2d_ok, 2])

    w = float(img_size[0])
    h = float(img_size[1])
    proj_matrix = np.asarray(proj_matrix, np.float32)

    valid_k = np.zeros((k_objs, gx_dim, gy_dim), bool)
    qx_k = np.zeros((k_objs, gx_dim, gy_dim), np.float32)
    qy_k = np.zeros((k_objs, gx_dim, gy_dim), np.float32)
    extent_k = np.zeros(k_objs, np.float32)
    center_k = np.zeros((k_objs, 3), np.float32)
    ominz_k = np.zeros(k_objs, np.float32)
    orange_k = np.zeros(k_objs, np.float32)
    extvox_k = np.zeros(k_objs, np.int32)
    cgx_k = np.zeros((k_objs, gx_dim, gy_dim), np.int32)
    cgy_k = np.zeros((k_objs, gx_dim, gy_dim), np.int32)

    for k in range(k_objs):
        ov = ovalid[k]
        obj = objs[k]
        om = np.where(ov[:, None], obj[:, :3], inf)
        omin_m = om.min(0)
        om = np.where(ov[:, None], obj[:, :3], -inf)
        omax_m = om.max(0)
        ovox_min = np.floor(omin_m / vs)
        ovox_max = np.floor(omax_m / vs)
        ext = (ovox_max - ovox_min + 1).astype(np.int64)
        ext_xy = int(np.ceil(np.sqrt(float(ext[0]) ** 2
                                     + float(ext[1]) ** 2)))
        ez = int(min(ext[2], Z_BUDGET - 2))
        ext_box = np.asarray([ext_xy, ext_xy, ez], np.int64)

        free = _free_grid(zp, ext_box, gx_dim, gy_dim, Z_BUDGET)

        cx = (gxx.astype(np.float32)
              + (float(ext_box[0]) - 1) / 2 + off[0]) * vs
        cy = (gyy.astype(np.float32)
              + (float(ext_box[1]) - 1) / 2 + off[1]) * vs
        qx = np.floor(cx / vs) * vs
        qy = np.floor(cy / vs) * vs

        valid = free & (cx > 0)
        cz = np.full_like(
            cx, (zmin_vox + 0.5 + (float(ext[2]) - 1) / 2) * vs)
        hom = np.stack([cx, cy, cz, np.ones_like(cx)], axis=-1)
        uvw = np.einsum("rc,xyc->xyr", proj_matrix, hom)
        den = np.where(np.abs(uvw[..., 2]) > 1e-6, uvw[..., 2], 1e-6)
        uu = uvw[..., 0] / den
        vv = uvw[..., 1] / den
        valid &= (uu > 0) & (uu < w) & (vv > 0) & (vv < h) & (uvw[..., 2] > 0)

        obj_center = (omax_m + omin_m) / 2
        ori_range = float(np.sqrt(obj_center[0] ** 2 + obj_center[1] ** 2))
        valid &= np.sqrt(cx ** 2 + cy ** 2) >= ori_range

        cgx = (np.floor(qx / vs) - off[0]).astype(np.int32)
        cgy = (np.floor(qy / vs) - off[1]).astype(np.int32)
        in_grid = (cgx >= 0) & (cgx < gx_dim) & (cgy >= 0) & (cgy < gy_dim)
        cgx_c = np.clip(cgx, 0, gx_dim - 1)
        cgy_c = np.clip(cgy, 0, gy_dim - 1)
        valid &= in_grid & (gground[cgx_c, cgy_c] > 0)

        valid_k[k] = valid
        qx_k[k], qy_k[k] = qx, qy
        extent_k[k] = np.sqrt((omax_m[0] - omin_m[0]) ** 2
                              + (omax_m[1] - omin_m[1]) ** 2) \
            if np.any(ov) else -inf
        center_k[k] = obj_center
        ominz_k[k] = omin_m[2]
        orange_k[k] = ori_range
        extvox_k[k] = ext_xy
        cgx_k[k], cgy_k[k] = cgx_c, cgy_c

    nonempty_k = ovalid.sum(1) > 0
    has_valid_k = valid_k.any(axis=(1, 2)) & nonempty_k

    # the largest object with a candidate cell anchors the placement
    order = np.argsort(-np.where(nonempty_k, extent_k, -inf), kind="stable")
    has_sorted = has_valid_k[order]
    any_success = bool(has_valid_k.any())
    pos_success = int(np.argmax(has_sorted)) if any_success else 0
    anchor = int(order[pos_success])
    rank = np.zeros(k_objs, np.int32)
    rank[order] = np.arange(k_objs, dtype=np.int32)
    inserted = any_success & (rank >= pos_success) & nonempty_k

    anchor_valid = valid_k[anchor]
    r_block = int(extvox_k[anchor])

    blocked = np.zeros((gx_dim, gy_dim), bool)
    pick = np.zeros(k_objs, np.int64)
    drew = np.zeros(k_objs, bool)
    for i in range(k_objs):
        k = int(order[i])
        if rank[k] < pos_success:
            continue
        avail = anchor_valid & ~blocked
        flat_avail = np.flatnonzero(avail.reshape(-1))
        if flat_avail.size == 0:
            continue
        p = int(rng.choice(flat_avail))
        pick[k] = p
        drew[k] = True
        px, py = p // gy_dim, p % gy_dim
        disk = ((np.abs(xs - px) <= r_block)[:, None]
                & (np.abs(ys - py) <= r_block)[None, :])
        blocked |= disk
    inserted = inserted & drew
    px, py = pick // gy_dim, pick % gy_dim

    new_cx = qx_k[anchor][px, py]
    new_cy = qy_k[anchor][px, py]
    ccx = cgx_k[anchor][px, py]
    ccy = cgy_k[anchor][px, py]
    road_z = np.where(np.isfinite(zmin_cell[ccx, ccy]), zmin_cell[ccx, ccy],
                      np.float32(z_min))

    # cylinder transform: rotate about the sensor, shift along the range
    theta_obj = np.arctan2(center_k[:, 1], center_k[:, 0])
    r_obj = orange_k
    theta_new = np.arctan2(new_cy, new_cx)
    r_new = np.sqrt(new_cx ** 2 + new_cy ** 2)
    d_r = r_new - r_obj
    d_theta = theta_new - theta_obj
    zjit = rng.uniform(0.0, 1.0, k_objs).astype(np.float32)
    z_disc = road_z - ominz_k + zjit * 0.1
    t = np.stack([d_r * np.cos(theta_obj), d_r * np.sin(theta_obj),
                  z_disc], axis=-1).astype(np.float32)
    c, s = np.cos(d_theta), np.sin(d_theta)
    zero = np.zeros_like(c)
    one = np.ones_like(c)
    rot = np.stack([
        np.stack([c, -s, zero], -1),
        np.stack([s, c, zero], -1),
        np.stack([zero, zero, one], -1)], -2).astype(np.float32)
    new_obj = np.einsum("kod,krd->kor", objs[:, :, :3] + t[:, None], rot)
    out = {"new_obj": new_obj.astype(np.float32), "inserted": inserted}
    if debug:
        out.update(valid_cells=valid_k, qx=qx_k, qy=qy_k, anchor=anchor,
                   road_z=road_z)
    return out


def vgi_host_batch(points, pvalid, scan_label, g_mask, objs, ovalid,
                   obj_labels, proj_matrix, img_size,
                   rng: np.random.Generator, *, pc_mm, aug, scale, full_scale,
                   front_axis_x) -> Dict[str, np.ndarray]:
    """VGI over a batch: placement, occlusion (``pc_mm.use_proj``), one
    shared augmentation draw and the voxel quantisation, giving the flat
    cat-domain arrays of the VGI loss.

    Args mirror the collated batch: points (B, P, 4) float, pvalid (B, P),
    scan_label (B, P) int (-100 = no pseudo label), g_mask (B, P),
    objs (B, K, O, 4), ovalid (B, K, O), obj_labels (B, K),
    proj_matrix (B, 3, 4), img_size (B, 2); ``pc_mm`` is the
    ``TRAIN.PC_MM`` config node and ``aug`` the target dataset's 3D
    augmentation (``noisy_rot``, ``flip_x``, ``flip_y``, ``rot_z``,
    ``transl``).

    Returns {coords (B*N, 3) int32, valid (B*N,), label (B*N,) int32,
    obj_mask (B*N,), inserted (B, K)} with N = P + K*O: each scan's points,
    then its objects'. A scan with no object placed contributes nothing."""
    b, p = np.asarray(pvalid).shape
    k_objs, o = np.asarray(ovalid).shape[1:3]
    points = np.asarray(points, np.float32)

    new_obj = np.zeros((b, k_objs, o, 3), np.float32)
    inserted = np.zeros((b, k_objs), bool)
    for i in range(b):
        ins = vgi_insert_sample_np(
            points[i], pvalid[i], g_mask[i], objs[i], ovalid[i],
            obj_labels[i], proj_matrix[i], img_size[i], rng,
            voxel_size=float(pc_mm.search_voxel_size),
            search_range=tuple(pc_mm.search_range),
            z_min=float(pc_mm.search_z_min),
            front_axis_x=front_axis_x,
            insert_mode=str(pc_mm.get("insert_mode", "ground")),
            fv_z_disc=-0.324)
        new_obj[i] = ins["new_obj"]
        inserted[i] = ins["inserted"]

    ko = k_objs * o
    obj_pts = new_obj.reshape(b, ko, 3)
    obj_pt_valid = (np.asarray(ovalid, bool)
                    & inserted[:, :, None]).reshape(b, ko)
    obj_pt_label = np.broadcast_to(
        np.asarray(obj_labels, np.int32)[:, :, None],
        (b, k_objs, o)).reshape(b, ko)
    any_inserted = inserted.any(axis=1)
    cat_pts = np.concatenate([points[:, :, :3], obj_pts], axis=1)
    obj_mask = np.concatenate([np.zeros((b, p), bool), obj_pt_valid], axis=1)
    cat_valid = np.concatenate(
        [np.asarray(pvalid, bool) & any_inserted[:, None], obj_pt_valid],
        axis=1)
    scan_label = np.asarray(scan_label, np.int32)
    cat_label = np.concatenate(
        [np.where(any_inserted[:, None], scan_label, -100),
         np.where(obj_pt_valid, obj_pt_label, -100)], axis=1)

    if pc_mm.use_proj:
        for i in range(b):
            # only valid points contest pixels (padding rows sit at the
            # origin and would win every pixel they land on)
            sel = np.flatnonzero(cat_valid[i])
            if sel.size == 0:
                continue
            rp = range_projection(cat_pts[i][sel], float(pc_mm.fov_up),
                                  float(pc_mm.fov_down), int(pc_mm.proj_W),
                                  int(pc_mm.proj_H),
                                  obj_mask=obj_mask[i][sel])
            cat_valid[i][sel] = rp["pres_idx"]

    # one augmentation draw for the batch
    rot = np.eye(3, dtype=np.float32)
    noisy_rot = float(aug.get("noisy_rot", 0.0))
    rot_z = float(aug.get("rot_z", 0.0))
    flip_x = float(aug.get("flip_x", 0.0))
    flip_y = float(aug.get("flip_y", 0.0))
    if noisy_rot > 0:
        rot = rot + noisy_rot * rng.normal(0.0, 1.0, (3, 3)).astype(np.float32)
    if flip_x > 0 or flip_y > 0:
        sign = rng.integers(0, 2, 2) * 2 - 1
        fx = sign[0] if flip_x > 0 else 1
        fy = sign[1] if flip_y > 0 else 1
        rot = rot * np.asarray([fx, fy, 1], np.float32)[:, None]
    if rot_z > 0:
        theta = float(rng.uniform(0.0, 1.0)) * rot_z
        cz, sz = np.cos(theta), np.sin(theta)
        rot = rot @ np.asarray([[cz, -sz, 0.0], [sz, cz, 0.0],
                                [0.0, 0.0, 1.0]], np.float32)
    aug_pts = np.einsum("bpc,cd->bpd", cat_pts, rot)

    coords = aug_pts * scale
    big = np.float32(1e30)
    cmin = np.min(np.where(cat_valid[..., None], coords, big), axis=1,
                  keepdims=True)
    coords = coords - np.where(np.isfinite(cmin), cmin, 0.0)
    if bool(aug.get("transl", False)):
        cmax = np.max(np.where(cat_valid[..., None], coords, -big), axis=1,
                      keepdims=True)
        offset = np.clip(full_scale - cmax - 0.001, 0, None) \
            * rng.uniform(0.0, 1.0, (b, 1, 3)).astype(np.float32)
        coords = coords + offset
    coords = np.round(coords).astype(np.int32)
    rf = (coords.min(axis=-1) >= 0) & (coords.max(axis=-1) < full_scale)
    cat_valid = cat_valid & rf

    return {
        "coords": coords.reshape(b * (p + ko), 3),
        "valid": cat_valid.reshape(-1),
        "label": np.where(cat_valid, cat_label, -100).reshape(-1)
        .astype(np.int32),
        "obj_mask": obj_mask.reshape(-1),
        "inserted": inserted,
    }
