"""VGI (Valid Ground-based Insertion) on the device, inside the train step
(PyTorch port of ``mopa_tpu/ops/mixmatch.py``; reference
``mopa/data/mixmatch_ss.py``).

The step takes this route when a VGI target batch ships no cat domain built
on the host (``data.vgi_host``): when the loader ran no host VGI, or when
the cat plan's fixups overflowed the host builder's budget. Per scan:

1. **Collision check**: the scan's occupancy over the search window of
   ``search_voxel_size`` cells, ``Z_BUDGET`` cells tall; a 3D summed-area
   table answers every candidate box of an object's xy-circumscribed
   extent with 8 gathers. A start is free when its box holds no point.
2. **Frustum and range**: a candidate centre lies in front of the car,
   projects into the image and lies no nearer than the object did.
3. **Ground**: the centre's cell holds ground points (the batch's
   ``g_mask``, else :func:`ops.ground.estimate_ground` on the card). The
   largest object with a candidate cell anchors the placement; it and every
   smaller object, in that order, pick a remaining anchor cell by a masked
   Gumbel argmax (first maximum), each pick blocking a square of the
   anchor's extent for the next. Each object is moved by a cylinder
   transform (shift along its azimuth, turn about the sensor) onto the
   cell's lowest ground point plus U(0, 0.1) m.
4. **Occlusion** (``use_proj``): points an inserted object hides on the
   range image are dropped (:func:`ops.projection.occlusion_removal`).
5. One augmentation draw for the batch (noisy rotation, flips, z rotation,
   translation), then the receptive-field filter.

The arithmetic takes every random draw as a tensor (:func:`vgi_insert_batch`,
:func:`vgi_insert_sample`); :func:`vgi_draws` makes the draws from a
``torch.Generator``, and :func:`vgi_insert` joins the two. ``jax.random``
and ``torch.Generator`` never give the same numbers, so the tests feed the
arithmetic the draws that the JAX package's keys give. The B scans are
batched tensor ops; only the K-object pick loop runs in Python (each pick
blocks cells for the next), with no host sync.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from mopa_tpu_torch.ops.ground import estimate_ground
from mopa_tpu_torch.ops.projection import occlusion_removal

# z cells of the occupancy window (of search_voxel_size; 32 * 0.5 m = 16 m
# above search_z_min, taller than any insertable object)
Z_BUDGET = 32
_INF = 1e30
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 as XLA converts: truncation, saturating at the int32
    range, NaN to 0. Returned as int64."""
    hi = x >= 2.0 ** 31
    lo = x < -2.0 ** 31
    mid = torch.where(hi | lo | x.isnan(), torch.zeros_like(x), x)
    out = mid.to(torch.int64)
    return torch.where(hi, torch.full_like(out, _I32_MAX),
                       torch.where(lo, torch.full_like(out, _I32_MIN), out))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 value wrapped to int32 as int32 arithmetic would leave it."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def _sat3(occ: torch.Tensor) -> torch.Tensor:
    """Inclusive summed-area table over the last three dims of ``occ``,
    zero-padded at the front of each."""
    sat = occ.long().cumsum(-3).cumsum(-2).cumsum(-1)
    return torch.nn.functional.pad(sat, (1, 0, 1, 0, 1, 0))


def _box_sum(sat: torch.Tensor, s: torch.Tensor,
             ext: torch.Tensor) -> torch.Tensor:
    """Occupancy sums of the boxes [s, s + ext) of scan b's table
    ``sat[b]`` (B, X, Y, Z) for starts ``s`` (B, ..., 3). Indices are
    clamped into the table, as XLA's gathers clamp them."""
    b = sat.shape[0]
    dims = sat.shape[1:]
    flat_sat = sat.reshape(b, -1)
    e = s + ext

    def g(ix, iy, iz):
        ix = ix.clamp(0, dims[0] - 1)
        iy = iy.clamp(0, dims[1] - 1)
        iz = iz.clamp(0, dims[2] - 1)
        flat = (ix * dims[1] + iy) * dims[2] + iz
        return torch.gather(flat_sat, 1, flat.reshape(b, -1)).reshape(
            flat.shape)

    x0, y0, z0 = s[..., 0], s[..., 1], s[..., 2]
    x1, y1, z1 = e[..., 0], e[..., 1], e[..., 2]
    return (g(x1, y1, z1) - g(x0, y1, z1) - g(x1, y0, z1) - g(x1, y1, z0)
            + g(x0, y0, z1) + g(x0, y1, z0) + g(x1, y0, z0) - g(x0, y0, z0))


def _scatter(fill, n: int, index, values, reduce: str) -> torch.Tensor:
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, index, values, reduce, include_self=True)


def _per_scan(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[b].flatten()[index[b]]`` for every scan b: ``t`` (B, ...),
    ``index`` (B, ...) into the flattened trailing dims."""
    b = t.shape[0]
    return torch.gather(t.reshape(b, -1), 1, index.reshape(b, -1)).reshape(
        index.shape)


def _fv_insert(objs, ovalid, fv_z_disc):
    """Front-view mirror insertion (reference ``mixmatch_ss.py:83-105``):
    every non-empty object is inserted, shifted by ``-fv_z_disc`` in z;
    one whose centroid lies behind the sensor is mirrored to the front by
    right-multiplying with Rz(2 theta), theta its centroid's angle from +y."""
    shifted_z = objs[..., 2] - fv_z_disc
    om = torch.where(ovalid[..., None], objs[..., :3],
                     torch.zeros_like(objs[..., :3]))
    cnt = ovalid.float().sum(-1).clamp(min=1.0)
    ctr = om.sum(-2) / cnt[..., None]
    r = torch.sqrt(ctr[..., 0] ** 2 + ctr[..., 1] ** 2)
    theta = torch.arccos(torch.clamp(ctr[..., 1] / r.clamp(min=1e-9),
                                     -1.0, 1.0))
    c2 = torch.cos(2.0 * theta)[..., None]
    s2 = torch.sin(2.0 * theta)[..., None]
    x, y = objs[..., 0], objs[..., 1]
    xr = x * c2 + y * s2
    yr = -x * s2 + y * c2
    mirror = (ctr[..., 0] < 0)[..., None]
    new_obj = torch.stack([torch.where(mirror, xr, x),
                           torch.where(mirror, yr, y), shifted_z], dim=-1)
    return {"new_obj": new_obj, "inserted": ovalid.sum(-1) > 0}


def vgi_insert_sample(points, pvalid, g_mask, objs, ovalid, proj_matrix,
                      img_size, gumbel, zjit, *, voxel_size, search_range,
                      z_min, front_axis_x: bool, insert_mode: str = "ground",
                      fv_z_disc: float = -0.324, debug: bool = False) -> Dict:
    """Place each scan's K candidate objects; B scans at once.

    Args:
        points (B, P, 3+) scan points in meters; pvalid, g_mask (B, P) bool;
        objs (B, K, O, 3+), ovalid (B, K, O); proj_matrix (B, 3, 4) lidar
        -> image; img_size (B, 2) (W, H); gumbel (B, K, gx, gy) each
        object's Gumbel score per cell of the search grid (gx = 2 *
        int(search_range[0] / voxel_size), gy likewise); zjit (B, K) the
        U(0, 1) z jitter. ``front_axis_x``: the window lies ahead in +x
        (KITTI), else in +y (nuScenes). ``insert_mode`` "ground" or "fv".

    Returns {"new_obj": (B, K, O, 3) float32, "inserted": (B, K) bool};
    with ``debug`` also each object's candidate cells ``valid_cells``, their
    quantised centres ``qx``/``qy``, the ``anchor`` (B,) and ``road_z``."""
    objs = objs.float()
    ovalid = ovalid.bool()
    if insert_mode == "fv":
        return _fv_insert(objs, ovalid, fv_z_disc)
    dev = points.device
    b, k_objs = ovalid.shape[:2]
    ar_b = torch.arange(b, device=dev)
    vs = voxel_size
    sx = int(search_range[0] / vs)
    sy = int(search_range[1] / vs)
    zmin_vox = int(math.floor(z_min / vs))
    gx_dim, gy_dim = 2 * sx, 2 * sy
    n_cell = gx_dim * gy_dim

    pts = points[..., :3].float()
    pvalid = pvalid.bool()
    off = [0, -sy, zmin_vox] if front_axis_x else [-sx, 0, zmin_vox]
    gidx = _to_int32(torch.floor(pts / vs)) - torch.tensor(off, device=dev)

    # scan-level structures: occupancy over the full z budget (an object's
    # z window is enforced by its box's extent), the 2D ground cells and
    # their lowest ground point
    in_xy = ((gidx[..., 0] >= 0) & (gidx[..., 0] < gx_dim)
             & (gidx[..., 1] >= 0) & (gidx[..., 1] < gy_dim))
    inb = pvalid & (gidx[..., 2] >= 0) & (gidx[..., 2] < Z_BUDGET) & in_xy
    n_occ = n_cell * Z_BUDGET + 1
    flat = torch.where(inb, (gidx[..., 0] * gy_dim + gidx[..., 1]) * Z_BUDGET
                       + gidx[..., 2].clamp(0, Z_BUDGET - 1),
                       torch.full_like(gidx[..., 0], n_occ - 1))
    occ = _scatter(0, b * n_occ, (flat + ar_b[:, None] * n_occ).reshape(-1),
                   inb.long().reshape(-1), "amax")
    occ = occ.reshape(b, n_occ)[:, :-1].reshape(b, gx_dim, gy_dim, Z_BUDGET)
    sat = _sat3(occ)

    xs = torch.arange(gx_dim, device=dev)
    ys = torch.arange(gy_dim, device=dev)
    gxx, gyy = torch.meshgrid(xs, ys, indexing="ij")

    g2d_ok = pvalid & g_mask.bool() & in_xy
    flat2d = torch.where(g2d_ok, gidx[..., 0] * gy_dim + gidx[..., 1],
                         torch.full_like(gidx[..., 0], n_cell))
    flat2d = (flat2d + ar_b[:, None] * (n_cell + 1)).reshape(-1)
    gground = _scatter(0, b * (n_cell + 1), flat2d,
                       g2d_ok.long().reshape(-1), "amax")
    gground = gground.reshape(b, n_cell + 1)[:, :-1].reshape(
        b, gx_dim, gy_dim)
    zmin_cell = _scatter(_INF, b * (n_cell + 1), flat2d, torch.where(
        g2d_ok, pts[..., 2], torch.full_like(pts[..., 2], _INF)).reshape(-1),
        "amin")
    zmin_cell = zmin_cell.reshape(b, n_cell + 1)[:, :-1].reshape(
        b, gx_dim, gy_dim)

    w = img_size[:, 0].float()[:, None, None, None]
    h = img_size[:, 1].float()[:, None, None, None]

    # per-object candidate cells, (B, K, gx, gy)
    inf = torch.tensor(_INF, device=dev)
    ov = ovalid[..., None]
    omin_m = torch.where(ov, objs[..., :3], inf).amin(dim=-2)  # (B, K, 3)
    omax_m = torch.where(ov, objs[..., :3], -inf).amax(dim=-2)
    ext = _to_int32(torch.floor(omax_m / vs) - torch.floor(omin_m / vs) + 1)
    # the circumscribed xy extent, in int32 arithmetic as the JAX op
    sq = _wrap_int32(_wrap_int32(ext[..., 0] * ext[..., 0])
                     + _wrap_int32(ext[..., 1] * ext[..., 1]))
    ext_xy = _to_int32(torch.ceil(torch.sqrt(sq.float())))
    ez = torch.clamp(ext[..., 2], max=Z_BUDGET - 2)
    ext_box = torch.stack([ext_xy, ext_xy, ez], dim=-1)[:, :, None, None]
    dims = torch.tensor([gx_dim, gy_dim, Z_BUDGET], device=dev)

    def collision_free(z0):
        s = torch.stack([gxx, gyy, torch.full_like(gxx, z0)], dim=-1)
        fits = ((s[..., 0] + ext_box[..., 0] <= gx_dim)
                & (s[..., 1] + ext_box[..., 1] <= gy_dim)
                & (z0 + ext_box[..., 2] <= Z_BUDGET))
        e_cl = torch.minimum(s + ext_box, dims)
        s_cl = torch.minimum(s, e_cl)
        return fits & (_box_sum(sat, s_cl, e_cl - s_cl) == 0)

    free = collision_free(0) | collision_free(1)

    eb = ext_box[..., 0].float()  # (B, K, 1, 1)
    cx = (gxx.float() + (eb - 1) / 2 + off[0]) * vs
    cy = (gyy.float() + (eb - 1) / 2 + off[1]) * vs
    qx = torch.floor(cx / vs) * vs
    qy = torch.floor(cy / vs) * vs

    valid = free & (cx > 0)
    cz = ((zmin_vox + 0.5 + (ext[..., 2].float() - 1) / 2) * vs)[
        :, :, None, None].expand_as(cx)
    hom = torch.stack([cx, cy, cz, torch.ones_like(cx)], dim=-1)
    uvw = torch.einsum("brc,bkxyc->bkxyr", proj_matrix.float(), hom)
    den = torch.where(uvw[..., 2].abs() > 1e-6, uvw[..., 2],
                      torch.full_like(uvw[..., 2], 1e-6))
    uu = uvw[..., 0] / den
    vv = uvw[..., 1] / den
    valid = valid & (uu > 0) & (uu < w) & (vv > 0) & (vv < h) \
        & (uvw[..., 2] > 0)

    obj_center = (omax_m + omin_m) / 2
    ori_range = torch.sqrt(obj_center[..., 0] ** 2 + obj_center[..., 1] ** 2)
    valid = valid & (torch.sqrt(cx ** 2 + cy ** 2)
                     >= ori_range[:, :, None, None])

    # ground support at the centre's cell
    cgx = _to_int32(torch.floor(qx / vs) - off[0])
    cgy = _to_int32(torch.floor(qy / vs) - off[1])
    in_grid = (cgx >= 0) & (cgx < gx_dim) & (cgy >= 0) & (cgy < gy_dim)
    cgx_c = cgx.clamp(0, gx_dim - 1)
    cgy_c = cgy.clamp(0, gy_dim - 1)
    valid = valid & in_grid & (_per_scan(gground, cgx_c * gy_dim + cgy_c) > 0)
    extent = torch.sqrt((omax_m[..., 0] - omin_m[..., 0]) ** 2
                        + (omax_m[..., 1] - omin_m[..., 1]) ** 2)

    nonempty = ovalid.sum(-1) > 0
    has_valid = valid.flatten(2).any(-1) & nonempty
    # the anchor: the largest object (xy diagonal) with a candidate cell
    order = torch.argsort(-torch.where(nonempty, extent, -inf), dim=1,
                          stable=True)
    any_success = has_valid.any(1)
    pos_success = torch.argmax(has_valid.gather(1, order).long(), dim=1)
    anchor = order.gather(1, pos_success[:, None])[:, 0]
    ar_k = torch.arange(k_objs, device=dev)
    rank = torch.empty_like(order).scatter_(1, order,
                                            ar_k.expand(b, k_objs))
    inserted = any_success[:, None] & (rank >= pos_success[:, None]) \
        & nonempty

    anchor_valid = valid[ar_b, anchor]  # (B, gx, gy)
    r_block = ext_xy[ar_b, anchor][:, None]

    # picks in anchor order; each blocks a square of the anchor's extent
    blocked = torch.zeros_like(anchor_valid)
    pick = torch.zeros((b, k_objs), dtype=torch.int64, device=dev)
    drew = torch.zeros((b, k_objs), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(-math.inf, device=dev)
    for i in range(k_objs):
        k = order[:, i]
        avail = anchor_valid & ~blocked
        has = avail.flatten(1).any(1) & (i >= pos_success)
        score = torch.where(avail, gumbel[ar_b, k].float(), neg_inf)
        p = score.flatten(1).argmax(1)
        near_x = (xs[None] - (p // gy_dim)[:, None]).abs() <= r_block
        near_y = (ys[None] - (p % gy_dim)[:, None]).abs() <= r_block
        blocked = blocked | (near_x[:, :, None] & near_y[:, None, :]
                             & has[:, None, None])
        pick[ar_b, k] = p
        drew[ar_b, k] = has
    inserted = inserted & drew

    new_cx = _per_scan(qx[ar_b, anchor], pick)
    new_cy = _per_scan(qy[ar_b, anchor], pick)
    cell = (_per_scan(cgx_c[ar_b, anchor], pick) * gy_dim
            + _per_scan(cgy_c[ar_b, anchor], pick))
    road = _per_scan(zmin_cell, cell)
    road_z = torch.where(torch.isfinite(road), road,
                         torch.full_like(road, float(z_min)))

    # cylinder transform: shift along the object's azimuth, then turn
    theta_obj = torch.atan2(obj_center[..., 1], obj_center[..., 0])
    d_r = torch.sqrt(new_cx ** 2 + new_cy ** 2) - ori_range
    d_theta = torch.atan2(new_cy, new_cx) - theta_obj
    z_disc = road_z - omin_m[..., 2] + zjit.float() * 0.1
    t = torch.stack([d_r * torch.cos(theta_obj), d_r * torch.sin(theta_obj),
                     z_disc], dim=-1)
    c, s = torch.cos(d_theta), torch.sin(d_theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, zero], -1),
                       torch.stack([s, c, zero], -1),
                       torch.stack([zero, zero, one], -1)], -2)
    new_obj = torch.einsum("bkod,bkrd->bkor", objs[..., :3] + t[:, :, None],
                           rot)
    out = {"new_obj": new_obj, "inserted": inserted}
    if debug:
        out.update(valid_cells=valid, qx=qx, qy=qy, anchor=anchor,
                   road_z=road_z)
    return out


def search_grid(pc_mm) -> tuple:
    """(gx, gy): the cells of the search window of ``TRAIN.PC_MM``, the
    last two dims of the ``gumbel`` draw."""
    vs = float(pc_mm.search_voxel_size)
    return (2 * int(pc_mm.search_range[0] / vs),
            2 * int(pc_mm.search_range[1] / vs))


def vgi_draws(b: int, k_objs: int, grid: tuple, generator: torch.Generator,
              device) -> Dict[str, torch.Tensor]:
    """Every random draw of one :func:`vgi_insert_batch` call, from
    ``generator``: ``gumbel`` (B, K, gx, gy) standard Gumbel, ``zjit`` (B, K)
    U(0, 1), and the batch's shared augmentation: ``noise`` (3, 3)
    standard normal, ``flip`` (2,) int64 in {0, 1}, ``rot`` () U(0, 1) and
    ``transl`` (B, 1, 3) U(0, 1)."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    gumbel = -torch.log(torch.empty((b, k_objs) + tuple(grid),
                                    device=device).exponential_(
                                        generator=generator))
    return {"gumbel": gumbel, "zjit": uniform(b, k_objs),
            "noise": torch.randn((3, 3), generator=generator, device=device),
            "flip": torch.randint(0, 2, (2,), generator=generator,
                                  device=device),
            "rot": uniform(), "transl": uniform(b, 1, 3)}


def _target_settings(cfg) -> tuple:
    """(augmentation, scale, full_scale, front_axis_x) of the target
    dataset, as the JAX package reads them."""
    node = cfg.DATASET_TARGET
    dkw = node.get(node.TYPE, {})
    front_axis_x = "SEMANTICKITTI" in node.TYPE.upper() \
        or node.TYPE == "SyntheticSCN"
    return (dkw.get("augmentation", {}), float(dkw.get("scale", 20)),
            int(dkw.get("full_scale", 4096)), front_axis_x)


def vgi_insert_batch(cfg, batch: Dict, scan_labels: bool,
                     draws: Dict[str, torch.Tensor]) -> Dict:
    """The VGI branch of the step over a decoded target batch: insert,
    remove occluded points, augment and pack, with the random draws of
    :func:`vgi_draws` given.

    Reads ``ori_points`` (B, P, 4), ``ori_points_valid``, ``g_mask`` (else
    the ground is fitted on the card), ``obj_pc`` (B, K, O, 4) (or the
    single-object (B, O, 4)), ``obj_valid``, ``obj_label``,
    ``proj_matrix``, ``img_size`` and, with ``scan_labels`` (the step has
    pseudo labels), ``ori_pseudo_label_3d``. Returns flat (B * (P + K*O))
    ``coords`` int64, ``batch_idx``, ``valid``, ``feats`` (all ones),
    ``label`` (-100 where not valid) and ``obj_mask``, and ``inserted`` (B,
    K): each scan's points, then its objects'. A scan where nothing was
    placed contributes nothing."""
    pc_mm = cfg.TRAIN.PC_MM
    aug, scale, full_scale, front_axis_x = _target_settings(cfg)
    points = batch["ori_points"].float()
    pvalid = batch["ori_points_valid"].bool()
    dev = points.device
    if "g_mask" in batch:
        g_mask = batch["g_mask"]
    else:
        # the online ground fit (reference mixmatch_ss.py:381-388)
        g_mask = estimate_ground(points[..., :3], pvalid)
    obj, ovalid, obj_label = (batch["obj_pc"], batch["obj_valid"].bool(),
                              batch["obj_label"])
    if obj.dim() == 3:  # single-object layout
        obj, ovalid, obj_label = obj[:, None], ovalid[:, None], \
            obj_label[:, None]
    b, p = pvalid.shape
    k_objs, o = ovalid.shape[1], ovalid.shape[2]
    no_label = torch.full((b, p), -100, dtype=torch.int64, device=dev)
    scan_label = batch.get("ori_pseudo_label_3d", no_label).long() \
        if scan_labels else no_label

    ins = vgi_insert_sample(
        points, pvalid, g_mask, obj, ovalid, batch["proj_matrix"],
        batch["img_size"], draws["gumbel"], draws["zjit"],
        voxel_size=float(pc_mm.search_voxel_size),
        search_range=tuple(pc_mm.search_range),
        z_min=float(pc_mm.search_z_min), front_axis_x=front_axis_x,
        insert_mode=str(pc_mm.get("insert_mode", "ground")),
        # the reference's point_mixmatch default; its train loop never
        # forwards TRAIN.PC_MM.z_disc
        fv_z_disc=-0.324)
    inserted = ins["inserted"]

    ko = k_objs * o
    obj_pts = ins["new_obj"].reshape(b, ko, 3)
    obj_pt_valid = (ovalid & inserted[:, :, None]).reshape(b, ko)
    obj_pt_label = obj_label.long()[:, :, None].expand(b, k_objs, o
                                                        ).reshape(b, ko)
    any_inserted = inserted.any(1)[:, None]
    cat_pts = torch.cat([points[..., :3], obj_pts], dim=1)
    obj_mask = torch.cat([torch.zeros_like(pvalid), obj_pt_valid], dim=1)
    cat_valid = torch.cat([pvalid & any_inserted, obj_pt_valid], dim=1)
    cat_label = torch.cat([
        torch.where(any_inserted, scan_label, no_label),
        torch.where(obj_pt_valid, obj_pt_label,
                    torch.full_like(obj_pt_label, -100))], dim=1)

    if pc_mm.use_proj:
        cat_valid = cat_valid & occlusion_removal(
            cat_pts, cat_valid, obj_mask, float(pc_mm.fov_up),
            float(pc_mm.fov_down), int(pc_mm.proj_W), int(pc_mm.proj_H))

    # one augmentation draw for the whole batch
    rot = torch.eye(3, device=dev)
    noisy_rot = float(aug.get("noisy_rot", 0.0))
    rot_z = float(aug.get("rot_z", 0.0))
    flip_x = float(aug.get("flip_x", 0.0))
    flip_y = float(aug.get("flip_y", 0.0))
    if noisy_rot > 0:
        rot = rot + noisy_rot * draws["noise"].float()
    if flip_x > 0 or flip_y > 0:
        sign = draws["flip"].to(dev) * 2 - 1
        ones = torch.ones_like(sign)
        flips = torch.stack([sign[0] if flip_x > 0 else ones[0],
                             sign[1] if flip_y > 0 else ones[1], ones[0]])
        rot = rot * flips[:, None].float()
    if rot_z > 0:
        theta = draws["rot"].float() * rot_z
        cz, sz = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(cz), torch.ones_like(cz)
        rot = rot @ torch.stack([torch.stack([cz, -sz, zero]),
                                 torch.stack([sz, cz, zero]),
                                 torch.stack([zero, zero, one])])
    coords = torch.einsum("bpc,cd->bpd", cat_pts, rot) * scale
    big = torch.tensor(_INF, device=dev)
    cmin = torch.where(cat_valid[..., None], coords, big).amin(
        dim=1, keepdim=True)
    coords = coords - torch.where(torch.isfinite(cmin), cmin,
                                  torch.zeros_like(cmin))
    if bool(aug.get("transl", False)):
        cmax = torch.where(cat_valid[..., None], coords, -big).amax(
            dim=1, keepdim=True)
        coords = coords + torch.clamp(full_scale - cmax - 0.001, min=0) \
            * draws["transl"].float()
    coords = _to_int32(torch.round(coords))
    cat_valid = cat_valid & (coords.amin(-1) >= 0) \
        & (coords.amax(-1) < full_scale)

    n = p + ko
    return {
        "coords": coords.reshape(b * n, 3),
        "batch_idx": torch.arange(b, device=dev).repeat_interleave(n),
        "valid": cat_valid.reshape(b * n),
        "feats": torch.ones((b * n, 1), device=dev),
        "label": torch.where(cat_valid, cat_label,
                             torch.full_like(cat_label, -100)).reshape(b * n),
        "obj_mask": obj_mask.reshape(b * n),
        "inserted": inserted,
    }


def vgi_insert(cfg, batch: Dict, scan_labels: bool,
               generator: torch.Generator) -> Dict:
    """:func:`vgi_insert_batch` with its draws made from ``generator``
    (:func:`vgi_draws`)."""
    obj_valid = batch["obj_valid"]
    b = obj_valid.shape[0]
    k_objs = obj_valid.shape[1] if obj_valid.dim() == 3 else 1
    draws = vgi_draws(b, k_objs, search_grid(cfg.TRAIN.PC_MM), generator,
                      obj_valid.device)
    return vgi_insert_batch(cfg, batch, scan_labels, draws)
