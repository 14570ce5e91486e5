"""Spherical range projection and occlusion-consistent removal (PyTorch port
of ``mopa_tpu/ops/projection.py``).

Device VGI (``ops.mixmatch``) drops the scan points that an inserted object
hides on the range image; ``ops.knn`` rasterises its range image with
:func:`project_pixels`. Both functions take a batch of scans at once: the
pixel ids of scan ``b`` are offset by ``b * proj_w * proj_h``, so each
segment-min is one ``scatter_reduce_`` over every scan.
"""

from __future__ import annotations

import math

import torch

_BIG = 1e30
_INT_BIG = torch.iinfo(torch.int64).max


def project_pixels(points: torch.Tensor, fov_up: float, fov_down: float,
                   proj_w: int, proj_h: int):
    """Per-point (pixel id, range) of a spherical projection of (..., 3)
    points: int64 ids in [0, proj_w * proj_h) and float ranges, both of
    shape (...)."""
    depth = torch.linalg.norm(points, dim=-1)
    yaw = -torch.atan2(points[..., 1], points[..., 0])
    pitch = torch.asin(torch.clamp(points[..., 2] / depth.clamp(min=1e-12),
                                   -1, 1))
    fov = abs(fov_down) + abs(fov_up)
    px = 0.5 * (yaw / math.pi + 1.0) * proj_w
    py = (1.0 - (pitch + abs(fov_down)) / fov) * proj_h
    px = torch.clamp(torch.floor(px), 0, proj_w - 1).long()
    py = torch.clamp(torch.floor(py), 0, proj_h - 1).long()
    return py * proj_w + px, depth


def _segment_min(seg: torch.Tensor, values: torch.Tensor, n_seg: int,
                 fill) -> torch.Tensor:
    """(n_seg,) minimum of ``values`` per segment id, ``fill`` where a
    segment holds nothing below it."""
    out = torch.full((n_seg,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg, values, "amin", include_self=True)


def occlusion_removal(points: torch.Tensor, valid: torch.Tensor,
                      obj_mask: torch.Tensor, fov_up: float, fov_down: float,
                      proj_w: int, proj_h: int) -> torch.Tensor:
    """Presence mask after inserting objects: ``points`` (N, 3+) or
    (B, N, 3+), ``valid`` and ``obj_mask`` of the same leading shape.

    A pixel is claimed by the nearest valid object point that lands on it;
    every valid point on a claimed pixel competes by range, and only the
    nearest survives (at equal ranges the lowest point index). Points on
    unclaimed pixels keep their validity; invalid points stay absent."""
    single = points.dim() == 2
    if single:
        points, valid, obj_mask = points[None], valid[None], obj_mask[None]
    b, n = valid.shape
    n_pix = proj_w * proj_h
    pix, depth = project_pixels(points[..., :3], fov_up, fov_down, proj_w,
                                proj_h)
    seg = (pix + torch.arange(b, device=pix.device)[:, None] * n_pix
           ).reshape(-1)
    depth = depth.reshape(-1)
    valid = valid.reshape(-1)
    big = torch.full_like(depth, _BIG)

    obj_min = _segment_min(seg, torch.where(valid & obj_mask.reshape(-1),
                                            depth, big), b * n_pix, _BIG)
    contested = (obj_min < _BIG)[seg] & valid
    cont_min = _segment_min(seg, torch.where(contested, depth, big),
                            b * n_pix, _BIG)
    is_min = contested & (depth <= cont_min[seg])
    idx = torch.arange(n, device=seg.device).repeat(b)
    idx_of_min = _segment_min(
        seg, torch.where(is_min, idx, torch.full_like(idx, _INT_BIG)),
        b * n_pix, _INT_BIG)
    survivor = is_min & (idx == idx_of_min[seg])
    pres = torch.where(contested, survivor, valid).reshape(b, n)
    return pres[0] if single else pres
