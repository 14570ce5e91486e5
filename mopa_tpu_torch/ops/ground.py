"""Ground segmentation of LiDAR scans, Patchwork++-style (PyTorch port of
``mopa_tpu/ops/ground.py``).

Device VGI falls back to it when a target batch ships no ground mask
(``ops.mixmatch.vgi_insert_batch``), and the SemanticKITTI preprocess writes
its indices as the ``g_indices`` files (``data.semantic_kitti.preprocess``).

Per scan, as in the JAX op:

1. reflected-noise removal: points below ``-(sensor_height +
   rnr_floor_margin)`` are never seeds, never fitted and never ground;
2. the points fall into ``num_rings`` log-spaced rings x ``num_sectors``
   azimuth sectors;
3. each bin is seeded with its lowest points (within ``seed_margin`` of its
   lowest z; in the inner rings also below ``-sensor_height + 1.5``);
4. a plane is fitted per bin by PCA of the weighted 3x3 covariance
   (``torch.linalg.eigh``), then refitted ``num_iter`` times on the points
   within ``dist_thresh`` of it;
5. a bin is ground when its plane is upright, flat, holds at least 3 points
   and, in the inner rings, lies no higher than ``-sensor_height +
   elev_margin``; its points within ``dist_thresh`` of the plane are ground.

A batch of scans is one problem: scan ``b``'s bins are numbered from
``b * num_rings * num_sectors``, and every per-bin sum is one ``index_add``
over all scans. The refits are a Python loop of device ops with no host
sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BIG = 1e30


def _fit(xyz, weights, sid, gbin, n_bins):
    """Weighted plane fit per bin: (normal, d, mean squared distance, weight
    sum, mean z), each (n_bins, ...). ``sid`` is each point's bin or the
    dump slot ``n_bins``; ``gbin`` its bin."""
    wsum = torch.zeros(n_bins + 1, dtype=xyz.dtype, device=xyz.device
                       ).index_add_(0, sid, weights)[:n_bins]
    wsum_c = wsum.clamp(min=1e-6)
    mean = torch.zeros(n_bins + 1, 3, dtype=xyz.dtype, device=xyz.device
                       ).index_add_(0, sid, weights[:, None] * xyz
                                    )[:n_bins] / wsum_c[:, None]
    centered = xyz - mean[gbin]
    outer = centered[:, :, None] * centered[:, None, :]
    cov = torch.zeros(n_bins + 1, 3, 3, dtype=xyz.dtype, device=xyz.device
                      ).index_add_(0, sid, weights[:, None, None] * outer
                                   )[:n_bins] / wsum_c[:, None, None]
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    normal = evecs[:, :, 0]
    normal = normal * torch.sign(normal[:, 2:3] + 1e-12)  # point up
    d = -(normal * mean).sum(dim=1)
    return normal, d, evals[:, 0], wsum, mean[:, 2]


def estimate_ground(points: torch.Tensor, valid: torch.Tensor, *,
                    num_rings: int = 16, num_sectors: int = 32,
                    num_iter: int = 3, r_min: float = 1.0,
                    r_max: float = 80.0, seed_margin: float = 0.3,
                    dist_thresh: float = 0.175, uprightness: float = 0.707,
                    max_surface_var: float = 0.02,
                    sensor_height: float = 1.73,
                    rnr_floor_margin: float = 0.8,
                    elev_margin: float = 0.7) -> torch.Tensor:
    """Ground mask of ``points`` (N, 3+) or (B, N, 3+) with ``valid`` of
    their leading shape: a bool tensor of that shape, on their device."""
    single = points.dim() == 2
    if single:
        points, valid = points[None], valid[None]
    b, n = valid.shape
    nb = num_rings * num_sectors
    xyz = points[..., :3].float().reshape(b * n, 3)
    valid = valid.reshape(-1)

    r = torch.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    theta = torch.atan2(xyz[:, 1], xyz[:, 0])  # [-pi, pi]
    log_r = torch.log(torch.clamp(r, r_min, r_max) / r_min)
    ring = torch.clamp((log_r / math.log(r_max / r_min)
                        * num_rings).to(torch.int64), 0, num_rings - 1)
    sector = torch.clamp(((theta + math.pi)
                          / (2 * math.pi) * num_sectors
                          ).to(torch.int64), 0, num_sectors - 1)
    scan = torch.arange(b, device=xyz.device).repeat_interleave(n)
    gbin = scan * nb + ring * num_sectors + sector
    noise = xyz[:, 2] < -(sensor_height + rnr_floor_margin)
    ok = valid & (r >= r_min * 0.5) & (r <= r_max) & ~noise
    sid = torch.where(ok, gbin, torch.full_like(gbin, b * nb))

    zmin = torch.full((b * nb + 1,), _BIG, device=xyz.device
                      ).scatter_reduce_(0, sid,
                                        torch.where(ok, xyz[:, 2],
                                                    torch.full_like(r, _BIG)),
                                        "amin", include_self=True)[:b * nb]
    inner_pt = ring < num_rings // 2
    seed_w = (ok & (xyz[:, 2] < zmin[gbin] + seed_margin)
              & (~inner_pt | (xyz[:, 2] < -sensor_height + 1.5))).float()
    normal, d, msd, wsum, mean_z = _fit(xyz, seed_w, sid, gbin, b * nb)
    for _ in range(num_iter):
        dist = ((xyz * normal[gbin]).sum(dim=1) + d[gbin]).abs()
        normal, d, msd, wsum, mean_z = _fit(
            xyz, (ok & (dist < dist_thresh)).float(), sid, gbin, b * nb)

    inner = (torch.arange(b * nb, device=xyz.device) % nb) // num_sectors \
        < num_rings // 2
    elev_ok = ~inner | (mean_z < -sensor_height + elev_margin)
    bin_ground = ((normal[:, 2].abs() > uprightness)
                  & (msd < max_surface_var) & (wsum >= 3) & elev_ok)
    dist = ((xyz * normal[gbin]).sum(dim=1) + d[gbin]).abs()
    mask = (ok & bin_ground[gbin] & (dist < dist_thresh)).reshape(b, n)
    return mask[0] if single else mask


def estimate_ground_np(points, device="cuda", **kwargs) -> np.ndarray:
    """Int32 indices of the ground points of one (N, 3+) scan, as
    pypatchworkpp's ``getGroundIndices()`` gives them; the fit runs on
    ``device`` (the card unless the caller asks for the CPU)."""
    pts = torch.as_tensor(np.asarray(points, np.float32)[:, :3],
                          device=device)
    mask = estimate_ground(pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                           device=device), **kwargs)
    return torch.nonzero(mask).reshape(-1).cpu().numpy().astype(np.int32)
