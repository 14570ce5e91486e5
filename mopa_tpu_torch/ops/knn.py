"""Range-image KNN post-processing of 3D predictions (PyTorch port of
``mopa_tpu/ops/knn.py``; reference ``mopa/models/knn.py:37-196``), used by
``validate`` when ``VAL.use_knn``.

For each point, the ``search`` x ``search`` range-image neighbourhood of
its pixel is gathered, the |range difference| weighted by an
inverse-gaussian spatial kernel, the ``k`` nearest kept, those beyond
``cutoff`` dropped, and the rest vote: by label, or with ``output_prob``
(``VAL.knn_prob``) by summing their class probabilities (the JAX package's
working form of the reference's flagged probability variant). Plain
PyTorch on the device; a scan at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from mopa_tpu_torch.ops.projection import project_pixels


def gaussian_kernel_2d(size: int, sigma: float) -> np.ndarray:
    """Normalised 2D gaussian (the reference's ``get_gaussian_kernel``)."""
    ax = np.arange(size) - size // 2
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


def build_range_image(points, fov_up, fov_down, proj_w, proj_h, values,
                      valid):
    """Rasterise per-point ranges and values into a range image, the
    nearest valid point winning each pixel: (range image (H, W), -1 where
    empty; value image (H, W) int labels or (H, W, C) probabilities; px;
    py; each point's range)."""
    n_pix = proj_h * proj_w
    pix, depth = project_pixels(points[:, :3], fov_up, fov_down, proj_w,
                                proj_h)
    big = torch.tensor(1e30, dtype=depth.dtype, device=depth.device)
    d = torch.where(valid, depth, big)
    dmin = torch.full((n_pix,), 1e30, dtype=d.dtype, device=d.device)
    dmin = dmin.scatter_reduce(0, pix, d, reduce="amin")
    winner = valid & (d <= dmin[pix])
    img_range = torch.where(dmin < big, dmin,
                            torch.full_like(dmin, -1.0)).reshape(proj_h,
                                                                  proj_w)
    if values.dim() == 1:
        vals = torch.zeros((n_pix,), dtype=values.dtype, device=values.device)
        vals = vals.scatter_reduce(
            0, torch.where(winner, pix, torch.full_like(pix, n_pix - 1)),
            torch.where(winner, values, torch.zeros_like(values)),
            reduce="amax")
        img_vals = vals.reshape(proj_h, proj_w)
    else:
        vals = torch.zeros((n_pix, values.shape[-1]), dtype=values.dtype,
                           device=values.device)
        vals = vals.index_add(0, torch.where(winner, pix,
                                             torch.zeros_like(pix)),
                              torch.where(winner[:, None], values,
                                          torch.zeros_like(values)))
        img_vals = vals.reshape(proj_h, proj_w, -1)
    return img_range, img_vals, pix % proj_w, pix // proj_w, depth


def knn_postprocess(proj_range, unproj_range, proj_values, px, py, valid, *,
                    nclasses: int, search: int = 5, k: int = 5,
                    sigma: float = 1.0, cutoff: float = 1.0,
                    output_prob: bool = False):
    """(P,) voted labels, or (P, C) summed neighbour probabilities with
    ``output_prob``, from a range image (H, W) (< 0 empty), each point's
    range (P,), the value image (H, W) or (H, W, C) and each point's pixel;
    invalid points give 0. Among equal distances the lower neighbourhood
    index comes first, as XLA's ``top_k`` orders them."""
    h, w = proj_range.shape
    pad = (search - 1) // 2
    offs = [(dy, dx) for dy in range(-pad, pad + 1)
            for dx in range(-pad, pad + 1)]
    center = (search * search - 1) // 2
    py = py.clamp(0, h - 1)
    px = px.clamp(0, w - 1)
    inf = torch.tensor(float("inf"), dtype=proj_range.dtype,
                       device=proj_range.device)
    ranges, coords = [], []
    for dy, dx in offs:
        yy = (py + dy).clamp(0, h - 1)
        xx = (px + dx).clamp(0, w - 1)
        inb = (py + dy >= 0) & (py + dy < h) & (px + dx >= 0) & (px + dx < w)
        r = proj_range[yy, xx]
        ranges.append(torch.where((r < 0) | ~inb, inf, r))
        coords.append((yy, xx))
    ranges = torch.stack(ranges, 0)  # (S2, P)
    ranges[center] = unproj_range
    inv_gauss = torch.as_tensor(
        1.0 - gaussian_kernel_2d(search, sigma).reshape(-1),
        dtype=ranges.dtype, device=ranges.device)
    dist = (ranges - unproj_range[None, :]).abs() * inv_gauss[:, None]
    knn_dist, idx = torch.sort(dist.T, dim=1, stable=True)
    knn_dist, idx = knn_dist[:, :k], idx[:, :k]  # (P, k)
    vals = torch.stack([proj_values[yy, xx] for yy, xx in coords], 0)
    if not output_prob:
        knn_lab = torch.gather(vals.T, 1, idx)
        knn_lab = torch.where(knn_dist > cutoff,
                              torch.full_like(knn_lab, nclasses), knn_lab)
        votes = torch.zeros((knn_lab.shape[0], nclasses + 1),
                            dtype=torch.int32, device=knn_lab.device)
        votes.scatter_add_(1, knn_lab.long(),
                           torch.ones_like(knn_lab, dtype=torch.int32))
        out = votes[:, :nclasses].argmax(-1)
        return torch.where(valid, out, torch.zeros_like(out))
    knn_p = torch.gather(vals.permute(1, 0, 2), 1,
                         idx[:, :, None].expand(-1, -1, vals.shape[-1]))
    knn_p = torch.where((knn_dist > cutoff)[:, :, None],
                        torch.zeros_like(knn_p), knn_p)
    out = knn_p.sum(1)
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def knn_postprocess_scan(points, valid, values, *, nclasses: int,
                         fov_up: float, fov_down: float, proj_w: int,
                         proj_h: int, k: int = 5, search: int = 5,
                         sigma: float = 1.0, cutoff: float = 1.0,
                         output_prob: bool = False):
    """One scan's predictions re-voted from its range image: ``points``
    (P, >= 3) in the sensor frame, ``valid`` (P,) bool, ``values`` (P,) int
    labels or (P, C) probabilities with ``output_prob``. Returns (P,)
    labels or (P, C) neighbour-summed probabilities."""
    img_range, img_vals, px, py, depth = build_range_image(
        points[:, :3], fov_up, fov_down, proj_w, proj_h, values, valid)
    return knn_postprocess(img_range, depth, img_vals, px, py, valid,
                           nclasses=nclasses, search=search, k=k,
                           sigma=sigma, cutoff=cutoff,
                           output_prob=output_prob)
