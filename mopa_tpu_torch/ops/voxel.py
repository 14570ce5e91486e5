"""Fixed-capacity voxel tables for the sparse UNet (PyTorch port of
``mopa_tpu/ops/voxel.py``).

Replaces ``scn.InputLayer(dim, full_scale, mode=4)`` (point -> voxel dedup
with mean pooling) and ``scn.OutputLayer`` (voxel -> point unmapping).

Tables are built for S samples at once, one row per sample: the same layout as
the reference's ``jax.vmap`` over per-sample ``voxelize`` calls. A voxel key
packs (sample, x, y, z) into ONE int64,
``((sample * 4096 + x) * 4096 + y) * 4096 + z``, which orders exactly like the
reference's (key_hi, key_lo) int32 pair; ``torch.sort`` and
``torch.searchsorted`` on it replace the TPU sort-merge tricks. Tables,
inverse maps and counts equal the reference's bit for bit; only the order of
one voxel's points in the run-order permutation may differ (the reference's
sort is not stable), which pooling does not see beyond float rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Coordinate packing base; coordinates live in [0, SHIFT).
SHIFT = 4096
# Key of padding slots and invalid points: larger than any real key.
PAD_KEY = torch.iinfo(torch.int64).max


class VoxelTable(NamedTuple):
    """S sorted, fixed-capacity tables of active voxels (one row per sample).

    Attributes:
        coords: (S, V, 3) int64 voxel coordinates (0 in padding slots).
        key:    (S, V) int64 sorted packed keys (PAD_KEY in padding slots).
        num:    (S,) int64 active voxels per sample (<= V).
    """

    coords: torch.Tensor
    key: torch.Tensor
    num: torch.Tensor

    def valid_mask(self) -> torch.Tensor:
        return self.key != PAD_KEY


def pack_keys(coords: torch.Tensor, sample: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """(..., 3) coordinates + sample id -> int64 key; invalid -> PAD_KEY."""
    c = coords.long()
    key = ((sample.long() * SHIFT + c[..., 0]) * SHIFT + c[..., 1]) * SHIFT \
        + c[..., 2]
    return torch.where(valid, key, torch.full_like(key, PAD_KEY))


def voxelize(coords: torch.Tensor, valid: torch.Tensor, capacity: int):
    """Per-sample active-voxel tables plus the point -> voxel inverse map.

    Args:
        coords: (S, N, 3) integer coordinates in [0, SHIFT).
        valid: (S, N) bool; invalid rows are padding and ignored.
        capacity: table capacity V. Voxels past it are dropped (their points
            map to -1), exactly as in the reference.

    The input is always sorted here (a stable ``torch.sort``), so unsorted
    points merge their duplicate voxels correctly.

    Returns:
        (table, inverse (S, N) int64 slot or -1, counts (S, V) int64 points
        per voxel, perm (S, N) int64 run order -> original point index).
    """
    s, n = valid.shape
    v = int(capacity)
    dev = coords.device
    sample = torch.arange(s, device=dev)[:, None].expand(s, n)
    key = pack_keys(coords, sample, valid)
    s_key, perm = torch.sort(key, dim=1, stable=True)
    s_valid = s_key != PAD_KEY
    prev = torch.cat([torch.full((s, 1), -1, dtype=torch.int64, device=dev),
                      s_key[:, :-1]], dim=1)
    new_group = (s_key != prev) & s_valid
    vox = torch.cumsum(new_group.long(), dim=1) - 1
    in_cap = vox < v
    s_valid = s_valid & in_cap
    new_group = new_group & in_cap
    vox = torch.where(s_valid, vox, torch.full_like(vox, -1))
    num = new_group.sum(dim=1).clamp(max=v)

    inverse = torch.empty_like(vox).scatter_(1, perm, vox)
    head = torch.where(new_group, vox, torch.full_like(vox, v))  # v = dump
    t_key = torch.full((s, v + 1), PAD_KEY, dtype=torch.int64, device=dev)
    t_key = t_key.scatter_(1, head, s_key)[:, :v].contiguous()
    t_valid = t_key != PAD_KEY
    t_coords = torch.stack([(t_key // (SHIFT * SHIFT)) % SHIFT,
                            (t_key // SHIFT) % SHIFT, t_key % SHIFT], dim=-1)
    t_coords = torch.where(t_valid[..., None], t_coords,
                           torch.zeros_like(t_coords))
    counts = torch.zeros((s, v), dtype=torch.int64, device=dev).scatter_add_(
        1, vox.clamp(0, v - 1), s_valid.long())
    return VoxelTable(coords=t_coords, key=t_key, num=num), inverse, counts, perm


def downsample_coords(table: VoxelTable, capacity: int):
    """Active sites of the next (coarser) level: floor(coords / 2) dedup
    (``scn.Convolution(size=2, stride=2)``'s output-site rule).

    Returns (coarse_table, f2c (S, V) fine slot -> coarse slot or -1)."""
    ctable, f2c, _, _ = voxelize(table.coords // 2, table.valid_mask(),
                                 capacity)
    return ctable, f2c


def pool_features_sorted(feats: torch.Tensor, counts: torch.Tensor,
                         end_pos: torch.Tensor,
                         perm: torch.Tensor) -> torch.Tensor:
    """Mean-pool point features into voxels (``scn.InputLayer`` mode=4).

    Points in run order (``feats[perm]``) put each voxel's points in one
    contiguous run ending at ``end_pos``; each run's sum is a difference of
    two float64 prefix sums, which is exact to float32 precision and, unlike
    a scatter-add, the same on every run of the GPU.

    Args:
        feats: (N, C) point features.
        counts: (V,) points per voxel.
        end_pos: (V,) run-order position of each voxel's last point.
        perm: (N,) run order -> original point index.
    """
    xs = feats[perm].double()
    cs = torch.cat([torch.zeros_like(xs[:1]), torch.cumsum(xs, dim=0)])
    start = end_pos + 1 - counts
    has = counts > 0
    hi = torch.where(has, end_pos + 1, torch.zeros_like(end_pos))
    lo = torch.where(has, start, torch.zeros_like(start))
    pooled = (cs[hi] - cs[lo]) / counts.clamp(min=1).double()[:, None]
    return pooled.to(feats.dtype)


def spread_misses(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` with every negative entry replaced by its own position mod
    ``n``. A gather at these indices reads some row for each miss, which the
    caller masks; unlike clamping all misses to row 0, it leaves the
    gather's backward (a sorted index accumulation that walks each index's
    run in one thread group) no run of ~10^5 entries at one row, which took
    seconds per train step on the card."""
    pos = torch.arange(idx.shape[0], device=idx.device, dtype=idx.dtype)
    return torch.where(idx >= 0, idx, pos % max(int(n), 1))


def unpool_features(vox_feats: torch.Tensor,
                    inverse: torch.Tensor) -> torch.Tensor:
    """Voxel -> point unmapping (``scn.OutputLayer``); padding points get 0."""
    out = vox_feats[spread_misses(inverse, vox_feats.shape[0])]
    return torch.where((inverse >= 0)[:, None], out, torch.zeros_like(out))
