"""Voxel-capacity audit of real scans (PyTorch port of
``mopa_tpu/data/capacity_audit.py``).

The plans' per-level voxel tables have fixed capacities
(``models.scn_unet.CAP_FACTORS`` of the point budget), measured on
synthetic LiDAR-geometry scans; a real scan that holds more unique voxels
at a level than its capacity loses voxels there without an error. The
offline preprocess runs a :class:`SplitAuditor` over every ``stride``-th
scan of a split and writes ``capacity_audit_<split>.json`` beside its
``.pkl``, and says loudly when a level would overflow. The counts come from
``data.collate._true_level_nums``, which, unlike the plan builder, does not
clamp at the capacities.
"""

from __future__ import annotations

import json

import numpy as np

from mopa_tpu_torch.data.collate import _true_level_nums
from mopa_tpu_torch.models.scn_unet import CAP_FACTORS


def coords_occupancy(coords: np.ndarray, *, point_budget: int = 16384,
                     cap_factors=None, num_levels: int = 7,
                     rng: "np.random.Generator | None" = None) -> np.ndarray:
    """(L,) share of each level's capacity that one scan's voxel coords
    (scaled ints) fill at the runtime budget: a uniform subsample to
    ``point_budget`` (collate's budget policy), then each level's true
    unique count over its capacity. Above 1.0 the level would overflow."""
    rng = rng or np.random.default_rng(0)
    coords = np.asarray(coords, np.int64)
    if coords.shape[0] > point_budget:
        coords = coords[rng.choice(coords.shape[0], point_budget,
                                   replace=False)]
    factors = tuple(cap_factors) if cap_factors else CAP_FACTORS[:num_levels]
    caps = np.asarray([max(int(point_budget * f), 128) for f in factors],
                      np.float64)
    nums = _true_level_nums(coords, np.ones(coords.shape[0], bool),
                            len(factors))
    return nums.astype(np.float64) / caps


def scan_occupancy(points_xyz: np.ndarray, *, scale: float = 20.0,
                   full_scale: int = 4096, point_budget: int = 16384,
                   cap_factors=None, num_levels: int = 7,
                   rng: "np.random.Generator | None" = None) -> np.ndarray:
    """:func:`coords_occupancy` of one raw scan in meters, voxelized as the
    runtime does with augmentation off: scaled by ``scale``, shifted to its
    minimum, the points inside the ``full_scale`` receptive field kept."""
    pts = np.asarray(points_xyz, np.float64)[:, :3]
    coords = np.round(pts * scale)
    coords -= coords.min(0)
    keep = (coords.min(1) >= 0) & (coords.max(1) < full_scale)
    return coords_occupancy(coords[keep], point_budget=point_budget,
                            cap_factors=cap_factors, num_levels=num_levels,
                            rng=rng)


class SplitAuditor:
    """Collects the occupancies of one split's scans and reports the
    envelope the capacities must cover."""

    def __init__(self, split_name: str, **kw):
        self.split_name = split_name
        self.kw = kw
        self.occ = []

    def add(self, points_xyz: np.ndarray) -> None:
        self.occ.append(scan_occupancy(points_xyz, **self.kw))

    def report(self) -> dict:
        if not self.occ:
            return {"split": self.split_name, "n_scans": 0}
        occ = np.stack(self.occ)  # (N, L)
        return {
            "split": self.split_name,
            "n_scans": int(occ.shape[0]),
            "point_budget": int(self.kw.get("point_budget", 16384)),
            "occupancy_max_per_level": [round(float(x), 4)
                                        for x in occ.max(0)],
            "occupancy_p99_per_level": [
                round(float(x), 4) for x in np.percentile(occ, 99, axis=0)],
            "occupancy_mean_per_level": [round(float(x), 4)
                                         for x in occ.mean(0)],
            "projected_overflow": bool(occ.max() > 1.0),
            "overflow_scan_fraction": round(
                float((occ.max(1) > 1.0).mean()), 4),
        }

    def save(self, path: str, print_fn=print) -> dict:
        """Write :meth:`report` as JSON to ``path``, say whether a level
        would overflow, and return the report."""
        rep = self.report()
        with open(path, "w") as f:
            json.dump(rep, f, indent=1)
        if rep.get("projected_overflow"):
            print_fn(
                "[capacity_audit] *** PROJECTED VOXEL OVERFLOW on split "
                "'{}': occupancy max {} — raise TPU.CAP_FACTORS or the "
                "point budget, or deep UNet levels will silently see a "
                "lexicographic prefix of each scene ({}).".format(
                    self.split_name, rep["occupancy_max_per_level"], path))
        else:
            print_fn("[capacity_audit] split '{}': no projected overflow "
                     "(max occupancy {}) -> {}".format(
                         self.split_name,
                         rep.get("occupancy_max_per_level"), path))
        return rep
