"""A toy 3D net that the tests add to :mod:`benchmark.reference.nets3d` at
test time (by this directory on the package's path), to show that a net
joins the benchmark with new files alone: a stem conv, one stride-2 conv
and its deconv back, summed with the stem's features. Values: ``m`` (8).

Its count ``toy_voxels`` is the level-0 voxels of a step; its check number
``toy_gap`` reads the backbone's point features of the first step's
source and target scans against the reference's."""

from __future__ import annotations

import torch

from benchmark.harness import counts
from benchmark.harness.counts import Conv
from benchmark.reference import sparse3d as sp
from benchmark.reference.net3d import BN, _Rounding, _w

TYPE = "TOY"


class Toy(_Rounding):
    def __init__(self, m: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.width = m
        self.num_levels = 2
        self.stem = _w(27, 1, m)
        self.bn = BN(m)
        self.down = _w(8, m, 2 * m)
        self.bn_down = BN(2 * m)
        self.up = _w(8, 2 * m, m)
        self.bn_up = BN(m)

    def forward(self, feats, plan: sp.Plan, nd: int, generator=None):
        lv0, lv1 = plan.levels[:2]
        x = sp.pool(feats.to(self.compute_dtype), plan.point_voxel,
                    lv0.key.shape[0])
        x = self.bn(sp.subm_conv(x, lv0, self.stem, self.r(x)), lv0.dom, nd)
        y = self.bn_down(sp.strided_conv(x, lv1, self.down, self.r(x)),
                         lv1.dom, nd)
        y = self.bn_up(sp.deconv(y, lv1, self.up, self.r(y)), lv0.dom, nd)
        return sp.unpool(x + y, plan.point_voxel)


def _m(sub: dict) -> int:
    return int(sub.get("m", 8))


def build(sub: dict, compute_dtype: torch.dtype) -> Toy:
    return Toy(_m(sub), compute_dtype)


def convs(sub: dict, dtype) -> list:
    m = _m(sub)
    return [Conv("subm", 0, 1, m, dtype, grad_in=False),
            Conv("down", 1, m, 2 * m, dtype), Conv("up", 0, 2 * m, m, dtype)]


def peak_s(sub: dict, dtype, stats: list, n3d: int, n_valid: int,
           heads: int, classes: int) -> float:
    return heads * counts.dense_peak_s(n3d, _m(sub), classes)


def small(sub: dict) -> dict:
    return dict(sub, m=4)


def work(sub: dict, dtype, plan, stats: list) -> dict:
    return {"toy_voxels": float(stats[0][0])}


def check_hooks(program_net, readings: dict) -> list:
    """Keep the backbone's point features (``readings["toy"]``)."""
    def hook(mod, args, out):
        readings["toy"] = out.detach().float().cpu()
    return [program_net.net_3d.register_forward_hook(hook)]


def check_gaps(readings: dict, net3d, feats, plan: sp.Plan, nd: int,
               rounding) -> dict:
    got = readings.get("toy")
    if got is None:
        return {}
    with torch.no_grad():
        want = net3d.net_3d(feats, plan, nd).float()
        out = {"program": {"toy_gap": _rel(got.to(want.device), want)}}
        if rounding is not None:
            net3d.set_rounding(rounding)
            out["control"] = {"toy_gap": _rel(
                net3d.net_3d(feats, plan, nd).float(), want)}
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-30))
