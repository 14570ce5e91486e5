"""SCN: SparseConvNet's UNet as xMUDA and MoPA configure it
(``InputLayer(mode=4)`` -> ``SubmanifoldConvolution(in, m, 3)`` ->
``UNet(block_reps=1, planes m, 2m, ..)`` -> ``BatchNormReLU(m)`` ->
``OutputLayer``). Level l: BN-ReLU, conv; below it BN-ReLU, stride-2
conv, the next level, BN-ReLU, deconv, concat with the skip, BN-ReLU,
conv. BN eps 1e-4. Values: ``in_channels`` (1), ``m`` (16),
``num_planes`` (7)."""

from __future__ import annotations

import torch

from benchmark.harness import counts
from benchmark.harness.counts import Conv

from .. import sparse3d as sp
from ..net3d import BN, _Rounding, _w

TYPE = "SCN"


def _sizes(sub: dict) -> tuple:
    return (int(sub.get("in_channels", 1)), int(sub.get("m", 16)),
            int(sub.get("num_planes", 7)))


class SCN(_Rounding):
    def __init__(self, in_channels: int, m: int, num_planes: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.width = m
        self.num_levels = num_planes
        self.planes = [(i + 1) * m for i in range(num_planes)]
        self.stem = _w(27, in_channels, m)
        for l, p in enumerate(self.planes):
            self.add_module(f"l{l}_bn1", BN(p))
            self.register_parameter(f"l{l}_conv1", _w(27, p, p))
            if l + 1 < num_planes:
                q = self.planes[l + 1]
                self.add_module(f"l{l}_bn_down", BN(p))
                self.register_parameter(f"l{l}_down", _w(8, p, q))
                self.add_module(f"l{l}_bn_up", BN(q))
                self.register_parameter(f"l{l}_up", _w(8, q, p))
                self.add_module(f"l{l}_bn2", BN(2 * p))
                self.register_parameter(f"l{l}_conv2", _w(27, 2 * p, p))
        self.final_bn = BN(m)

    def forward(self, feats, plan: sp.Plan, nd: int, generator=None):
        lv0 = plan.levels[0]
        x = sp.pool(feats.to(self.compute_dtype), plan.point_voxel,
                    lv0.key.shape[0])
        x = sp.subm_conv(x, lv0, self.stem, self.r(x))
        x = self._level(0, x, plan, nd)
        x = self.final_bn(x, lv0.dom, nd)
        return sp.unpool(x, plan.point_voxel)

    def _level(self, l, x, plan, nd):
        lv = plan.levels[l]
        x = getattr(self, f"l{l}_bn1")(x, lv.dom, nd)
        x = sp.subm_conv(x, lv, getattr(self, f"l{l}_conv1"), self.r(x))
        if l + 1 < len(self.planes):
            nxt = plan.levels[l + 1]
            skip = x
            y = getattr(self, f"l{l}_bn_down")(x, lv.dom, nd)
            y = sp.strided_conv(y, nxt, getattr(self, f"l{l}_down"),
                                self.r(y))
            y = self._level(l + 1, y, plan, nd)
            y = getattr(self, f"l{l}_bn_up")(y, nxt.dom, nd)
            y = sp.deconv(y, nxt, getattr(self, f"l{l}_up"), self.r(y))
            x = getattr(self, f"l{l}_bn2")(torch.cat([skip, y], dim=-1),
                                           lv.dom, nd)
            x = sp.subm_conv(x, lv, getattr(self, f"l{l}_conv2"), self.r(x))
        return x


def build(sub: dict, compute_dtype: torch.dtype) -> SCN:
    return SCN(*_sizes(sub), compute_dtype)


def convs(sub: dict, dtype: torch.dtype) -> list:
    in_channels, m, num_planes = _sizes(sub)
    planes = [(i + 1) * m for i in range(num_planes)]
    out = [Conv("subm", 0, in_channels, m, dtype, grad_in=False)]
    for l, p in enumerate(planes):
        out.append(Conv("subm", l, p, p, dtype))
        if l + 1 < num_planes:
            q = planes[l + 1]
            out += [Conv("down", l + 1, p, q, dtype),
                    Conv("up", l, q, p, dtype),
                    Conv("subm", l, 2 * p, p, dtype)]
    return out


def peak_s(sub: dict, dtype, stats: list, n3d: int, n_valid: int,
           heads: int, classes: int) -> float:
    """The float32 seg heads over every point."""
    return heads * counts.dense_peak_s(n3d, _sizes(sub)[1], classes)


def small(sub: dict) -> dict:
    return dict(sub, m=4, num_planes=3)
