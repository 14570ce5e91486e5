"""What the reference's 3D nets share, in plain PyTorch over
:mod:`.sparse3d`'s levels, and :class:`Net3DSeg`: the backbone that
``MODEL_3D.TYPE`` names (one module of :mod:`.nets3d` each, with the
program's parameter names, so that one dict of seeded tensors loads both)
and float32 linear heads.

``set_rounding`` rounds the operands of every GEMM of the net by their
dtype (the control's lower precision); identity otherwise.
"""

from __future__ import annotations

import torch
from torch import nn

from . import nets3d
from . import sparse3d as sp


class BN(nn.Module):
    def __init__(self, c: int, act: bool = True):
        super().__init__()
        self.act = act
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, dom, nd, valid=None):
        return sp.batch_norm(x, dom, nd, self.scale, self.bias, self.mean,
                             self.var, self.training, act=self.act,
                             valid=valid)


def _w(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class _Rounding(nn.Module):
    """Operand rounding of the GEMMs, by operand dtype (``rounding``)."""

    rounding: dict = {}

    def r(self, x: torch.Tensor):
        return self.rounding.get(x.dtype, sp.identity)


def point_maps(plan: sp.Plan) -> list:
    """Each point's voxel at every level (-1 for points of no voxel)."""
    maps = [plan.point_voxel]
    for lv in plan.levels[1:]:
        prev = maps[-1]
        maps.append(torch.where(prev >= 0, lv.f2c[prev.clamp(min=0)], prev))
    return maps


def to_voxels(z: torch.Tensor, pmap: torch.Tensor, n: int) -> torch.Tensor:
    """Each voxel's mean of its points' features, summed in float32."""
    ok = pmap >= 0
    idx = pmap[ok]
    sums = torch.zeros((n, z.shape[1]), device=z.device).index_add(
        0, idx, z[ok].float())
    cnt = torch.zeros(n, device=z.device).index_add(
        0, idx, torch.ones(idx.shape[0], device=z.device))
    return (sums / cnt.clamp(min=1.0)[:, None]).to(z.dtype)


def dropout(x, p: float, generator):
    """Keep with probability 1 - p and scale by 1 / (1 - p); the mask is
    drawn over every row, padding points' too, as the program draws it."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Net3DSeg(nn.Module):
    """The backbone of the 3D net ``backbone`` (``MODEL_3D.TYPE``) built
    from ``sub`` (its ``MODEL_3D.<TYPE>`` values), then the seg heads."""

    def __init__(self, backbone: str, sub: dict, num_classes: int,
                 dual_head: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.net_3d = nets3d.find(backbone).build(sub, compute_dtype)
        self.num_levels = self.net_3d.num_levels
        width = self.net_3d.width
        self.linear = nn.Linear(width, num_classes)
        self.linear2 = nn.Linear(width, num_classes) if dual_head else None

    def set_rounding(self, rounding: dict) -> None:
        for mod in self.modules():
            if isinstance(mod, _Rounding):
                mod.rounding = rounding

    def forward(self, feats, plan, nd: int = 1, generator=None) -> dict:
        f = self.net_3d(feats, plan, nd, generator).float()
        out = {"feats": f, "seg_logit": self.linear(f)}
        if self.linear2 is not None:
            out["seg_logit2"] = self.linear2(f)
        return out
