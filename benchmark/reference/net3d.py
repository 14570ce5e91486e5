"""The 3D nets of the reference, in plain PyTorch over
:mod:`.sparse3d`'s levels, with the program's parameter names so that one
dict of seeded tensors loads both.

- :class:`SCN`: SparseConvNet's UNet as xMUDA and MoPA configure it
  (``InputLayer(mode=4)`` -> ``SubmanifoldConvolution(in, m, 3)`` ->
  ``UNet(block_reps=1, planes m, 2m, ..)`` -> ``BatchNormReLU(m)`` ->
  ``OutputLayer``). Level l: BN-ReLU, conv; below it BN-ReLU, stride-2
  conv, the next level, BN-ReLU, deconv, concat with the skip, BN-ReLU,
  conv. BN eps 1e-4.
- :class:`SPVCNN`: Tang et al., ECCV 2020 (mit-han-lab/spvnas
  ``core/models/semantic_kitti/spvcnn.py``) with the nearest voxel as the
  voxel-to-point map: stem, four stride-2 stages of two residual blocks,
  four deconv stages with skip concats, and a point branch of linear
  layers fused at the bottleneck, mid-decoder and end (dropout 0.3 after
  the first two fusions). The stem and encoder run in the compute dtype;
  the point layers are float32, so from the first fusion on the decoder
  runs in float32.
- :class:`Net3DSeg`: the backbone and float32 linear heads.

``set_rounding`` rounds the operands of every GEMM of the net by their
dtype (the control's lower precision); identity otherwise.
"""

from __future__ import annotations

import torch
from torch import nn

from . import sparse3d as sp

SPVCNN_CS = (32, 32, 64, 128, 256, 256, 128, 96, 96)
SPVCNN_LEVELS = 5


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


class SCN(_Rounding):
    def __init__(self, in_channels: int, m: int, num_planes: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
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


class ResidualBlock(_Rounding):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _w(27, cin, cout)
        self.bn1 = BN(cout)
        self.conv2 = _w(27, cout, cout)
        self.bn2 = BN(cout, act=False)
        if cin != cout:
            self.down = _w(1, cin, cout)
            self.bn_skip = BN(cout, act=False)
        else:
            self.down = None

    def forward(self, x, lv: sp.Level, nd: int):
        h = self.bn1(sp.subm_conv(x, lv, self.conv1, self.r(x)), lv.dom, nd)
        h = self.bn2(sp.subm_conv(h, lv, self.conv2, self.r(h)), lv.dom, nd)
        skip = x
        if self.down is not None:
            r = self.r(x)
            skip = self.bn_skip(r(x) @ r(self.down[0].to(x.dtype)), lv.dom,
                                nd)
        return torch.relu(h + skip)


def _point_maps(plan: sp.Plan) -> list:
    """Each point's voxel at every level (-1 for points of no voxel)."""
    maps = [plan.point_voxel]
    for lv in plan.levels[1:]:
        prev = maps[-1]
        maps.append(torch.where(prev >= 0, lv.f2c[prev.clamp(min=0)], prev))
    return maps


def _to_voxels(z: torch.Tensor, pmap: torch.Tensor, n: int) -> torch.Tensor:
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


class SPVCNN(_Rounding):
    def __init__(self, in_channels: int, compute_dtype: torch.dtype,
                 cs=SPVCNN_CS, dropout_rate: float = 0.3):
        super().__init__()
        self.cs = cs
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        self.stem1 = _w(27, in_channels, cs[0])
        self.stem_bn1 = BN(cs[0])
        self.stem2 = _w(27, cs[0], cs[0])
        self.stem_bn2 = BN(cs[0])
        for i in range(1, 5):
            self.register_parameter(f"down{i}", _w(8, cs[i - 1], cs[i - 1]))
            self.add_module(f"down_bn{i}", BN(cs[i - 1]))
            self.add_module(f"res{i}a", ResidualBlock(cs[i - 1], cs[i]))
            self.add_module(f"res{i}b", ResidualBlock(cs[i], cs[i]))
        for tag, cin, cout, skip_c in (("1", cs[4], cs[5], cs[3]),
                                       ("2", cs[5], cs[6], cs[2]),
                                       ("3", cs[6], cs[7], cs[1]),
                                       ("4", cs[7], cs[8], cs[0])):
            self.register_parameter(f"up{tag}", _w(8, cin, cout))
            self.add_module(f"up_bn{tag}", BN(cout))
            self.add_module(f"upres{tag}a",
                            ResidualBlock(cout + skip_c, cout))
            self.add_module(f"upres{tag}b", ResidualBlock(cout, cout))
        for tag, cin, cout in (("0", cs[0], cs[4]), ("1", cs[4], cs[6]),
                               ("2", cs[6], cs[8])):
            self.add_module(f"point_transform{tag}", nn.Linear(cin, cout))
            self.add_module(f"pt_bn{tag}", BN(cout))

    def forward(self, feats, plan: sp.Plan, nd: int, generator=None):
        lv = plan.levels
        p = self.dropout_rate if self.training else 0.0
        pm = _point_maps(plan)
        pvalid = pm[0] >= 0

        def point_mlp(z, tag):
            lin = getattr(self, f"point_transform{tag}")
            zf = z.float()
            r = self.r(zf)
            h = r(zf) @ r(lin.weight).T + lin.bias
            return getattr(self, f"pt_bn{tag}")(h, plan.point_dom, nd,
                                                valid=pvalid)

        z = feats.to(self.compute_dtype)
        x0 = sp.pool(z, pm[0], lv[0].key.shape[0])
        x0 = sp.subm_conv(x0, lv[0], self.stem1, self.r(x0))
        x0 = self.stem_bn1(x0, lv[0].dom, nd)
        x0 = self.stem_bn2(sp.subm_conv(x0, lv[0], self.stem2, self.r(x0)),
                           lv[0].dom, nd)
        z0 = sp.unpool(x0, pm[0])
        skips = [x0]
        x = _to_voxels(z0, pm[0], lv[0].key.shape[0])
        for i in range(1, 5):
            y = sp.strided_conv(x, lv[i], getattr(self, f"down{i}"),
                                self.r(x))
            y = getattr(self, f"down_bn{i}")(y, lv[i].dom, nd)
            y = getattr(self, f"res{i}a")(y, lv[i], nd)
            y = getattr(self, f"res{i}b")(y, lv[i], nd)
            skips.append(y)
            x = y
        z1 = sp.unpool(x, pm[4]) + point_mlp(z0, "0")
        z1 = dropout(z1, p, generator)
        y = _to_voxels(z1, pm[4], lv[4].key.shape[0])
        y = self._up(y, lv, 4, skips[3], nd)
        y = self._up(y, lv, 3, skips[2], nd)
        z2 = sp.unpool(y, pm[2]) + point_mlp(z1, "1")
        z2 = dropout(z2, p, generator)
        y = _to_voxels(z2, pm[2], lv[2].key.shape[0])
        y = self._up(y, lv, 2, skips[1], nd)
        y = self._up(y, lv, 1, skips[0], nd)
        return (sp.unpool(y, pm[0]) + point_mlp(z2, "2")).float()

    def _up(self, x, lv, l, skip, nd):
        tag = str(5 - l)
        y = sp.deconv(x, lv[l], getattr(self, f"up{tag}"), self.r(x))
        y = getattr(self, f"up_bn{tag}")(y, lv[l - 1].dom, nd)
        dt = torch.promote_types(y.dtype, skip.dtype)
        y = torch.cat([y.to(dt), skip.to(dt)], dim=-1)
        y = getattr(self, f"upres{tag}a")(y, lv[l - 1], nd)
        return getattr(self, f"upres{tag}b")(y, lv[l - 1], nd)


class Net3DSeg(nn.Module):
    def __init__(self, backbone: str, num_classes: int, dual_head: bool,
                 compute_dtype: torch.dtype, in_channels: int = 1,
                 m: int = 16, num_planes: int = 7):
        super().__init__()
        if backbone == "SCN":
            self.net_3d = SCN(in_channels, m, num_planes, compute_dtype)
            width = m
            self.num_levels = num_planes
        elif backbone == "SPVCNN":
            self.net_3d = SPVCNN(in_channels, compute_dtype)
            width = SPVCNN_CS[8]
            self.num_levels = SPVCNN_LEVELS
        else:
            raise ValueError("no reference for the 3D net " + backbone)
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
