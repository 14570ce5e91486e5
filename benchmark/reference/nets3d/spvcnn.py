"""SPVCNN: Tang et al., ECCV 2020 (mit-han-lab/spvnas
``core/models/semantic_kitti/spvcnn.py``) with the nearest voxel as the
voxel-to-point map: stem, four stride-2 stages of two residual blocks,
four deconv stages with skip concats, and a point branch of linear layers
fused at the bottleneck, mid-decoder and end (dropout 0.3 after the first
two fusions). The stem and encoder run in the compute dtype; the point
layers are float32, so from the first fusion on the decoder runs in
float32. Values: ``in_channels`` (1).

Its check adds ``decoder_gap``, which reads the float32 decoder by itself.
In the first step the hooks keep what each of the decoder's residual
blocks (:data:`DECODER_BLOCKS`, the float32 K1 / K2 convs of the step)
took in and gave out, and each point's voxel slot at every level of the
program's plan. After the window the reference's own block, from the
seeded weights on its own voxel levels, works the block out again from
the program's input: the worst block's relative norm of the difference,
``|prog - ref| / |ref|``. The encoder's rounding, which the step's
numbers see, does not reach it; a float32 decoder computed in TF32 does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.harness import counts
from benchmark.harness.counts import Conv

from .. import sparse3d as sp
from ..net3d import BN, _Rounding, _w, dropout, point_maps, to_voxels

TYPE = "SPVCNN"
CS = (32, 32, 64, 128, 256, 256, 128, 96, 96)
LEVELS = 5
# the float32 decoder's residual blocks, each at plan level 4 - stage
# (``mopa_tpu_torch/models/spvcnn.py``)
DECODER_BLOCKS = tuple("upres{}{}".format(t, ab) for t in "1234"
                       for ab in "ab")


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


class SPVCNN(_Rounding):
    def __init__(self, in_channels: int, compute_dtype: torch.dtype,
                 cs=CS, dropout_rate: float = 0.3):
        super().__init__()
        self.cs = cs
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        self.width = cs[8]
        self.num_levels = LEVELS
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
        pm = point_maps(plan)
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
        x = to_voxels(z0, pm[0], lv[0].key.shape[0])
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
        y = to_voxels(z1, pm[4], lv[4].key.shape[0])
        y = self._up(y, lv, 4, skips[3], nd)
        y = self._up(y, lv, 3, skips[2], nd)
        z2 = sp.unpool(y, pm[2]) + point_mlp(z1, "1")
        z2 = dropout(z2, p, generator)
        y = to_voxels(z2, pm[2], lv[2].key.shape[0])
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


def build(sub: dict, compute_dtype: torch.dtype) -> SPVCNN:
    return SPVCNN(int(sub.get("in_channels", 1)), compute_dtype)


def convs(sub: dict, dtype: torch.dtype) -> list:
    cs, f32 = CS, torch.float32
    out = [Conv("subm", 0, int(sub.get("in_channels", 1)), cs[0], dtype,
                grad_in=False),
           Conv("subm", 0, cs[0], cs[0], dtype)]

    def res(level, cin, cout, dt):
        blk = [Conv("subm", level, cin, cout, dt),
               Conv("subm", level, cout, cout, dt)]
        return blk + ([Conv("one", level, cin, cout, dt)]
                      if cin != cout else [])

    for i in range(1, 5):
        out.append(Conv("down", i, cs[i - 1], cs[i - 1], dtype))
        out += res(i, cs[i - 1], cs[i], dtype) + res(i, cs[i], cs[i], dtype)
    for t, (cin, cout, skip) in enumerate(((cs[4], cs[5], cs[3]),
                                           (cs[5], cs[6], cs[2]),
                                           (cs[6], cs[7], cs[1]),
                                           (cs[7], cs[8], cs[0]))):
        level = 3 - t
        out.append(Conv("up", level, cin, cout, f32))
        out += res(level, cout + skip, cout, f32) + res(level, cout, cout,
                                                       f32)
    return out


def peak_s(sub: dict, dtype, stats: list, n3d: int, n_valid: int,
           heads: int, classes: int) -> float:
    """The float32 seg heads over every point, then the point branch's
    three linear layers over the points in a voxel."""
    cs = CS
    out = heads * counts.dense_peak_s(n3d, cs[8], classes)
    for cin, cout in ((cs[0], cs[4]), (cs[4], cs[6]), (cs[6], cs[8])):
        out += counts.dense_peak_s(n_valid, cin, cout)
    return out


def small(sub: dict) -> dict:
    return dict(sub)


def check_hooks(program_net, readings: dict) -> list:
    """Hooks on the program's 3D net that keep on the host, for the first
    step, each point's slot at the decoder's levels and each decoder
    block's input and output (``readings["decoder"]``)."""
    net = program_net.net_3d
    got = readings["decoder"] = {"blocks": {}}

    def on_plan(mod, args):
        plan = args[1]
        maps = [plan.point_inverse]
        for lv in plan.levels[1:4]:
            prev = maps[-1]
            maps.append(torch.where(prev >= 0,
                                    lv.f2c[prev.clamp(min=0)], prev))
        got["maps"] = [m.cpu() for m in maps]

    def on_block(name):
        def hook(mod, args, out):
            got["blocks"].setdefault(name, []).append(
                (args[0].detach().float().cpu(),
                 out.detach().float().cpu()))
        return hook

    hooks = [net.register_forward_pre_hook(on_plan)]
    hooks += [getattr(net, n).register_forward_hook(on_block(n))
              for n in DECODER_BLOCKS]
    return hooks


def check_gaps(readings: dict, net3d, feats, plan: sp.Plan, nd: int,
               rounding) -> dict:
    """``decoder_gap`` of the program (module docstring) over the first
    step's batch pair, and with a ``rounding`` that of the reference's
    blocks computed with the control's float32 rounding in the program's
    place. inf where the program's levels are not the reference's or a
    block ran other than once."""
    got = readings.get("decoder")
    if got is None:
        return {}
    dev = plan.point_voxel.device
    mine = point_maps(plan)
    out = dict.fromkeys(("program",) if rounding is None
                        else ("program", "control"), 0.0)
    for name in DECODER_BLOCKS:
        level = 4 - int(name[5])
        slots = _slots(mine[level], got["maps"][level].to(dev),
                       plan.levels[level].key.shape[0])
        runs = got["blocks"].get(name, [])
        if slots is None or len(runs) != 1:
            return {who: {"decoder_gap": math.inf} for who in out}
        x, y = (t.to(dev)[slots] for t in runs[0])
        blk = getattr(net3d.net_3d, name)
        with torch.no_grad():
            blk.rounding = {}
            want = blk(x, plan.levels[level], nd)
            out["program"] = max(out["program"], _rel(y, want))
            if rounding is not None:
                blk.rounding = {torch.float32: rounding[torch.float32]}
                out["control"] = max(out["control"], _rel(
                    blk(x, plan.levels[level], nd), want))
        del x, y, want
    return {who: {"decoder_gap": gap} for who, gap in out.items()}


def _slots(mine: torch.Tensor, prog: torch.Tensor, rows: int):
    """The program's slot of each of the reference's ``rows`` voxels, from
    the two point -> voxel maps; None where they disagree: a point in a
    voxel on one side alone, two voxels in one slot, one voxel in two."""
    ok = mine >= 0
    if not torch.equal(ok, prog >= 0):
        return None
    slot = torch.full((rows,), -1, dtype=torch.long, device=mine.device)
    slot[mine[ok]] = prog[ok].long()
    if bool((slot < 0).any()) or not torch.equal(slot[mine[ok]],
                                                 prog[ok].long()) \
            or torch.unique(slot).numel() != rows:
        return None
    return slot


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))
