"""SPVCNN, the sparse point-voxel 3D backbone (PyTorch port of
``mopa_tpu/models/spvcnn.py``), eval and training forward.

A sparse voxel UNet after mit-han-lab/spvnas's SPVCNN (stem, 4 strided
stages of two residual blocks, 4 deconv stages with skip concats) beside a
point branch: voxel -> point gathers plus per-point linear layers at the
bottleneck, mid-decoder and end. Voxel -> point is the nearest voxel (the
JAX package's choice over trilinear devoxelisation), so every map comes from
the 5-level :class:`~mopa_tpu_torch.models.scn_unet.UNetPlan` the SCN net
uses, and the submanifold convs go through
:func:`~mopa_tpu_torch.models.scn_unet.apply_submanifold` (K1 / K2 on CUDA
tensors, at the widths above 192 channels as column blocks).

Dtypes follow the JAX package's: the stem and the encoder run in the compute
dtype, but the point layers are flax ``nn.Dense`` without a dtype, which
promote to float32, so from the bottleneck fusion on the decoder and its
convs run in float32 whatever the compute dtype (ROADMAP Queue 3 records
this as the JAX package's behaviour; the port copies it).

Parameters carry the flax names (``stem1``, ``down{i}``, ``res{i}a.conv1``,
``up{tag}``, ``point_transform{j}``, ``*_bn*``), so flax variables cross by
name (``models.weights``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from mopa_tpu_torch.models.resnet34_unet import dropout, init_weights
from mopa_tpu_torch.models.scn_unet import (_BN, UNetPlan, _conv_weight,
                                            apply_submanifold)
from mopa_tpu_torch.ops import sparse_conv as sc

# torchsparse's SPVCNN channel schedule (cr = 1.0)
DEFAULT_CS = (32, 32, 64, 128, 256, 256, 128, 96, 96)
NUM_LEVELS = 5  # stem + 4 strides


class _Rows(NamedTuple):
    """What a masked batch norm reads of its rows: validity and domain."""
    valid: torch.Tensor
    dom: torch.Tensor | None


def compose_point_maps(plan: UNetPlan) -> list:
    """Per level, each point's slot in that level ((N,) int64, -1 for
    padding points)."""
    maps = [plan.point_inverse]
    idx = plan.point_inverse
    for lv in plan.levels[1:]:
        safe = idx.clamp(0, lv.f2c.shape[0] - 1)
        idx = torch.where(idx >= 0, lv.f2c[safe], torch.full_like(idx, -1))
        maps.append(idx)
    return maps


def voxel_to_point(vfeats: torch.Tensor,
                   point_map: torch.Tensor) -> torch.Tensor:
    """Each point's voxel feature (zero for padding points)."""
    out = vfeats[point_map.clamp(0, vfeats.shape[0] - 1)]
    return torch.where((point_map >= 0)[:, None], out, torch.zeros_like(out))


def point_to_voxel(pfeats: torch.Tensor, point_map: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """Mean of the point features of each of ``capacity`` voxels, summed in
    the features' dtype as the JAX package's scatter-add sums them."""
    ok = point_map >= 0
    tgt = torch.where(ok, point_map, torch.full_like(point_map, capacity))
    sums = pfeats.new_zeros((capacity + 1, pfeats.shape[1])).index_add(
        0, tgt, torch.where(ok[:, None], pfeats, torch.zeros_like(pfeats)))
    counts = pfeats.new_zeros((capacity + 1,)).index_add(
        0, tgt, ok.to(pfeats.dtype))
    return sums[:-1] / counts[:-1, None].clamp(min=1.0)


def _promoted_cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.concatenate``'s dtype promotion (bfloat16 with float32 gives
    float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=-1)


class ResidualBlock(nn.Module):
    """Conv3-BN-ReLU-Conv3-BN plus the skip (a 1x1 conv and BN where the
    width changes), then ReLU (torchsparse's ``ResidualBlock``)."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.conv1 = _conv_weight((27, cin, cout), generator)
        self.bn1 = _BN(cout, act=True)
        self.conv2 = _conv_weight((27, cout, cout), generator)
        self.bn2 = _BN(cout, act=False)
        if cin != cout:
            self.down = _conv_weight((1, cin, cout), generator)
            self.bn_skip = _BN(cout, act=False)
        else:
            self.down = None

    def forward(self, x: torch.Tensor, lv, n_domains: int) -> torch.Tensor:
        h = self.bn1(apply_submanifold(x, lv, self.conv1), lv, n_domains)
        h = self.bn2(apply_submanifold(h, lv, self.conv2), lv, n_domains)
        skip = x
        if self.down is not None:
            skip = self.bn_skip(x @ self.down[0].to(x.dtype), lv, n_domains)
        return torch.relu(h + skip)


class SPVCNN(nn.Module):
    """(N, in_channels) point features over a 5-level plan -> (N, cs[8])
    float32 point features. Dropout (p 0.3 after the bottleneck and mid
    fusions) acts in training only, its mask drawn from the caller's
    generator."""

    def __init__(self, in_channels: int = 4, cs: Sequence[int] = DEFAULT_CS,
                 dropout: float = 0.3,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        cs = list(cs)
        self.cs = cs
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.stem1 = _conv_weight((27, in_channels, cs[0]), generator)
        self.stem_bn1 = _BN(cs[0])
        self.stem2 = _conv_weight((27, cs[0], cs[0]), generator)
        self.stem_bn2 = _BN(cs[0])
        for i in range(1, 5):
            self.register_parameter(
                f"down{i}", _conv_weight((8, cs[i - 1], cs[i - 1]),
                                         generator))
            self.add_module(f"down_bn{i}", _BN(cs[i - 1]))
            self.add_module(f"res{i}a",
                            ResidualBlock(cs[i - 1], cs[i], generator))
            self.add_module(f"res{i}b", ResidualBlock(cs[i], cs[i], generator))
        # decoder stages: (tag, input width, output width, skip width)
        stages = (("1", cs[4], cs[5], cs[3]), ("2", cs[5], cs[6], cs[2]),
                  ("3", cs[6], cs[7], cs[1]), ("4", cs[7], cs[8], cs[0]))
        for tag, cin, cout, skip_c in stages:
            self.register_parameter(f"up{tag}",
                                    _conv_weight((8, cin, cout), generator))
            self.add_module(f"up_bn{tag}", _BN(cout))
            self.add_module(f"upres{tag}a",
                            ResidualBlock(cout + skip_c, cout, generator))
            self.add_module(f"upres{tag}b",
                            ResidualBlock(cout, cout, generator))
        for tag, cin, cout in (("0", cs[0], cs[4]), ("1", cs[4], cs[6]),
                               ("2", cs[6], cs[8])):
            self.add_module(f"point_transform{tag}", nn.Linear(cin, cout))
            self.add_module(f"pt_bn{tag}", _BN(cout))
        init_weights(self, generator)

    @property
    def out_channels(self) -> int:
        return self.cs[8]

    def forward(self, point_feats: torch.Tensor, plan: UNetPlan,
                n_domains: int = 1,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if len(plan.levels) != NUM_LEVELS:
            raise ValueError("SPVCNN needs a {}-level plan, got {}".format(
                NUM_LEVELS, len(plan.levels)))
        lv = plan.levels
        nd = n_domains
        p = self.dropout if self.training else 0.0
        pmaps = compose_point_maps(plan)
        pdom = None
        if lv[0].dom is not None:
            pdom = lv[0].dom[pmaps[0].clamp(0, lv[0].dom.shape[0] - 1)]
        prows = _Rows(pmaps[0] >= 0, pdom)

        def point_mlp(feats, tag):
            # flax nn.Dense without a dtype: float32 whatever the input's
            h = getattr(self, f"point_transform{tag}")(feats.float())
            return getattr(self, f"pt_bn{tag}")(h, prows, nd)

        z = point_feats.to(self.compute_dtype)
        cap0 = lv[0].valid.shape[0]
        x0 = apply_submanifold(point_to_voxel(z, pmaps[0], cap0), lv[0],
                               self.stem1)
        x0 = self.stem_bn1(x0, lv[0], nd)
        x0 = self.stem_bn2(apply_submanifold(x0, lv[0], self.stem2), lv[0],
                           nd)
        z0 = voxel_to_point(x0, pmaps[0])

        skips = [x0]
        x = point_to_voxel(z0, pmaps[0], cap0)
        for i in range(1, 5):
            y = sc.strided_conv(x, lv[i].down_nbr, getattr(self, f"down{i}"))
            y = getattr(self, f"down_bn{i}")(y, lv[i], nd)
            y = getattr(self, f"res{i}a")(y, lv[i], nd)
            y = getattr(self, f"res{i}b")(y, lv[i], nd)
            skips.append(y)
            x = y

        # bottleneck point fusion (float32 from here: point_mlp's promotion)
        z1 = voxel_to_point(x, pmaps[4]) + point_mlp(z0, "0")
        z1 = dropout(z1, p, generator)
        y = point_to_voxel(z1, pmaps[4], lv[4].valid.shape[0])
        y = self._up_stage(y, lv, 4, skips[3], nd)
        y = self._up_stage(y, lv, 3, skips[2], nd)

        # mid point fusion
        z2 = voxel_to_point(y, pmaps[2]) + point_mlp(z1, "1")
        z2 = dropout(z2, p, generator)
        y = point_to_voxel(z2, pmaps[2], lv[2].valid.shape[0])
        y = self._up_stage(y, lv, 2, skips[1], nd)
        y = self._up_stage(y, lv, 1, skips[0], nd)

        # final point fusion
        z3 = voxel_to_point(y, pmaps[0]) + point_mlp(z2, "2")
        return z3.float()

    def _up_stage(self, feats: torch.Tensor, lv: tuple, l: int,
                  skip: torch.Tensor, nd: int) -> torch.Tensor:
        """Deconv from plan level l to l - 1, BN, the skip concat and two
        residual blocks (decoder stage ``5 - l``)."""
        tag = str(5 - l)
        nxt, fine = lv[l], lv[l - 1]
        y = sc.deconv(feats, nxt.f2c, nxt.up_off, getattr(self, f"up{tag}"),
                      fine.valid)
        y = getattr(self, f"up_bn{tag}")(y, fine, nd)
        y = _promoted_cat(y, skip)
        y = getattr(self, f"upres{tag}a")(y, fine, nd)
        return getattr(self, f"upres{tag}b")(y, fine, nd)
