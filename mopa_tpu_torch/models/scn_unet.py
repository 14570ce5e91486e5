"""3D submanifold sparse-conv UNet (PyTorch port of
``mopa_tpu/models/scn_unet.py``), eval and training forward.

``scn.InputLayer(3, full_scale, mode=4)`` -> ``SubmanifoldConvolution(1, m, 3)``
-> ``scn.UNet(3, block_reps=1, planes=[m, 2m, ..., 7m])`` -> ``BatchNormReLU(m)``
-> ``scn.OutputLayer(3)``. The UNet level graph (VGG-style, reps=1)::

    U(l):  BN(p_l) -> SubConv(p_l -> p_l)                          # block
           if l+1 < L:
               skip = x
               BN(p_l) -> Convolution(p_l -> p_{l+1}, k2 s2)
               U(l+1)
               BN(p_{l+1}) -> Deconvolution(p_{l+1} -> p_l, k2 s2)
               x = concat([skip, up])
               BN(2 p_l) -> SubConv(2 p_l -> p_l)                   # fuse

The voxel tables and maps of a batch are built once into a :class:`UNetPlan`
(a pure function of the coordinates); the module then runs gather-GEMM
compute only. The plan is the reference's flat layout: level-l capacity
S * cap_l, slots sample-major, every integer equal to the reference's.
Several forwards fuse into one (the train step's [source; target] scans):
each level then carries the batch-norm domain of every slot (``dom``) and the
batch norms of a training forward take statistics per domain.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
from torch import nn

from mopa_tpu_torch.ops import sparse_conv as sc
from mopa_tpu_torch.ops import voxel as voxel_ops


class LevelPlan(NamedTuple):
    valid: torch.Tensor            # (V_l,) active-slot mask
    # transition from the previous (finer) level; None at level 0
    down_nbr: torch.Tensor | None  # (V_l, 8) coarse -> fine gather map
    f2c: torch.Tensor | None       # (V_{l-1},) fine -> coarse slot map
    up_off: torch.Tensor | None    # (V_{l-1},) deconv kernel-offset index
    ranks: torch.Tensor            # (V_l * 9,) int32 wide-column plan
    sel: torch.Tensor              # (V_l * 9,) int32 packed dz codes
    dom: torch.Tensor | None = None  # (V_l,) BN-domain id (fused forwards)


class UNetPlan(NamedTuple):
    levels: tuple
    point_inverse: torch.Tensor  # (N,) point -> level-0 slot (-1 padding)
    point_counts: torch.Tensor   # (V_0,) points per voxel
    num_voxels: torch.Tensor     # (L,) active voxels per level
    point_end: torch.Tensor      # (V_0,) run-order position of last point
    point_perm: torch.Tensor     # (N,) run order -> original point index


# Per-level capacity as a fraction of the point budget; sized to hold the true
# per-level unique-voxel counts of LiDAR-geometry scans at the 16,384-point
# budget with ~8-10% headroom (the reference's measured schedule).
CAP_FACTORS = (0.95, 0.82, 0.67, 0.42, 0.15, 0.047, 0.017)


def capacity_schedule(n_points: int, num_levels: int,
                      factors=None, floor: int = 128) -> List[int]:
    """Static per-level voxel capacities (fractions of the point budget)."""
    factors = list(CAP_FACTORS if factors is None else factors)
    while len(factors) < num_levels:  # extend geometrically past the table
        factors.append(factors[-1] * 0.5)
    return [max(int(n_points * factors[l]), floor)
            for l in range(num_levels)]


def build_unet_plan_batched(coords: torch.Tensor, valid: torch.Tensor,
                            num_levels: int,
                            capacities: Sequence[int] | None = None,
                            sample_domains: Sequence[int] | None = None
                            ) -> UNetPlan:
    """Per-sample plans for S scans, stitched into one flat plan.

    Args:
        coords: (S, P, 3) integer per-sample coordinates in [0, 4096).
        valid: (S, P) bool.
        sample_domains: optional (S,) BN-domain id per sample; each level's
            ``dom`` then repeats it over the sample's slots.

    Points need not be sorted: level 0 sorts them (the reference's eval path
    skips that sort on the promise of sorted input and then mis-merges
    unsorted scans; see ROADMAP Queue 3).
    """
    s, p = valid.shape
    if capacities is None:
        capacities = capacity_schedule(p, num_levels)
    capacities = [int(c) for c in capacities]
    dev = coords.device

    table, inverse, counts, perm = voxel_ops.voxelize(coords, valid,
                                                      capacities[0])
    end_pos = torch.cumsum(counts, dim=1) - 1

    def offset_flat(arr, cap):
        """(S, cap[, K]) slot array -> flat global slots; -1 stays -1."""
        off = (torch.arange(s, device=dev) * cap).reshape(
            (s,) + (1,) * (arr.dim() - 1))
        out = torch.where(arr >= 0, arr + off, torch.full_like(arr, -1))
        return out.reshape((s * arr.shape[1],) + tuple(arr.shape[2:]))

    doms = None
    if sample_domains is not None:
        doms = torch.as_tensor(sample_domains, dtype=torch.int64, device=dev)
    levels = []
    nums = []
    prev = table
    pending = None  # (down_nbr, f2c, up_off) feeding the next level
    for l in range(num_levels):
        cap = capacities[l]
        nums.append(prev.num)
        ranks, sel = sc.wide_from_nbr(sc.build_submanifold_plan(prev), cap)
        down_nbr = f2c = up_off = None
        if pending is not None:
            down_b, f2c_b, up_b = pending
            down_nbr = offset_flat(down_b, capacities[l - 1])
            f2c = offset_flat(f2c_b, cap)
            up_off = up_b.reshape(-1)
        levels.append(LevelPlan(
            valid=prev.valid_mask().reshape(-1), down_nbr=down_nbr, f2c=f2c,
            up_off=up_off,
            ranks=offset_flat(ranks, cap).to(torch.int32).reshape(-1),
            sel=sel.to(torch.int32).reshape(-1),
            dom=None if doms is None else doms.repeat_interleave(cap)))
        if l + 1 < num_levels:
            coarse, f2c_b = voxel_ops.downsample_coords(prev,
                                                        capacities[l + 1])
            up_b = sc.up_offset_index(prev.coords)
            pending = (sc.down_plan_from_f2c(f2c_b, up_b, prev.valid_mask(),
                                             capacities[l + 1]), f2c_b, up_b)
            prev = coarse
    poff = (torch.arange(s, device=dev) * p)[:, None]
    return UNetPlan(levels=tuple(levels),
                    point_inverse=offset_flat(inverse, capacities[0]),
                    point_counts=counts.reshape(-1),
                    num_voxels=torch.stack(nums).sum(dim=1),
                    point_end=(end_pos + poff).reshape(-1),
                    point_perm=(perm + poff).reshape(-1))


def apply_submanifold(x: torch.Tensor, lv: LevelPlan,
                      weight: torch.Tensor) -> torch.Tensor:
    """Submanifold conv through the level's wide-column plan (the K1
    kernel on CUDA tensors)."""
    return sc.submanifold_conv_wide(x, sc.WidePlan(lv.ranks, lv.sel), weight)


class _BN(nn.Module):
    """Masked BatchNorm(+ReLU) over active voxels (eps 1e-4, momentum 0.9):
    running statistics in eval mode, batch statistics (per domain when the
    plan carries domains) in training mode, which also updates the running
    buffers. Names follow the reference: scale, bias, mean, var."""

    def __init__(self, features: int, leakiness: float = 0.0,
                 act: bool = True, eps: float = 1e-4):
        super().__init__()
        self.leakiness = leakiness
        self.act = act
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, lv: LevelPlan,
                n_domains: int = 1) -> torch.Tensor:
        return sc.batch_norm_act(x, self.scale, self.bias, self.mean,
                                 self.var, training=self.training,
                                 valid=lv.valid, dom=lv.dom,
                                 n_domains=n_domains, eps=self.eps,
                                 leakiness=self.leakiness, act=self.act)


def _conv_weight(shape, generator) -> nn.Parameter:
    """SCN-style init: normal with std sqrt(2 / (kernel_volume * fan_in)).
    Held in float32 like every parameter of the reference; the convs cast to
    the compute dtype at use."""
    k, cin, _ = shape
    std = (2.0 / (k * cin)) ** 0.5
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class SparseUNet(nn.Module):
    """The scn.UNet stack (stem conv + recursive UNet + final BNReLU).

    ``full_scale`` is accepted for config compatibility; coordinates must lie
    in [0, 4096) whatever its value, as in the reference.

    Parameters are named as the reference's flax variables (``stem``,
    ``l{l}_conv1``, ``l{l}_bn1.scale``, ...), so flax checkpoints cross by
    name (``models.weights``)."""

    def __init__(self, in_channels: int = 1, m: int = 16, num_planes: int = 7,
                 block_reps: int = 1, residual_blocks: bool = False,
                 full_scale: int = 4096,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if residual_blocks or block_reps != 1:
            raise NotImplementedError(
                "shipped configs use VGG-style blocks with block_reps=1")
        self.compute_dtype = compute_dtype
        self.planes = [(i + 1) * m for i in range(num_planes)]
        self.stem = _conv_weight((27, in_channels, m), generator)
        for l, p in enumerate(self.planes):
            self.add_module(f"l{l}_bn1", _BN(p))
            self.register_parameter(f"l{l}_conv1",
                                    _conv_weight((27, p, p), generator))
            if l + 1 < num_planes:
                q = self.planes[l + 1]
                self.add_module(f"l{l}_bn_down", _BN(p))
                self.register_parameter(f"l{l}_down",
                                        _conv_weight((8, p, q), generator))
                self.add_module(f"l{l}_bn_up", _BN(q))
                self.register_parameter(f"l{l}_up",
                                        _conv_weight((8, q, p), generator))
                self.add_module(f"l{l}_bn2", _BN(2 * p))
                self.register_parameter(f"l{l}_conv2",
                                        _conv_weight((27, 2 * p, p),
                                                     generator))
        self.final_bn = _BN(m)

    def forward(self, point_feats: torch.Tensor, plan: UNetPlan,
                n_domains: int = 1) -> torch.Tensor:
        """(N, in_channels) point features -> (N, m) in the compute dtype.
        ``n_domains`` > 1 fuses that many forwards whose slots the plan's
        ``dom`` assigns (training-mode batch norm per domain)."""
        x = voxel_ops.pool_features_sorted(
            point_feats.to(self.compute_dtype), plan.point_counts,
            plan.point_end, plan.point_perm)
        x = apply_submanifold(x, plan.levels[0], self.stem)
        x = self._level(0, x, plan, n_domains)
        x = self.final_bn(x, plan.levels[0], n_domains)
        return voxel_ops.unpool_features(x, plan.point_inverse)

    def _level(self, l: int, x: torch.Tensor, plan: UNetPlan,
               n_domains: int) -> torch.Tensor:
        lv = plan.levels[l]
        x = getattr(self, f"l{l}_bn1")(x, lv, n_domains)
        x = apply_submanifold(x, lv, getattr(self, f"l{l}_conv1"))
        if l + 1 < len(self.planes):
            nxt = plan.levels[l + 1]
            skip = x
            y = getattr(self, f"l{l}_bn_down")(x, lv, n_domains)
            y = sc.strided_conv(y, nxt.down_nbr, getattr(self, f"l{l}_down"))
            y = self._level(l + 1, y, plan, n_domains)
            y = getattr(self, f"l{l}_bn_up")(y, nxt, n_domains)
            y = sc.deconv(y, nxt.f2c, nxt.up_off, getattr(self, f"l{l}_up"),
                          lv.valid)
            x = getattr(self, f"l{l}_bn2")(torch.cat([skip, y], dim=-1), lv,
                                           n_domains)
            x = apply_submanifold(x, lv, getattr(self, f"l{l}_conv2"))
        return x
