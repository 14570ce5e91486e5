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

A level's submanifold convs take whichever form its plan carries, routed as
the reference routes them: a z-dense plan (``p2a``), else the wide-column
plan (``ranks``/``sel``: the K1 kernel on CUDA tensors), else the exact
neighbour map (``nbr``). The shipped plans (:func:`build_unet_plan_batched`,
:func:`plan_from_host_arrays`) are wide; the reference's monolithic
:func:`build_unet_plan` gives ``nbr`` levels and no run ends, so its input
pooling is one scatter-add (``voxel.pool_features``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
from torch import nn

from mopa_tpu_torch.common.spans import span
from mopa_tpu_torch.ops import sparse_conv as sc
from mopa_tpu_torch.ops import voxel as voxel_ops


class LevelPlan(NamedTuple):
    valid: torch.Tensor            # (V_l,) active-slot mask
    # transition from the previous (finer) level; None at level 0
    down_nbr: torch.Tensor | None  # (V_l, 8) coarse -> fine gather map
    f2c: torch.Tensor | None       # (V_{l-1},) fine -> coarse slot map
    up_off: torch.Tensor | None    # (V_{l-1},) deconv kernel-offset index
    # wide-column plan (int32; with p2a: z-dense padded-slot starts)
    ranks: torch.Tensor | None = None  # (V_l * 9,)
    sel: torch.Tensor | None = None    # (V_l * 9,) packed dz codes
    dom: torch.Tensor | None = None    # (V_l,) BN-domain id (fused forwards)
    nbr: torch.Tensor | None = None    # (V_l, 27) exact neighbour map
    p2a: torch.Tensor | None = None    # (Vp_l,) z-dense active slot map


class UNetPlan(NamedTuple):
    levels: tuple
    point_inverse: torch.Tensor  # (N,) point -> level-0 slot (-1 padding)
    point_counts: torch.Tensor   # (V_0,) points per voxel
    num_voxels: torch.Tensor     # (L,) active voxels per level
    # run-order pooling: the last point of each voxel in run order and the
    # run order -> original point map; None = scatter pooling
    point_end: torch.Tensor | None = None   # (V_0,)
    point_perm: torch.Tensor | None = None  # (N,)


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


def build_unet_plan(coords: torch.Tensor, batch_idx: torch.Tensor,
                    valid: torch.Tensor, num_levels: int,
                    capacities: Sequence[int] | None = None,
                    batch_domains: Sequence[int] | None = None) -> UNetPlan:
    """The reference's monolithic plan of a flat batch: one voxel table per
    level over all N points, its batch index in the key, exact (V, 27)
    neighbour maps (``nbr`` levels) and no run ends (scatter pooling).

    Args:
        coords: (N, 3) integer coordinates in [0, 4096).
        batch_idx: (N,) each point's scan.
        valid: (N,) bool.
        capacities: per-level capacities (default: the schedule of N).
        batch_domains: optional BN-domain id per scan; each slot's ``dom``
            is its scan's.
    """
    n = coords.shape[0]
    if capacities is None:
        capacities = capacity_schedule(n, num_levels)
    capacities = [int(c) for c in capacities]
    doms = None
    if batch_domains is not None:
        doms = torch.as_tensor(batch_domains, dtype=torch.int64,
                               device=coords.device)
    table, inverse, counts, _ = voxel_ops.voxelize(
        coords[None], valid[None], capacities[0], batch=batch_idx[None])
    levels = []
    nums = []
    prev = table
    pending = (None, None, None)  # (down_nbr, f2c, up_off) into this level
    for l in range(num_levels):
        nums.append(prev.num[0])
        dom = (None if doms is None else
               doms[prev.batch[0].clamp(0, doms.shape[0] - 1)])
        levels.append(LevelPlan(
            valid=prev.valid_mask()[0], down_nbr=pending[0], f2c=pending[1],
            up_off=pending[2], dom=dom,
            nbr=sc.build_submanifold_plan(prev)[0]))
        if l + 1 < num_levels:
            coarse, f2c = voxel_ops.downsample_coords(prev,
                                                      capacities[l + 1])
            up_off = sc.up_offset_index(prev.coords)
            down_nbr = sc.down_plan_from_f2c(f2c, up_off, prev.valid_mask(),
                                             capacities[l + 1])
            pending = (down_nbr[0], f2c[0], up_off[0])
            prev = coarse
    return UNetPlan(levels=tuple(levels), point_inverse=inverse[0],
                    point_counts=counts[0], num_voxels=torch.stack(nums))


HOST_PLAN_KEYS = ("rankn", "ebits", "cbits", "downn", "downe", "f2c",
                  "upoffn", "inverse", "counts", "nums", "fix")


def _sel_code(e0: bool, e1: bool, e2: bool) -> int:
    """The packed dz code of a column from its three dz existence bits
    (``sparse_conv.wide_from_nbr``'s t0/t1/t2)."""
    t0 = 0 if e0 else 1 if e1 else 2 if e2 else 3
    t1 = 1 if e0 and e1 else 2 if (e0 or e1) and e2 else 3
    t2 = 2 if e0 and e1 and e2 else 3
    return t0 + (t1 << 2) + (t2 << 4)


# dz code by the column's existence bits e0 | e1 << 1 | e2 << 2
_SEL_BY_BITS = torch.tensor([_sel_code(b & 1, b >> 1 & 1, b >> 2 & 1)
                             for b in range(8)], dtype=torch.int32)


def _nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(S, n) packed bytes -> (S, 2n) int64 nibbles, the low nibble first."""
    p = packed.long()
    return torch.stack([p & 15, p >> 4], dim=-1).reshape(p.shape[0],
                                                         2 * p.shape[1])


def plan_from_host_arrays(arrs: dict, capacities: Sequence[int],
                          num_levels: int,
                          sample_domains: Sequence[int] | None = None
                          ) -> UNetPlan:
    """Decode the host-built plans of S samples (``hp_*`` batch keys, wire
    format v3 of ``csrc/host_plan.cpp``; each array (S, ...)) into one flat
    plan: every array of :func:`build_unet_plan_batched`'s on the same
    samples, with its dtypes, except the ranks of all-miss columns (dz code
    63), which hold the previous rank instead of the sentinel and are read by
    no kernel.

    Rank and down-map deltas are 4-bit nibbles (low first) integrated by one
    cumsum per level, after the fixups ((pos << 11) | excess, several at one
    position add up) are scatter-added into them. The centre column is not
    on the wire: its rank is slot - e0, its dz=0 bit is the slot's validity
    and its dz=+1 bit is the next row's dz=-1 bit (``cbits``).

    The points need not be sorted: ``point_perm`` is each sample's stable
    argsort of its point -> slot map with misses last (the identity on
    key-sorted points), so mean pooling reads each voxel's points as one
    run."""
    capacities = [int(c) for c in capacities]
    dev = arrs["rankn"].device
    s = arrs["rankn"].shape[0]
    ar = torch.arange(s, device=dev)
    sum8r = sum(capacities) * 8
    sum8d = sum(capacities[1:]) * 8
    fix = arrs["fix"].long()
    pos, extra = fix >> 11, fix & 2047

    def deltas(key, base, length):
        """Nibble deltas of [base, base + length) of the unpacked
        [rankn | downn] space with the fixups that land there added."""
        d = _nibbles(arrs[key])[:, :length].reshape(-1)
        local = pos - base
        ok = (fix >= 0) & (local >= 0) & (local < length)
        at = torch.where(ok, local + (ar * length)[:, None], 0)
        return d.index_add_(0, at.reshape(-1),
                            torch.where(ok, extra, 0).reshape(-1)
                            ).reshape(s, length)

    rank_d = deltas("rankn", 0, sum8r)
    down_d = deltas("downn", sum8r, sum8d)
    eb = arrs["ebits"].long()
    w24 = eb[:, 0::3] | (eb[:, 1::3] << 8) | (eb[:, 2::3] << 16)
    cb = arrs["cbits"].long()
    cbits = ((cb[:, :, None] >> torch.arange(8, device=dev)) & 1).reshape(s,
                                                                         -1)
    upoff_all = _nibbles(arrs["upoffn"])
    downe = arrs["downe"].long()
    nums = arrs["nums"].long()
    f2c_all = arrs["f2c"].long()
    with span("sync/plan_upload"):
        # two host constants copied to the card: each copy waits for the
        # device's queue
        sel_lut = _SEL_BY_BITS.to(dev)
        doms = None
        if sample_domains is not None:
            doms = torch.as_tensor(sample_domains, dtype=torch.int64,
                                   device=dev)
    col_shift = 3 * torch.arange(8, device=dev)
    octant = torch.arange(8, device=dev)

    def column_sums(d, cap):
        """(S, cap*8) row-major deltas -> (S, cap, 8) running sums down each
        column. The scan runs along the last dimension: along dim 1 the GPU
        scans each of the S*8 columns in one thread."""
        return d.reshape(s, cap, 8).transpose(1, 2).cumsum(dim=2).transpose(
            1, 2)

    def with_centre(cols, centre):
        return torch.cat([cols[:, :, :4], centre[:, :, None], cols[:, :, 4:]],
                         dim=2)

    levels = []
    o8r = o1 = o8 = of = oe = oc = 0
    for l in range(num_levels):
        cap = capacities[l]
        slot = torch.arange(cap, device=dev)[None, :]
        valid = slot < nums[:, l:l + 1]
        e0c = cbits[:, oc:oc + cap]
        r8 = column_sums(rank_d[:, o8r:o8r + cap * 8], cap)
        ranks = with_centre(r8, slot - e0c) + (ar * cap)[:, None, None]
        nxt = torch.cat([e0c[:, 1:], e0c.new_zeros((s, 1))], dim=1)
        bits = with_centre((w24[:, o1:o1 + cap, None] >> col_shift) & 7,
                           e0c | (valid.long() << 1) | (nxt << 2))
        down_nbr = f2c = up_off = None
        if l >= 1:
            capf = capacities[l - 1]
            dloc = column_sums(down_d[:, o8:o8 + cap * 8], cap)
            has = ((downe[:, oe:oe + cap, None] >> octant) & 1) == 1
            down_nbr = torch.where(has, dloc + (ar * capf)[:, None, None],
                                   -1).reshape(-1, 8)
            fv = f2c_all[:, of:of + capf]
            f2c = torch.where(fv >= 0, fv + (ar * cap)[:, None],
                              -1).reshape(-1)
            up_off = upoff_all[:, of:of + capf].reshape(-1)
            o8 += cap * 8
            of += capf
            oe += cap
        levels.append(LevelPlan(
            valid=valid.reshape(-1), down_nbr=down_nbr, f2c=f2c,
            up_off=up_off, ranks=ranks.reshape(-1).to(torch.int32),
            sel=sel_lut[bits].reshape(-1),
            dom=None if doms is None else doms.repeat_interleave(cap)))
        o8r += cap * 8
        o1 += cap
        oc += -(-cap // 8) * 8
    cap0 = capacities[0]
    inv = arrs["inverse"].long()
    p = inv.shape[1]
    counts = arrs["counts"].long()
    poff = (ar * p)[:, None]
    run_order = torch.sort(torch.where(inv >= 0, inv, cap0), dim=1,
                           stable=True).indices
    return UNetPlan(
        levels=tuple(levels),
        point_inverse=torch.where(inv >= 0, inv + (ar * cap0)[:, None],
                                  -1).reshape(-1),
        point_counts=counts.reshape(-1),
        num_voxels=nums.sum(dim=0),
        point_end=(torch.cumsum(counts, dim=1) - 1 + poff).reshape(-1),
        point_perm=(run_order + poff).reshape(-1))


def concat_plans(plans: Sequence[UNetPlan]) -> UNetPlan:
    """Concatenate flat plans with the same level count into one, shifting
    slot and point indices by the preceding plans' sizes: fuses plan groups
    of different per-sample capacities ([source; target] and the VGI cat
    scans) into one multi-domain forward. The last sample's all-miss
    sentinel rank of one group lands on the next group's first row; its dz
    code (63) keeps every reader off it."""

    def shifted(arrs, strides):
        out, off = [], 0
        for a, stride in zip(arrs, strides):
            out.append(torch.where(a >= 0, a + off, -1))
            off += stride
        return torch.cat(out)

    def cat(arrs):
        return None if arrs[0] is None else torch.cat(arrs)

    levels = []
    for l in range(len(plans[0].levels)):
        lv = [p.levels[l] for p in plans]
        caps = [x.valid.shape[0] for x in lv]
        down_nbr = f2c = up_off = None
        if l >= 1:
            down_nbr = shifted([x.down_nbr for x in lv],
                               [p.levels[l - 1].valid.shape[0]
                                for p in plans])
            f2c = shifted([x.f2c for x in lv], caps)
            up_off = torch.cat([x.up_off for x in lv])
        ranks = p2a = None
        if lv[0].p2a is not None:
            # z-dense: ranks in padded-slot space (each plan's sentinel
            # Vp_i becomes the joint one), p2a in active-slot space
            vps = [x.p2a.shape[0] for x in lv]
            r_parts, p_parts, off_vp, off_cap = [], [], 0, 0
            for x, vp_i, cap_i in zip(lv, vps, caps):
                r_parts.append(torch.where(x.ranks < vp_i, x.ranks + off_vp,
                                           sum(vps)))
                p_parts.append(torch.where(x.p2a >= 0, x.p2a + off_cap, -1))
                off_vp += vp_i
                off_cap += cap_i
            ranks, p2a = torch.cat(r_parts), torch.cat(p_parts)
        elif lv[0].ranks is not None:
            ranks = shifted([x.ranks for x in lv], caps)
        levels.append(LevelPlan(
            valid=torch.cat([x.valid for x in lv]), down_nbr=down_nbr,
            f2c=f2c, up_off=up_off, ranks=ranks,
            sel=cat([x.sel for x in lv]), dom=cat([x.dom for x in lv]),
            nbr=(shifted([x.nbr for x in lv], caps)
                 if lv[0].nbr is not None else None), p2a=p2a))
    npts = [p.point_inverse.shape[0] for p in plans]
    point_end = point_perm = None
    if all(p.point_end is not None for p in plans):
        point_end = shifted([p.point_end for p in plans], npts)
        if any(p.point_perm is not None for p in plans):
            # a plan without a permutation is in run order already
            point_perm = shifted(
                [torch.arange(n, device=p.point_inverse.device)
                 if p.point_perm is None else p.point_perm
                 for p, n in zip(plans, npts)], npts)
    return UNetPlan(
        levels=tuple(levels),
        point_inverse=shifted([p.point_inverse for p in plans],
                              [p.levels[0].valid.shape[0] for p in plans]),
        point_counts=torch.cat([p.point_counts for p in plans]),
        num_voxels=sum(p.num_voxels for p in plans),
        point_end=point_end, point_perm=point_perm)


def level_spans(num_levels: int) -> tuple:
    """(down, up) span names of a UNet's levels: a level's blocks before
    the coarser level, and after it."""
    return tuple(("net3d/down{}".format(l), "net3d/up{}".format(l))
                 for l in range(num_levels))


def apply_submanifold(x: torch.Tensor, lv: LevelPlan,
                      weight: torch.Tensor) -> torch.Tensor:
    """Submanifold conv through whichever plan form the level carries: the
    z-dense plan, else the wide-column plan (the K1 kernel on CUDA
    tensors), else the exact neighbour map."""
    if lv.p2a is not None:
        return sc.submanifold_conv_zdense(x, sc.ZPlan(lv.ranks, lv.p2a),
                                          weight)
    if lv.ranks is not None:
        return sc.submanifold_conv_wide(x, sc.WidePlan(lv.ranks, lv.sel),
                                        weight)
    return sc.submanifold_conv(x, lv.nbr, weight)


class _BN(nn.Module):
    """Masked BatchNorm(+ReLU) over active voxels (eps 1e-4, momentum 0.9):
    running statistics in eval mode, batch statistics (per domain when the
    plan carries domains) in training mode, which also updates the running
    buffers. Names follow the reference: scale, bias, mean, var. One
    ``net3d/bn`` span a call."""

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
        with span("net3d/bn", trace=False):
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
        self.span_names = level_spans(num_planes)
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
        feats = point_feats.to(self.compute_dtype)
        if plan.point_end is not None:
            x = voxel_ops.pool_features_sorted(feats, plan.point_counts,
                                               plan.point_end,
                                               plan.point_perm)
        else:
            x = voxel_ops.pool_features(feats, plan.point_inverse,
                                        plan.point_counts,
                                        plan.levels[0].valid.shape[0])
        x = apply_submanifold(x, plan.levels[0], self.stem)
        x = self._level(0, x, plan, n_domains)
        x = self.final_bn(x, plan.levels[0], n_domains)
        return voxel_ops.unpool_features(x, plan.point_inverse)

    def _level(self, l: int, x: torch.Tensor, plan: UNetPlan,
               n_domains: int) -> torch.Tensor:
        """Level ``l``'s blocks: the part before the next level (span
        ``net3d/down{l}``), the next level, then the part after it
        (``net3d/up{l}``)."""
        lv = plan.levels[l]
        last = l + 1 == len(self.planes)
        down, up = self.span_names[l]
        with span(down, trace=False):
            x = getattr(self, f"l{l}_bn1")(x, lv, n_domains)
            x = apply_submanifold(x, lv, getattr(self, f"l{l}_conv1"))
            if last:
                return x
            nxt = plan.levels[l + 1]
            skip = x
            y = getattr(self, f"l{l}_bn_down")(x, lv, n_domains)
            y = sc.strided_conv(y, nxt.down_nbr, getattr(self, f"l{l}_down"))
        y = self._level(l + 1, y, plan, n_domains)
        with span(up, trace=False):
            y = getattr(self, f"l{l}_bn_up")(y, nxt, n_domains)
            y = sc.deconv(y, nxt.f2c, nxt.up_off, getattr(self, f"l{l}_up"),
                          lv.valid)
            x = getattr(self, f"l{l}_bn2")(torch.cat([skip, y], dim=-1), lv,
                                           n_domains)
            return apply_submanifold(x, lv, getattr(self, f"l{l}_conv2"))
