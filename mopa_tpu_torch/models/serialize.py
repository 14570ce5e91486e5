"""Serialization of a voxel plan for Point Transformer V3: each level's voxel
coordinates, its space-filling-curve codes and sort orders, the static patch
layout of its serialized attention, and the stem's 5x5x5 neighbour map.

Everything is built on the plan's device from what every plan carries (the
points' level-0 slots ``point_inverse``, each level's ``f2c`` and ``valid``)
and the points' integer coordinates, with no wait of the host on the device,
so the host plans (wire format v3) stay as they are.

Curves (Pointcept's ``pointcept/models/utils/serialization``), on a level's
integer coordinates at depth ``12 - level`` (level 0 spans 4096 = 2**12 per
axis), the sample index in the bits above the code:

- ``"z"``: bit interleave, x highest in each triple (``z_order.py``);
- ``"hilbert"``: Skilling's transpose algorithm (``hilbert.py``), x the
  most significant axis;
- ``"z-trans"``, ``"hilbert-trans"``: the same with x and y swapped.

A level's code is its children's code >> 3, as Pointcept's pooling takes it,
since a curve at depth d - 1 orders the parents of its depth-d order.

Patch layout of a level with S samples of ``cap`` slots each and patch
size K: every sample owns P = ceil(cap / K) patches (``S * P * K`` layout
slots, sample-major). A sample of n voxels fills the first ceil(n / K)
patches in the order's sequence; with n > K the tail of its last patch
repeats the voxels K places before (Pointcept's padding: slots [n_pad - K +
n mod K, n_pad) copy [n_pad - 2K + n mod K, n_pad - K)), with n <= K its one
patch holds its n voxels alone. Every other layout slot reads some row of
the sample and carries the key bias :data:`MASK_BIAS`, which takes it out of
every softmax; the queries there are thrown away.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from mopa_tpu_torch.ops import sparse_conv as sc
from mopa_tpu_torch.ops import voxel as voxel_ops

DEPTH = 12                 # bits per axis at level 0 (coordinates < 4096)
STEM = 5                   # the stem conv's cube side
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
# the key bias of a layout slot outside its sample's patches: with a query
# column of ones it adds -16384 * scale to the score, whose exponential is 0
MASK_BIAS = -16384.0
_M31 = (1 << 31) - 1


class SerialLevel(NamedTuple):
    """One level's serialization; order tensors stack the orders in the
    order of the configuration's list."""
    key: torch.Tensor        # (V,) packed (sample, x, y, z) of each slot
    coords: torch.Tensor     # (V, 3) int64 (0 at invalid slots)
    codes: torch.Tensor      # (O, V) int64 curve codes (int64 max: invalid)
    idx: torch.Tensor        # (O, S*P*K) level row read by each layout slot
    bias: torch.Tensor       # (O, S*P*K) float32 key bias, 0 or MASK_BIAS
    inverse: torch.Tensor    # (O, V) layout slot of each level row
    samples: int
    patch: int               # K
    patches: int             # P, static patches per sample


class SerialPlan(NamedTuple):
    levels: tuple            # SerialLevel each
    stem_nbr: torch.Tensor   # (V_0, STEM**3) level-0 neighbour row or -1


def z_order(coords: torch.Tensor, depth: int) -> torch.Tensor:
    """(V,) Z-order codes of (V, 3) coordinates: bit b of x, y, z goes to
    bit 3b + 2, 3b + 1, 3b."""
    c = coords.long()
    code = torch.zeros_like(c[:, 0])
    for b in range(depth):
        for axis in range(3):
            code |= ((c[:, axis] >> b) & 1) << (3 * b + 2 - axis)
    return code


def hilbert(coords: torch.Tensor, depth: int) -> torch.Tensor:
    """(V,) Hilbert codes of (V, 3) coordinates at ``depth`` bits per axis
    (Skilling, "Programming the Hilbert curve", 2004: axes to transpose,
    then the transpose's bits interleaved x first, Gray decoded)."""
    x = [coords[:, a].long().clone() for a in range(3)]
    for b in range(depth - 1, 0, -1):
        q = 1 << b
        lower = q - 1
        for i in range(3):
            on = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & lower
            x0 = torch.where(on, x[0] ^ lower, x[0] ^ t)
            if i > 0:
                x[i] = torch.where(on, x[i], x[i] ^ t)
            x[0] = x0
    gray = torch.zeros_like(x[0])
    for b in range(depth):
        for axis in range(3):
            gray |= ((x[axis] >> b) & 1) << (3 * b + 2 - axis)
    code = gray
    shift = 1
    while shift < 3 * depth:
        code = code ^ (code >> shift)
        shift *= 2
    return code


def curve_code(coords: torch.Tensor, order: str, depth: int) -> torch.Tensor:
    """Codes of ``order`` (one of :data:`ORDERS`)."""
    if order.endswith("-trans"):
        # (not an index list, whose copy to the card waits on it)
        coords = torch.stack((coords[:, 1], coords[:, 0], coords[:, 2]), 1)
        order = order[:-len("-trans")]
    if order == "z":
        return z_order(coords, depth)
    if order == "hilbert":
        return hilbert(coords, depth)
    raise ValueError("unknown serialization order {}".format(order))


def _mix31(x: torch.Tensor) -> torch.Tensor:
    """A 31-bit integer hash (xor-shift-multiply rounds, kept in int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M31
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M31
    return x ^ (x >> 16)


def drop_uniform(key: torch.Tensor, seed: torch.Tensor,
                 stream: int) -> torch.Tensor:
    """A uniform [0, 1) float32 per voxel key, from the step's ``seed`` (a
    one-element int64 tensor in [0, 2**31)) and the ``stream`` (a block's
    branch): the same voxel draws the same number whatever its slot, so
    the reference draws the same drop-path masks on its own layout."""
    h = _mix31((key & _M31) ^ seed)
    h = _mix31(h ^ ((key >> 31) & _M31))
    h = _mix31(h ^ ((stream * 0x9E3779B1) & _M31))
    return (h >> 7).float() * (1.0 / (1 << 24))


def level_coords(plan, coords: torch.Tensor) -> list:
    """Each level's (V_l, 3) voxel coordinates from the points' (N, 3)
    integer ``coords``: a voxel's points, and at level l + 1 its children
    halved, all hold its coordinates (0 at invalid slots)."""
    pts = coords.reshape(-1, 3).long()
    out = []
    src, into = pts, plan.point_inverse
    for l, lv in enumerate(plan.levels):
        v = lv.valid.shape[0]
        if l > 0:
            src, into = out[-1] // 2, lv.f2c
        tgt = torch.where(into >= 0, into, v)[:, None].expand(-1, 3)
        c = torch.zeros((v + 1, 3), dtype=torch.int64, device=pts.device)
        out.append(c.scatter_reduce_(0, tgt, src, "amax",
                                     include_self=True)[:v])
    return out


def patch_layout(codes: torch.Tensor, valid: torch.Tensor, samples: int,
                 patch: int) -> tuple:
    """(idx, bias, inverse) of one order's codes (V,) over ``samples``
    samples of equal capacity (module docstring)."""
    v = codes.shape[0]
    cap = v // samples
    k = int(patch)
    width = -(-cap // k) * k
    dev = codes.device
    order = torch.sort(codes.reshape(samples, cap), dim=1).indices
    n = valid.reshape(samples, cap).sum(dim=1, keepdim=True)
    j = torch.arange(width, device=dev)[None, :]
    n_pad = torch.where(n > k, -(-n // k) * k, n)
    real = j < n
    dup = (j >= n) & (j < n_pad)
    src = torch.where(real, j, j - k).clamp(0, cap - 1).expand(samples,
                                                               width)
    row = torch.where(real | dup, order.gather(1, src), j % cap)
    base = torch.arange(samples, device=dev)[:, None]
    idx = (row + base * cap).reshape(-1)
    bias = torch.where(real | dup, 0.0, MASK_BIAS).expand(samples,
                                                          width).reshape(-1)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(cap, device=dev).expand(samples, cap))
    return idx, bias.float(), (rank + base * width).reshape(-1)


def serialize(plan, coords: torch.Tensor, samples: int,
              patch_sizes: Sequence[int],
              orders: Sequence[str] = ORDERS) -> SerialPlan:
    """The :class:`SerialPlan` of ``plan`` (``samples`` samples of equal
    capacity per level, slots sample-major and key-sorted within each, as
    the plans of ``scn_unet`` lay them out) from the points' integer
    ``coords``; ``patch_sizes`` gives K per level."""
    levels = []
    cs = level_coords(plan, coords)
    for l, (lv, c) in enumerate(zip(plan.levels, cs)):
        v = lv.valid.shape[0]
        cap = v // samples
        sample = torch.arange(v, device=c.device) // cap
        depth = DEPTH - l
        big = torch.iinfo(torch.int64).max
        codes = torch.stack([
            torch.where(lv.valid, (sample << (3 * depth))
                        | curve_code(c, o, depth), big) for o in orders])
        outs = [patch_layout(code, lv.valid, samples, patch_sizes[l])
                for code in codes]
        k = int(patch_sizes[l])
        levels.append(SerialLevel(
            key=voxel_ops.pack_keys(c, sample, lv.valid), coords=c,
            codes=codes, idx=torch.stack([o[0] for o in outs]),
            bias=torch.stack([o[1] for o in outs]),
            inverse=torch.stack([o[2] for o in outs]), samples=samples,
            patch=k, patches=-(-cap // k)))
    lv0 = levels[0]
    cap0 = plan.levels[0].valid.shape[0] // samples
    valid0 = plan.levels[0].valid.reshape(samples, cap0)
    table = voxel_ops.VoxelTable(coords=lv0.coords.reshape(samples, cap0, 3),
                                 key=lv0.key.reshape(samples, cap0),
                                 num=valid0.sum(dim=1))
    nbr = sc.build_submanifold_plan(table, kernel_size=STEM)
    off = (torch.arange(samples, device=nbr.device) * cap0)[:, None, None]
    stem_nbr = torch.where(nbr >= 0, nbr + off, -1).reshape(
        samples * cap0, -1)
    return SerialPlan(levels=tuple(levels), stem_nbr=stem_nbr)
