"""Fixed-capacity voxel tables for the sparse UNet (PyTorch port of
``mopa_tpu/ops/voxel.py``).

Replaces ``scn.InputLayer(dim, full_scale, mode=4)`` (point -> voxel dedup
with mean pooling) and ``scn.OutputLayer`` (voxel -> point unmapping).

Tables are built for S samples at once, one row per sample: the same layout as
the reference's ``jax.vmap`` over per-sample ``voxelize`` calls. A voxel key
packs (batch, x, y, z) into ONE int64,
``((batch * 4096 + x) * 4096 + y) * 4096 + z``, which orders exactly like the
reference's (key_hi, key_lo) int32 pair; ``torch.sort`` and
``torch.searchsorted`` on it replace the TPU sort-merge tricks. The batch
field is the sample's row by default; the reference's flat batch-indexed
table (its monolithic plan) is one row whose points carry their batch index
(``voxelize(..., batch=)``). Tables, inverse maps and counts equal the
reference's bit for bit; only the order of one voxel's points in the
run-order permutation may differ (the reference's sort is not stable), which
pooling does not see beyond float rounding.

The reference's lookups over one flat table are here too, with its
outputs: :func:`merge_lookup` / :func:`merge_lookup_keys` /
:func:`merge_lookup_presorted` (exact matches), :func:`rank_lookup` (lower
bounds), :func:`lookup`, the z-padded tables :func:`build_padded_ztable`
and :func:`build_padded_ztable_keys`, and the open-addressing index
:func:`build_hash` / :func:`hash_lookup` (its slots placed by the
reference's ``_hash32`` and scatter-min rounds). Their (hi, lo) key pairs
are int64 tensors holding the reference's int32 values (``PAD_HI`` in
padding); one lookup of any kind is a ``searchsorted`` over the table's
sorted keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Coordinate packing base; coordinates live in [0, SHIFT).
SHIFT = 4096
# Key of padding slots and invalid points: larger than any real key.
PAD_KEY = torch.iinfo(torch.int64).max
# The reference's int32 padding key (both halves of a (hi, lo) pair).
PAD_HI = 2 ** 31 - 1


class VoxelTable(NamedTuple):
    """S sorted, fixed-capacity tables of active voxels (one row per sample).

    Attributes:
        coords: (S, V, 3) int64 voxel coordinates (0 in padding slots).
        key:    (S, V) int64 sorted packed keys (PAD_KEY in padding slots).
        num:    (S,) int64 active voxels per sample (<= V).
    """

    coords: torch.Tensor
    key: torch.Tensor
    num: torch.Tensor

    def valid_mask(self) -> torch.Tensor:
        return self.key != PAD_KEY

    @property
    def capacity(self) -> int:
        return self.key.shape[-1]

    @property
    def batch(self) -> torch.Tensor:
        """(S, V) batch field of each voxel's key (0 in padding slots)."""
        return torch.where(self.valid_mask(), self.key // SHIFT ** 3, 0)

    @property
    def key_hi(self) -> torch.Tensor:
        """(S, V) the reference's ``batch * 4096 + x`` (PAD_HI in
        padding)."""
        return torch.where(self.valid_mask(), self.key // SHIFT ** 2, PAD_HI)

    @property
    def key_lo(self) -> torch.Tensor:
        """(S, V) the reference's ``y * 4096 + z`` (PAD_HI in padding)."""
        return torch.where(self.valid_mask(), self.key % SHIFT ** 2, PAD_HI)


def pack_keys(coords: torch.Tensor, sample: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """(..., 3) coordinates + sample id -> int64 key; invalid -> PAD_KEY."""
    c = coords.long()
    key = ((sample.long() * SHIFT + c[..., 0]) * SHIFT + c[..., 1]) * SHIFT \
        + c[..., 2]
    return torch.where(valid, key, torch.full_like(key, PAD_KEY))


def voxelize(coords: torch.Tensor, valid: torch.Tensor, capacity: int,
             batch: torch.Tensor | None = None):
    """Per-sample active-voxel tables plus the point -> voxel inverse map.

    Args:
        coords: (S, N, 3) integer coordinates in [0, SHIFT).
        valid: (S, N) bool; invalid rows are padding and ignored.
        capacity: table capacity V. Voxels past it are dropped (their points
            map to -1), exactly as in the reference.
        batch: (S, N) batch index of each point, the key's batch field
            (default: the sample's row).

    The input is always sorted here (a stable ``torch.sort``), so unsorted
    points merge their duplicate voxels correctly.

    Returns:
        (table, inverse (S, N) int64 slot or -1, counts (S, V) int64 points
        per voxel, perm (S, N) int64 run order -> original point index).
    """
    s, n = valid.shape
    v = int(capacity)
    dev = coords.device
    if batch is None:
        batch = torch.arange(s, device=dev)[:, None].expand(s, n)
    key = pack_keys(coords, batch, valid)
    s_key, perm = torch.sort(key, dim=1, stable=True)
    s_valid = s_key != PAD_KEY
    prev = torch.cat([torch.full((s, 1), -1, dtype=torch.int64, device=dev),
                      s_key[:, :-1]], dim=1)
    new_group = (s_key != prev) & s_valid
    vox = torch.cumsum(new_group.long(), dim=1) - 1
    in_cap = vox < v
    s_valid = s_valid & in_cap
    new_group = new_group & in_cap
    vox = torch.where(s_valid, vox, torch.full_like(vox, -1))
    num = new_group.sum(dim=1).clamp(max=v)

    inverse = torch.empty_like(vox).scatter_(1, perm, vox)
    head = torch.where(new_group, vox, torch.full_like(vox, v))  # v = dump
    t_key = torch.full((s, v + 1), PAD_KEY, dtype=torch.int64, device=dev)
    t_key = t_key.scatter_(1, head, s_key)[:, :v].contiguous()
    t_valid = t_key != PAD_KEY
    t_coords = torch.stack([(t_key // (SHIFT * SHIFT)) % SHIFT,
                            (t_key // SHIFT) % SHIFT, t_key % SHIFT], dim=-1)
    t_coords = torch.where(t_valid[..., None], t_coords,
                           torch.zeros_like(t_coords))
    counts = torch.zeros((s, v), dtype=torch.int64, device=dev).scatter_add_(
        1, vox.clamp(0, v - 1), s_valid.long())
    return VoxelTable(coords=t_coords, key=t_key, num=num), inverse, counts, perm


def downsample_coords(table: VoxelTable, capacity: int):
    """Active sites of the next (coarser) level: floor(coords / 2) dedup
    (``scn.Convolution(size=2, stride=2)``'s output-site rule).

    Returns (coarse_table, f2c (S, V) fine slot -> coarse slot or -1)."""
    ctable, f2c, _, _ = voxelize(table.coords // 2, table.valid_mask(),
                                 capacity, batch=table.batch)
    return ctable, f2c


def pool_features_sorted(feats: torch.Tensor, counts: torch.Tensor,
                         end_pos: torch.Tensor,
                         perm: torch.Tensor) -> torch.Tensor:
    """Mean-pool point features into voxels (``scn.InputLayer`` mode=4).

    Points in run order (``feats[perm]``) put each voxel's points in one
    contiguous run ending at ``end_pos``; each run's sum is a difference of
    two float64 prefix sums, which is exact to float32 precision and, unlike
    a scatter-add, the same on every run of the GPU.

    Args:
        feats: (N, C) point features.
        counts: (V,) points per voxel.
        end_pos: (V,) run-order position of each voxel's last point.
        perm: (N,) run order -> original point index (None: the points are
            in run order).
    """
    xs = (feats if perm is None else feats[perm]).double()
    cs = torch.cat([torch.zeros_like(xs[:1]), torch.cumsum(xs, dim=0)])
    start = end_pos + 1 - counts
    has = counts > 0
    hi = torch.where(has, end_pos + 1, torch.zeros_like(end_pos))
    lo = torch.where(has, start, torch.zeros_like(start))
    pooled = (cs[hi] - cs[lo]) / counts.clamp(min=1).double()[:, None]
    return pooled.to(feats.dtype)


def spread_misses(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` with every negative entry replaced by its own position mod
    ``n``. A gather at these indices reads some row for each miss, which the
    caller masks; unlike clamping all misses to row 0, it leaves the
    gather's backward (a sorted index accumulation that walks each index's
    run in one thread group) no run of ~10^5 entries at one row, which took
    seconds per train step on the card."""
    pos = torch.arange(idx.shape[0], device=idx.device, dtype=idx.dtype)
    return torch.where(idx >= 0, idx, pos % max(int(n), 1))


def unpool_features(vox_feats: torch.Tensor,
                    inverse: torch.Tensor) -> torch.Tensor:
    """Voxel -> point unmapping (``scn.OutputLayer``); padding points get 0."""
    out = vox_feats[spread_misses(inverse, vox_feats.shape[0])]
    return torch.where((inverse >= 0)[:, None], out, torch.zeros_like(out))


def pool_features(feats: torch.Tensor, inverse: torch.Tensor,
                  counts: torch.Tensor, capacity: int,
                  mode: str = "mean") -> torch.Tensor:
    """Pool point features into voxels through the inverse map with one
    scatter-add (the reference's ``pool_features``, which its plans without
    run ends take): (capacity, C) in the feature dtype, the sum divided by
    the voxel's count for ``mode="mean"``."""
    valid = inverse >= 0
    contrib = torch.where(valid[:, None], feats, torch.zeros_like(feats))
    pooled = feats.new_zeros((capacity, feats.shape[-1])).index_add_(
        0, inverse.clamp(0, capacity - 1), contrib)
    if mode == "mean":
        return pooled / counts.clamp(min=1).to(feats.dtype)[:, None]
    if mode != "sum":
        raise ValueError(mode)
    return pooled


# ---- the reference's lookups over one flat table --------------------------


def _flat(table: VoxelTable) -> VoxelTable:
    """The one row of a flat table."""
    if table.key.dim() == 2:
        if table.key.shape[0] != 1:
            raise ValueError("a flat table has one row, got {}".format(
                table.key.shape[0]))
        return VoxelTable(table.coords[0], table.key[0], table.num[0])
    return table


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 ordering like the (hi, lo) pair of non-negative int32
    values (PAD_HI included)."""
    return hi.long() * 2 ** 32 + lo.long()


def pack_keys_hilo(coords: torch.Tensor, batch: torch.Tensor,
                   valid: torch.Tensor) -> tuple:
    """The reference's ``pack_keys``: (key_hi, key_lo) = (batch * 4096 + x,
    y * 4096 + z), PAD_HI for invalid rows (int64 tensors)."""
    c = coords.long()
    hi = batch.long() * SHIFT + c[..., 0]
    lo = c[..., 1] * SHIFT + c[..., 2]
    return (torch.where(valid, hi, PAD_HI), torch.where(valid, lo, PAD_HI))


def _exact(t_key: torch.Tensor, q_key: torch.Tensor,
           q_valid: torch.Tensor) -> torch.Tensor:
    """Position in ``t_key`` (unique wherever a valid query can match) of
    each valid query key, -1 on a miss or an invalid query."""
    order = torch.argsort(t_key, stable=True)
    s_key = t_key[order]
    pos = torch.searchsorted(s_key, q_key).clamp(max=t_key.shape[0] - 1)
    hit = (s_key[pos] == q_key) & q_valid
    return torch.where(hit, order[pos], -1)


def merge_lookup_keys(t_hi, t_lo, q_hi, q_lo, q_valid) -> torch.Tensor:
    """(Q,) table slot of each valid query's (hi, lo) key among the table's
    keys, -1 on a miss or an invalid query (the reference's sort-merge)."""
    return _exact(_pair_key(t_hi, t_lo), _pair_key(q_hi, q_lo), q_valid)


def merge_lookup(table: VoxelTable, q_hi, q_lo, q_valid) -> torch.Tensor:
    """:func:`merge_lookup_keys` against a flat table's keys."""
    t = _flat(table)
    return _exact(t.key, q_hi.long() * SHIFT ** 2 + q_lo.long(), q_valid)


def merge_lookup_presorted(table: VoxelTable, q_hi, q_lo,
                           q_valid) -> torch.Tensor:
    """The reference's lookup for a query stream already sorted by (hi, lo)
    with unique keys (a table's keys plus one offset). Its answers are
    :func:`merge_lookup`'s on such a stream, which a ``searchsorted`` gives
    with no separate path."""
    return merge_lookup(table, q_hi, q_lo, q_valid)


def rank_lookup(table: VoxelTable, q_hi, q_lo, q_valid) -> torch.Tensor:
    """(Q,) lower-bound rank of each query key among the flat table's
    sorted keys (the number of table keys below it); an invalid query gets
    the capacity."""
    t = _flat(table)
    rank = torch.searchsorted(_pair_key(t.key_hi, t.key_lo),
                              _pair_key(q_hi, q_lo))
    return torch.where(q_valid, rank, t.key.shape[0])


def lookup(table: VoxelTable, q_coords: torch.Tensor, q_batch: torch.Tensor,
           q_valid: torch.Tensor) -> torch.Tensor:
    """(M,) flat-table slots of query voxels, -1 on a miss; queries outside
    [0, SHIFT) miss."""
    in_range = ((q_coords >= 0) & (q_coords < SHIFT)).all(dim=-1)
    q_valid = q_valid & in_range
    q_hi, q_lo = pack_keys_hilo(q_coords, q_batch, q_valid)
    return merge_lookup(table, q_hi, q_lo, q_valid)


class PaddedZTable(NamedTuple):
    """The reference's z-window padding of a flat table: the sorted union of
    its keys shifted by dz in [-pad, pad], in the private packing
    ``lo = y * (SHIFT + 4 pad) + z + 2 pad``.

    Attributes:
        p2a: (Vp,) active-table slot at each padded slot, -1 where none.
        a2p: (V,) padded slot of each active slot (capacity in padding and
            past the capacity); :func:`build_padded_ztable` only.
        num: () live padded slots (<= Vp).
        key_hi / key_lo: (Vp,) the union's sorted keys, PAD_HI past
            ``num``; :func:`build_padded_ztable_keys` only.
    """

    p2a: torch.Tensor
    a2p: torch.Tensor | None
    num: torch.Tensor
    key_hi: torch.Tensor | None = None
    key_lo: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.p2a.shape[0]


def _ztable_union(table: VoxelTable, pad: int) -> tuple:
    """(sorted unique union keys, the dz = 0 key of each valid slot, valid
    mask) of a flat table in the private packing, as one int64 each."""
    t = _flat(table)
    valid = t.valid_mask()
    base = t.coords[:, 1] * (SHIFT + 4 * pad) + t.coords[:, 2] + 2 * pad
    hi = t.key_hi
    dzs = torch.arange(-pad, pad + 1, device=hi.device)
    union = _pair_key(hi[valid][None, :], (base[valid][None, :]
                                           + dzs[:, None]))
    return (torch.unique(union.reshape(-1), sorted=True),
            _pair_key(hi, base), valid)


def build_padded_ztable(table: VoxelTable, capacity: int,
                        pad: int = 2) -> PaddedZTable:
    """The reference's ``build_padded_ztable``: the padded slot of each
    active slot (``a2p``) and its inverse (``p2a``); ``capacity`` = (2 pad
    + 1) V never overflows."""
    union, key0, valid = _ztable_union(table, pad)
    vp = int(capacity)
    v = key0.shape[0]
    slot = torch.searchsorted(union, key0)
    keep = valid & (slot < vp)
    a2p = torch.where(keep, slot, vp)
    src = torch.arange(v, device=slot.device)
    p2a = torch.full((vp + 1,), -1, dtype=torch.int64, device=slot.device)
    p2a = p2a.scatter_(0, a2p, torch.where(keep, src, -1))[:vp]
    return PaddedZTable(p2a=p2a, a2p=a2p,
                        num=torch.clamp(torch.tensor(union.shape[0]),
                                        max=vp))


def build_padded_ztable_keys(table: VoxelTable, capacity: int,
                             pad: int = 2) -> PaddedZTable:
    """The reference's ``build_padded_ztable_keys``: the union's first
    ``capacity`` keys as (key_hi, key_lo) and the active slot whose dz = 0
    key each one is (``p2a``), no ``a2p``."""
    union, key0, valid = _ztable_union(table, pad)
    vp = int(capacity)
    num = min(union.shape[0], vp)
    keys = torch.full((vp,), _pair_key(torch.tensor(PAD_HI),
                                       torch.tensor(PAD_HI)).item(),
                      dtype=torch.int64, device=union.device)
    keys[:num] = union[:num]
    p2a = _exact(torch.where(valid, key0, -1), keys,
                 torch.arange(vp, device=keys.device) < num)
    return PaddedZTable(p2a=p2a, a2p=None, num=torch.tensor(num),
                        key_hi=keys // 2 ** 32, key_lo=keys % 2 ** 32)


_MASK32 = 2 ** 32 - 1


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2**32 for 0 <= a < 2**32 in int64 without overflow."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _hash32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The reference's 32-bit multiplicative key mix, as its int32 values
    (in int64 tensors)."""
    h = _mul32(hi.long() & _MASK32, 0x9E3779B9) \
        ^ _mul32(lo.long() & _MASK32, 0x85EBCA6B)
    h = h ^ (h >> 15)
    h = _mul32(h, 0xC2B2AE35)
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h)


class HashTable(NamedTuple):
    """Open-addressing (linear probing) index over a flat table's keys."""

    slot_hi: torch.Tensor   # (H,) key per slot, PAD_HI = empty
    slot_lo: torch.Tensor   # (H,)
    slot_src: torch.Tensor  # (H,) table slot stored there, -1 = empty
    n_unplaced: torch.Tensor  # () keys that did not fit in HASH_ROUNDS


HASH_ROUNDS = 12


def build_hash(table: VoxelTable) -> HashTable:
    """The reference's hash index, slot for slot: H = the power of two >=
    2 V (at least 16), HASH_ROUNDS rounds in which each unplaced key bids
    for slot ``(hash + round) mod H`` and the smallest table slot among the
    bidders for an empty slot takes it."""
    t = _flat(table)
    v = t.key.shape[0]
    h_size = 1 << max(int(v - 1).bit_length() + 1, 4)
    dev = t.key.device
    valid = t.valid_mask()
    t_hi, t_lo = t.key_hi, t.key_lo
    base = _hash32(t_hi, t_lo) & (h_size - 1)
    big = 2 ** 31 - 1
    ids = torch.arange(v, device=dev)
    slot_src = torch.full((h_size + 1,), -1, dtype=torch.int64, device=dev)
    slot_hi = torch.full((h_size + 1,), PAD_HI, dtype=torch.int64,
                         device=dev)
    slot_lo = slot_hi.clone()
    unplaced = valid
    for r in range(HASH_ROUNDS):
        tgt = (base + r) & (h_size - 1)
        cand = torch.where(unplaced, ids, big)
        win = torch.full((h_size,), big, dtype=torch.int64,
                         device=dev).scatter_reduce_(0, tgt, cand, "amin")
        won = unplaced & (win[tgt] == ids) & (slot_src[tgt] < 0)
        put = torch.where(won, tgt, h_size)
        slot_src = slot_src.scatter(0, put, ids)
        slot_hi = slot_hi.scatter(0, put, t_hi)
        slot_lo = slot_lo.scatter(0, put, t_lo)
        slot_src[h_size] = -1
        slot_hi[h_size] = PAD_HI
        slot_lo[h_size] = PAD_HI
        unplaced = unplaced & ~won
    return HashTable(slot_hi[:h_size], slot_lo[:h_size], slot_src[:h_size],
                     unplaced.sum())


def hash_lookup(table: VoxelTable, ht: HashTable, q_hi, q_lo,
                q_valid) -> torch.Tensor:
    """Exact matches through the hash index (HASH_ROUNDS probes), or
    :func:`merge_lookup` when the build left keys unplaced, as the
    reference falls back; the same answers either way."""
    if int(ht.n_unplaced) != 0:
        return merge_lookup(table, q_hi, q_lo, q_valid)
    h_size = ht.slot_hi.shape[0]
    base = _hash32(q_hi, q_lo) & (h_size - 1)
    found = torch.full_like(base, -1)
    for r in range(HASH_ROUNDS):
        s = (base + r) & (h_size - 1)
        hit = (ht.slot_hi[s] == q_hi) & (ht.slot_lo[s] == q_lo)
        found = torch.where((found < 0) & hit, ht.slot_src[s], found)
    return torch.where(q_valid, found, -1)
