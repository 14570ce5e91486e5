"""Sparse convolution plans and compute, forward and backward (PyTorch port of
``mopa_tpu/ops/sparse_conv.py``).

* ``SubmanifoldConvolution(3, a, b, 3, False)`` -> :func:`submanifold_conv_wide`
  over a :class:`WidePlan`, an autograd Function: on CUDA tensors its forward
  is the hand-written K1 kernel and its backward the K2 kernels of
  ``ops.sparse_conv_cuda``; on CPU tensors the plain twins
  :func:`submanifold_conv_wide_ref` and :func:`submanifold_conv_wide_bwd_ref`.
  The reference's other two forms are plain gathers and one matmul, as
  they are XLA in JAX, each with the reference's scatter-free backward:
  :func:`submanifold_conv` over the exact (V, 27) neighbour map
  (:func:`build_submanifold_plan`) and :func:`submanifold_conv_zdense` over
  a z-padded :class:`ZPlan` (:func:`build_zplan`, :func:`zplan_from_nbr`).
* ``Convolution(3, a, b, 2, 2, False)`` -> :func:`strided_conv`.
* ``Deconvolution(3, a, b, 2, 2, False)`` -> :func:`deconv`.
  Both differentiate by autograd through their gather + matmul: the gradients
  are the reference's scatter-free custom VJPs, and nothing large is
  materialised beyond what the forward already holds.
* ``BatchNormLeakyReLU`` -> :func:`batch_norm_act`, with running statistics
  (eval) or masked, optionally per-domain batch statistics (training).

Weight layout: ``(K, Cin, Cout)``; kernel offsets enumerate (dx, dy, dz) with
dx slowest and dz fastest, as in the reference and in SparseConvNet.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from mopa_tpu_torch.ops import voxel as voxel_ops


def kernel_offsets(kernel_size: int = 3) -> np.ndarray:
    """All (dx, dy, dz) offsets, dx slowest / dz fastest; int64 (K, 3)."""
    r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    return np.asarray(list(itertools.product(r, r, r)), dtype=np.int64)


WIDE_COLS = np.asarray([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                       dtype=np.int64)  # (9, 2) the wide plan's columns


def build_submanifold_plan(table: voxel_ops.VoxelTable,
                           kernel_size: int = 3,
                           ht: "voxel_ops.HashTable | None" = None,
                           method: str = "merge") -> torch.Tensor:
    """Exact neighbour map of a submanifold conv: (S, V, K) local slots,
    -1 = miss.

    As in the reference, only the first half of the offsets is looked up;
    the match u -> u + o is injective, so the map of -o is its transpose
    (one collision-free scatter), and the centre is the identity. The
    lookup is the reference's ``method`` ("merge": one ``searchsorted`` per
    sample row over its sorted keys; "presorted": one per offset,
    :func:`voxel.merge_lookup_presorted`) or, with ``ht`` (a flat table's
    :func:`voxel.build_hash`), the hash probes; all give the same map."""
    s, v = table.key.shape
    dev = table.key.device
    k = kernel_size ** 3
    half = k // 2
    # kernel_offsets' order, made on the device (a host array's copy to
    # the card waits on it)
    r = torch.arange(-(kernel_size // 2), kernel_size // 2 + 1, device=dev)
    offs = torch.cartesian_prod(r, r, r)[:half]                   # (h, 3)
    valid = table.valid_mask()
    q = table.coords[:, :, None, :] + offs                       # (S, V, h, 3)
    q_valid = valid[:, :, None] & ((q >= 0) & (q < voxel_ops.SHIFT)).all(-1)
    qkey = voxel_ops.pack_keys(q, table.batch[:, :, None], q_valid)
    if ht is not None:
        q_hi, q_lo = voxel_ops.pack_keys_hilo(q[0], table.batch[0, :, None],
                                              q_valid[0])
        nbr_half = voxel_ops.hash_lookup(
            table, ht, q_hi.reshape(-1), q_lo.reshape(-1),
            q_valid[0].reshape(-1)).reshape(1, v, half)
    elif method == "presorted":
        q_hi, q_lo = voxel_ops.pack_keys_hilo(q[0], table.batch[0, :, None],
                                              q_valid[0])
        nbr_half = torch.stack([voxel_ops.merge_lookup_presorted(
            table, q_hi[:, j], q_lo[:, j], q_valid[0, :, j])
            for j in range(half)], dim=1)[None]
    else:
        flat = qkey.reshape(s, v * half)
        pos = torch.searchsorted(table.key, flat).clamp(max=v - 1)
        hit = (table.key.gather(1, pos) == flat) & q_valid.reshape(s, -1)
        nbr_half = torch.where(hit, pos, -1).reshape(s, v, half)
    slots = torch.arange(v, device=dev).expand(s, v)
    centre = torch.where(valid, slots, -1)
    # nbr[u, j] = w  =>  nbr[w, k-1-j] = u; misses land in the dump slot
    mirror_col = (half - 1 - torch.arange(half, device=dev))
    tgt = torch.where(nbr_half >= 0, nbr_half * half + mirror_col,
                      v * half).reshape(s, -1)
    src = slots[:, :, None].expand(s, v, half).reshape(s, -1)
    mirror = torch.full((s, v * half + 1), -1, dtype=torch.int64,
                        device=dev).scatter_(1, tgt, src)[:, :-1]
    return torch.cat([nbr_half, centre[:, :, None],
                      mirror.reshape(s, v, half)], dim=2)


class WidePlan(NamedTuple):
    """Wide-column submanifold plan: one lower-bound rank per (dx, dy) column.

    Keys sort z-fastest, so a column's (up to) three dz neighbours occupy
    CONSECUTIVE table rows starting at its rank; ``sel`` routes gathered row
    j to its dz slot.

    Attributes:
        ranks: (V*9,) int32 window start rows, v-major then column (columns
            enumerate (dx, dy) with dx slowest; column 4 = centre). The
            all-miss sentinel is the sample's capacity, which after the
            per-sample offset is the next sample's first row (or one past
            the table for the last sample): readers bound-check it.
        sel: (V*9,) int32 packed dz codes: bits [2j, 2j+2) hold the dz slot
            (0..2) of gathered row j, 3 = none (63 = an all-miss column).
    """

    ranks: torch.Tensor
    sel: torch.Tensor


def wide_from_nbr(nbr: torch.Tensor, capacity: int):
    """(S, V, 27) exact neighbour map -> per-sample (ranks, sel), each
    (S, V, 9), in local slot space (sentinel rank = ``capacity``)."""
    n = nbr.reshape(nbr.shape[0], nbr.shape[1], 9, 3)
    s0, s1, s2 = n[..., 0], n[..., 1], n[..., 2]
    e0, e1, e2 = s0 >= 0, s1 >= 0, s2 >= 0
    cap = torch.full_like(s0, capacity)
    ranks = torch.where(e0, s0, torch.where(e1, s1, torch.where(e2, s2, cap)))

    def code(*pairs):
        out = torch.full_like(s0, 3)
        for cond, val in reversed(pairs):
            out = torch.where(cond, torch.full_like(s0, val), out)
        return out

    t0 = code((e0, 0), (e1, 1), (e2, 2))
    t1 = code((e0 & e1, 1), ((e0 | e1) & e2, 2))
    t2 = code((e0 & e1 & e2, 2))
    return ranks, t0 + (t1 << 2) + (t2 << 4)


def build_wide_plan(table: voxel_ops.VoxelTable) -> WidePlan:
    """The wide-column plan of S tables as one flat plan: ranks offset by
    each sample's first row (S * V slots, sample-major, as the batched UNet
    plan lays them out); of a flat table, the reference's
    ``build_wide_plan``."""
    s, v = table.key.shape
    ranks, sel = wide_from_nbr(build_submanifold_plan(table), v)
    off = (torch.arange(s, device=ranks.device) * v)[:, None, None]
    return WidePlan(ranks=(ranks + off).reshape(-1).to(torch.int32),
                    sel=sel.reshape(-1).to(torch.int32))


class ZPlan(NamedTuple):
    """z-dense wide-column plan: window reads are dz-aligned by
    construction (the reference's ``ZPlan``).

    Attributes:
        ranks: (V*9,) padded-slot window starts, v-major then column
            (columns enumerate (dx, dy), dx slowest); ``Vp`` is the
            all-miss sentinel, which reads zero rows.
        p2a: (Vp,) active slot per padded slot, -1 = a zero slot.
    """

    ranks: torch.Tensor
    p2a: torch.Tensor


def zplan_from_nbr(nbr: torch.Tensor,
                   pz: voxel_ops.PaddedZTable) -> ZPlan:
    """The z-dense plan from a flat table's exact (V, 27) neighbour map and
    its :func:`voxel.build_padded_ztable`: a column's window starts at the
    padded slot of its dz = -1 key, which is ``a2p`` of that neighbour, or
    1 (2) below ``a2p`` of its dz = 0 (+1) neighbour; ``Vp`` where the
    column has none."""
    v = nbr.shape[0]
    vp = pz.capacity
    ap = pz.a2p[nbr.clamp(0, v - 1)]
    n = nbr.reshape(v, 9, 3)
    a = ap.reshape(v, 9, 3)
    start = torch.where(n[..., 0] >= 0, a[..., 0],
                        torch.where(n[..., 1] >= 0, a[..., 1] - 1,
                                    torch.where(n[..., 2] >= 0, a[..., 2] - 2,
                                                vp)))
    return ZPlan(ranks=start.reshape(-1), p2a=pz.p2a)


def build_zplan(table: voxel_ops.VoxelTable,
                pad_capacity: int | None = None) -> ZPlan:
    """The z-dense plan of a flat table straight from its padded keys
    (:func:`voxel.build_padded_ztable_keys`, capacity 5 V by default): each
    column's window-start key (x+dx, y+dy, z-1) looked up among them, kept
    only where the slot two above holds (x+dx, y+dy, z+1), else ``Vp``."""
    t = voxel_ops._flat(table)
    v = t.key.shape[0]
    vp = 5 * v if pad_capacity is None else int(pad_capacity)
    pz = voxel_ops.build_padded_ztable_keys(table, vp)
    valid = t.valid_mask()
    zbase = voxel_ops.SHIFT + 8
    dev = t.key.device
    cols = torch.as_tensor(WIDE_COLS, device=dev)
    base_lo = t.coords[:, 1] * zbase + t.coords[:, 2] + 4
    q_hi = torch.where(valid[:, None], t.key_hi[:, None] + cols[:, 0],
                       voxel_ops.PAD_HI).reshape(-1)
    q_lo = torch.where(valid[:, None],
                       base_lo[:, None] + cols[:, 1] * zbase - 1,
                       voxel_ops.PAD_HI).reshape(-1)
    qx = t.coords[:, 0:1] + cols[:, 0]
    qy = t.coords[:, 1:2] + cols[:, 1]
    q_valid = (valid[:, None] & (qx >= 0) & (qx < voxel_ops.SHIFT)
               & (qy >= 0) & (qy < voxel_ops.SHIFT)).reshape(-1)
    slots = voxel_ops.merge_lookup_keys(pz.key_hi, pz.key_lo, q_hi, q_lo,
                                        q_valid)
    probe = (slots + 2).clamp(0, vp - 1)
    ok = ((slots >= 0) & (pz.key_hi[probe] == q_hi)
          & (pz.key_lo[probe] == q_lo + 2))
    return ZPlan(ranks=torch.where(ok, slots, vp), p2a=pz.p2a)


def down_plan_from_f2c(f2c: torch.Tensor, up_off: torch.Tensor,
                       fine_valid: torch.Tensor,
                       coarse_capacity: int) -> torch.Tensor:
    """(S, Vc, 8) stride-2 gather map as the inverse of (f2c, up_off): each
    fine site f is the unique input of coarse site f2c[f] at kernel offset
    up_off[f], so ``down_nbr[f2c[f], up_off[f]] = f`` (one collision-free
    scatter; misses stay -1)."""
    s, vf = f2c.shape
    vc = int(coarse_capacity)
    ok = fine_valid & (f2c >= 0)
    flat = torch.where(ok, f2c * 8 + up_off, torch.full_like(f2c, vc * 8))
    src = torch.arange(vf, device=f2c.device).expand(s, vf)
    out = torch.full((s, vc * 8 + 1), -1, dtype=torch.int64,
                     device=f2c.device)
    return out.scatter_(1, flat, src)[:, :-1].reshape(s, vc, 8)


def up_offset_index(coords: torch.Tensor) -> torch.Tensor:
    """Per fine-site deconv kernel-offset index ``4*(x%2) + 2*(y%2) + z%2``."""
    rem = coords % 2
    return rem[..., 0] * 4 + rem[..., 1] * 2 + rem[..., 2]


def _masked_take(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of feats at idx; idx < 0 yields zeros."""
    out = feats[voxel_ops.spread_misses(idx, feats.shape[0])]
    return torch.where((idx >= 0)[:, None], out, torch.zeros_like(out))


def _wide_align(x: torch.Tensor, ranks: torch.Tensor,
                sel: torch.Tensor) -> torch.Tensor:
    """(V, C) rows -> (V, 27*C) dz-aligned windows: block k = 3*c + t of row
    v holds the row at kernel offset k (zero where absent). Window rows past
    the table read zero (the all-miss sentinel of the last sample is V); rows
    whose dz code is 3 contribute nothing. The centre column is gathered like
    the other 8: its rank is ``v - e0``, the rows the reference reads by
    shifts."""
    v, c = x.shape
    fp = torch.cat([x, x.new_zeros(2, c)])
    base = ranks.reshape(v, 9).long().clamp(0, v - 1)
    codes = sel.reshape(v, 9)
    g = [fp[base + j] for j in range(3)]                   # (V, 9, C) each
    t = [(codes >> (2 * j)) & 3 for j in range(3)]
    zero = torch.zeros_like(g[0])
    slots = []
    for slot in range(3):  # codes strictly increase, so slot t takes j <= t
        acc = zero
        for j in range(slot + 1):
            acc = acc + torch.where((t[j] == slot)[..., None], g[j], zero)
        slots.append(acc)
    return torch.stack(slots, dim=2).reshape(v, 27 * c)


def submanifold_conv_wide_ref(feats: torch.Tensor, ranks: torch.Tensor,
                              sel: torch.Tensor,
                              weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the K1 kernel: gather, dz-align, one GEMM.

    feats (V, Cin); ranks/sel (V*9,) over the flat global plan; weight
    (27, Cin, Cout), used in the feature dtype."""
    k, cin, cout = weight.shape
    return _wide_align(feats, ranks, sel) @ weight.reshape(k * cin, cout).to(
        feats.dtype)


def submanifold_conv_wide_dfeats_ref(g: torch.Tensor, ranks: torch.Tensor,
                                     sel: torch.Tensor,
                                     weight: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2's ``d_feats``: the same windowed conv of the
    cotangent g (V, Cout) with the mirrored, transposed forward weight
    ``weight[::-1].transpose(1, 2)`` (u is v's neighbour at offset o iff v is
    u's at -o, and the offsets enumerate symmetrically)."""
    return submanifold_conv_wide_ref(g, ranks, sel,
                                     weight.flip(0).transpose(1, 2))


def submanifold_conv_wide_dw_ref(g: torch.Tensor, feats: torch.Tensor,
                                 ranks: torch.Tensor,
                                 sel: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2's ``d_w`` (27, Cin, Cout) float32, in the reference's
    mirror form: ``d_w[k] = feats^T @ aligned_g[:, block 26-k]``, products
    summed in float32."""
    v, cin = feats.shape
    cout = g.shape[1]
    p = feats.float().T @ _wide_align(g, ranks, sel).float()  # (Cin, 27*Cout)
    return p.reshape(cin, 27, cout).flip(1).permute(1, 0, 2).contiguous()


def submanifold_conv_wide_bwd_ref(g: torch.Tensor, feats: torch.Tensor,
                                  ranks: torch.Tensor, sel: torch.Tensor,
                                  weight: torch.Tensor):
    """Plain twin of K2, the monolithic ``_wide_bwd`` maths: (d_feats in the
    feature dtype, d_w float32) for a cotangent g already in the feature
    dtype."""
    return (submanifold_conv_wide_dfeats_ref(g, ranks, sel, weight),
            submanifold_conv_wide_dw_ref(g, feats, ranks, sel))


def _conv_fwd(feats, ranks, sel, weight):
    if feats.is_cuda:
        from mopa_tpu_torch.ops import sparse_conv_cuda

        return sparse_conv_cuda.submanifold_conv_wide_cuda(feats, ranks, sel,
                                                           weight)
    return submanifold_conv_wide_ref(feats, ranks, sel, weight)


def _conv_bwd(g, feats, ranks, sel, weight, need_dfeats, need_dw):
    """(d_feats or None, d_w or None): K2 on CUDA tensors (one set of pair
    lists for both on the float32 route), the plain twins on the CPU."""
    if g.is_cuda:
        from mopa_tpu_torch.ops import sparse_conv_cuda

        return sparse_conv_cuda.submanifold_conv_wide_bwd_cuda(
            g, feats, ranks, sel, weight, need_dfeats, need_dw)
    return (submanifold_conv_wide_dfeats_ref(g, ranks, sel, weight)
            if need_dfeats else None,
            submanifold_conv_wide_dw_ref(g, feats, ranks, sel)
            if need_dw else None)


class _SubmanifoldConvWide(torch.autograd.Function):
    """The reference's ``_submanifold_conv_wide`` custom VJP. The weight
    parameter stays float32 and is cast to the feature dtype here, at use,
    so ``d_w`` leaves in float32 as JAX returns it."""

    @staticmethod
    def forward(ctx, feats, weight, ranks, sel):
        feats = feats.contiguous()
        w = weight.to(feats.dtype).contiguous()
        ctx.save_for_backward(feats, w, ranks, sel)
        ctx.weight_dtype = weight.dtype
        return _conv_fwd(feats, ranks, sel, w)

    @staticmethod
    def backward(ctx, g):
        feats, w, ranks, sel = ctx.saved_tensors
        g = g.to(feats.dtype).contiguous()
        # no d_feats for the stem's all-ones input
        d_feats, d_w = _conv_bwd(g, feats, ranks, sel, w,
                                 ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1])
        if d_w is not None:
            d_w = d_w.to(ctx.weight_dtype)
        return d_feats, d_w, None, None


def submanifold_conv_wide(feats: torch.Tensor, plan: WidePlan,
                          weight: torch.Tensor) -> torch.Tensor:
    """Submanifold 3x3x3 conv over a flat :class:`WidePlan`, differentiable.

    CUDA tensors always run the hand-written kernels (K1 forward, K2
    backward; a build or launch failure raises); CPU tensors run the plain
    twins."""
    return _SubmanifoldConvWide.apply(feats, weight, plan.ranks, plan.sel)


def _zdense_align(feats: torch.Tensor, ranks: torch.Tensor,
                  p2a: torch.Tensor) -> torch.Tensor:
    """(V, C) rows -> (V, 27*C) windows read from the z-padded slots: the
    active rows placed at their padded slots (zero elsewhere), three
    consecutive slots per column, the all-miss sentinel on zero rows."""
    c = feats.shape[1]
    vp = p2a.shape[0]
    fp = torch.cat([_masked_take(feats, p2a), feats.new_zeros(3, c)])
    windows = torch.cat([fp[:vp + 1], fp[1:vp + 2], fp[2:vp + 3]], dim=1)
    return windows[ranks.long().clamp(0, vp)].reshape(-1, 27 * c)


class _SubmanifoldConvZdense(torch.autograd.Function):
    """The reference's ``_submanifold_conv_zdense`` custom VJP: the windows
    are gathered again in the backward; ``d_feats`` is the same conv of the
    cotangent with the mirrored, transposed weight, ``d_w`` the windows'
    transpose times the cotangent, in float32."""

    @staticmethod
    def forward(ctx, feats, weight, ranks, p2a):
        k, cin, cout = weight.shape
        ctx.save_for_backward(feats, weight, ranks, p2a)
        return _zdense_align(feats, ranks, p2a) @ weight.reshape(
            k * cin, cout).to(feats.dtype)

    @staticmethod
    def backward(ctx, g):
        feats, weight, ranks, p2a = ctx.saved_tensors
        k, cin, cout = weight.shape
        g = g.to(feats.dtype)
        d_w = (_zdense_align(feats, ranks, p2a).float().T @ g.float())
        w_bwd = weight.flip(0).transpose(1, 2).reshape(k * cout, cin)
        d_feats = _zdense_align(g, ranks, p2a) @ w_bwd.to(g.dtype)
        return (d_feats.to(feats.dtype),
                d_w.reshape(k, cin, cout).to(weight.dtype), None, None)


def submanifold_conv_zdense(feats: torch.Tensor, plan: ZPlan,
                            weight: torch.Tensor) -> torch.Tensor:
    """Submanifold conv through a :class:`ZPlan` (the exact neighbour
    conv's numbers), differentiable."""
    return _SubmanifoldConvZdense.apply(feats, weight, plan.ranks, plan.p2a)


def _gather_concat(feats: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(V, K*C): the rows at each of the K neighbours, zero at misses."""
    v, k = nbr.shape
    return _masked_take(feats, nbr.reshape(-1)).reshape(v, k * feats.shape[1])


class _SubmanifoldConv(torch.autograd.Function):
    """The reference's ``_submanifold_conv`` custom VJP, scatter-free: the
    cotangent gathered over the mirrored map gives ``d_feats`` (one GEMM
    with the per-offset transposed weight) and ``d_w`` (the features'
    transpose times it, in float32)."""

    @staticmethod
    def forward(ctx, feats, weight, nbr):
        k, cin, cout = weight.shape
        ctx.save_for_backward(feats, weight, nbr)
        return _gather_concat(feats, nbr) @ weight.reshape(
            k * cin, cout).to(feats.dtype)

    @staticmethod
    def backward(ctx, g):
        feats, weight, nbr = ctx.saved_tensors
        k, cin, cout = weight.shape
        g = g.to(feats.dtype)
        g_gathered = _gather_concat(g, nbr.flip(1))         # (V, K*Cout)
        w_t = weight.transpose(1, 2).reshape(k * cout, cin).to(g.dtype)
        d_feats = g_gathered @ w_t
        d_w = (feats.float().T @ g_gathered.float()).reshape(
            cin, k, cout).transpose(0, 1)
        return d_feats.to(feats.dtype), d_w.to(weight.dtype), None


def submanifold_conv(feats: torch.Tensor, nbr: torch.Tensor,
                     weight: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """out[v] = sum_k feats[nbr[v, k]] @ weight[k] (misses contribute zero)
    over the exact (V, K) neighbour map, plus ``bias``; differentiable."""
    out = _SubmanifoldConv.apply(feats, weight, nbr)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def strided_conv(fine_feats: torch.Tensor, down_nbr: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Stride-2 conv: out (Vc, Cout) = sum_o fine[down_nbr[:, o]] @ W[o]
    over the (Vc, 8) gather map (misses contribute zero)."""
    vc = down_nbr.shape[0]
    k, cin, cout = weight.shape
    gathered = _masked_take(fine_feats, down_nbr.reshape(-1))
    return gathered.reshape(vc, k * cin) @ weight.reshape(k * cin, cout).to(
        fine_feats.dtype)


def deconv(coarse_feats: torch.Tensor, f2c: torch.Tensor,
           up_off: torch.Tensor, weight: torch.Tensor,
           fine_valid: torch.Tensor) -> torch.Tensor:
    """Stride-2 transposed conv onto the fine level's active sites:
    out[f] = coarse[f2c[f]] @ W[up_off[f]] (zero at invalid fine sites)."""
    k, cin, cout = weight.shape
    gathered = _masked_take(coarse_feats, f2c)                     # (Vf, Cin)
    w_all = weight.to(coarse_feats.dtype).permute(1, 0, 2).reshape(
        cin, k * cout)
    y = (gathered @ w_all).reshape(-1, k, cout)
    out = y.gather(1, up_off[:, None, None].expand(-1, 1, cout))[:, 0]
    return torch.where(fine_valid[:, None], out, torch.zeros_like(out))


def batch_norm_act(feats: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, running_mean: torch.Tensor,
                   running_var: torch.Tensor, *, training: bool = False,
                   valid: torch.Tensor | None = None,
                   dom: torch.Tensor | None = None, n_domains: int = 1,
                   momentum: float = 0.9, eps: float = 1e-4,
                   leakiness: float = 0.0, act: bool = True) -> torch.Tensor:
    """Masked batch norm + (leaky) ReLU over voxels (``scn.BatchNormLeakyReLU``,
    eps 1e-4), computed in float32 and returned in the feature dtype.

    Eval: running statistics. Training: statistics of the ``valid`` rows
    (biased variance), and the running buffers are updated IN PLACE, under
    ``no_grad``, as running = momentum * running + (1 - momentum) * batch.
    Domain mode (``dom`` (V,) ids, ``n_domains`` > 1): each domain's rows are
    normalised with their own statistics, exactly as separate forwards would
    be; the running buffers take the per-domain updates in domain order, and
    a domain with no valid row leaves them untouched. Rows of no domain
    (padding) come out as ``bias`` (before the activation).
    """
    if not training:
        return _act((feats.float() - running_mean)
                    * (torch.rsqrt(running_var + eps) * scale) + bias,
                    leakiness, act).to(feats.dtype)
    f32 = feats.float()
    if dom is None or n_domains == 1:
        m = valid.float()[:, None]
        n = m.sum().clamp(min=1.0)
        mean = (f32 * m).sum(dim=0) / n
        var = ((f32 - mean).square() * m).sum(dim=0) / n
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
            running_var.mul_(momentum).add_((1.0 - momentum) * var)
        out = (f32 - mean) * (torch.rsqrt(var + eps) * scale) + bias
    else:
        d = int(n_domains)
        onehot = ((dom[:, None] == torch.arange(d, device=dom.device))
                  & valid[:, None]).float()                      # (V, D)
        counts = onehot.sum(dim=0)
        denom = counts.clamp(min=1.0)[:, None]
        mean = (onehot.T @ f32) / denom                          # (D, C)
        # per-domain stats go back to the rows by one-hot GEMMs, as in the
        # reference (their backward is a GEMM, not a scatter-add)
        centered = f32 - onehot @ mean
        var = (onehot.T @ centered.square()) / denom             # (D, C)
        with torch.no_grad():
            for i in range(d):  # sequential; an empty domain keeps momentum 1
                mom = torch.where(counts[i] > 0, momentum, 1.0)
                running_mean.mul_(mom).add_((1.0 - mom) * mean[i])
                running_var.mul_(mom).add_((1.0 - mom) * var[i])
        out = centered * (onehot @ (torch.rsqrt(var + eps) * scale)) + bias
    return _act(out, leakiness, act).to(feats.dtype)


def _act(x: torch.Tensor, leakiness: float, act: bool) -> torch.Tensor:
    if not act:
        return x
    return torch.where(x >= 0, x, leakiness * x) if leakiness > 0 \
        else torch.relu(x)
