"""Plain sparse-voxel arithmetic of the reference, in PyTorch: voxel levels
built with ``torch.unique`` and ``searchsorted`` over packed keys, and the
convolutions as gathers and one GEMM each. Only active voxels are held (no
capacities, no padding slots). It imports nothing of the program.

Conventions (those of SparseConvNet, which the program follows):

- Level 0 holds the unique (scan, x, y, z) of the valid points whose
  coordinates lie in [0, 4096); level l + 1 the unique (scan, c // 2) of
  level l's voxels.
- A submanifold conv's weight is (27, Cin, Cout), offsets (dx, dy, dz) in
  -1..1 with dx slowest and dz fastest; out[v] = sum_k in[v + offset_k] @
  W[k] over the neighbours that exist. :func:`neighbours` gives the map of
  any odd cube, in the same order.
- A stride-2 conv's and a deconv's weight is (8, Cin, Cout), indexed by
  the fine voxel's place in its parent, 4 (x % 2) + 2 (y % 2) + z % 2.
- Input pooling takes each voxel's mean of its points' features; output
  gives each point its voxel's features.
- Batch norm, in float32, normalises each batch-norm domain by its own
  batch statistics in training (biased variance) and by the running ones
  in eval.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FIELD = 4096  # coordinates lie in [0, FIELD)


def pack(sample: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """int64 keys of (scan, x, y, z); ordered by scan, then x, y, z."""
    c = coords.long()
    return ((sample.long() * FIELD + c[:, 0]) * FIELD + c[:, 1]) * FIELD \
        + c[:, 2]


def unpack(key: torch.Tensor) -> tuple:
    z = key % FIELD
    y = (key // FIELD) % FIELD
    x = (key // FIELD ** 2) % FIELD
    return key // FIELD ** 3, torch.stack([x, y, z], dim=1)


def offsets(kernel_size: int) -> torch.Tensor:
    """(k^3, 3) offsets of a cube of odd side k, dx slowest, dz fastest."""
    if kernel_size < 1 or kernel_size % 2 != 1:
        raise ValueError("kernel size {} is not odd".format(kernel_size))
    r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    return torch.tensor([(dx, dy, dz) for dx in r for dy in r for dz in r])


OFFSETS = offsets(3)


class Level(NamedTuple):
    key: torch.Tensor        # (V,) sorted packed keys
    coords: torch.Tensor     # (V, 3)
    dom: torch.Tensor        # (V,) batch-norm domain
    nbr: torch.Tensor        # (V, 27) neighbour voxel or -1
    # from the finer level (None at level 0)
    f2c: torch.Tensor | None = None       # (V_fine,) parent voxel
    up_off: torch.Tensor | None = None    # (V_fine,) place in the parent
    down_nbr: torch.Tensor | None = None  # (V, 8) child voxel or -1


class Plan(NamedTuple):
    levels: list
    point_voxel: torch.Tensor  # (N,) level-0 voxel of each point, -1 if none
    point_dom: torch.Tensor    # (N,) batch-norm domain of each point


def _neighbours(key: torch.Tensor, sample: torch.Tensor,
                coords: torch.Tensor, offs: torch.Tensor = OFFSETS
                ) -> torch.Tensor:
    offs = offs.to(coords.device)
    q = coords[:, None, :] + offs[None]                       # (V, K, 3)
    inside = ((q >= 0) & (q < FIELD)).all(-1)
    qk = pack(sample[:, None].expand_as(inside).reshape(-1),
              q.clamp(0, FIELD - 1).reshape(-1, 3)).reshape(inside.shape)
    pos = torch.searchsorted(key, qk).clamp(max=key.shape[0] - 1)
    hit = (key[pos] == qk) & inside
    return torch.where(hit, pos, torch.full_like(pos, -1))


def neighbours(level: Level, kernel_size: int) -> torch.Tensor:
    """(V, k^3) neighbour voxel of each of ``level``'s voxels at each
    offset of :func:`offsets` (``kernel_size``), or -1; at 3 it is the
    level's ``nbr``."""
    return _neighbours(level.key, unpack(level.key)[0], level.coords,
                       offsets(kernel_size))


def build_plan(coords: torch.Tensor, sample: torch.Tensor,
               valid: torch.Tensor, sample_dom: torch.Tensor,
               num_levels: int) -> Plan:
    """The levels of the points ``coords`` (N, 3) of scans ``sample`` (N,)
    where ``valid``; ``sample_dom`` (S,) gives each scan's domain."""
    coords = coords.long()
    ok = valid & ((coords >= 0) & (coords < FIELD)).all(-1)
    key, inv = torch.unique(pack(sample[ok], coords[ok]), return_inverse=True)
    point_voxel = torch.full_like(sample.long(), -1)
    point_voxel[ok] = inv
    s, c = unpack(key)
    levels = [Level(key, c, sample_dom[s], _neighbours(key, s, c))]
    for _ in range(1, num_levels):
        fine_c = c
        key, f2c = torch.unique(pack(s, c // 2), return_inverse=True)
        s, c = unpack(key)
        rem = fine_c % 2
        up_off = rem[:, 0] * 4 + rem[:, 1] * 2 + rem[:, 2]
        down = torch.full((key.shape[0], 8), -1, dtype=torch.long,
                          device=key.device)
        down[f2c, up_off] = torch.arange(f2c.shape[0], device=key.device)
        levels.append(Level(key, c, sample_dom[s], _neighbours(key, s, c),
                            f2c, up_off, down))
    point_dom = sample_dom[sample.long()]
    return Plan(levels, point_voxel, point_dom)


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` at ``idx``; zeros where idx < 0. A miss reads a row
    of its own (its position mod the rows), so that no run of one index
    meets the gather's backward."""
    pos = torch.arange(idx.numel(), device=idx.device).reshape(idx.shape)
    safe = torch.where(idx >= 0, idx, pos % max(x.shape[0], 1))
    out = x[safe]
    return torch.where((idx >= 0).reshape(idx.shape + (1,)), out,
                       torch.zeros_like(out))


ROWS = 32768  # voxels a block of a submanifold conv's GEMMs


class _SubmConv(torch.autograd.Function):
    """out = gather(x, nbr) (V, 27 Cin) @ W (27 Cin, Cout), in blocks of
    rows, keeping only x for the backward: d_x gathers the output's
    gradient through the mirrored map (the neighbour at -o is the one that
    reads at +o), d_W sums gather(x)^T g in float32."""

    @staticmethod
    def forward(ctx, x, w, nbr):
        ctx.save_for_backward(x, w, nbr)
        k, cin, cout = w.shape
        wf = w.reshape(k * cin, cout)
        out = x.new_empty((x.shape[0], cout))
        for a in range(0, x.shape[0], ROWS):
            g = _take(x, nbr[a:a + ROWS]).reshape(-1, k * cin)
            out[a:a + ROWS] = g @ wf
        return out

    @staticmethod
    def backward(ctx, go):
        x, w, nbr = ctx.saved_tensors
        k, cin, cout = w.shape
        go = go.to(x.dtype).contiguous()
        flip = nbr.flip(1)
        wt = w.transpose(1, 2).reshape(k * cout, cin)
        dx = torch.empty_like(x)
        dw = torch.zeros((k * cin, cout), dtype=torch.float32,
                         device=x.device)
        for a in range(0, x.shape[0], ROWS):
            gg = _take(go, flip[a:a + ROWS]).reshape(-1, k * cout)
            dx[a:a + ROWS] = gg @ wt
            xg = _take(x, nbr[a:a + ROWS]).reshape(-1, k * cin)
            dw += xg.float().T @ go[a:a + ROWS].float()
        return dx, dw.reshape(k, cin, cout).to(w.dtype), None


def subm_conv(x: torch.Tensor, lv: Level, w: torch.Tensor,
              rnd=identity) -> torch.Tensor:
    """Submanifold 3x3x3 conv in ``x``'s dtype: the GEMM of the gathered
    (V, 27 Cin) neighbourhoods with the (27 Cin, Cout) weight, over blocks
    of rows."""
    return _SubmConv.apply(rnd(x), rnd(w.to(x.dtype)), lv.nbr)


def strided_conv(x: torch.Tensor, coarse: Level, w: torch.Tensor,
                 rnd=identity) -> torch.Tensor:
    """Stride-2 conv onto the coarse level: (Vc, 8 Cin) @ (8 Cin, Cout)."""
    k, cin, cout = w.shape
    g = _take(x, coarse.down_nbr).reshape(coarse.key.shape[0], k * cin)
    return rnd(g) @ rnd(w.reshape(k * cin, cout).to(x.dtype))


def deconv(x: torch.Tensor, coarse: Level, w: torch.Tensor,
           rnd=identity) -> torch.Tensor:
    """Stride-2 transposed conv back onto the fine level's voxels: each
    fine voxel takes its parent's features times W at its place."""
    k, cin, cout = w.shape
    y = rnd(x[coarse.f2c]) @ rnd(w.to(x.dtype).permute(1, 0, 2)
                                 .reshape(cin, k * cout))
    y = y.reshape(-1, k, cout)
    return y.gather(1, coarse.up_off[:, None, None].expand(-1, 1, cout))[:, 0]


def pool(feats: torch.Tensor, point_voxel: torch.Tensor,
         n_voxels: int) -> torch.Tensor:
    """Each voxel's mean of its points' features, summed in float64."""
    ok = point_voxel >= 0
    f = feats[ok].double()
    idx = point_voxel[ok]
    sums = torch.zeros((n_voxels, feats.shape[1]), dtype=torch.float64,
                       device=feats.device).index_add(0, idx, f)
    cnt = torch.zeros(n_voxels, dtype=torch.float64,
                      device=feats.device).index_add(
        0, idx, torch.ones_like(idx, dtype=torch.float64))
    return (sums / cnt[:, None]).to(feats.dtype)


def unpool(x: torch.Tensor, point_voxel: torch.Tensor) -> torch.Tensor:
    return _take(x, point_voxel)


def batch_norm(x: torch.Tensor, dom: torch.Tensor, n_domains: int,
               scale: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               training: bool, eps: float = 1e-4, act: bool = True,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Batch norm (+ ReLU with ``act``) in float32, returned in ``x``'s
    dtype. Training: each domain's rows by their own mean and biased
    variance over its ``valid`` rows (all rows when None); rows outside
    ``valid`` come out as ``bias`` before the activation. Eval: the
    running statistics."""
    f = x.float()
    if not training:
        out = (f - running_mean) * (torch.rsqrt(running_var + eps) * scale) \
            + bias
    else:
        # rows outside ``valid`` go to an extra domain, left out below
        d = torch.where(valid, dom, torch.full_like(dom, n_domains)) \
            if valid is not None else dom
        cnt = torch.bincount(d, minlength=n_domains + 1)[:n_domains + 1]
        cnt = cnt.float().clamp(min=1.0)[:, None]
        zeros = torch.zeros((n_domains + 1, f.shape[1]), device=f.device)
        mean = zeros.index_add(0, d, f) / cnt
        c = f - mean[d]
        var = zeros.index_add(0, d, c * c) / cnt
        out = c * (torch.rsqrt(var + eps) * scale)[d] + bias
        out = torch.where((d < n_domains)[:, None], out,
                          bias.expand_as(out))
    return (torch.relu(out) if act else out).to(x.dtype)
