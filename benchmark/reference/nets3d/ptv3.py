"""Point Transformer V3: Wu et al., CVPR 2024 (Pointcept
``pointcept/models/point_transformer_v3/point_transformer_v3m1_base.py``,
``configs/semantic_kitti/semseg-pt-v3m1-0-base.py``), in plain float32
PyTorch over the reference's own voxel levels (stride 2 each, SCN's). Values
(``MODEL_3D.PTv3``): Pointcept's keywords, :data:`DEFAULTS` where unset
(``enc_patch_size`` the patch of each level, encoder and decoder alike).

- Serialization, as Pointcept writes it: level 0's codes at depth 12 (the
  4096 cells of an axis) with the scan's index above them, ``"z"`` by bit
  interleave (x highest), ``"hilbert"`` by Pointcept's bit-array form of
  Skilling's algorithm, ``-trans`` with x and y swapped; a coarser level's
  code is its children's >> 3. Each scan's voxels sorted by code make its
  sequence, cut into patches of K: a scan of n > K voxels pads its last
  patch with the voxels K places before (``get_padding_and_inverse``), a
  scan of n <= K is one patch of n. Block i of a level uses order i % 4 of
  its list, shuffled in training (below).
- Stem: 5x5x5 submanifold conv (``sparse3d.neighbours(level, 5)``) without
  bias, batch norm (eps 1e-3), GELU. Input: each voxel's mean of its points'
  features.
- Block: x += LN(Linear(SubMConv3(x) + b)); x += DropPath(Proj(Attn(LN(x))));
  x += DropPath(fc2(GELU(fc1(LN(x))))). Attention: the textbook
  softmax(q k^T / sqrt(d)) v of each patch and head, in chunks of patches,
  each under ``torch.utils.checkpoint`` so that the saved scores stay
  small at published widths; padded queries are thrown away, padded keys
  count as Pointcept counts them.
- Pooling: max over children of Linear(x), batch norm, GELU; unpooling:
  GELU(BN(Linear(skip))) + GELU(BN(Linear(coarse)))[parent].
- Training draws from the generator, as the program documents: one (levels,
  orders) uniform draw argsorted per level (the orders' shuffle), then one
  int64 seed in [0, 2**31) where any block drops. Block j (encoder, then
  decoder, in execution order) keeps a voxel's branch where the 31-bit hash
  of (voxel key, seed, stream 2 j or 2 j + 1) / 2**31 >= its rate
  (:func:`drop_uniform`), scaling by 1 / (1 - rate).

Every GEMM module subclasses ``net3d._Rounding`` and rounds its operands by
the configuration's compute dtype (its float32 operands, the attention's
products included), so that the control (``fp8``) reaches them.

Its check adds ``serial_gap`` (the share of (level, order, voxel) whose
(patch, place) in the program's layout is not the reference's; limit 0)
and ``block_gap`` (the first block of each encoder stage worked out again
from the program's own input, with the program's order and drop seed:
max |prog - ref| / max |ref| over the stages).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.harness import counts
from benchmark.harness.counts import Conv

from .. import sparse3d as sp
from ..net3d import _Rounding

TYPE = "PTv3"
DEFAULTS = {
    "in_channels": 4,
    "order": ("z", "z-trans", "hilbert", "hilbert-trans"),
    "enc_depths": (2, 2, 2, 6, 2),
    "enc_channels": (32, 64, 128, 256, 512),
    "enc_num_head": (2, 4, 8, 16, 32),
    "enc_patch_size": (1024, 1024, 1024, 1024, 1024),
    "dec_depths": (2, 2, 2, 2),
    "dec_channels": (64, 64, 128, 256),
    "dec_num_head": (4, 4, 8, 16),
    "mlp_ratio": 4,
    "qkv_bias": True,
    "drop_path": 0.3,
}
DEPTH = 12
STEM = 5
SCORES = 2 ** 26   # float32 scores a checkpointed chunk of patches holds
# H100 SXM: bfloat16 tensor-core peak, the special-function units'
# exponentials (FlashAttention-3's figure), HBM bandwidth
PEAK_BF16 = 989e12
EXP_PER_S = 3.9e12
_M31 = (1 << 31) - 1


def values(sub: dict) -> dict:
    out = dict(DEFAULTS)
    out.update(sub)
    return out


# -- serialization ------------------------------------------------------------

def z_order(c: torch.Tensor, depth: int) -> torch.Tensor:
    """Pointcept's ``z_order.xyz2key``: bit i of x, y, z to 3i + 2, 3i + 1,
    3i."""
    x, y, z = c[:, 0].long(), c[:, 1].long(), c[:, 2].long()
    key = torch.zeros_like(x)
    for i in range(depth):
        m = 1 << i
        key = key | ((x & m) << (2 * i + 2)) | ((y & m) << (2 * i + 1)) \
            | ((z & m) << (2 * i))
    return key


def hilbert(c: torch.Tensor, depth: int) -> torch.Tensor:
    """Pointcept's ``hilbert.encode`` on bit arrays (most significant bit
    first): the transpose, then the bits flattened bit-major, x first, and
    Gray decoded."""
    n = c.shape[0]
    gray = torch.stack([(c.long() >> (depth - 1 - b)) & 1
                        for b in range(depth)], dim=-1).bool()  # (n, 3, d)
    for bit in range(depth):
        for dim in range(3):
            mask = gray[:, dim, bit].clone()
            gray[:, 0, bit + 1:] ^= mask[:, None]
            flip = ~mask[:, None] & (gray[:, 0, bit + 1:]
                                     ^ gray[:, dim, bit + 1:])
            gray[:, dim, bit + 1:] ^= flip
            gray[:, 0, bit + 1:] ^= flip
    seq = gray.transpose(1, 2).reshape(n, 3 * depth).long()
    binary = torch.cumsum(seq, dim=1) % 2
    weight = 2 ** torch.arange(3 * depth - 1, -1, -1, device=c.device)
    return (binary * weight).sum(dim=1)


def encode(coords: torch.Tensor, sample: torch.Tensor, order: str,
           depth: int) -> torch.Tensor:
    """Pointcept's ``serialization.encode`` with the scan's index above."""
    if order.endswith("-trans"):
        coords = coords[:, [1, 0, 2]]
    code = z_order(coords, depth) if order.startswith("z") \
        else hilbert(coords, depth)
    return (sample.long() << (3 * depth)) | code


class Layout:
    """One level's layout in one order: ``rank`` (V,), each voxel's place
    in its scan's sequence; ``full`` (patches, K), the voxels of each
    K-patch, with ``own`` marking a voxel's own place (not a pad); ``short``,
    the voxels of each scan of fewer than K voxels."""

    def __init__(self, code: torch.Tensor, sample: torch.Tensor, k: int):
        order = torch.argsort(code)
        n = torch.bincount(sample, minlength=int(sample.max()) + 1
                           if sample.numel() else 0).tolist()
        self.k = k
        self.rank = torch.empty_like(order)
        full, own, self.short = [], [], []
        at = 0
        for cnt in n:
            seq = order[at:at + cnt]
            self.rank[seq] = torch.arange(cnt, device=code.device)
            at += cnt
            if cnt == 0:
                continue
            if cnt < k:
                self.short.append(seq)
                continue
            n_pad = -(-cnt // k) * k
            p = torch.arange(n_pad, device=code.device)
            full.append(seq[torch.where(p < cnt, p, p - k)].reshape(-1, k))
            own.append((p < cnt).reshape(-1, k))
        dev = code.device
        self.full = torch.cat(full) if full else torch.zeros(
            (0, k), dtype=torch.long, device=dev)
        self.own = torch.cat(own) if own else torch.zeros(
            (0, k), dtype=torch.bool, device=dev)


def level_codes(plan: sp.Plan, orders) -> list:
    """(orders, V_l) codes of each level: level 0's at depth 12, each
    coarser level's its children's >> 3."""
    out = []
    for l, lv in enumerate(plan.levels):
        if l == 0:
            sample = sp.unpack(lv.key)[0]
            out.append(torch.stack([encode(lv.coords, sample, o, DEPTH)
                                    for o in orders]))
            continue
        child = out[-1] >> 3
        big = torch.iinfo(torch.int64).max
        parent = torch.full((child.shape[0], lv.key.shape[0]), big,
                            dtype=torch.long, device=child.device)
        out.append(parent.scatter_reduce(
            1, lv.f2c[None].expand_as(child), child, "amin"))
    return out


def layouts(plan: sp.Plan, orders, patch_sizes) -> list:
    """[level][order] :class:`Layout` of ``plan``."""
    out = []
    for l, codes in enumerate(level_codes(plan, orders)):
        sample = sp.unpack(plan.levels[l].key)[0]
        out.append([Layout(c, sample, int(patch_sizes[l])) for c in codes])
    return out


def drop_uniform(key: torch.Tensor, seed: int, stream: int) -> torch.Tensor:
    """The drop-path draw of each voxel key: three rounds of a 31-bit
    xor-shift-multiply hash over (key's low 31 bits ^ seed), (key's high
    bits), (stream * 0x9E3779B1), its top 24 bits over 2**24."""
    def mix(x):
        for _ in range(2):
            x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M31
        return x ^ (x >> 16)

    h = mix((key & _M31) ^ int(seed))
    h = mix(h ^ ((key >> 31) & _M31))
    h = mix(h ^ ((int(stream) * 0x9E3779B1) & _M31))
    return (h >> 7).double() / float(1 << 24)


# -- layers -------------------------------------------------------------------

class _Round(_Rounding):
    """Rounds its GEMMs' operands by the net's compute dtype (``dtype``, set
    by :class:`PTv3`), not by theirs: the reference computes in float32."""

    dtype = torch.float32

    def r(self, x):
        return self.rounding.get(self.dtype, sp.identity)


class Linear(nn.Linear, _Round):
    def forward(self, x):
        r = self.r(x)
        out = r(x) @ r(self.weight).T
        return out if self.bias is None else out + self.bias


class SubMConv(_Round):
    def __init__(self, k: int, cin: int, cout: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((k, cin, cout)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class BatchNorm(nn.Module):
    def __init__(self, c: int, act: bool = True):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, lv: sp.Level, nd: int):
        y = sp.batch_norm(x, lv.dom, nd, self.weight, self.bias,
                          self.running_mean, self.running_var, self.training,
                          eps=1e-3, act=False)
        return F.gelu(y) if self.act else y


def _scores(q, k, v, scale, r):
    p = torch.softmax((r(q) @ r(k).transpose(-1, -2)) * scale, dim=-1)
    return r(p) @ r(v)


def attend(qkv: torch.Tensor, lay: Layout, heads: int,
           r=sp.identity) -> torch.Tensor:
    """(V, C) attention of (V, 3C) ``qkv`` (q, k, v, each head-major) over
    ``lay``'s patches, each voxel's output at its own place; ``r`` rounds
    the products' operands."""
    v_rows, c = qkv.shape[0], qkv.shape[1] // 3
    h = heads
    d = c // h
    qkv = qkv.view(v_rows, 3, h, d)
    rows, outs = [], []
    if lay.full.shape[0]:
        step = max(1, SCORES // (h * lay.k * lay.k))
        for a in range(0, lay.full.shape[0], step):
            idx = lay.full[a:a + step]
            g = qkv[idx].permute(2, 0, 3, 1, 4)   # (3, n, h, K, d)
            o = checkpoint(_scores, g[0], g[1], g[2], d ** -0.5, r,
                           use_reentrant=False)
            o = o.permute(0, 2, 1, 3).reshape(-1, c)
            own = lay.own[a:a + step].reshape(-1)
            rows.append(idx.reshape(-1)[own])
            outs.append(o[own])
    for seq in lay.short:
        g = qkv[seq].permute(1, 2, 0, 3)[:, None]  # (3, 1, h, n, d)
        o = _scores(g[0], g[1], g[2], d ** -0.5, r)
        rows.append(seq)
        outs.append(o[0].permute(1, 0, 2).reshape(-1, c))
    return qkv.new_zeros((v_rows, c)).index_put(
        (torch.cat(rows),), torch.cat(outs))


class Attention(_Round):
    def __init__(self, c: int, heads: int, qkv_bias: bool):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(c, 3 * c, bias=qkv_bias)
        self.proj = Linear(c, c)

    def forward(self, x, lay: Layout):
        return self.proj(attend(self.qkv(x), lay, self.heads, self.r(x)))


class MLP(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(c, hidden)
        self.fc2 = Linear(hidden, c)


class Block(_Round):
    def __init__(self, c, heads, mlp_ratio, qkv_bias, rate, index):
        super().__init__()
        self.rate, self.index = float(rate), index
        self.cpe = nn.ModuleList([SubMConv(27, c, c, True), Linear(c, c),
                                  nn.LayerNorm(c)])
        self.norm1 = nn.ModuleList([nn.LayerNorm(c)])
        self.attn = Attention(c, heads, qkv_bias)
        self.norm2 = nn.ModuleList([nn.LayerNorm(c)])
        self.mlp = nn.ModuleList([MLP(c, int(c * mlp_ratio))])

    def _drop(self, x, key, seed, stream):
        if seed is None or self.rate <= 0.0:
            return x
        keep = drop_uniform(key, seed, stream) >= self.rate
        return torch.where(keep[:, None], x / (1.0 - self.rate),
                           torch.zeros_like(x))

    def forward(self, x, lv: sp.Level, lay: Layout, seed):
        conv, lin, ln = self.cpe
        h = sp.subm_conv(x, lv, conv.weight, self.r(x)) + conv.bias
        x = x + ln(lin(h))
        h = self.attn(self.norm1[0](x), lay)
        x = x + self._drop(h, lv.key, seed, 2 * self.index)
        mlp = self.mlp[0]
        h = mlp.fc2(F.gelu(mlp.fc1(self.norm2[0](x))))
        return x + self._drop(h, lv.key, seed, 2 * self.index + 1)


class Pooling(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = Linear(cin, cout)
        self.norm = nn.ModuleList([BatchNorm(cout, act=False)])

    def forward(self, x, coarse: sp.Level, nd: int):
        h = self.proj(x)
        nbr = coarse.down_nbr
        g = h[nbr.clamp(min=0)]
        g = torch.where((nbr >= 0)[..., None], g,
                        torch.full_like(g, float("-inf")))
        return F.gelu(self.norm[0](g.amax(dim=1), coarse, nd))


class Unpooling(nn.Module):
    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.proj = nn.ModuleList([Linear(cin, cout), BatchNorm(cout)])
        self.proj_skip = nn.ModuleList([Linear(skip, cout), BatchNorm(cout)])

    def forward(self, x, skip, coarse: sp.Level, fine: sp.Level, nd: int):
        up = self.proj[1](self.proj[0](x), coarse, nd)
        return self.proj_skip[1](self.proj_skip[0](skip), fine, nd) \
            + up[coarse.f2c]


def _rates(depths, drop_path: float, reverse: bool) -> list:
    rates = torch.linspace(0, drop_path, sum(depths), device="cpu").tolist()
    out, at = [], 0
    for d in depths:
        part = rates[at:at + d]
        out.append(part[::-1] if reverse else part)
        at += d
    return out


class PTv3(_Round):
    def __init__(self, v: dict, compute_dtype: torch.dtype):
        super().__init__()
        self.v = v
        self.compute_dtype = compute_dtype
        levels = len(v["enc_depths"])
        self.num_levels = levels
        self.width = v["dec_channels"][0]
        enc, dec = v["enc_channels"], list(v["dec_channels"]) \
            + [v["enc_channels"][-1]]
        self.embedding = nn.Module()
        self.embedding.stem = nn.Module()
        self.embedding.stem.conv = SubMConv(STEM ** 3, v["in_channels"],
                                            enc[0], False)
        self.embedding.stem.norm = BatchNorm(enc[0])
        index = 0
        self.enc = nn.Module()
        for s, rates in enumerate(_rates(v["enc_depths"], v["drop_path"],
                                         False)):
            stage = nn.Module()
            if s > 0:
                stage.down = Pooling(enc[s - 1], enc[s])
            for i, rate in enumerate(rates):
                stage.add_module("block{}".format(i), Block(
                    enc[s], v["enc_num_head"][s], v["mlp_ratio"],
                    v["qkv_bias"], rate, index))
                index += 1
            self.enc.add_module("enc{}".format(s), stage)
        dec_rates = _rates(v["dec_depths"], v["drop_path"], True)
        self.dec = nn.Module()
        for s in reversed(range(levels - 1)):
            stage = nn.Module()
            stage.up = Unpooling(dec[s + 1], enc[s], dec[s])
            for i, rate in enumerate(dec_rates[s]):
                stage.add_module("block{}".format(i), Block(
                    dec[s], v["dec_num_head"][s], v["mlp_ratio"],
                    v["qkv_bias"], rate, index))
                index += 1
            self.dec.add_module("dec{}".format(s), stage)
        self.drops = v["drop_path"] > 0
        for mod in self.modules():
            if isinstance(mod, _Round):
                mod.dtype = compute_dtype

    def layouts(self, plan: sp.Plan) -> list:
        return layouts(plan, self.v["order"], self.v["enc_patch_size"])

    def draws(self, device, generator) -> tuple:
        """(per-level order permutations, drop seed or None)."""
        n = len(self.v["order"])
        if self.training:
            perm = torch.rand((self.num_levels, n), generator=generator,
                              device=device).argsort(dim=1).tolist()
        else:
            perm = [list(range(n))] * self.num_levels
        seed = None
        if self.training and self.drops:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=generator, device=device))
        return perm, seed

    def forward(self, feats, plan: sp.Plan, nd: int, generator=None):
        lv = plan.levels
        perm, seed = self.draws(feats.device, generator)
        lays = self.layouts(plan)
        x = sp.pool(feats.float(), plan.point_voxel, lv[0].key.shape[0])
        nbr = sp.neighbours(lv[0], STEM)
        w = self.embedding.stem.conv.weight
        r = self.r(x)
        x = r(sp._take(x, nbr).reshape(nbr.shape[0], -1)) \
            @ r(w.reshape(-1, w.shape[2]))
        x = self.embedding.stem.norm(x, lv[0], nd)
        skips = []
        for s in range(self.num_levels):
            stage = getattr(self.enc, "enc{}".format(s))
            if s > 0:
                x = stage.down(x, lv[s], nd)
            for i, blk in enumerate(_blocks(stage)):
                x = blk(x, lv[s], lays[s][perm[s][i % len(perm[s])]], seed)
            skips.append(x)
        for s in reversed(range(self.num_levels - 1)):
            stage = getattr(self.dec, "dec{}".format(s))
            x = stage.up(x, skips[s], lv[s + 1], lv[s], nd)
            for i, blk in enumerate(_blocks(stage)):
                x = blk(x, lv[s], lays[s][perm[s][i % len(perm[s])]], seed)
        return sp.unpool(x, plan.point_voxel)


def _blocks(stage) -> list:
    return [m for n, m in stage.named_children() if n.startswith("block")]


# -- the contract of nets3d/__init__.py ---------------------------------------

def build(sub: dict, compute_dtype: torch.dtype) -> PTv3:
    return PTv3(values(sub), compute_dtype)


def _stages(v: dict) -> list:
    """(level, channels, heads, blocks) of every stage, encoder first."""
    out = [(s, c, h, d) for s, (c, h, d) in enumerate(zip(
        v["enc_channels"], v["enc_num_head"], v["enc_depths"]))]
    out += [(s, v["dec_channels"][s], v["dec_num_head"][s],
             v["dec_depths"][s])
            for s in reversed(range(len(v["dec_depths"])))]
    return out


def convs(sub: dict, dtype: torch.dtype) -> list:
    """The blocks' CPE convs (3x3x3 with bias, K1 / K2), one a block."""
    return [Conv("subm", s, c, c, dtype)
            for s, c, _, blocks in _stages(values(sub))
            for _ in range(blocks)]


def peak_s(sub: dict, dtype, stats: list, n3d: int, n_valid: int,
           heads: int, classes: int) -> float:
    """At the compute dtype's peak: the stem's GEMM over its 125 offsets,
    each block's linear layers (CPE, qkv, proj, fc1, fc2) and attention
    products (each voxel's query against the K keys of its patch, q k^T and
    p v), the pooling and unpooling projections; the float32 seg heads over
    every point."""
    v = values(sub)
    vox = [s[0] for s in stats]
    enc = v["enc_channels"]
    dec = list(v["dec_channels"]) + [enc[-1]]
    ops = 2 * vox[0] * STEM ** 3 * v["in_channels"] * enc[0]
    for s, c, _, blocks in _stages(v):
        k = v["enc_patch_size"][s]
        per = 2 * c * c * (5 + 2 * v["mlp_ratio"]) + 4 * k * c
        ops += blocks * vox[s] * per
    for s in range(1, len(enc)):
        ops += 2 * vox[s - 1] * enc[s - 1] * enc[s]
    for s in range(len(v["dec_depths"])):
        ops += 2 * vox[s + 1] * dec[s + 1] * dec[s] \
            + 2 * vox[s] * enc[s] * dec[s]
    return ops / counts.PEAK_FLOPS[dtype] \
        + heads * counts.dense_peak_s(n3d, v["dec_channels"][0], classes)


def small(sub: dict) -> dict:
    """Narrow stages of head width 4, short patches (the coarsest longer
    than its scans, so that a scan of fewer voxels than K is one short
    patch), the depths cut: the CPU tests' sizes."""
    return dict(sub, enc_channels=[8, 8, 16, 16, 16],
                enc_num_head=[2, 2, 4, 4, 4], enc_depths=[2, 1, 1, 2, 1],
                enc_patch_size=[16, 16, 32, 64, 128],
                dec_channels=[8, 8, 16, 16], dec_num_head=[2, 2, 4, 4],
                dec_depths=[1, 1, 1, 1])


def attn_least_s(m: int, d: int) -> float:
    """Least time of one patch of ``m`` tokens and one head of width ``d``,
    forward and backward: 14 m^2 d products at the bfloat16 peak, 2 m^2
    exponentials, q, k, v, o and their gradients moved once in bfloat16."""
    return max(14 * m * m * d / PEAK_BF16, 2 * m * m / EXP_PER_S,
               8 * m * d * 2 / counts.HBM_BYTES_PER_S)


def work(sub: dict, dtype, plan: sp.Plan, stats: list) -> dict:
    """``ptv3_attn_least_s``: the attention's least time a step, summed over
    each block's real patches (ceil(n / K) of K tokens for a scan of n > K
    voxels at its level, one of n for n <= K) and heads;
    ``ptv3_attn_tokens``: the tokens of those patches, forward;
    ``ptv3_short_scans``: (scan, level) pairs of fewer than K voxels."""
    v = values(sub)
    least = tokens = 0.0
    short = 0
    counted = set()
    for s, c, h, blocks in _stages(v):
        k = int(v["enc_patch_size"][s])
        sample = sp.unpack(plan.levels[s].key)[0]
        for n in torch.bincount(sample).tolist():
            if n == 0:
                continue
            patches = [n] if n < k else [k] * -(-n // k)
            if n < k and s not in counted:
                short += 1
            least += blocks * h * sum(attn_least_s(m, c // h)
                                      for m in patches)
            tokens += blocks * sum(patches)
        counted.add(s)
    return {"ptv3_attn_least_s": least, "ptv3_attn_tokens": tokens,
            "ptv3_short_scans": float(short)}


def check_hooks(program_net, readings: dict) -> list:
    """Hooks on the program's 3D net that keep on the host, for the first
    step, each level's slot coordinates and validity and its layout slot
    of each slot in each order, and the first block of each encoder
    stage's input, output, order and drop seed (``readings["ptv3"]``)."""
    net = program_net.net_3d
    got = readings["ptv3"] = {"levels": [], "blocks": {}}

    def on_plan(mod, args):
        plan = args[1]
        for lv, sl in zip(plan.levels, plan.serial.levels):
            got["levels"].append({
                "coords": sl.coords.cpu(), "valid": lv.valid.cpu(),
                "inverse": sl.inverse.cpu(), "samples": sl.samples,
                "patch": sl.patch, "patches": sl.patches})

    def on_block(stage):
        def hook(mod, args, out):
            seed = args[3]
            got["blocks"].setdefault(stage, []).append({
                "x": args[0].detach().float().cpu(),
                "y": out.detach().float().cpu(),
                "order": int(args[2].order),
                "seed": None if seed is None else int(seed.reshape(-1)[0])})
        return hook

    hooks = [net.register_forward_pre_hook(on_plan)]
    for s in range(len(net.enc._modules)):
        blk = getattr(getattr(net.enc, "enc{}".format(s)), "block0")
        hooks.append(blk.register_forward_hook(on_block(s)))
    return hooks


def _program_slots(level: dict, ref_key: torch.Tensor):
    """The program's slot of each of the reference's voxels (by key), or
    None where the two sets of voxels differ."""
    valid = level["valid"]
    v = valid.shape[0]
    cap = v // level["samples"]
    sample = torch.arange(v) // cap
    key = sp.pack(sample, level["coords"])[valid]
    slot = torch.arange(v)[valid]
    ref_key = ref_key.cpu()
    if key.shape[0] != ref_key.shape[0]:
        return None
    pos = torch.searchsorted(ref_key, key).clamp(max=ref_key.shape[0] - 1)
    if not torch.equal(ref_key[pos], key) \
            or torch.unique(pos).numel() != pos.numel():
        return None
    out = torch.empty_like(slot)
    out[pos] = slot
    return out


def check_gaps(readings: dict, net3d, feats, plan: sp.Plan, nd: int,
               rounding) -> dict:
    """``serial_gap`` and ``block_gap`` of the program (module docstring),
    and with a ``rounding`` the control's: its serialization is the
    reference's own (0), its blocks computed with the control's rounding
    in the program's place. Both 1 / inf where the program's voxels are
    not the reference's."""
    got = readings.get("ptv3")
    if got is None:
        return {}
    who = ("program",) if rounding is None else ("program", "control")
    net = net3d.net_3d
    lays = net.layouts(plan)
    dev = plan.point_voxel.device
    miss = total = 0
    slots = []
    for l, level in enumerate(got["levels"]):
        sl = _program_slots(level, plan.levels[l].key)
        slots.append(sl)
        n_ref = plan.levels[l].key.shape[0]
        if sl is None:
            return {w: {"serial_gap": 1.0, "block_gap": math.inf}
                    for w in who}
        width = level["patches"] * level["patch"]
        cap = level["valid"].shape[0] // level["samples"]
        for o, lay in enumerate(lays[l]):
            pos = level["inverse"][o][sl]
            local = pos - (sl // cap) * width
            ref = lay.rank.cpu()
            k = level["patch"]
            miss += int(((local // k != ref // k)
                         | (local % k != ref % k)).sum())
            total += n_ref
    gaps = {"program": 0.0, "control": 0.0}
    for s, runs in sorted(got["blocks"].items()):
        if len(runs) != 1:
            return {w: {"serial_gap": miss / max(total, 1),
                        "block_gap": math.inf} for w in who}
        run = runs[0]
        sl = slots[s].to(dev)
        x, y = run["x"].to(dev)[sl], run["y"].to(dev)[sl]
        blk = getattr(getattr(net.enc, "enc{}".format(s)), "block0")
        lay = lays[s][run["order"]]
        with torch.no_grad():
            net3d.set_rounding({})
            want = blk(x, plan.levels[s], lay, run["seed"])
            scale = float(want.abs().max().clamp(min=1e-30))
            gaps["program"] = max(gaps["program"],
                                  float((y - want).abs().max()) / scale)
            if rounding is not None:
                net3d.set_rounding(rounding)
                ctl = blk(x, plan.levels[s], lay, run["seed"])
                gaps["control"] = max(gaps["control"],
                                      float((ctl - want).abs().max()) / scale)
                net3d.set_rounding({})
        del x, y, want
    out = {"program": {"serial_gap": miss / max(total, 1),
                       "block_gap": gaps["program"]}}
    if rounding is not None:
        out["control"] = {"serial_gap": 0.0, "block_gap": gaps["control"]}
    return out
