"""Point Transformer V3 (Wu et al., CVPR 2024; Pointcept's
``point_transformer_v3m1_base.py``) over the shared voxel plan: the 3D net
of ``MODEL_3D.TYPE = "PTv3"``.

The plan's levels are PTv3's grid levels (stride 2 each): level 0 holds the
voxels at the configured grid (SCN's ``scale``), level l + 1 the stride-2
parents of level l, exactly SCN's levels. :func:`~mopa_tpu_torch.models.
serialize.serialize` adds, in the plan stage, each level's curve orders and
static patch layout and the stem's 5x5x5 neighbour map (``plan.serial``).

- Input: each level-0 voxel's mean of its points' features, summed in
  float32 as SPVCNN's (Pointcept's ``GridSample`` keeps one point a cell
  instead).
- Stem (``embedding``): a 5x5x5 submanifold conv without bias (the exact
  neighbour map, one gather and one GEMM), batch norm, GELU.
- Block (pre-norm): x += LN(Linear(SubMConv3(x) + b)) (the CPE, its conv
  through K1 / K2); x += DropPath(Proj(Attn(LN(x)))); x += DropPath(
  fc2(GELU(fc1(LN(x))))), fc1 C -> ``mlp_ratio`` C, GELU exact, LN eps 1e-5.
- Attention: qkv = Linear(C, 3C) gathered in the block's order into the
  level's patch layout; per patch and head softmax(Q K^T / sqrt(d)) V,
  the softmax in float32 (:func:`patch_attention`); back to the slots,
  then Proj. Block i of a level uses order i % 4 of that level's list.
- Pooling (``down``): max over each parent's children of Linear(C_in,
  C_out)(x), batch norm, GELU. Unpooling (``up``): GELU(BN(Linear(skip)))
  + GELU(BN(Linear(x_coarse))) at each fine voxel's parent.
- Batch norm: eps 1e-3, PyTorch momentum 0.01 (running = 0.99 running +
  0.01 batch, the variance biased as the port's ``_BN`` takes it), per
  batch-norm domain in a fused forward.
- Output: level 0's features at each point's voxel, ``dec_channels[0]``
  wide, float32.

Training draws from the step's generator, in this order: the orders' shuffle
(one (levels, O) uniform draw, argsorted per level; eval keeps the listed
order), then one int64 seed in [0, 2**31) where any block drops. Block j
(encoder then decoder, in execution order) keeps a voxel's attention branch
where ``serialize.drop_uniform(key, seed, 2 j)`` >= its rate, its MLP branch
by stream 2 j + 1, and scales the kept rows by 1 / (1 - rate) (timm's
``DropPath`` over rows). Rates: ``linspace(0, drop_path, sum(enc_depths))``
over the encoder's blocks, ``linspace(0, drop_path, sum(dec_depths))``
split by stage and each stage's slice reversed, as Pointcept sets them.

Dtypes: every GEMM (the stem, CPE conv and linears, qkv, proj, MLP, pooling
and unpooling projections, the attention's products) takes compute-dtype
operands and accumulates in float32; layer and batch norms, the softmax's
statistics and the residual stream are float32.

Parameter names are Pointcept's module names (``embedding.stem.conv``,
``enc.enc{s}.block{i}.cpe.0``, ``.attn.qkv``, ``.mlp.0.fc1``,
``enc.enc{s}.down.proj``, ``dec.dec{s}.up.proj_skip.0``, ...), with batch
norms as ``nn.BatchNorm1d`` names them and convs as (K, Cin, Cout).

Spans (record only): ``net3d/stem``, ``net3d/cpe``, ``net3d/attn``,
``net3d/mlp``, ``net3d/pool{l}`` and ``net3d/unpool{l}`` (by the level they
end at). The counter ``ptv3.attn`` (:data:`ATTN`) counts the attention's
calls and the layout slots they run, padding included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from mopa_tpu_torch.common import spans
from mopa_tpu_torch.common.spans import span
from mopa_tpu_torch.models import serialize as ser
from mopa_tpu_torch.models.resnet34_unet import init_weights
from mopa_tpu_torch.models.scn_unet import _conv_weight, apply_submanifold
from mopa_tpu_torch.models.spvcnn import point_to_voxel
from mopa_tpu_torch.ops import sparse_conv as sc
from mopa_tpu_torch.ops import voxel as voxel_ops

# the attention's calls and layout slots (queries, padding included) run
ATTN = {"launches": 0, "tokens": 0}
spans.counter("ptv3.attn", ATTN)
# every kernel of the attention, forward and backward, carries this in its
# name (PyTorch's flash SDPA kernels; a kernel written for it keeps it)
KERNEL_FRAGMENT = "flash"


class Layout(NamedTuple):
    """What a block reads of its level's serialization: one order's
    layout (``serialize.SerialLevel``), the order's index in the list, and
    the level's voxel keys (the drop-path masks')."""
    idx: torch.Tensor
    bias: torch.Tensor
    inverse: torch.Tensor
    order: torch.Tensor      # 0-dim int64, on the device
    key: torch.Tensor
    patch: int


def _sdpa(q, k, v, scale):
    """PyTorch's SDPA; on the card its flash kernels (bfloat16 and float16;
    the memory-efficient ones for float32) or an error, never the math
    fallback, which holds every patch's K x K scores."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        flash = q.dtype in (torch.bfloat16, torch.float16)
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION if flash
                          else SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, scale=scale)
    return F.scaled_dot_product_attention(q, k, v, scale=scale)


def patch_attention(qkv: torch.Tensor, layout: Layout,
                    heads: int) -> torch.Tensor:
    """(V, C) attention output of (V, 3C) ``qkv`` (q, k, v, each head-major)
    over ``layout``'s patches: each layout slot's q, k, v gathered, per
    patch and head softmax(q k^T / sqrt(d)) v, each level row's output
    read back at its own layout slot.

    A slot's key bias (0, or ``serialize.MASK_BIAS`` outside its sample's
    patches) rides in an extra head column, against a query column of
    ones; the head width is padded to a multiple of 8 with zeros, which
    add nothing to the scores. The flash kernels then need no mask."""
    v_rows, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    k = int(layout.patch)
    t = layout.idx.shape[0]
    n = t // k
    g = qkv.index_select(0, layout.idx).view(n, k, 3, heads, d)
    q, kk, vv = (g[:, :, i].transpose(1, 2) for i in range(3))
    width = -(-(d + 1) // 8) * 8
    pad = q.new_zeros((n, heads, k, width - d - 1))
    q = torch.cat([q, q.new_ones((n, heads, k, 1)), pad], dim=-1)
    bias = layout.bias.to(kk.dtype).view(n, 1, k, 1).expand(n, heads, k, 1)
    kk = torch.cat([kk, bias, pad], dim=-1)
    vv = torch.cat([vv, pad, pad[..., :1]], dim=-1)
    o = _sdpa(q, kk, vv, d ** -0.5)[..., :d]
    ATTN["launches"] += 1
    ATTN["tokens"] += t
    o = o.transpose(1, 2).reshape(t, c)
    return o.index_select(0, layout.inverse)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``layer(x)`` with compute-dtype operands (float32 accumulation)."""
    b = layer.bias
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    None if b is None else b.to(dtype))


def _drop_path(x: torch.Tensor, rate: float, seed, key: torch.Tensor,
               stream: int) -> torch.Tensor:
    if seed is None or rate <= 0.0:
        return x
    keep = ser.drop_uniform(key, seed, stream) >= rate
    return torch.where(keep[:, None], x / (1.0 - rate), torch.zeros_like(x))


class BatchNorm(nn.Module):
    """Masked batch norm over a level's valid rows, per batch-norm domain in
    training, with ``nn.BatchNorm1d``'s names; GELU after it with
    ``act``."""

    def __init__(self, c: int, act: bool = True):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, lv, nd: int):
        y = sc.batch_norm_act(x, self.weight, self.bias, self.running_mean,
                              self.running_var, training=self.training,
                              valid=lv.valid, dom=lv.dom, n_domains=nd,
                              momentum=0.99, eps=1e-3, act=False)
        return F.gelu(y) if self.act else y


class SubMConv(nn.Module):
    """A submanifold conv's weight (K, Cin, Cout) and optional bias."""

    def __init__(self, k: int, cin: int, cout: int, bias: bool, generator):
        super().__init__()
        self.weight = _conv_weight((k, cin, cout), generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class MLP(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(c, hidden)
        self.fc2 = nn.Linear(hidden, c)


class Attention(nn.Module):
    def __init__(self, c: int, heads: int, qkv_bias: bool):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c, bias=qkv_bias)
        self.proj = nn.Linear(c, c)


class Block(nn.Module):
    """One pre-norm PTv3 block; ``index`` numbers it among the net's blocks
    in execution order (its drop-path streams)."""

    def __init__(self, c: int, heads: int, mlp_ratio: float, qkv_bias: bool,
                 drop_path: float, index: int, dtype, generator):
        super().__init__()
        self.rate = float(drop_path)
        self.index = index
        self.dtype = dtype
        self.cpe = nn.ModuleList([SubMConv(27, c, c, True, generator),
                                  nn.Linear(c, c), nn.LayerNorm(c)])
        self.norm1 = nn.ModuleList([nn.LayerNorm(c)])
        self.attn = Attention(c, heads, qkv_bias)
        self.norm2 = nn.ModuleList([nn.LayerNorm(c)])
        self.mlp = nn.ModuleList([MLP(c, int(c * mlp_ratio))])

    def forward(self, x: torch.Tensor, lv, layout: Layout, seed):
        dt = self.dtype
        conv, lin, ln = self.cpe
        with span("net3d/cpe", trace=False):
            h = apply_submanifold(x.to(dt), lv, conv.weight)
            h = _linear(lin, h.float() + conv.bias, dt)
            x = x + ln(h.float())
        with span("net3d/attn", trace=False):
            qkv = _linear(self.attn.qkv, self.norm1[0](x), dt)
            h = _linear(self.attn.proj,
                        patch_attention(qkv, layout, self.attn.heads), dt)
            x = x + _drop_path(h.float(), self.rate, seed, layout.key,
                               2 * self.index)
        with span("net3d/mlp", trace=False):
            mlp = self.mlp[0]
            h = F.gelu(_linear(mlp.fc1, self.norm2[0](x), dt))
            h = _linear(mlp.fc2, h, dt)
            return x + _drop_path(h.float(), self.rate, seed, layout.key,
                                  2 * self.index + 1)


class Pooling(nn.Module):
    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(cin, cout)
        self.norm = nn.ModuleList([BatchNorm(cout, act=False)])

    def forward(self, x, coarse, nd: int):
        h = _linear(self.proj, x, self.dtype)
        nbr = coarse.down_nbr
        g = h[voxel_ops.spread_misses(nbr.reshape(-1), h.shape[0])].view(
            nbr.shape[0], nbr.shape[1], -1)
        g = torch.where((nbr >= 0)[..., None], g,
                        torch.full_like(g, float("-inf")))
        y = g.amax(dim=1)
        y = torch.where(coarse.valid[:, None], y, torch.zeros_like(y))
        return F.gelu(self.norm[0](y, coarse, nd)).float()


class Unpooling(nn.Module):
    def __init__(self, cin: int, skip: int, cout: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.ModuleList([nn.Linear(cin, cout), BatchNorm(cout)])
        self.proj_skip = nn.ModuleList([nn.Linear(skip, cout),
                                        BatchNorm(cout)])

    def forward(self, x, skip, coarse, fine, nd: int):
        up = self.proj[1](_linear(self.proj[0], x, self.dtype), coarse, nd)
        sk = self.proj_skip[1](_linear(self.proj_skip[0], skip, self.dtype),
                               fine, nd)
        return sk.float() + sc._masked_take(up.float(), coarse.f2c)


def drop_rates(depths, drop_path: float, reverse: bool) -> list:
    """Each stage's drop-path rates: ``linspace(0, drop_path, sum)`` split
    by stage, each stage's slice reversed for the decoder."""
    rates = torch.linspace(0, drop_path, sum(depths), device="cpu").tolist()
    out, at = [], 0
    for d in depths:
        part = rates[at:at + d]
        out.append(part[::-1] if reverse else part)
        at += d
    return out


class PointTransformerV3(nn.Module):
    """(N, in_channels) point features over a plan with ``serial`` ->
    (N, dec_channels[0]) float32 point features. Keyword arguments are
    Pointcept's (``MODEL_3D.PTv3``) less what the plan fixes: stride 2 at
    every stage (the plan's levels are SCN's), one patch size a level for
    the encoder and the decoder (``enc_patch_size``, which the plan's
    serialization reads); pre-norm, no RPE, the orders shuffled in
    training."""

    def __init__(self, in_channels: int = 4, order=ser.ORDERS,
                 enc_depths=(2, 2, 2, 6, 2),
                 enc_channels=(32, 64, 128, 256, 512),
                 enc_num_head=(2, 4, 8, 16, 32),
                 enc_patch_size=(1024,) * 5,
                 dec_depths=(2, 2, 2, 2), dec_channels=(64, 64, 128, 256),
                 dec_num_head=(4, 4, 8, 16), mlp_ratio: float = 4,
                 qkv_bias: bool = True, drop_path: float = 0.3,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        levels = len(enc_depths)
        if len(dec_depths) != levels - 1:
            raise ValueError("{} decoder stages for {} encoder stages".format(
                len(dec_depths), levels))
        self.orders = tuple(order)
        self.num_levels = levels
        self.compute_dtype = compute_dtype
        self.out_channels = dec_channels[0]
        dt = compute_dtype
        self.embedding = nn.Module()
        self.embedding.stem = nn.Module()
        self.embedding.stem.conv = SubMConv(ser.STEM ** 3, in_channels,
                                            enc_channels[0], False, generator)
        self.embedding.stem.norm = BatchNorm(enc_channels[0])
        index = 0
        self.enc = nn.Module()
        for s, rates in enumerate(drop_rates(enc_depths, drop_path, False)):
            stage = nn.Module()
            if s > 0:
                stage.down = Pooling(enc_channels[s - 1], enc_channels[s], dt)
            for i, rate in enumerate(rates):
                stage.add_module("block{}".format(i), Block(
                    enc_channels[s], enc_num_head[s], mlp_ratio, qkv_bias,
                    rate, index, dt, generator))
                index += 1
            self.enc.add_module("enc{}".format(s), stage)
        dec_rates = drop_rates(dec_depths, drop_path, True)
        wide = list(dec_channels) + [enc_channels[-1]]
        self.dec = nn.Module()
        for s in reversed(range(levels - 1)):
            stage = nn.Module()
            stage.up = Unpooling(wide[s + 1], enc_channels[s], wide[s], dt)
            for i, rate in enumerate(dec_rates[s]):
                stage.add_module("block{}".format(i), Block(
                    wide[s], dec_num_head[s], mlp_ratio, qkv_bias, rate,
                    index, dt, generator))
                index += 1
            self.dec.add_module("dec{}".format(s), stage)
        self.drops = drop_path > 0
        init_weights(self, generator)

    def _blocks(self, stage):
        return [m for n, m in stage.named_children() if n.startswith("block")]

    def forward(self, point_feats: torch.Tensor, plan, n_domains: int = 1,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if getattr(plan, "serial", None) is None:
            raise ValueError("PTv3 needs the plan's serialization "
                             "(models.serialize.serialize in the plan stage)")
        if len(plan.levels) != self.num_levels:
            raise ValueError("PTv3 needs a {}-level plan, got {}".format(
                self.num_levels, len(plan.levels)))
        lv, sl, nd = plan.levels, plan.serial.levels, n_domains
        dev = point_feats.device
        nord = len(self.orders)
        if self.training:
            perm = torch.rand((self.num_levels, nord), generator=generator,
                              device=dev).argsort(dim=1)
        else:
            perm = torch.arange(nord, device=dev).expand(self.num_levels,
                                                         nord)
        seed = None
        if self.training and self.drops:
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=dev)

        def layouts(l):
            s, p = sl[l], perm[l]
            idx, bias, inv = (t.index_select(0, p)
                              for t in (s.idx, s.bias, s.inverse))
            return [Layout(idx[i], bias[i], inv[i], p[i], s.key, s.patch)
                    for i in range(nord)]

        with span("net3d/stem", trace=False):
            x = point_to_voxel(point_feats.float(), plan.point_inverse,
                               lv[0].valid.shape[0])
            nbr = plan.serial.stem_nbr
            stem = self.embedding.stem
            w = stem.conv.weight
            g = sc._masked_take(x.to(self.compute_dtype), nbr.reshape(-1))
            x = g.view(nbr.shape[0], -1) @ w.reshape(-1, w.shape[2]).to(
                self.compute_dtype)
            x = stem.norm(x, lv[0], nd).float()
        skips = []
        lays = [layouts(l) for l in range(self.num_levels)]
        for s in range(self.num_levels):
            stage = getattr(self.enc, "enc{}".format(s))
            if s > 0:
                with span("net3d/pool{}".format(s), trace=False):
                    x = stage.down(x, lv[s], nd)
            for i, blk in enumerate(self._blocks(stage)):
                x = blk(x, lv[s], lays[s][i % nord], seed)
            skips.append(x)
        for s in reversed(range(self.num_levels - 1)):
            stage = getattr(self.dec, "dec{}".format(s))
            with span("net3d/unpool{}".format(s), trace=False):
                x = stage.up(x, skips[s], lv[s + 1], lv[s], nd)
            for i, blk in enumerate(self._blocks(stage)):
                x = blk(x, lv[s], lays[s][i % nord], seed)
        return voxel_ops.unpool_features(x, plan.point_inverse).float()
