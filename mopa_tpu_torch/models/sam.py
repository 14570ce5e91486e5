"""Segment-Anything in PyTorch (port of ``mopa_tpu/models/sam.py``): the
ViTDet image encoder with windowed attention, the point prompt encoder, the
two-way-transformer mask decoder, the import of a segment-anything ``.pth``
state dict, and the automatic mask generator that rasterises a point grid's
masks into the fixed-budget id map ``losses.mask_cons_loss`` consumes.

The layout is NHWC, as in the JAX package; convolutions run NCHW. Module and
parameter names are the flax names, so ``models.weights`` maps a flax SAM's
variables one to one: ``block{i}``, ``layers.{i}`` (``nn.ModuleList``),
``mlp.lin1`` in a decoder block, ``hyper_mlps.{i}.layers.{j}``. Layer norms
keep flax's ``scale`` / ``bias`` names and its eps of 1e-6 everywhere, the
decoder's norms included (segment-anything's decoder uses torch's 1e-5;
the JAX package, which this port follows, does not). Raw parameters keep
their flax shapes: ``pos_embed`` (1, S, S, dim) channels-last, ``rel_pos_h``
/ ``rel_pos_w`` (2 * window - 1, head_dim), ``iou_token`` (1, dim),
``mask_tokens`` (4, dim) and the prompt encoder's ``pe_gaussian`` (2,
dim / 2) and embedding vectors (dim,).

flax sizes a global block's relative positions from the first image it
sees (``2 * max(h, w) - 1`` rows, ``h, w`` the patch grid); a torch module
needs them at construction, so :class:`ImageEncoderViT` and :class:`SAM`
take that grid side (``grid``, by default ``ceil(img_size / 16)``). Like
flax, a global block refuses a grid of another side.

No TPU kernel lies on this path: the JAX module computes its attention,
GEMMs and norms with ``jnp`` and flax layers, and this port with plain
PyTorch ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mopa_tpu_torch.common.spans import span

VARIANTS = {
    "vit_b": dict(depth=12, dim=768, heads=12, global_idx=(2, 5, 8, 11)),
    "vit_l": dict(depth=24, dim=1024, heads=16, global_idx=(5, 11, 17, 23)),
    "vit_h": dict(depth=32, dim=1280, heads=16, global_idx=(7, 15, 23, 31)),
}

PATCH = 16
# Prompts decoded at once by generate_mask_id_map (segment-anything's
# points_per_batch); each prompt's decode is independent of the others.
DECODE_CHUNK = 64
# spans (profiler ranges) of generate_mask_id_map.
STAGES = ("sam/encode", "sam/decode", "sam/rasterize")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6, parameters
    ``scale`` and ``bias``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias,
                            self.eps)


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW op to an NHWC tensor."""
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MLPBlock(nn.Module):
    """``lin2(act(lin1(x)))``: exact GELU (the ViT blocks) or ReLU (the
    decoder blocks' ``mlp``)."""

    def __init__(self, dim: int, hidden: int, relu: bool = False):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.lin1(x)
        h = F.relu(h) if self.relu else F.gelu(h)
        return self.lin2(h)


class WindowAttention(nn.Module):
    """ViTDet attention over ``window`` x ``window`` windows (0: one global
    window of the grid's larger side) with decomposed relative positions.
    ``grid`` sizes a global block's ``rel_pos_h`` / ``rel_pos_w``."""

    def __init__(self, dim: int, heads: int, window: int, grid: int = 0):
        super().__init__()
        self.dim, self.heads, self.window = dim, heads, window
        size = window or grid
        if size <= 0:
            raise ValueError("a global block needs its grid side")
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        win = self.window or max(h, w)
        if self.rel_pos_h.shape[0] != 2 * win - 1:
            raise ValueError(
                "global attention over a {}x{} grid needs {} relative "
                "positions; this block has {}".format(
                    h, w, 2 * win - 1, self.rel_pos_h.shape[0]))
        pad_h, pad_w = (-h) % win, (-w) % win
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hh, ww = x.shape[1], x.shape[2]
        nh, nw = hh // win, ww // win
        xw = x.reshape(b, nh, win, nw, win, c).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(b * nh * nw, win * win, c)

        q, k, v = self.qkv(xw).split(self.dim, dim=-1)
        hd = self.dim // self.heads

        def heads_split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, hd
                             ).permute(0, 2, 1, 3)

        q, k, v = map(heads_split, (q, k, v))
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(hd)

        # decomposed relative positions, from the unscaled q
        coords = torch.arange(win, device=x.device)
        rel = coords[:, None] - coords[None, :] + win - 1
        rh, rw = self.rel_pos_h[rel], self.rel_pos_w[rel]  # (win, win, hd)
        qg = q.reshape(-1, self.heads, win, win, hd)
        bias_h = torch.einsum("bhxyd,xud->bhxyu", qg, rh)
        bias_w = torch.einsum("bhxyd,yvd->bhxyv", qg, rw)
        attn = attn + (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
            -1, self.heads, win * win, win * win)

        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(xw.shape[0], win * win,
                                                     self.dim)
        out = self.proj(out)
        out = out.reshape(b, nh, nw, win, win, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, hh, ww, c)
        return out[:, :h, :w] if pad_h or pad_w else out


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, grid: int = 0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window, grid)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad NHWC ``x`` as XLA's ``"SAME"`` does for a strided conv: to
    ``ceil(side / stride)`` outputs, half the padding low and the odd one
    high."""
    pads = []
    for side in (x.shape[2], x.shape[1]):
        total = max((-(-side // stride) - 1) * stride + kernel - side, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0) + tuple(pads)) if any(pads) else x


class ImageEncoderViT(nn.Module):
    """Patch embedding (16 x 16, ``"SAME"``), ``pos_embed`` (resized with
    antialiasing when the grid differs), the ViT blocks and the neck (1 x 1
    conv, norm, 3 x 3 conv, norm) to ``out_chans``. NHWC in and out."""

    def __init__(self, variant: str = "vit_b", img_size: int = 1024,
                 patch: int = PATCH, out_chans: int = 256, window: int = 14,
                 grid: int | None = None):
        super().__init__()
        cfgv = VARIANTS[variant]
        dim, depth, heads = cfgv["dim"], cfgv["depth"], cfgv["heads"]
        self.patch = patch
        grid = grid or -(-img_size // patch)
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, img_size // patch, img_size // patch, dim))
        self.depth = depth
        for i in range(depth):
            window_i = 0 if i in cfgv["global_idx"] else window
            setattr(self, "block{}".format(i),
                    ViTBlock(dim, heads, window_i, grid))
        self.neck0 = nn.Conv2d(dim, out_chans, 1, bias=False)
        self.neck_ln0 = LayerNorm(out_chans)
        self.neck1 = nn.Conv2d(out_chans, out_chans, 3, padding=1,
                               bias=False)
        self.neck_ln1 = LayerNorm(out_chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(self.patch_embed, same_pad(x, self.patch, self.patch))
        pos = self.pos_embed
        if pos.shape[1:3] != x.shape[1:3]:
            pos = _nchw(lambda t: F.interpolate(
                t, size=tuple(x.shape[1:3]), mode="bilinear",
                align_corners=False, antialias=True), pos)
        x = x + pos
        for i in range(self.depth):
            x = getattr(self, "block{}".format(i))(x)
        x = self.neck_ln0(_nchw(self.neck0, x))
        return self.neck_ln1(_nchw(self.neck1, x))  # (B, H/16, W/16, 256)


class PromptEncoder(nn.Module):
    """Point prompts -> sparse embeddings with a random-Fourier positional
    encoding (segment-anything's point path): pixel coordinates shift by
    +0.5, labels -1 (padding: no positional encoding), 0 (negative), 1
    (positive)."""

    def __init__(self, embed_dim: int = 256):
        super().__init__()
        self.pe_gaussian = nn.Parameter(torch.zeros(2, embed_dim // 2))
        self.fg_embed = nn.Parameter(torch.zeros(embed_dim))
        self.bg_embed = nn.Parameter(torch.zeros(embed_dim))
        self.not_a_point_embed = nn.Parameter(torch.zeros(embed_dim))
        self.no_mask_embed = nn.Parameter(torch.zeros(embed_dim))

    def forward(self, points: torch.Tensor, labels: torch.Tensor,
                image_size) -> tuple:
        """points (B, N, 2) in pixels (x, y); labels (B, N). Returns
        (sparse_embeddings, pe_gaussian, no_mask_embed)."""
        size = torch.tensor(image_size, dtype=torch.float32,
                            device=points.device)
        coords = 2 * ((points + 0.5) / size) - 1
        proj = coords @ self.pe_gaussian * (2 * np.pi)
        pe = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        lab = labels[..., None]
        pe = torch.where(lab == -1, torch.zeros_like(pe), pe)
        type_emb = torch.where(lab == -1, self.not_a_point_embed,
                               torch.where(lab > 0, self.fg_embed,
                                           self.bg_embed))
        return pe + type_emb, self.pe_gaussian, self.no_mask_embed


def dense_positional_encoding(pe_gaussian: torch.Tensor, grid_hw
                              ) -> torch.Tensor:
    """The positional encoding of the (h, w) feature grid, (h, w, dim)."""
    h, w = grid_hw
    dev = pe_gaussian.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1)
    coords = 2 * grid.flip(-1) - 1
    proj = coords @ pe_gaussian * (2 * np.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class DecoderAttention(nn.Module):
    """segment-anything ``transformer.Attention``: q/k/v projections to
    dim / downsample_rate, multi-head attention, out projection back."""

    def __init__(self, dim: int = 256, heads: int = 8,
                 downsample_rate: int = 1):
        super().__init__()
        d = dim // downsample_rate
        self.heads = heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
        qh, kh, vh = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        d = qh.shape[-1]
        hd = d // self.heads

        def sp(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, hd
                             ).permute(0, 2, 1, 3)

        a = (sp(qh) @ sp(kh).transpose(-1, -2)) / math.sqrt(hd)
        a = torch.softmax(a, dim=-1)
        o = (a @ sp(vh)).permute(0, 2, 1, 3).reshape(q.shape[0], q.shape[1],
                                                     d)
        return self.out_proj(o)


class TwoWayBlock(nn.Module):
    """segment-anything ``TwoWayAttentionBlock``: token self-attention
    (the first layer without positional encoding and residual),
    token-to-image cross-attention, ReLU MLP, image-to-token
    cross-attention, each followed by a norm."""

    def __init__(self, dim: int = 256, heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(dim, heads)
        self.norm1 = LayerNorm(dim)
        self.cross_attn_token_to_image = DecoderAttention(dim, heads, 2)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, relu=True)
        self.norm3 = LayerNorm(dim)
        self.cross_attn_image_to_token = DecoderAttention(dim, heads, 2)
        self.norm4 = LayerNorm(dim)

    def forward(self, queries, keys, qpe, kpe) -> tuple:
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + qpe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + qpe, keys + kpe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q, k = queries + qpe, keys + kpe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class HyperMLP(nn.Module):
    """``depth`` linear layers with ReLU between them: the mask
    hypernetworks and the IoU head."""

    def __init__(self, in_dim: int, hidden: int, out: int, depth: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden] * (depth - 1) + [out]
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class MaskDecoder(nn.Module):
    """segment-anything ``MaskDecoder``: two two-way blocks and a final
    token-to-image attention, the 4x upscaler (transposed conv, norm,
    GELU, transposed conv, GELU), per-mask-token hypernetworks and the IoU
    head."""

    def __init__(self, dim: int = 256, num_mask_tokens: int = 4,
                 iou_head_hidden: int = 256, mlp_dim: int = 2048):
        super().__init__()
        self.num_mask_tokens = num_mask_tokens
        self.iou_token = nn.Parameter(torch.zeros(1, dim))
        self.mask_tokens = nn.Parameter(torch.zeros(num_mask_tokens, dim))
        self.layers = nn.ModuleList(
            [TwoWayBlock(dim, mlp_dim=mlp_dim, skip_first_layer_pe=(i == 0))
             for i in range(2)])
        self.final_attn_token_to_image = DecoderAttention(dim,
                                                          downsample_rate=2)
        self.norm_final_attn = LayerNorm(dim)
        self.up1 = nn.ConvTranspose2d(dim, dim // 4, 2, stride=2)
        self.up_ln = LayerNorm(dim // 4)
        self.up2 = nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2)
        self.hyper_mlps = nn.ModuleList(
            [HyperMLP(dim, dim, dim // 8) for _ in range(num_mask_tokens)])
        self.iou_head = HyperMLP(dim, iou_head_hidden, num_mask_tokens)

    def forward(self, img_embed, img_pe, sparse_prompt, dense_prompt=None
                ) -> tuple:
        """img_embed (B, h, w, dim), img_pe (1, h, w, dim), sparse_prompt
        (B, N, dim), dense_prompt broadcast onto img_embed. Returns masks
        (B, 4, 4h, 4w) and IoU predictions (B, 4)."""
        b, h, w, dim = img_embed.shape
        tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([tokens[None].expand(b, -1, -1), sparse_prompt],
                           dim=1)
        src = img_embed if dense_prompt is None else img_embed + dense_prompt
        keys = src.reshape(b, h * w, dim)
        kpe = img_pe.reshape(1, h * w, dim).expand(b, -1, -1)

        q, k = tokens, keys
        for layer in self.layers:
            q, k = layer(q, k, tokens, kpe)
        q = q + self.final_attn_token_to_image(q + tokens, k + kpe, k)
        q = self.norm_final_attn(q)

        up = _nchw(self.up1, k.reshape(b, h, w, dim))
        up = F.gelu(self.up_ln(up))
        up = F.gelu(_nchw(self.up2, up))
        hyper = torch.stack([mlp(q[:, 1 + i])
                             for i, mlp in enumerate(self.hyper_mlps)], dim=1)
        masks = torch.einsum("bmd,bhwd->bmhw", hyper, up)
        return masks, self.iou_head(q[:, 0])


# Raw parameters' random starts: std 0.02 for those flax starts at zero,
# standard normal for the rest.
_SMALL = ("pos_embed", "rel_pos_h", "rel_pos_w")
_UNIT = ("pe_gaussian", "fg_embed", "bg_embed", "not_a_point_embed",
         "no_mask_embed", "iou_token", "mask_tokens")


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for every parameter of ``module``: linear and
    conv weights normal with variance 1 / fan_in, their biases zero, norms
    one and zero, raw parameters as :data:`_SMALL` and :data:`_UNIT` say.
    A parameter of no known kind raises."""
    dev = generator.device
    owners = dict(module.named_modules())
    for name, p in module.named_parameters():
        owner_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        owner = owners[owner_name]
        with torch.no_grad():
            if isinstance(owner, LayerNorm):
                p.fill_(1.0 if leaf == "scale" else 0.0)
            elif isinstance(owner, (nn.Conv2d, nn.ConvTranspose2d,
                                    nn.Linear)):
                if leaf == "bias":
                    p.zero_()
                    continue
                fan_in = (p.shape[0] * p.shape[2] * p.shape[3]
                          if isinstance(owner, nn.ConvTranspose2d)
                          else p[0].numel())
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=dev) * fan_in ** -0.5)
            elif leaf in _SMALL or leaf in _UNIT:
                std = 0.02 if leaf in _SMALL else 1.0
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=dev) * std)
            else:
                raise KeyError("no random start for {}".format(name))


class SAM(nn.Module):
    """The image encoder, prompt encoder and mask decoder, built on
    ``device`` (``cuda`` unless the caller passes another) with seeded
    random weights from a ``torch.Generator`` on that device."""

    def __init__(self, variant: str = "vit_b", img_size: int = 1024,
                 device=None, seed: int = 0, grid: int | None = None):
        super().__init__()
        self.img_size = img_size
        dev = torch.device(device if device is not None else "cuda")
        with torch.device("meta"):
            self.image_encoder = ImageEncoderViT(variant, img_size,
                                                 grid=grid)
            self.prompt_encoder = PromptEncoder()
            self.mask_decoder = MaskDecoder()
        self.to_empty(device=dev)
        init_weights(self, torch.Generator(device=dev).manual_seed(seed))

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) -> embeddings (B, H/16, W/16, 256)."""
        return self.image_encoder(image)

    def decode(self, img_embed: torch.Tensor, points: torch.Tensor,
               labels: torch.Tensor) -> tuple:
        """Point prompts (B, N, 2) with labels (B, N) on ``img_embed`` (B,
        h, w, 256) -> masks (B, 4, 4h, 4w) and IoU scores (B, 4). A padding
        point (label -1) is appended, as segment-anything does without a
        box prompt; coordinates are pixels of an ``img_size`` square."""
        h, w = img_embed.shape[1:3]
        b = points.shape[0]
        points = torch.cat([points, points.new_zeros(b, 1, 2)], dim=1)
        labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        sparse, pe_gaussian, no_mask = self.prompt_encoder(
            points, labels, (self.img_size, self.img_size))
        pe = dense_positional_encoding(pe_gaussian, (h, w))
        return self.mask_decoder(img_embed, pe[None], sparse, no_mask)

    def forward(self, image, points, labels) -> tuple:
        return self.decode(self.encode(image), points, labels)


def import_sam_checkpoint(state_dict: dict, variant: str = "vit_h",
                          parts=("image_encoder", "prompt_encoder",
                                 "mask_decoder")) -> dict:
    """A segment-anything ``.pth`` state dict -> {port name: float32 CPU
    tensor} for :class:`SAM`'s ``load_state_dict``: the image encoder, the
    prompt encoder's point path and the whole mask decoder, the names of
    ``mopa_tpu.models.sam.import_sam_checkpoint`` in the port's layouts.
    segment-anything's layouts are torch's, so no kernel is transposed or
    flipped; norms' ``weight`` becomes ``scale``. The box-corner point
    embeddings and the mask-prompt downscaler are not read. A name missing
    from ``state_dict`` raises ``KeyError``."""
    sd = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
          for k, v in state_dict.items()}
    out = {}

    def layer(src, dst, bias=True):
        out[dst + ".weight"] = sd[src + ".weight"]
        if bias and src + ".bias" in sd:
            out[dst + ".bias"] = sd[src + ".bias"]

    def ln(src, dst):
        out[dst + ".scale"] = sd[src + ".weight"]
        out[dst + ".bias"] = sd[src + ".bias"]

    if "image_encoder" in parts:
        enc = "image_encoder"
        layer(enc + ".patch_embed.proj", enc + ".patch_embed")
        out[enc + ".pos_embed"] = sd[enc + ".pos_embed"]
        for i in range(VARIANTS[variant]["depth"]):
            s = "{}.blocks.{}".format(enc, i)
            d = "{}.block{}".format(enc, i)
            ln(s + ".norm1", d + ".norm1")
            ln(s + ".norm2", d + ".norm2")
            for name in ("attn.qkv", "attn.proj", "mlp.lin1", "mlp.lin2"):
                layer(s + "." + name, d + "." + name)
            for name in ("attn.rel_pos_h", "attn.rel_pos_w"):
                out[d + "." + name] = sd[s + "." + name]
        layer(enc + ".neck.0", enc + ".neck0", bias=False)
        ln(enc + ".neck.1", enc + ".neck_ln0")
        layer(enc + ".neck.2", enc + ".neck1", bias=False)
        ln(enc + ".neck.3", enc + ".neck_ln1")

    if "prompt_encoder" in parts:
        pe = "prompt_encoder"
        out[pe + ".pe_gaussian"] = \
            sd[pe + ".pe_layer.positional_encoding_gaussian_matrix"]
        # point_embeddings: 0 = negative, 1 = positive (segment-anything)
        for src, dst in (("point_embeddings.0", "bg_embed"),
                         ("point_embeddings.1", "fg_embed"),
                         ("not_a_point_embed", "not_a_point_embed"),
                         ("no_mask_embed", "no_mask_embed")):
            out["{}.{}".format(pe, dst)] = sd[
                "{}.{}.weight".format(pe, src)][0]

    if "mask_decoder" in parts:
        md = "mask_decoder"
        out[md + ".iou_token"] = sd[md + ".iou_token.weight"]
        out[md + ".mask_tokens"] = sd[md + ".mask_tokens.weight"]

        def decoder_attn(src, dst):
            for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                layer("{}.{}".format(src, p), "{}.{}".format(dst, p))

        tr = md + ".transformer"
        for i in range(2):
            s = "{}.layers.{}".format(tr, i)
            d = "{}.layers.{}".format(md, i)
            for name in ("self_attn", "cross_attn_token_to_image",
                         "cross_attn_image_to_token"):
                decoder_attn(s + "." + name, d + "." + name)
            layer(s + ".mlp.lin1", d + ".mlp.lin1")
            layer(s + ".mlp.lin2", d + ".mlp.lin2")
            for n in ("norm1", "norm2", "norm3", "norm4"):
                ln("{}.{}".format(s, n), "{}.{}".format(d, n))
        decoder_attn(tr + ".final_attn_token_to_image",
                     md + ".final_attn_token_to_image")
        ln(tr + ".norm_final_attn", md + ".norm_final_attn")
        layer(md + ".output_upscaling.0", md + ".up1")
        ln(md + ".output_upscaling.1", md + ".up_ln")
        layer(md + ".output_upscaling.3", md + ".up2")
        for i in range(4):
            for j in range(3):
                layer("{}.output_hypernetworks_mlps.{}.layers.{}".format(
                    md, i, j), "{}.hyper_mlps.{}.layers.{}".format(md, i, j))
        for j in range(3):
            layer("{}.iou_prediction_head.layers.{}".format(md, j),
                   "{}.iou_head.layers.{}".format(md, j))
    return out


def point_grid(points_per_side: int, img_size: int, device=None
               ) -> torch.Tensor:
    """The (n * n, 2) prompt grid of pixel centres, x-major as the JAX
    package's ``meshgrid(xs, ys, indexing="ij")``."""
    n = points_per_side
    c = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n \
        * img_size
    return torch.stack(torch.meshgrid(c, c, indexing="ij"), -1).reshape(-1, 2)


@torch.no_grad()
def grid_masks(model: SAM, image, points_per_side: int, img_size: int
               ) -> tuple:
    """One foreground point per grid cell -> its best-of-4 mask (by IoU
    score) upscaled to ``img_size`` and thresholded at 0, and that score:
    bool (n * n, img_size, img_size) and float (n * n,). Prompts decode
    :data:`DECODE_CHUNK` at a time."""
    dev = next(model.parameters()).device
    image = torch.as_tensor(image, dtype=torch.float32, device=dev)
    grid = point_grid(points_per_side, img_size, dev)
    with span(STAGES[0]):
        emb = model.encode(image[None])
    masks, scores = [], []
    with span(STAGES[1]):
        for start in range(0, grid.shape[0], DECODE_CHUNK):
            pts = grid[start:start + DECODE_CHUNK]
            c = pts.shape[0]
            m, iou = model.decode(emb.expand(c, -1, -1, -1), pts[:, None],
                                  pts.new_ones(c, 1))
            best = torch.argmax(iou, dim=1)
            rows = torch.arange(c, device=dev)
            up = F.interpolate(m[rows, best][:, None], size=(img_size,
                                                             img_size),
                               mode="bilinear", align_corners=False)
            masks.append(up[:, 0] > 0)
            scores.append(iou[rows, best])
    return torch.cat(masks), torch.cat(scores)


@torch.no_grad()
def rasterize_id_map(masks: torch.Tensor, scores: torch.Tensor,
                     mask_budget: int, iou_thresh: float) -> torch.Tensor:
    """Masks scoring above ``iou_thresh``, largest first (a stable sort of
    the areas), the first ``min(mask_budget, len(masks))`` written in
    order, so a smaller mask overwrites a larger one: (H, W) int32 ids,
    -100 where none is written."""
    with span(STAGES[2]):
        ok = scores > iou_thresh
        areas = masks.sum(dim=(1, 2))
        key = torch.where(ok, areas, torch.full_like(areas, -1))
        order = torch.argsort(-key, stable=True)
        budget = min(mask_budget, masks.shape[0])
        sel = order[:budget]
        write = masks[sel] & ok[sel][:, None, None]
        ids = torch.arange(budget, dtype=torch.int32, device=masks.device)
        last = torch.where(write, ids[:, None, None],
                           torch.full_like(ids, -1)[:, None, None]).amax(0)
        return torch.where(last >= 0, last, torch.full_like(last, -100))


def generate_mask_id_map(model: SAM, image, *, points_per_side: int = 8,
                         mask_budget: int = 64, iou_thresh: float = 0.7,
                         img_size: int = 256) -> torch.Tensor:
    """Automatic mask generation -> the fixed-budget id map, where the model
    is: a ``points_per_side`` square grid of foreground prompts, one mask
    each, rasterised as :func:`rasterize_id_map` says. ``image`` (img_size,
    img_size, 3); returns (img_size, img_size) int32, -100 unassigned."""
    masks, scores = grid_masks(model, image, points_per_side, img_size)
    return rasterize_id_map(masks, scores, mask_budget, iou_thresh)
