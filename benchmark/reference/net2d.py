"""The 2D net of the reference: UNetResNet34 with its lifting and linear
heads, in plain PyTorch. A frozen copy of the arithmetic of the port's
``models/resnet34_unet.py`` and ``models/xmuda_arch.py::Net2DSeg``
(reference ``mopa/models/resnet34_unet.py:83-191``): ResNet34 encoder with
conv1 stride 1, decoder of ConvTranspose(k2, s2)+BN+ReLU stages with skip
concatenation and 3x3 fusions, 64 output channels; dropout p=0.4 after
layer3 and layer4 in training, its masks drawn from the caller's generator
in the program's order; batch norm in float32 with per-domain statistics.
Parameter names are the port's, so one dict of seeded tensors loads both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype (weights cast per call);
    ``round_operands`` rounds both operands (the control's precision)."""

    round_operands = staticmethod(lambda t: t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        r = self.round_operands
        return F.conv2d(r(x), r(self.weight.to(x.dtype)), bias, self.stride,
                        self.padding, self.dilation)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in the input's dtype."""

    round_operands = staticmethod(lambda t: t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        r = self.round_operands
        return F.conv_transpose2d(r(x), r(self.weight.to(x.dtype)), bias,
                                  self.stride, self.padding)


class DomainBatchNorm(nn.Module):
    """Batch norm over NCHW (eps 1e-5, momentum 0.9), computed in float32 and
    returned in the input dtype.

    Eval: running statistics. Training: the batch splits into ``n_domains``
    equal leading groups, each normalised with its own statistics (biased
    variance, unlike ``nn.BatchNorm2d``'s running update); the running
    buffers take the per-domain updates in domain order, in place."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, n_domains: int = 1) -> torch.Tensor:
        # no float32 copy of x outlives its first use: at full resolution
        # each one is a whole (B, C, H, W) map
        if not self.training:
            inv = torch.rsqrt(self.var + self.eps) * self.scale
            out = (x.float() - self.mean[:, None, None]) * inv[:, None, None] \
                + self.bias[:, None, None]
            return out.to(x.dtype)
        d = int(n_domains)
        g = x.float().reshape((d, x.shape[0] // d) + tuple(x.shape[1:]))
        mean = g.mean(dim=(1, 3, 4), keepdim=True)               # (D,1,C,1,1)
        var = (g - mean).square().mean(dim=(1, 3, 4), keepdim=True)
        with torch.no_grad():
            for i in range(d):
                self.mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean[i].reshape(-1))
                self.var.mul_(self.momentum).add_(
                    (1 - self.momentum) * var[i].reshape(-1))
        out = (g - mean) * (torch.rsqrt(var + self.eps)
                            * self.scale[:, None, None]) \
            + self.bias[:, None, None]
        return out.reshape(x.shape).to(x.dtype)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None
            ) -> torch.Tensor:
    """Dropout: keep with probability 1 - p and scale by
    1 / (1 - p), in the input dtype; the mask comes from ``generator``."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class BasicBlock(nn.Module):
    """torchvision BasicBlock: (3x3 conv, BN, ReLU) x2 + skip."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = DomainBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = DomainBatchNorm(planes)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, planes, 1, stride,
                                          bias=False)
            self.downsample_bn = DomainBatchNorm(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, nd: int) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), nd))
        y = self.bn2(self.conv2(y), nd)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x), nd)
        return torch.relu(y + residual)


class ResLayer(nn.Module):
    def __init__(self, inplanes: int, planes: int, blocks: int,
                 stride: int = 1):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            s = stride if i == 0 else 1
            down = i == 0 and (s != 1 or inplanes != planes)
            self.add_module(f"block{i}", BasicBlock(
                inplanes if i == 0 else planes, planes, s, down))

    def forward(self, x: torch.Tensor, nd: int) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x, nd)
        return x


class DecStage(nn.Module):
    """3x3 conv + BN + ReLU fusion after the skip concat."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, 1, 1)
        self.bn = DomainBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, nd: int) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), nd))


class TConvStage(nn.Module):
    """ConvTranspose(k2, s2) + BN + ReLU upsampling."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.tconv = ConvTranspose2d(in_channels, out_channels, 2, 2)
        self.bn = DomainBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, nd: int) -> torch.Tensor:
        return torch.relu(self.bn(self.tconv(x), nd))


class UNetResNet34(nn.Module):
    """Full-resolution 64-channel feature UNet; (B, H, W, 3) -> (B, H, W,
    64)."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.4):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        self.conv1 = Conv2d(3, 64, 7, 1, 3, bias=False)  # stride 1 (ref :93)
        self.bn1 = DomainBatchNorm(64)
        self.layer1 = ResLayer(64, 64, 3, 1)
        self.layer2 = ResLayer(64, 128, 4, 2)
        self.layer3 = ResLayer(128, 256, 6, 2)
        self.layer4 = ResLayer(256, 512, 3, 2)
        self.dec_t_conv_stage5 = TConvStage(512, 256)
        self.dec_conv_stage4 = DecStage(512, 256)
        self.dec_t_conv_stage4 = TConvStage(256, 128)
        self.dec_conv_stage3 = DecStage(256, 128)
        self.dec_t_conv_stage3 = TConvStage(128, 64)
        self.dec_conv_stage2 = DecStage(128, 64)
        self.dec_t_conv_stage2 = TConvStage(64, 64)
        self.dec_conv_stage1 = Conv2d(128, 64, 3, 1, 1)

    def forward(self, img: torch.Tensor, n_domains: int = 1,
                generator: torch.Generator | None = None):
        """(B, H, W, 3) -> (B, H, W, 64) in the compute dtype. In training,
        ``generator`` draws the dropout masks."""
        nd = n_domains
        p = self.dropout_rate if self.training else 0.0
        h, w = img.shape[1], img.shape[2]
        pad_h, pad_w = (-h) % 16, (-w) % 16
        x = F.pad(img, (0, 0, 0, pad_w, 0, pad_h))
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x), nd))
        inter = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer1(x, nd)
        inter.append(x)
        x = self.layer2(x, nd)
        inter.append(x)
        x = dropout(self.layer3(x, nd), p, generator)
        inter.append(x)
        x = dropout(self.layer4(x, nd), p, generator)
        x = self.dec_t_conv_stage5(x, nd)
        x = self.dec_conv_stage4(torch.cat([inter[3], x], dim=1), nd)
        x = self.dec_t_conv_stage4(x, nd)
        x = self.dec_conv_stage3(torch.cat([inter[2], x], dim=1), nd)
        x = self.dec_t_conv_stage3(x, nd)
        x = self.dec_conv_stage2(torch.cat([inter[1], x], dim=1), nd)
        x = self.dec_t_conv_stage2(x, nd)
        x = self.dec_conv_stage1(torch.cat([inter[0], x], dim=1))
        x = x[:, :, :h, :w]
        return x.permute(0, 2, 3, 1)


def lift_image_feats(feat_map: torch.Tensor, img_indices: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) features at each point's (row, col) pixel: (B, P, C),
    zeros at padding points (which read pixels of their own, so that no
    run of one pixel meets the gather's backward)."""
    b, h, w, c = feat_map.shape
    p = img_indices.shape[1]
    rows = img_indices[..., 0].long().clamp(0, h - 1)
    cols = img_indices[..., 1].long().clamp(0, w - 1)
    pos = torch.arange(p, device=feat_map.device)[None, :] % (h * w)
    flat = torch.where(valid, rows * w + cols, pos)
    bidx = torch.arange(b, device=feat_map.device)[:, None]
    out = feat_map.reshape(b, h * w, c)[bidx, flat]
    return torch.where(valid[..., None], out, torch.zeros_like(out))


class Net2DSeg(nn.Module):
    """UNetResNet34 features lifted to the points, float32 linear heads
    (``linear``, ``linear2`` with the dual head) and, with ``output_all``,
    the dense ``seg_logit_all`` map that the SAM loss reads."""

    def __init__(self, num_classes: int, dual_head: bool,
                 compute_dtype: torch.dtype, output_all: bool):
        super().__init__()
        self.output_all = output_all
        self.net_2d = UNetResNet34(compute_dtype)
        self.linear = nn.Linear(64, num_classes)
        self.linear2 = nn.Linear(64, num_classes) if dual_head else None

    def forward(self, img, img_indices, point_valid, n_domains: int = 1,
                generator: torch.Generator | None = None) -> dict:
        x = self.net_2d(img, n_domains, generator)
        b, p = img_indices.shape[:2]
        preds = {}
        if self.output_all:
            preds["seg_logit_all"] = self.linear(x.float())
        feats = lift_image_feats(x, img_indices, point_valid)
        feats = feats.float().reshape(b * p, -1)
        preds.update(feats=feats, seg_logit=self.linear(feats))
        if self.linear2 is not None:
            preds["seg_logit2"] = self.linear2(feats)
        return preds
