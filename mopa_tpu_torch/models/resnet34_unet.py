"""UNet on a ResNet34 encoder (PyTorch port of
``mopa_tpu/models/resnet34_unet.py``), eval and training forward.

Reference backbone ``mopa/models/resnet34_unet.py:83-191``: torchvision-style
ResNet34 encoder with conv1 stride 1, maxpool + 4 stages, decoder of
ConvTranspose(k2, s2)+BN+ReLU stages with skip concatenation and 3x3 conv
fusions, final 3x3 conv to 64 channels; the input is padded to a multiple of
16 and cropped back. With ``depth_pred`` the depth head
(:class:`InitialTaskPredictionModule`, reference ``resnet34_unet.py:52-80``)
reads the cropped features. Dropout (p=0.4 after layer3 and layer4) acts in training
only, drawing its mask from the caller's generator. ``n_domains`` > 1 fuses
that many forwards stacked on the batch axis, with per-domain batch-norm
statistics. The public layout is NHWC like the reference; convolutions run
NCHW through cuDNN. Parameters stay float32 and are cast to the compute dtype
at each conv, as flax's ``dtype=`` does; batch norm computes in float32.
Module and parameter names follow the reference's flax names
(``layer1.block0.conv1``, ``bn1.scale``, ...), so ``models.weights`` maps
them one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mopa_tpu_torch.common.spans import span


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype (weights cast per call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding)


def init_weights(module: nn.Module, generator: torch.Generator | None) -> None:
    """Seeded init: conv/linear weights normal with variance 1 / fan_in (the
    reference's lecun-normal scale), biases zero."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=generator)
                        * fan_in ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()


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
    """flax ``nn.Dropout``: keep with probability 1 - p and scale by
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


class BottleneckPad(nn.Module):
    """Bottleneck residual block: 1x1 -> 3x3 -> 1x1 x4, each conv without
    bias and followed by batch norm, and a 1x1 conv + BN on the skip with
    ``downsample`` (the depth head's; the JAX package's stride and dilation
    are always 1 there)."""

    def __init__(self, inplanes: int, planes: int, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = DomainBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = DomainBatchNorm(planes)
        self.conv3 = Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = DomainBatchNorm(4 * planes)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, 4 * planes, 1, bias=False)
            self.downsample_bn = DomainBatchNorm(4 * planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, nd: int) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), nd))
        y = torch.relu(self.bn2(self.conv2(y), nd))
        y = self.bn3(self.conv3(y), nd)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x), nd)
        return torch.relu(y + residual)


class InitialTaskPredictionModule(nn.Module):
    """The depth head: two :class:`BottleneckPad` blocks to
    ``intermediate_channels`` (the first with a downsampled skip where the
    width changes), then a 1x1 conv with bias to one channel in float32
    (flax's ``conv_out`` has no dtype)."""

    def __init__(self, in_channels: int = 64,
                 intermediate_channels: int = 256):
        super().__init__()
        inter = intermediate_channels
        self.bottleneck1 = BottleneckPad(in_channels, inter // 4,
                                         downsample=in_channels != inter)
        self.bottleneck2 = BottleneckPad(inter, inter // 4)
        self.conv_out = Conv2d(inter, 1, 1)

    def forward(self, x: torch.Tensor, nd: int) -> torch.Tensor:
        """(B, C, H, W) -> (B, 1, H, W) float32."""
        x = self.bottleneck2(self.bottleneck1(x, nd), nd)
        return self.conv_out(x.float())


class UNetResNet34(nn.Module):
    """Full-resolution 64-channel feature UNet; (B, H, W, 3) -> (B, H, W, 64)
    and, with ``depth_pred``, the depth head's (B, H, W, 1) float32 map."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 dropout_rate: float = 0.4, depth_pred: bool = False):
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
        self.depth_head = InitialTaskPredictionModule() if depth_pred \
            else None
        init_weights(self, generator)

    def forward(self, img: torch.Tensor, n_domains: int = 1,
                generator: torch.Generator | None = None):
        """(B, H, W, 3) -> (B, H, W, 64) in the compute dtype, with the depth
        head a pair (features, (B, H, W, 1) depth). In training,
        ``generator`` draws the dropout masks. Spans ``net2d/encoder`` and
        ``net2d/decoder`` (the depth head with it)."""
        nd = n_domains
        p = self.dropout_rate if self.training else 0.0
        h, w = img.shape[1], img.shape[2]
        pad_h, pad_w = (-h) % 16, (-w) % 16
        with span("net2d/encoder", trace=False):
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
        with span("net2d/decoder", trace=False):
            x = self.dec_t_conv_stage5(x, nd)
            x = self.dec_conv_stage4(torch.cat([inter[3], x], dim=1), nd)
            x = self.dec_t_conv_stage4(x, nd)
            x = self.dec_conv_stage3(torch.cat([inter[2], x], dim=1), nd)
            x = self.dec_t_conv_stage3(x, nd)
            x = self.dec_conv_stage2(torch.cat([inter[1], x], dim=1), nd)
            x = self.dec_t_conv_stage2(x, nd)
            x = self.dec_conv_stage1(torch.cat([inter[0], x], dim=1))
            x = x[:, :, :h, :w]
            if self.depth_head is None:
                return x.permute(0, 2, 3, 1)
            return (x.permute(0, 2, 3, 1),
                    self.depth_head(x, nd).permute(0, 2, 3, 1))
