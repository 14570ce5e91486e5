"""SalsaNext, the range-image 3D backbone (PyTorch port of
``mopa_tpu/models/salsanext.py``), eval and training forward.

After TiagoCortinhal/SalsaNext: three residual context blocks, four pooled
residual dilation blocks, an unpooled bottleneck and four pixel-shuffle up
blocks; the segmentation heads live in ``Net3DSeg``, so the net ends at the
``base``-channel feature map. Input (B, H, W, 5) range images (range, x, y,
z, intensity), output (B, H, W, base) float32; inside, NCHW through cuDNN
(the JAX package computes these convs with XLA, outside any Pallas kernel).

The JAX package's conventions, copied:

* flax ``nn.Conv`` and ``nn.BatchNorm`` without a dtype promote to their
  float32 parameters, so after the input is rounded to the compute dtype the
  whole net runs in float32;
* "SAME" padding, the 2x2 dilated convs padded by 1 on each side;
* ``avg_pool`` 3x3 / 2 "SAME" pads (0, 1) on an even side and (1, 1) on an
  odd one, the padding counted in the mean;
* batch norm is flax's: momentum 0.9, eps 1e-5, the variance E[x^2] -
  E[x]^2 (clipped at 0), and the running variance updated with that biased
  batch variance;
* the JAX package's NHWC ``pixel_shuffle`` reads channel c * r^2 + i * r
  + j for pixel (i, j) of a block, which is ``F.pixel_shuffle``'s order on
  NCHW;
* dropout (p 0.2) acts in training only, its mask drawn from the caller's
  generator.

Names follow flax's (``downCntx.conv1``, ``resBlock1.bn2.scale``,
``upBlock4.conv4``, ...), so flax variables cross by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mopa_tpu_torch.models.resnet34_unet import Conv2d, dropout, init_weights


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW float32 (momentum 0.9, eps 1e-5, fast
    variance); the running buffers update in place in training."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


def _conv(cin: int, cout: int, kernel: int, dilation: int = 1) -> Conv2d:
    """flax ``nn.Conv`` with "SAME" padding (odd kernels)."""
    return Conv2d(cin, cout, kernel, 1, dilation * (kernel - 1) // 2,
                  dilation=dilation)


def _conv2x2(cin: int, cout: int) -> Conv2d:
    """The 2x2 conv of dilation 2 padded by 1 on each side."""
    return Conv2d(cin, cout, 2, 1, 1, dilation=2)


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (3, 3), (2, 2), "SAME")`` on NCHW: XLA's SAME
    padding, low total // 2 and high the rest, with the padding counted."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.avg_pool2d(F.pad(x, pads), 3, 2, 0)


class ResContextBlock(nn.Module):
    def __init__(self, cin: int, out: int):
        super().__init__()
        self.conv1 = _conv(cin, out, 1)
        self.conv2 = _conv(out, out, 3)
        self.bn1 = BatchNorm(out)
        self.conv3 = _conv(out, out, 3, 2)
        self.bn2 = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = torch.relu(self.conv1(x))
        h = self.bn1(torch.relu(self.conv2(shortcut)))
        h = self.bn2(torch.relu(self.conv3(h)))
        return shortcut + h


class ResBlock(nn.Module):
    def __init__(self, cin: int, out: int, dropout_rate: float = 0.2,
                 pooling: bool = True, drop_out: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate if drop_out else 0.0
        self.pooling = pooling
        self.conv1 = _conv(cin, out, 1)
        self.conv2 = _conv(cin, out, 3)
        self.bn1 = BatchNorm(out)
        self.conv3 = _conv(out, out, 3, 2)
        self.bn2 = BatchNorm(out)
        self.conv4 = _conv2x2(out, out)
        self.bn3 = BatchNorm(out)
        self.conv5 = _conv(3 * out, out, 1)
        self.bn4 = BatchNorm(out)

    def forward(self, x: torch.Tensor, generator) -> tuple:
        p = self.dropout_rate if self.training else 0.0
        shortcut = torch.relu(self.conv1(x))
        a1 = self.bn1(torch.relu(self.conv2(x)))
        a2 = self.bn2(torch.relu(self.conv3(a1)))
        a3 = self.bn3(torch.relu(self.conv4(a2)))
        cat = self.bn4(torch.relu(self.conv5(torch.cat([a1, a2, a3], dim=1))))
        res = shortcut + cat
        if not self.pooling:
            res = dropout(res, p, generator)
            return res, res
        return dropout(avg_pool_same(res), p, generator), res


class UpBlock(nn.Module):
    def __init__(self, cin: int, skip_c: int, out: int,
                 dropout_rate: float = 0.2, drop_out: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate if drop_out else 0.0
        self.conv1 = _conv(cin // 4 + skip_c, out, 3)
        self.bn1 = BatchNorm(out)
        self.conv2 = _conv(out, out, 3, 2)
        self.bn2 = BatchNorm(out)
        self.conv3 = _conv2x2(out, out)
        self.bn3 = BatchNorm(out)
        self.conv4 = _conv(3 * out, out, 1)
        self.bn4 = BatchNorm(out)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator) -> torch.Tensor:
        p = self.dropout_rate if self.training else 0.0
        up = F.pixel_shuffle(x, 2)
        up = dropout(up, p, generator)
        sh, sw = skip.shape[2], skip.shape[3]
        # crop, then zero-pad at the bottom and right, to the skip's size
        up = up[:, :, :sh, :sw]
        up = F.pad(up, (0, sw - up.shape[3], 0, sh - up.shape[2]))
        h = dropout(torch.cat([up, skip], dim=1), p, generator)
        e1 = self.bn1(torch.relu(self.conv1(h)))
        e2 = self.bn2(torch.relu(self.conv2(e1)))
        e3 = self.bn3(torch.relu(self.conv3(e2)))
        cat = self.bn4(torch.relu(self.conv4(torch.cat([e1, e2, e3], dim=1))))
        return dropout(cat, p, generator)


class SalsaNext(nn.Module):
    """(B, H, W, in_channels) range images -> (B, H, W, base) float32."""

    def __init__(self, in_channels: int = 5, base: int = 32,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        m = base
        self.base = base
        self.compute_dtype = compute_dtype
        self.downCntx = ResContextBlock(in_channels, m)
        self.downCntx2 = ResContextBlock(m, m)
        self.downCntx3 = ResContextBlock(m, m)
        self.resBlock1 = ResBlock(m, 2 * m, drop_out=False)
        self.resBlock2 = ResBlock(2 * m, 4 * m)
        self.resBlock3 = ResBlock(4 * m, 8 * m)
        self.resBlock4 = ResBlock(8 * m, 8 * m)
        self.resBlock5 = ResBlock(8 * m, 8 * m, pooling=False)
        self.upBlock1 = UpBlock(8 * m, 8 * m, 4 * m)
        self.upBlock2 = UpBlock(4 * m, 8 * m, 4 * m)
        self.upBlock3 = UpBlock(4 * m, 4 * m, 2 * m)
        self.upBlock4 = UpBlock(2 * m, 2 * m, m, drop_out=False)
        init_weights(self, generator)

    @property
    def out_channels(self) -> int:
        return self.base

    def forward(self, proj_in: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # rounded to the compute dtype, then promoted with the parameters
        # (float32), as flax promotes
        x = proj_in.to(self.compute_dtype)
        x = x.to(torch.promote_types(
            x.dtype, next(self.parameters()).dtype)).permute(0, 3, 1, 2)
        x = self.downCntx3(self.downCntx2(self.downCntx(x)))
        d1, s1 = self.resBlock1(x, generator)
        d2, s2 = self.resBlock2(d1, generator)
        d3, s3 = self.resBlock3(d2, generator)
        d4, s4 = self.resBlock4(d3, generator)
        d5, _ = self.resBlock5(d4, generator)
        u = self.upBlock1(d5, s4, generator)
        u = self.upBlock2(u, s3, generator)
        u = self.upBlock3(u, s2, generator)
        u = self.upBlock4(u, s1, generator)
        return u.permute(0, 2, 3, 1).float()
