"""xMUDA dual-network architecture (PyTorch port of
``mopa_tpu/models/xmuda_arch.py``), eval and training forward.

* :class:`Net2DSeg`: UNetResNet34 features, 2D -> 3D lifting over a padded
  (B, P, 2) pixel-index tensor, linear seg head(s) in float32; with
  ``output_all`` also the dense ``seg_logit_all`` map (the shared ``linear``
  head on the float32 feature map, read by the SAM consistency loss); with
  ``depth_pred`` the depth head's dense ``depth_pred`` map.
* :class:`Net3DSeg`: a 3D backbone and linear seg head(s) in float32 on its
  point features: the SCN SparseUNet or SPVCNN over a precomputed
  ``UNetPlan``, or SalsaNext over range images, its (B, H, W, C) features
  gathered at each point's pixel (and the dense ``seg_logit_all`` range
  logits beside the per-point ones).

``n_domains`` > 1 fuses that many forwards (stacked images; a plan whose
levels carry domains) with per-domain batch-norm statistics in training.

Per-point tensors are padded to a per-sample budget P; ``point_valid`` (B, P)
masks padding.
"""

from __future__ import annotations

import torch
from torch import nn

from mopa_tpu_torch.common.spans import span
from mopa_tpu_torch.models.resnet34_unet import UNetResNet34, init_weights
from mopa_tpu_torch.models.salsanext import SalsaNext
from mopa_tpu_torch.models.scn_unet import SparseUNet, UNetPlan
from mopa_tpu_torch.models.spvcnn import SPVCNN
from mopa_tpu_torch.ops.lifting import lift_image_feats


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` with ``x`` promoted with the layer's weights, as flax's
    ``nn.Dense`` without a dtype promotes."""
    return layer(x.to(torch.promote_types(x.dtype, layer.weight.dtype)))


class Net2DSeg(nn.Module):
    def __init__(self, num_classes: int, dual_head: bool,
                 backbone_2d: str = "UNetResNet34",
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 output_all: bool = False, depth_pred: bool = False):
        super().__init__()
        if backbone_2d != "UNetResNet34":
            raise NotImplementedError(
                "2D backbone {} not supported".format(backbone_2d))
        self.output_all = output_all
        self.depth_pred = depth_pred
        self.net_2d = UNetResNet34(compute_dtype, generator,
                                   depth_pred=depth_pred)
        self.linear = nn.Linear(64, num_classes)
        self.linear2 = nn.Linear(64, num_classes) if dual_head else None
        init_weights(self.linear, generator)
        if dual_head:
            init_weights(self.linear2, generator)

    def forward(self, img: torch.Tensor, img_indices: torch.Tensor,
                point_valid: torch.Tensor, n_domains: int = 1,
                generator: torch.Generator | None = None) -> dict:
        """img (B, H, W, 3); img_indices (B, P, 2); point_valid (B, P).

        Returns 'feats' (B*P, 64), 'seg_logit' (B*P, C), with the dual head
        'seg_logit2', with ``output_all`` 'seg_logit_all' (B, H, W, C), and
        with ``depth_pred`` 'depth_pred' (B, H, W, 1) float32.
        ``generator`` draws the training-mode dropout masks. Spans
        ``net2d/lift`` (the features at the points) and ``net2d/heads``."""
        x = self.net_2d(img, n_domains, generator)
        b, p = img_indices.shape[:2]
        preds = {}
        if self.depth_pred:
            x, preds["depth_pred"] = x
        with span("net2d/lift", trace=False):
            feats = lift_image_feats(x, img_indices, point_valid)
            feats = feats.float().reshape(b * p, -1)
        with span("net2d/heads", trace=False):
            if self.output_all:
                preds["seg_logit_all"] = self.linear(x.float())
            preds.update(feats=feats, seg_logit=self.linear(feats))
            if self.linear2 is not None:
                preds["seg_logit2"] = self.linear2(feats)
        return preds


class Net3DSeg(nn.Module):
    """``backbone_3d`` "SCN", a name containing "SPVCNN" (``in_channels``
    point features, 5-level plans) or containing "SalsaNext" (5-channel
    range images)."""

    def __init__(self, num_classes: int, dual_head: bool,
                 backbone_3d: str = "SCN", in_channels: int = 1, m: int = 16,
                 num_planes: int = 7, block_reps: int = 1,
                 residual_blocks: bool = False, full_scale: int = 4096,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.is_range = "SalsaNext" in backbone_3d
        if backbone_3d == "SCN":
            self.net_3d = SparseUNet(in_channels, m, num_planes, block_reps,
                                     residual_blocks, full_scale,
                                     compute_dtype, generator)
            width = m
        elif "SPVCNN" in backbone_3d:
            self.net_3d = SPVCNN(in_channels, compute_dtype=compute_dtype,
                                 generator=generator)
            width = self.net_3d.out_channels
        elif self.is_range:
            # range, x, y, z, intensity (augmentation_3d.build_range_input)
            self.net_3d = SalsaNext(5, compute_dtype=compute_dtype,
                                    generator=generator)
            width = self.net_3d.out_channels
        else:
            raise NotImplementedError(
                "3D backbone {} not supported".format(backbone_3d))
        self.linear = nn.Linear(width, num_classes)
        self.linear2 = nn.Linear(width, num_classes) if dual_head else None
        init_weights(self.linear, generator)
        if dual_head:
            init_weights(self.linear2, generator)

    def forward(self, point_feats: torch.Tensor, plan: UNetPlan | None,
                n_domains: int = 1, proj_in: torch.Tensor | None = None,
                proj_xy: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict:
        """point_feats (B*P, in_channels) over ``plan``, or SalsaNext's
        ``proj_in`` (B, H, W, 5) and ``proj_xy`` (B, P, 2) (row, col) pixels
        -> 'feats', 'seg_logit' [, 'seg_logit2'] per point [, SalsaNext's
        'seg_logit_all' (B, H, W, C)]. ``generator`` draws the training-mode
        dropout masks of SPVCNN and SalsaNext."""
        dense = None
        if self.is_range:
            dense = self.net_3d(proj_in, generator)
            b, p = proj_xy.shape[:2]
            py = proj_xy[..., 0].clamp(0, dense.shape[1] - 1)
            px = proj_xy[..., 1].clamp(0, dense.shape[2] - 1)
            rows = torch.arange(b, device=dense.device)[:, None]
            feats = dense[rows, py, px].reshape(b * p, -1)
        elif isinstance(self.net_3d, SPVCNN):
            feats = self.net_3d(point_feats, plan, n_domains, generator)
        else:
            feats = self.net_3d(point_feats, plan, n_domains)
        feats = feats.float()
        preds = {"feats": feats, "seg_logit": _dense(self.linear, feats)}
        if self.linear2 is not None:
            preds["seg_logit2"] = _dense(self.linear2, feats)
        if dense is not None:
            preds["seg_logit_all"] = _dense(self.linear, dense.float())
        return preds
