"""xMUDA dual-network architecture (PyTorch port of
``mopa_tpu/models/xmuda_arch.py``), eval and training forward.

* :class:`Net2DSeg`: UNetResNet34 features, 2D -> 3D lifting over a padded
  (B, P, 2) pixel-index tensor, linear seg head(s) in float32; with
  ``output_all`` also the dense ``seg_logit_all`` map (the shared ``linear``
  head on the float32 feature map, read by the SAM consistency loss).
* :class:`Net3DSeg`: the SCN SparseUNet over a precomputed ``UNetPlan``,
  linear seg head(s) in float32 on the 16-channel point features.

``n_domains`` > 1 fuses that many forwards (stacked images; a plan whose
levels carry domains) with per-domain batch-norm statistics in training.

Per-point tensors are padded to a per-sample budget P; ``point_valid`` (B, P)
masks padding.
"""

from __future__ import annotations

import torch
from torch import nn

from mopa_tpu_torch.models.resnet34_unet import UNetResNet34, init_weights
from mopa_tpu_torch.models.scn_unet import SparseUNet, UNetPlan
from mopa_tpu_torch.ops.lifting import lift_image_feats


class Net2DSeg(nn.Module):
    def __init__(self, num_classes: int, dual_head: bool,
                 backbone_2d: str = "UNetResNet34",
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 output_all: bool = False):
        super().__init__()
        if backbone_2d != "UNetResNet34":
            raise NotImplementedError(
                "2D backbone {} not supported".format(backbone_2d))
        self.output_all = output_all
        self.net_2d = UNetResNet34(compute_dtype, generator)
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
        'seg_logit2', and with ``output_all`` 'seg_logit_all' (B, H, W, C).
        ``generator`` draws the training-mode dropout masks."""
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


class Net3DSeg(nn.Module):
    def __init__(self, num_classes: int, dual_head: bool,
                 backbone_3d: str = "SCN", in_channels: int = 1, m: int = 16,
                 num_planes: int = 7, block_reps: int = 1,
                 residual_blocks: bool = False, full_scale: int = 4096,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if backbone_3d != "SCN":
            raise NotImplementedError(
                "3D backbone {} not supported yet".format(backbone_3d))
        self.net_3d = SparseUNet(in_channels, m, num_planes, block_reps,
                                 residual_blocks, full_scale, compute_dtype,
                                 generator)
        self.linear = nn.Linear(m, num_classes)
        self.linear2 = nn.Linear(m, num_classes) if dual_head else None
        init_weights(self.linear, generator)
        if dual_head:
            init_weights(self.linear2, generator)

    def forward(self, point_feats: torch.Tensor, plan: UNetPlan,
                n_domains: int = 1) -> dict:
        """point_feats (B*P, in_channels) -> 'feats', 'seg_logit'
        [, 'seg_logit2']."""
        feats = self.net_3d(point_feats, plan, n_domains).float()
        preds = {"feats": feats, "seg_logit": self.linear(feats)}
        if self.linear2 is not None:
            preds["seg_logit2"] = self.linear2(feats)
        return preds
