"""2D -> 3D feature lifting (PyTorch port of ``mopa_tpu/ops/lifting.py``,
forward): one batched gather of per-point pixel features."""

import torch


def lift_image_feats(feat_map: torch.Tensor, img_indices: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Gather features at per-point pixel coordinates.

    Args:
        feat_map: (B, H, W, C) image features.
        img_indices: (B, P, 2) integer (row, col) per point, clamped to the
            image.
        valid: (B, P) bool padding mask.

    Returns (B, P, C); padding points receive zeros.
    """
    b, h, w, _ = feat_map.shape
    rows = img_indices[..., 0].long().clamp(0, h - 1)
    cols = img_indices[..., 1].long().clamp(0, w - 1)
    bidx = torch.arange(b, device=feat_map.device)[:, None]
    out = feat_map[bidx, rows, cols]
    return torch.where(valid[..., None], out, torch.zeros_like(out))
